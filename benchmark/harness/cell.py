"""One run of one cell: set-up, the measured window, the check against
the plain reference, the result's line.

Set-up makes the traffic's pool of images on the device from the seed,
builds or loads the program's kernels, and warms up with ``window``
batches of the cell's own shape through the same loop, so that the
kernels, the solver tables and the pinned staging buffers of the window
are all in place before it opens.  After the window ``memory_peak_bytes``
is read, the program's device state freed, and the reference computes
every pool image that a kept batch holds, on the same device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import dataclass

from . import check, drive, photos, roofline, spec, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "jpegqs_tpu")


def forbidden_modules(modules=None) -> list:
    """Modules whose top-level name (the part before the first dot) is
    JAX's or the JAX package's, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


@dataclass
class RunContext:
    """What a metric reads: the loop's record (end-to-end metrics) and,
    in a traced run, the trace's reading (per-layer metrics)."""
    loop: drive.LoopRecord
    image_mp: float
    setup_s: float
    reading: trace.Reading = None


def to_reference(photo):
    from ..reference import image
    return image.Image(photo.width, photo.height, photo.ycbcr, [
        image.Component(c.h_samp, c.v_samp, c.hb, c.wb, c.quantval, c.coefs)
        for c in photo.comps])


def reference_results(pool, indices, cfg, device, float_dtype=None):
    """The plain reference of each pool image in ``indices``."""
    import torch

    from ..reference import image
    from ..reference.tables import quality_to_flags
    flags = quality_to_flags(cfg["quality"])
    ft = float_dtype or torch.float32
    return {i: image.smooth_image(to_reference(pool[i]), flags, cfg["niter"],
                                  device, ft) for i in sorted(indices)}


def _pace(rec, image_mp) -> str:
    """The window's batches, their completions in each quarter, the mean
    host time of each call and, as diagnostics with no bound, the rate of
    the window by the host's clock and the 95th percentile of a batch's
    time from dispatch to assembled."""
    import numpy as np
    span = max(rec.t_end - rec.t0, 1e-9)
    quarters = [0] * 4
    for b in rec.done:
        quarters[min(int(4 * (b.t_done - rec.t0) / span), 3)] += 1
    mean = lambda v: 1e3 * sum(v) / max(len(v), 1)
    lat = [b.t_done - b.t_dispatch for b in rec.done] or [0.0]
    return (f"window: {len(rec.done)} batches in {span:.3f} s, "
            f"{len(rec.drained)} drained after; completions by quarter "
            f"{quarters}; mean dispatch "
            f"{mean([b.t_dispatched - b.t_dispatch for b in rec.done]):.3f}"
            f" ms, assemble "
            f"{mean([b.t_done - b.t_assemble for b in rec.done]):.3f} ms; "
            f"throughput "
            f"{sum(len(b.images) for b in rec.done) * image_mp / span:.4f} "
            f"MP/s; batch latency p95 {1e3 * np.percentile(lat, 95):.3f} ms")


def _reading(rec, tracer, pool, cfg) -> trace.Reading:
    from ..reference.tables import quality_to_flags
    batches = rec.dispatched
    r = trace.Reading(batches=len(batches),
                      images=sum(len(b.images) for b in batches))
    r.spans = {"dispatch": [b.t_dispatched - b.t_dispatch for b in batches],
               "assemble": [b.t_done - b.t_assemble for b in batches]}
    if tracer.traced:
        flags = quality_to_flags(cfg["quality"])
        ops = nbytes = b2_ops = b2_bytes = 0
        for b in batches:
            for i in b.images:
                o, n = roofline.image_work(pool[i], flags, cfg["niter"])
                ops, nbytes = ops + o, nbytes + n
                o, n = roofline.b2_work(pool[i], flags, cfg["niter"])
                b2_ops, b2_bytes = b2_ops + o, b2_bytes + n
        r.least_s = roofline.least_seconds(ops, nbytes)
        r.b2_least_s = roofline.least_seconds(b2_ops, b2_bytes)
    if not tracer.on_card or tracer.prof is None:
        return r
    ops_, spans = tracer.events()
    if tracer.traced:
        ds, ae = spans["bench.dispatch"], spans["bench.assemble"]
        if not ds or not ae:
            return r
        lo, hi = ds[0][0], ae[-1][1]
    elif ops_:
        # the card alone, recorded from after the warm-up: every
        # operation belongs to a batch dispatched in the window
        lo, hi = ops_[0][2], max(o[3] for o in ops_)
    else:
        return r
    r.device_ops = [o for o in ops_ if o[3] > lo and o[2] < hi]
    r.window_s = (hi - lo) / 1e9
    r.busy_s = trace.union_s([(o[2], o[3]) for o in r.device_ops], lo, hi)
    r.compute_s = trace.union_s([(o[2], o[3]) for o in r.device_ops
                                 if o[1] != "copy"], lo, hi)
    if tracer.traced:
        r.breakdown = {"device_ops": trace.top_ops(r.device_ops),
                       "idle_gaps": trace.idle_gaps(
                           [(o[2], o[3]) for o in r.device_ops], spans, lo,
                           hi)}
    return r


def run_cell(bench, wl, seed, seconds, traced, device, t_start,
             overrides=None, log=None):
    """Run cell ``wl`` once on ``device``; returns the result's dict."""
    import torch

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    cfg = spec.config(bench, wl["config"])
    traffic = dict(spec.traffic(wl["traffic"]), **(overrides or {}))
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.init()
    log(f"set-up: device ready at {time.perf_counter() - t_start:.3f} s")
    pool = photos.make_pool(traffic, seed, dev)
    log(f"set-up: {len(pool)} images made at "
        f"{time.perf_counter() - t_start:.3f} s")
    system = drive.Program(cfg, device)
    inputs = [system.prepare(p) for p in pool]
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    window = traffic["window"]
    order = drive.batch_order(traffic, seed)
    warm = drive.run_loop(system, inputs, order, 0.0, window)
    system.synchronize()
    log(f"set-up: {len(warm.dispatched)} warm-up batches done at "
        f"{time.perf_counter() - t_start:.3f} s")
    tracer = trace.Tracer(traced, on_card)
    rec = warm
    if not warm.error:
        with tracer.trace():
            rec = drive.run_loop(system, inputs, order, seconds, window,
                                 traffic.get("check_batches", 1), seed,
                                 tracer.span)
            system.synchronize()
    setup_s = (rec.t0 if not warm.error else time.perf_counter()) - t_start
    if rec.error:
        log(rec.error)
    else:
        log(_pace(rec, pool[0].megapixels))
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(dev) if on_card
                            else "cpu"),
                   "count": wl["chips"],
                   "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                         if on_card else 0)}
    ctx = RunContext(rec, pool[0].megapixels, setup_s)
    if (traced or on_card) and not rec.error:
        t_read = time.perf_counter()
        ctx.reading = _reading(rec, tracer, pool, cfg)
        log(f"trace: {len(ctx.reading.device_ops)} device operations read "
            f"in {time.perf_counter() - t_read:.3f} s, the card busy "
            f"{ctx.reading.busy_s:.6f} s of {ctx.reading.window_s:.6f}, "
            f"{ctx.reading.compute_s:.6f} s without host copies")
        if traced:
            device_info["busy_s"] = ctx.reading.busy_s
            device_info["window_s"] = ctx.reading.window_s
    tracer.prof = None
    del system, inputs, warm
    if on_card:
        torch.cuda.empty_cache()

    needed = {i for b, _ in rec.kept for i in b.images}
    t_ref = time.perf_counter()
    refs = reference_results(pool, needed, cfg, dev)
    log(f"reference: {len(needed)} images in "
        f"{time.perf_counter() - t_ref:.3f} s")
    min_images = traffic.get("check_batches", 1) * traffic["batch_images"]
    checks, failed = check.checks(rec.kept, refs, min_images,
                                  int(bool(rec.error)))
    correct = all(check.passed(c) for c in checks.values())

    metrics = {}
    if not rec.error:
        section = "per_layer" if traced else "end_to_end"
        for m in spec.metrics_of(bench, wl["name"], section):
            value = spec.metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    attempted = sum(len(b.images) for b in rec.dispatched)
    out = {"correct": correct, "attempted": attempted,
           "failed": attempted if rec.error else failed,
           "metrics": metrics, "device": device_info}
    if ctx.reading is not None and ctx.reading.breakdown:
        out["breakdown"] = ctx.reading.breakdown
    out["checks"] = checks
    return out


def power_limit() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=20)
        return r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e})"


def parse_args(argv):
    p = argparse.ArgumentParser(description="Run one cell of "
                                "BENCHMARK.json once on the card.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_start) -> int:
    args = parse_args(argv)
    bench = spec.load_benchmark()
    wl = spec.workload(bench, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < wl["chips"]:
        print(f"no result: the cell needs {wl['chips']} CUDA device(s), "
              f"found {torch.cuda.device_count()} "
              f"(cuda available: {torch.cuda.is_available()})",
              file=sys.stderr)
        return 3
    out = run_cell(bench, wl, args.seed, args.seconds, bool(args.trace),
                   "cuda", t_start)
    found = forbidden_modules()
    if found:
        print(f"no result: JAX or the JAX package was loaded: {found}",
              file=sys.stderr)
        return 4
    print(f"card: {power_limit()}", file=sys.stderr)
    for line in check.lines(out["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
