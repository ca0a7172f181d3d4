#!/usr/bin/env python3
"""Time the host-bound paths of a checkout of this repository on one
card -- the main path's colour runs, the progress path and the row
flow's shards -- so that two checkouts compare in turns within one call:

    for t in dist/parent . . dist/parent; do python3 tools/time_paths.py $t; done

TREE (default: the checkout holding this script) is the root of a
checkout; its ``jpegqs_tpu_torch`` is imported, built under TREE/build,
and driven through public entry points only.  The inputs (synthetic
photos of ``synth.py``, IJG q75, seed 0) and the progress callback are
this checkout's ``chip_smoke.py``'s.

- colour 12 MP 4:2:0 (4000x3000) at q2 n3 and q6 n3: engine.run_image on
  inputs already on the card;
- the progress path, ``smooth()`` with a callback: 12 MP q6 n3 with
  PRECISE_PROGRESS row chunks, and q2 n3;
- the row flow over shards of this card, make_sharded_* on inputs
  already on the card: 4032x3024 4:2:0 q6 n3 on 2 and 4 shards, 12 MP q3
  n3 on 3 (each component on its own), 2.1 MP gray q0 n3 on 4.

Per run: the window (CUDA events around the call, or the host clock for
``smooth()``, median of REPS) and the host time until the call returns
(the dispatch: where it is close to the window, the host sets the
pace); then one run under torch.profiler split into kernel time and
launches (B1-B7 and the glue, copies between device buffers included),
host<->device copies (their length follows the host's page faults) and
the ghost exchange's range ("jpegqs_exchange").  Prints the card's
name and power limit, then one JSON line.  Exits 1 without a card.
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import sys
import time

REPS = 10
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_here(name, rel):
    """Module ``rel`` of this checkout, whatever TREE's package is."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(HERE,
                                                                     rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def window(torch, fn, reps=REPS):
    """(median event ms, median host ms until fn() returns) of warm
    runs."""
    fn()
    torch.cuda.synchronize()
    dev, host = [], []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
        b.record()
        b.synchronize()
        dev.append(a.elapsed_time(b))
    return statistics.median(dev), statistics.median(host)


def split(torch, fn):
    """One run of fn() under the profiler: kernel ms and launches,
    host<->device copy ms, exchange-range ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {"kernel_ms": 0.0, "launches": 0, "host_copy_ms": 0.0,
           "exchange_ms": 0.0}
    for e in prof.key_averages():
        if e.key == "jpegqs_exchange":
            out["exchange_ms"] += e.device_time_total / 1e3
            continue
        t = getattr(e, "self_device_time_total", 0) / 1e3
        if e.device_type != DeviceType.CUDA or t <= 0:
            continue
        if "HtoD" in e.key or "DtoH" in e.key:
            out["host_copy_ms"] += t
        else:
            out["kernel_ms"] += t
            out["launches"] += e.count
    return {k: round(v, 3) for k, v in out.items()}


def main() -> int:
    tree = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else HERE)
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("time_paths: no CUDA device", file=sys.stderr)
        return 1
    smoke = load_here("chip_smoke", "chip_smoke.py")
    from jpegqs_tpu_torch import QsOptions, engine, smooth, synth
    from jpegqs_tpu_torch.ops import _build
    from jpegqs_tpu_torch.ops.quant import make_quant_tables
    from jpegqs_tpu_torch.parallel import sharded
    assert os.path.dirname(os.path.abspath(_build.__file__)).startswith(tree)
    _build.build()
    _build.load()
    card = smoke.nvidia_smi()
    print(f"card: {card}", flush=True)
    dev = engine.resolve_device()
    color = synth.make_image(*smoke.COLOR_HW, color=True, seed=0)
    aligned = synth.make_image(*smoke.ALIGNED_HW, color=True, seed=0)
    gray = synth.make_image(*smoke.GRAY_HW, color=False, seed=0)
    out = {}

    def record(name, fn, dev_ms, host_ms):
        out[name] = {"window_ms": round(dev_ms, 3),
                     "host_ms": round(host_ms, 3), **split(torch, fn)}
        print(f"{name}: {out[name]}", flush=True)

    for q in (2, 6):
        opts = QsOptions.from_quality(q, 3)
        plan = engine.plan_image(color, opts)
        inputs = engine.upload([color], plan.comps, dev)
        run = lambda: engine.run_image(plan, inputs)
        record(f"colour 12 MP q{q} n3, device", run, *window(torch, run, 20))

    for name, q, kw in (("q6 n3 precise", 6, {"precise": True}),
                        ("q2 n3", 2, {})):
        opts = QsOptions.from_quality(q, 3, progress=smoke.recorder([]), **kw)
        run = lambda: (smooth(color, opts), torch.cuda.synchronize())
        run()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            run()
            times.append((time.perf_counter() - t0) * 1e3)
        med = statistics.median(times)
        record(f"progress {name}, smooth()", run, med, med)

    def dev_inputs(c):
        qraw = np.asarray(c.quantval, np.int32)
        return (smoke.to_dev(np.asarray(c.coefs, np.int16).reshape(
            c.height_in_blocks, c.width_in_blocks, 64)),
            [smoke.to_dev(t) for t in (qraw, *make_quant_tables(qraw))])

    y, cb = aligned.components[:2]
    ins = [dev_inputs(c) for c in aligned.components]
    for n in (2, 4):
        fn = sharded.make_sharded_ycbcr_smooth(
            ["cuda"] * n, hb_l=y.height_in_blocks, wb_l=y.width_in_blocks,
            hb_c=cb.height_in_blocks, wb_c=cb.width_in_blocks, ws=2, hs=2,
            flags=QsOptions.from_quality(6, 3).flags, niter=3,
            img_w=aligned.width, img_h=aligned.height)
        run = lambda: fn(*(p for p, _ in ins), *(t for _, t in ins))
        record(f"row flow 4032x3024 q6 n3, {n} shards", run,
               *window(torch, run))
    for name, img, q, n in (("12 MP q3 n3, 3 shards", color, 3, 3),
                            ("gray q0 n3, 4 shards", gray, 0, 4)):
        flags = QsOptions.from_quality(q, 3).flags
        fns = [(sharded.make_sharded_smooth(
            ["cuda"] * n, hb=c.height_in_blocks, wb=c.width_in_blocks,
            flags=flags, niter=3, luma=ci == 0), *dev_inputs(c))
            for ci, c in enumerate(img.components)]
        run = lambda: [f(p, *t) for f, p, t in fns]
        record(f"row flow {name}", run, *window(torch, run))
    print(json.dumps({"card": card, "tree": tree, "runs": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
