#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (jpegqs_tpu_torch) on one NVIDIA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from csrc/ and, failing loudly (non-zero exit)
on any mismatch:

1. prints the card (nvidia-smi name, power limit) and the versions;
2. builds the kernels and prints the build time and the ptxas report;
3. runs the arithmetic canaries: no mul+add contraction, an exact fp32
   left fold, IEEE division;
4. holds both kernels bit for bit against their plain PyTorch versions on
   the card: flags 0 and DIAGONALS, rebalance on and off, edge shapes
   (hb=1, wb=1, 1x1) and full-size planes;
5. reproduces the golden SHA-256 digests of the JAX package's output
   planes (GOLDEN below; tests/test_torch_isolation.py recomputes them
   with jpegqs_tpu.engine) with the kernels;
6. drives the main path, ``jpegqs_tpu_torch.smooth`` at q3 n3, on a 12 MP
   4:2:0 colour photo and on the 2.1 MP gray frame of bench.py: launch
   counts, bit-identity with the plain path on the card, device and
   end-to-end times, MP/s.

Its last line is {"ok": true, "device": {...}}; the line before it is
nvidia-smi's name and power limit, and before that one JSON line of
per-kernel numbers, and before that one summary line per main-path
image.  Without a CUDA device it exits 1 and prints no result.
"""

from __future__ import annotations

import hashlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np

import jpegqs_tpu_torch
from jpegqs_tpu_torch import DIAGONALS, QsOptions, engine, synth
from jpegqs_tpu_torch.host.jpegio import ComponentData, JpegImage, JCS_YCBCR
from jpegqs_tpu_torch.ops import _build, cuda_solver, dct, planar
from jpegqs_tpu_torch.ops.quant import make_quant_tables

# H100 SXM peaks (NVIDIA data sheet, at a 700 W limit): 3.35 TB/s of HBM;
# 67 TFLOP/s fp32 counts an FMA as two operations, so separate fp32 adds
# and multiplies (the solver's fold never fuses) issue at half that.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12 / 2
# per term of non-zero weight; a zero-weight term cannot change the fold
# (make_solver_tables), so the work the function needs skips it
B2_FP32_OPS_PER_TERM = 9   # sub, max, t*t, d*t, tab*t, u*w, +, w*w, +

# (name, image, quality, niter).  image: ("synth", height, width, color,
# seed) -- jpegqs_tpu_torch.synth at IJG quality 75, at the shapes of
# tests/test_engine.py -- or ("crafted", which): tests/test_robustness.py's
# damaged inputs, which trip the dequantization guard on the device.
GOLDEN_CASES = (
    ("gray_q3_n0", ("synth", 64, 64, False, 1), 3, 0),
    ("gray_q3_n1", ("synth", 64, 64, False, 1), 3, 1),
    ("gray_q3_n3", ("synth", 64, 64, False, 1), 3, 3),
    ("gray_q4_n3", ("synth", 64, 64, False, 1), 4, 3),
    ("c420_q3_n3", ("synth", 48, 64, True, 3), 3, 3),
    ("c420_q4_n1", ("synth", 48, 64, True, 3), 4, 1),
    ("coef_overflow_q3_n3", ("crafted", "coef_overflow"), 3, 3),
    ("bad_second_comp_q3_n3", ("crafted", "bad_second_comp"), 3, 3),
)
# SHA-256 of jpegqs_tpu.engine.smooth's output planes (see digest()).
GOLDEN = {
    "gray_q3_n0":
        "d6018d05b1630bcd470f29945ae673d978b7c919728fc24cd44a258ee500e999",
    "gray_q3_n1":
        "1b8999a7dc5731f745e59284dd11c25fe7564f0ab37a0c209843538e8bf78c9c",
    "gray_q3_n3":
        "bd2bb3367a02f29cebf17b4bf50953890368bd776fb81368a217164f134c9356",
    "gray_q4_n3":
        "8f8561a02cff9cdd8ae1b1e93d05787229636f5e24988ac5964dc18368dc044c",
    "c420_q3_n3":
        "d868a59adeb3de54fb7693dd11007e1fd143cb338980fcb3e2ce561633141125",
    "c420_q4_n1":
        "c56c82d124cf3d9dffa06a0d4df45176e4f0aa692fb23351827a3a285d0e44e1",
    "coef_overflow_q3_n3":
        "00348cf32b75fb382781eb44a5c5faa42ea1705282e16a388b7455e25a473e22",
    "bad_second_comp_q3_n3":
        "5b41820de2f41c6d5759540f19cc3057e81fbe398c98bcfe76ca0a7056d8f539",
}


def crafted_image(which):
    """tests/test_robustness.py's damaged inputs, one 6x8-block plane per
    component: a dequantized coefficient past int16 (900 * 64), alone or
    in the second of three YCbCr components."""
    if which == "coef_overflow":
        rng = np.random.default_rng(2)
        planes = rng.integers(-5, 6, (1, 6, 8, 64)).astype(np.int16)
        planes[0, 2, 3, 10] = 900
    else:
        rng = np.random.default_rng(5)
        planes = rng.integers(-5, 6, (3, 6, 8, 64)).astype(np.int16)
        planes[1, 0, 0, 3] = 1000
    img = JpegImage(width=64, height=48,
                    jpeg_color_space=JCS_YCBCR if len(planes) == 3 else 1,
                    progressive=False, max_h_samp_factor=1,
                    max_v_samp_factor=1)
    for ci, plane in enumerate(planes):
        img.components.append(ComponentData(
            component_id=ci, h_samp_factor=1, v_samp_factor=1,
            quant_tbl_no=0, width_in_blocks=8, height_in_blocks=6,
            quantval=np.full(64, 64, np.uint16), coefs=plane.copy()))
    return img


def golden_image(case):
    spec = case[1]
    if spec[0] == "crafted":
        return crafted_image(spec[1])
    _, h, w, color, seed = spec
    return synth.make_image(h, w, color=color, seed=seed, quality=75)


def golden_opts(case):
    return QsOptions.from_quality(case[2], case[3])


def digest(coefs, stop) -> str:
    """SHA-256 over the int16 output planes (little-endian, in order)
    and the stop flag."""
    h = hashlib.sha256()
    for c in coefs:
        h.update(np.ascontiguousarray(c, dtype="<i2").tobytes())
    h.update(bytes([int(stop)]))
    return h.hexdigest()


# ---------------------------------------------------------------------------


def log(msg):
    print(msg, flush=True)


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=5):
    """Median of ``reps`` warm runs of fn() on the card, CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def host_ms(fn, reps=5):
    """Median host-clock time of fn() (which must synchronize)."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


class plain_kernels:
    """Swap the kernel wrappers for their plain PyTorch versions, so the
    engine runs the plain path on CUDA tensors (the comparison run)."""

    def __enter__(self):
        self.saved = (cuda_solver.idct_pix, cuda_solver.solve_rebalance_pix)
        cuda_solver.idct_pix = plain_idct_pix
        cuda_solver.solve_rebalance_pix = plain_solve_rebalance_pix
        return self

    def __exit__(self, *exc):
        cuda_solver.idct_pix, cuda_solver.solve_rebalance_pix = self.saved


def plain_idct_pix(coef):
    B = coef.shape[1]
    return dct.idct_islow(coef.reshape(8, 8, B)).reshape(64, B)


def plain_solve_rebalance_pix(coef, pix, div, x1, qshr, flags, do_rebalance,
                              hb, wb, want_pix=True):
    tab = cuda_solver.solver_tables(flags, coef.device)
    return planar.solve_rebalance_pix(coef, pix, div, x1, qshr, tab,
                                      do_rebalance, hb, wb, want_pix)


def max_abs_err(a, b) -> int:
    return int((a.long() - b.long()).abs().max().item()) if a.numel() else 0


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_card(torch):
    log(f"card: {nvidia_smi()}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"python {sys.version.split()[0]}")


def phase_build():
    t0 = time.perf_counter()
    path = _build.build()
    _build.load()
    log(f"build: {time.perf_counter() - t0:.1f} s -> {path}")
    with open(path + ".log") as f:
        for line in f:
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"  ptxas: {line.strip()}")


def phase_canaries(torch):
    rng = np.random.default_rng(1)
    n = 1 << 16
    a = rng.uniform(1.0, 2.0, n).astype(np.float32)
    b = rng.uniform(1.0, 2.0, n).astype(np.float32)
    c = -(a * b)                     # numpy: separately rounded product
    dev = lambda x: torch.from_numpy(x).cuda()
    out = cuda_solver.canary_muladd(dev(a), dev(b), dev(c)).cpu().numpy()
    bad = int(np.count_nonzero(out))
    assert bad == 0, f"muladd canary: {bad}/{n} lanes nonzero: mul+add " \
                     f"contracted into FMA"
    terms = rng.uniform(-1e3, 1e3, (242, n)).astype(np.float32)
    want = np.zeros(n, np.float32)
    for j in range(242):             # numpy float32 left fold
        want = want + terms[j]
    got = cuda_solver.canary_fold(dev(terms)).cpu().numpy()
    bad = int(np.count_nonzero(got.view(np.int32) != want.view(np.int32)))
    assert bad == 0, f"fold canary: {bad}/{n} lanes differ"
    num = rng.uniform(-1e6, 1e6, n).astype(np.float32)
    den = rng.uniform(0.1, 1e4, n).astype(np.float32)
    den[:64] = 0.0                   # +-inf and NaN (0/0) lanes
    num[:8] = 0.0
    with np.errstate(divide="ignore", invalid="ignore"):
        want = num / den
    got = cuda_solver.canary_divide(dev(num), dev(den)).cpu().numpy()
    # NaN payloads differ between x86 and the card; the solver only
    # tests NaN-ness (the C cast maps every NaN to INT32_MIN)
    nan = np.isnan(want)
    bad = int(np.count_nonzero(nan != np.isnan(got))) + int(np.count_nonzero(
        got[~nan].view(np.int32) != want[~nan].view(np.int32)))
    assert bad == 0, f"divide canary: {bad}/{n} lanes differ from IEEE"
    log(f"canaries: muladd, fold(242), divide: {n} lanes each, all exact")


def _random_case(torch, rng, hb, wb, random_pix):
    B = hb * wb
    qtbl = rng.integers(1, 120, 64).astype(np.uint16)
    tabs = [torch.from_numpy(t).cuda() for t in make_quant_tables(qtbl)]
    coef = np.clip(rng.integers(-40, 41, (64, B))
                   * qtbl.astype(np.int32)[:, None], -32768, 32767)
    coef = torch.from_numpy(coef.astype(np.int32)).cuda()
    if random_pix:
        pix = torch.from_numpy(
            rng.integers(0, 256, (64, B)).astype(np.int32)).cuda()
    else:
        pix = plain_idct_pix(coef)
    return coef, pix, tabs


def check_pair(torch, coef, pix, tabs, flags, reb, hb, wb, want_pix=True):
    """Kernels vs plain versions on one input; returns max |err|."""
    got_pix0 = cuda_solver.idct_pix(coef)
    want_pix0 = plain_idct_pix(coef)
    got = cuda_solver.solve_rebalance_pix(coef, pix, *tabs, flags, reb, hb,
                                          wb, want_pix)
    want = plain_solve_rebalance_pix(coef, pix, *tabs, flags, reb, hb, wb,
                                     want_pix)
    torch.cuda.synchronize()
    e1 = max_abs_err(got_pix0, want_pix0)
    e2 = max_abs_err(got[0], want[0])
    if want_pix:
        e2 = max(e2, max_abs_err(got[1], want[1]))
    assert e1 == 0, f"idct_pix differs from plain (max |err| {e1})"
    assert e2 == 0, (f"solve_rebalance_pix differs from plain at hb={hb} "
                     f"wb={wb} flags={flags} reb={reb} (max |err| {e2})")
    return e1, e2


def phase_kernels_vs_plain(torch, stats):
    rng = np.random.default_rng(7)
    n = 0
    for hb, wb in ((1, 13), (9, 1), (1, 1), (9, 13), (40, 57)):
        for flags in (0, DIAGONALS):
            for reb in (True, False):
                for random_pix in (False, True):
                    coef, pix, tabs = _random_case(torch, rng, hb, wb,
                                                   random_pix)
                    e1, e2 = check_pair(torch, coef, pix, tabs, flags, reb,
                                        hb, wb, want_pix=random_pix)
                    stats["idct_pix"]["max_abs_err"] = max(
                        stats["idct_pix"]["max_abs_err"], e1)
                    stats["solve_rebalance_pix"]["max_abs_err"] = max(
                        stats["solve_rebalance_pix"]["max_abs_err"], e2)
                    n += 1
    log(f"kernels vs plain: {n} small cases bit-identical "
        f"(hb,wb in 1x13, 9x1, 1x1, 9x13, 40x57; flags 0/DIAGONALS; "
        f"rebalance on/off)")


def phase_golden(torch):
    for case in GOLDEN_CASES:
        res = engine.smooth(golden_image(case), golden_opts(case))
        got = digest(res.coefs, res.stop)
        assert got == GOLDEN[case[0]], (
            f"golden {case[0]}: {got} != {GOLDEN[case[0]]}")
    log(f"golden digests of the JAX package reproduced on the card: "
        f"{len(GOLDEN_CASES)} cases")


def _main_inputs(torch, img):
    """The 12 MP luma plane's first-pass kernel inputs (dequantized,
    int16-wrapped coefficients and their IDCT), as the engine makes them."""
    comp = img.components[0]
    hb, wb = comp.height_in_blocks, comp.width_in_blocks
    qraw = np.asarray(comp.quantval, np.int32)
    coef16 = torch.from_numpy(np.ascontiguousarray(comp.coefs).reshape(
        hb * wb, 64)).cuda()
    prod = (coef16.to(torch.int32).T
            * torch.from_numpy(qraw).cuda()[:, None]).contiguous()
    coef = engine.int16_wrap(prod)
    tabs = [torch.from_numpy(t).cuda() for t in make_quant_tables(qraw)]
    return coef, plain_idct_pix(coef), tabs, hb, wb


def phase_full_plane(torch, img, stats, card):
    """Both kernels vs plain on the 12 MP luma plane (flags 0 and
    DIAGONALS), and the per-kernel numbers of the JSON line."""
    coef, pix, tabs, hb, wb = _main_inputs(torch, img)
    B = hb * wb
    for flags in (0, DIAGONALS):
        e1, e2 = check_pair(torch, coef, pix, tabs, flags, True, hb, wb)
        stats["solve_rebalance_pix"]["max_abs_err"] = max(
            stats["solve_rebalance_pix"]["max_abs_err"], e2)
        stats["idct_pix"]["max_abs_err"] = max(
            stats["idct_pix"]["max_abs_err"], e1)
    log(f"kernels vs plain: full {hb}x{wb} luma plane bit-identical "
        f"(flags 0 and DIAGONALS, rebalance on)")
    b1, b2 = stats["idct_pix"], stats["solve_rebalance_pix"]
    b1["ms"] = cuda_ms(lambda: cuda_solver.idct_pix(coef))
    b1["plain_ms"] = cuda_ms(lambda: plain_idct_pix(coef))
    b1["bound_ms"] = B * 64 * 4 * 2 / PEAK_BYTES_PER_S * 1e3
    b1["bound_by"] = "bytes"
    args = (coef, pix, *tabs, 0, True, hb, wb)
    b2["ms"] = cuda_ms(lambda: cuda_solver.solve_rebalance_pix(*args))
    b2["plain_ms"] = cuda_ms(lambda: plain_solve_rebalance_pix(*args), 3)
    # non-zero-weight terms over the 63 sweep steps (k = 63..1) at flags 0
    terms = int(torch.count_nonzero(cuda_solver.solver_tables(0, "cpu")[1:]))
    t_ops = B * terms * B2_FP32_OPS_PER_TERM / PEAK_FP32_OPS_PER_S * 1e3
    t_bytes = B * 64 * 4 * 4 / PEAK_BYTES_PER_S * 1e3
    b2["bound_ms"] = max(t_ops, t_bytes)
    b2["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    for name in ("idct_pix", "solve_rebalance_pix"):
        s = stats[name]
        log(f"{name} on {B} blocks (q3 pass): kernel {s['ms']:.4f} ms, "
            f"plain {s['plain_ms']:.3f} ms, bound {s['bound_ms']:.4f} ms "
            f"({s['bound_by']}) [{card}]")
    log(f"  B2 bound counts {terms} non-zero-weight terms per block and "
        f"pass, of 63 x {cuda_solver.nt_for(0)} folded")


def _check_planes(img, res):
    assert res.stop == 0, "unexpected stop on a clean image"
    for comp, out in zip(img.components, res.coefs):
        shape = (comp.height_in_blocks, comp.width_in_blocks, 64)
        assert out.shape == shape and out.dtype == np.int16, out.shape
        assert np.abs(out.astype(np.int32)).max() <= 1023


def phase_main(torch, images, card):
    """The main path through the user entry point, with launch counts,
    bit-identity with the plain path on the card, and times; returns the
    launch counts and a one-line summary per image."""
    opts = QsOptions.from_quality(3, 3)
    cuda_solver.reset_launches()
    want_b1 = want_b2 = 0
    results, summaries = [], []
    for name, img in images:
        res = jpegqs_tpu_torch.smooth(img, opts)
        torch.cuda.synchronize()
        want_b1 += len(img.components)
        want_b2 += len(img.components) * opts.niter
        counts = dict(cuda_solver.LAUNCHES)
        assert counts == {"idct_pix": want_b1,
                          "solve_rebalance_pix": want_b2}, counts
        results.append(res)
    launches = dict(cuda_solver.LAUNCHES)
    log(f"main path launches: {launches}")

    for (name, img), res in zip(images, results):
        _check_planes(img, res)
        with plain_kernels():
            plain = engine.smooth(img, opts)
        for ci, (a, b) in enumerate(zip(res.coefs, plain.coefs)):
            assert np.array_equal(a, b), f"{name} comp {ci}: kernel path " \
                                         f"!= plain path"
        changed = sum(int(np.count_nonzero(
            a != (c.coefs.astype(np.int32) * c.quantval.astype(np.int32)
                  ).astype(np.int16)))
            for a, c in zip(res.coefs, img.components))
        plans, _ = engine.plan_image(img, opts)
        inputs = engine.upload(img, plans, engine.resolve_device())
        run = lambda: engine.run_image(plans, inputs, opts.flags)
        dev_ms = cuda_ms(run)
        with plain_kernels():
            plain_ms = cuda_ms(run, 3)
        e2e_ms = host_ms(lambda: jpegqs_tpu_torch.smooth(img, opts))
        up_ms = host_ms(lambda: (engine.upload(img, plans, inputs[0][0].device),
                                 torch.cuda.synchronize()))
        outs = run()[0]
        down_ms = host_ms(lambda: [o.cpu().numpy() for o in outs])
        mp = img.width * img.height / 1e6
        log(f"{name}: {img.width}x{img.height} ({mp:.2f} MP), q3 n3, "
            f"{len(img.components)} comps, {changed} coefs moved off the "
            f"lattice; bit-identical to the plain path on the card")
        log(f"  device {dev_ms:.3f} ms ({mp / dev_ms * 1e3:.1f} MP/s), "
            f"end-to-end smooth() {e2e_ms:.3f} ms "
            f"({mp / e2e_ms * 1e3:.1f} MP/s), plain device "
            f"{plain_ms:.3f} ms [{card}]")
        rest_ms = e2e_ms - up_ms - dev_ms - down_ms
        log(f"  host: upload {up_ms:.3f} ms, download {down_ms:.3f} ms, "
            f"rest of smooth() {rest_ms:.3f} ms")
        busy, n_launch, b2_ms = device_breakdown(torch, run, dev_ms)
        summaries.append(
            f"summary {name}: device {dev_ms:.3f} ms, smooth() {e2e_ms:.3f} "
            f"ms = upload {up_ms:.3f} + device + download {down_ms:.3f} + "
            f"rest {rest_ms:.3f}; card busy {100 * busy / dev_ms:.1f}%, "
            f"{n_launch} kernels, B2 {b2_ms:.3f} ms [{card}]")
    return launches, summaries


def device_breakdown(torch, run, dev_ms):
    """Kernel time by name over one device run (torch.profiler), and the
    share of the CUDA-event time the card was busy.  Returns the busy ms,
    the kernel launches and B2's ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0)
        if e.device_type == DeviceType.CUDA and t > 0:
            rows.append((t / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"  profiler: kernels {busy:.3f} ms busy in a {dev_ms:.3f} ms "
        f"device run ({100 * busy / dev_ms:.1f}%), {sum(r[1] for r in rows)}"
        f" kernel launches; top:")
    for t, n, k in rows[:6]:
        log(f"    {t:.3f} ms x{n} {k[:90]}")
    b2_ms = sum(r[0] for r in rows if "solve_rebalance_pix_kernel" in r[2])
    return busy, sum(r[1] for r in rows), b2_ms


def phase_transcode(torch, card):
    """smooth_jpeg_bytes on a JPEG of the 2.1 MP gray frame.  The host
    codec needs libjpeg; where the machine has no jpeglib.h the phase
    says so and does not run."""
    import os
    from jpegqs_tpu_torch.host import jpegio
    incs = ("/usr/include", "/usr/local/include",
            "/usr/include/x86_64-linux-gnu")
    if not any(os.path.exists(os.path.join(d, "jpeglib.h")) for d in incs):
        log("transcode (smooth_jpeg_bytes): not run: this machine has no "
            "libjpeg headers (jpeglib.h), which the host codec needs")
        return
    data = jpegio.encode_pixels(synth.synth_image(1080, 1920, seed=0),
                                quality=75)
    opts = QsOptions.from_quality(3, 3)
    out = jpegqs_tpu_torch.smooth_jpeg_bytes(data, opts)
    with plain_kernels():
        plain = jpegqs_tpu_torch.smooth_jpeg_bytes(data, opts)
    assert out == plain, "smooth_jpeg_bytes: kernel path != plain path"
    assert all(np.all(c.quantval == 1)
               for c in jpegio.read_coefficients(out).components)
    ms = host_ms(lambda: jpegqs_tpu_torch.smooth_jpeg_bytes(data, opts), 3)
    log(f"transcode (smooth_jpeg_bytes) 1920x1080 gray: {len(data)} -> "
        f"{len(out)} bytes, {ms:.3f} ms, bit-identical to the plain path "
        f"[{card}]")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    phase_card(torch)
    card = nvidia_smi()
    stats = {name: {"max_abs_err": 0} for name in cuda_solver.LAUNCHES}
    phase_build()
    phase_canaries(torch)
    phase_kernels_vs_plain(torch, stats)
    phase_golden(torch)
    t0 = time.perf_counter()
    color = synth.make_image(3000, 4000, color=True, seed=0)
    gray = synth.make_image(1080, 1920, color=False, seed=0)
    log(f"inputs: synthetic 12 MP 4:2:0 and 2.1 MP gray, IJG q75, "
        f"{time.perf_counter() - t0:.1f} s")
    phase_full_plane(torch, color, stats, card)
    launches, summaries = phase_main(torch, (("color_12mp", color),
                                             ("gray_2mp", gray)), card)
    phase_transcode(torch, card)
    for line in summaries:
        log(line)
    replaces = {
        "idct_pix": "jpegqs_tpu/ops/pallas_solver.py:883",
        "solve_rebalance_pix": "jpegqs_tpu/ops/pallas_solver.py:902",
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": "jpegqs_tpu_torch/csrc/solver.cu",
         "replaces": replaces[name], "launches": launches[name],
         "max_abs_err": stats[name]["max_abs_err"],
         "ms": stats[name]["ms"], "plain_ms": stats[name]["plain_ms"],
         "bound_ms": stats[name]["bound_ms"],
         "bound_by": stats[name]["bound_by"], "library_ms": None}
        for name in ("idct_pix", "solve_rebalance_pix")]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
