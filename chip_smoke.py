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
4. holds every kernel bit for bit against its plain PyTorch version on the
   card: B1/B2 at flags 0 and DIAGONALS, B3 (JOINT_YUV preamble) with the
   sweep at NT 242 and 144 and without it, B4 (LOW_QUALITY preamble);
   rebalance on and off, pixels emitted or not, edge shapes (hb=1, wb=1,
   1x1), two images back to back, and the main path's full-size planes;
5. reproduces the golden SHA-256 digests of the JAX package's output
   planes, upsampled planes and stop flag (GOLDEN below;
   tests/test_torch_isolation.py recomputes them with jpegqs_tpu.engine)
   with the kernels, q0-q6, gray and 4:4:4 / 4:2:2 / 4:2:0 / 4:1:1;
6. drives the main path, ``jpegqs_tpu_torch.smooth``, on a 12 MP 4:2:0
   colour photo at q3 n1, q6 n3 and q2 n3 and on the 2.1 MP gray frame of
   bench.py at q3 n1 and q0 n3: launch counts per run, bit-identity with
   the plain path on the card, device and end-to-end times, MP/s.

Its last line is {"ok": true, "device": {...}}; the line before it is
nvidia-smi's name and power limit, and before that one JSON line of
per-kernel numbers, and before that one summary line per main-path
run.  Without a CUDA device it exits 1 and prints no result.
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
from jpegqs_tpu_torch import (DIAGONALS, JOINT_YUV, LOW_QUALITY, UPSAMPLE_UV,
                              QsOptions, engine, quality_to_flags, synth)
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
FP32_OPS_PER_TERM = 9   # sub, max, t*t, d*t, tab*t, u*w, +, w*w, +
# fp32 operations per block of the B3/B4 preambles, counted from
# csrc/solver.cu: fdct_clamp is 16 butterflies of 44 ops, the 64 x0.125
# scalings and 64 roundf; JOINT is 13 per pixel (4 int->float
# conversions, the divide, 2 clamps, mul, add, mul, max, sub, min); LQ is
# the range fold (63 conversions + 63 adds, divide, mul, min, roundf) and
# per pixel 8 neighbours x 11 plus divide, 2 conversions, sub and cast
FDCT_CLAMP_OPS = 16 * 44 + 64 + 64
JOINT_PREAMBLE_OPS = 64 * 13 + FDCT_CLAMP_OPS
LQ_PREAMBLE_OPS = 130 + 64 * (8 * 11 + 5) + FDCT_CLAMP_OPS

DEVICE = "cuda"
# the main path's images: a 12 MP phone-camera frame (4:2:0) and the
# 2.1 MP frame of bench.py (gray), (height, width)
COLOR_HW = (3000, 4000)
GRAY_HW = (1080, 1920)

Q_FLAGS = {q: quality_to_flags(q) for q in range(7)}
# (flags, JOINT_YUV preamble) of the B3/B4 checks: B3 with the sweep at
# NT 242 (q6 chroma) and NT 144, B3 without it (q1/q2 chroma), B4 (q0)
FUSED_FLAG_SETS = ((JOINT_YUV | DIAGONALS, True), (JOINT_YUV, True),
                   (JOINT_YUV | LOW_QUALITY | DIAGONALS, True),
                   (LOW_QUALITY | DIAGONALS, False))
FLAG_NAMES = {JOINT_YUV | DIAGONALS: "JOINT|DIAGONALS",
              JOINT_YUV: "JOINT",
              JOINT_YUV | LOW_QUALITY | DIAGONALS: "JOINT|LQ|DIAGONALS",
              LOW_QUALITY | DIAGONALS: "LQ|DIAGONALS"}

# (name, image, quality, niter).  image: ("synth", height, width, color,
# seed[, luma sampling (h, v), default (2, 2)]) -- jpegqs_tpu_torch.synth
# at IJG quality 75, at the shapes of tests/test_engine.py -- or
# ("crafted", which): tests/test_robustness.py's damaged inputs, which
# trip the dequantization guard on the device.
GOLDEN_CASES = (
    ("gray_q3_n0", ("synth", 64, 64, False, 1), 3, 0),
    ("gray_q3_n1", ("synth", 64, 64, False, 1), 3, 1),
    ("gray_q3_n3", ("synth", 64, 64, False, 1), 3, 3),
    ("gray_q4_n3", ("synth", 64, 64, False, 1), 4, 3),
    ("c420_q3_n3", ("synth", 48, 64, True, 3), 3, 3),
    ("c420_q4_n1", ("synth", 48, 64, True, 3), 4, 1),
    ("coef_overflow_q3_n3", ("crafted", "coef_overflow"), 3, 3),
    ("bad_second_comp_q3_n3", ("crafted", "bad_second_comp"), 3, 3),
    ("gray_q0_n3", ("synth", 64, 64, False, 1), 0, 3),
    ("c420_q1_n3", ("synth", 64, 48, True, 3), 1, 3),
    ("c420_q2_n3", ("synth", 64, 48, True, 3), 2, 3),
    ("c420_q2_n0", ("synth", 64, 48, True, 3), 2, 0),
    ("c420_q5_n3", ("synth", 64, 48, True, 3), 5, 3),
    ("c420_q6_n3", ("synth", 64, 48, True, 3), 6, 3),
    ("c444_q6_n3", ("synth", 48, 56, True, 5, (1, 1)), 6, 3),
    ("c422_q6_n3", ("synth", 48, 56, True, 5, (2, 1)), 6, 3),
    ("c411_q6_n2", ("synth", 48, 72, True, 23, (4, 1)), 6, 2),
    ("bad_second_comp_q6_n3", ("crafted", "bad_second_comp"), 6, 3),
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
    "gray_q0_n3":
        "d774d0bedf1db5f73f0983445f16ab2316c4c80d65d21aebbf876ccc68c6b0c2",
    "c420_q1_n3":
        "6b51fe99d4fa8454a8b59188c33d53f03c949870e05cd86bb3c010a7edf42d33",
    "c420_q2_n3":
        "e302938271c0da67ce6fd575647ee16b0a7519973320b2edf785c470311a3ee4",
    "c420_q2_n0":
        "999dfc3a922d7eaede3bb29f6874836d90a31f01cde363b1d390cd12a2175788",
    "c420_q5_n3":
        "69bed197e1f3d35932dec5720567efc81119609d4159989ffee748de3e7b9d0c",
    "c420_q6_n3":
        "6952201bfcfa2ae0ab5f68f4fc36d411f0eda211634234942870da53e08b8bb6",
    "c444_q6_n3":
        "aec38921eccd6981ef35ec2a8c7018c9396e993ded45293531c24c2713189c82",
    "c422_q6_n3":
        "5fd8fd9fb0a78634acc1032ea6c8a311c62a17bd05558c63d3ccaa8a66d649ef",
    "c411_q6_n2":
        "eecc1712aa17d4a10436c59d2799fff73eb2885776c5437a50320611ec268634",
    "bad_second_comp_q6_n3":
        "dc8984e00c37d96c2c9dbf2d0af6e388c526edc7aaa21f98e262cbf4aff176bb",
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
    _, h, w, color, seed, *sampling = spec
    return synth.make_image(h, w, color=color, seed=seed, quality=75,
                            sampling=sampling[0] if sampling else (2, 2))


def golden_opts(case):
    return QsOptions.from_quality(case[2], case[3])


def digest(coefs, stop, upsampled=None) -> str:
    """SHA-256 over the int16 output planes (little-endian, in order),
    then the upsampled planes when there are any, then the stop flag."""
    h = hashlib.sha256()
    for c in list(coefs) + list(upsampled or ()):
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


def to_dev(a):
    import torch
    return torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)


def plain_idct_pix(coef):
    B = coef.shape[1]
    return dct.idct_islow(coef.reshape(8, 8, B)).reshape(64, B)


def plain_solve_rebalance_pix(coef, pix, div, x1, qshr, flags, do_rebalance,
                              hb, wb, want_pix=True):
    tab = cuda_solver.solver_tables(flags, coef.device)
    return planar.solve_rebalance_pix(coef, pix, div, x1, qshr, tab,
                                      do_rebalance, hb, wb, want_pix)


def plain_solve_fused_pix(coef, pix, image2, div, x1, qshr, flags,
                          do_rebalance, hb, wb, want_pix=True):
    tab = (None if flags & LOW_QUALITY
           else cuda_solver.solver_tables(flags, coef.device))
    return planar.solve_fused_pix(coef, pix, image2, div, x1, qshr, tab,
                                  flags, do_rebalance, hb, wb, want_pix)


KERNELS = ("idct_pix", "solve_rebalance_pix", "solve_fused_pix")
PLAIN = {"idct_pix": plain_idct_pix,
         "solve_rebalance_pix": plain_solve_rebalance_pix,
         "solve_fused_pix": plain_solve_fused_pix}


class plain_kernels:
    """Swap the kernel wrappers for their plain PyTorch versions, so the
    engine runs the plain path on CUDA tensors (the comparison run)."""

    def __enter__(self):
        self.saved = {k: getattr(cuda_solver, k) for k in KERNELS}
        for k in KERNELS:
            setattr(cuda_solver, k, PLAIN[k])
        return self

    def __exit__(self, *exc):
        for k, fn in self.saved.items():
            setattr(cuda_solver, k, fn)


def max_abs_err(a, b) -> int:
    return int((a.long() - b.long()).abs().max().item()) if a.numel() else 0


def bound(nbytes, ops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate
    and fp32 operations over the non-FMA fp32 rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_OPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def sweep_terms(flags) -> int:
    """Terms of non-zero table weight over the 63 sweep steps (k = 63..1)
    per block and pass: a zero-weight term cannot change the folds."""
    import torch
    return int(torch.count_nonzero(cuda_solver.solver_tables(flags,
                                                             "cpu")[1:]))


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
    out = cuda_solver.canary_muladd(to_dev(a), to_dev(b),
                                    to_dev(c)).cpu().numpy()
    bad = int(np.count_nonzero(out))
    assert bad == 0, f"muladd canary: {bad}/{n} lanes nonzero: mul+add " \
                     f"contracted into FMA"
    terms = rng.uniform(-1e3, 1e3, (242, n)).astype(np.float32)
    want = np.zeros(n, np.float32)
    for j in range(242):             # numpy float32 left fold
        want = want + terms[j]
    got = cuda_solver.canary_fold(to_dev(terms)).cpu().numpy()
    bad = int(np.count_nonzero(got.view(np.int32) != want.view(np.int32)))
    assert bad == 0, f"fold canary: {bad}/{n} lanes differ"
    num = rng.uniform(-1e6, 1e6, n).astype(np.float32)
    den = rng.uniform(0.1, 1e4, n).astype(np.float32)
    den[:64] = 0.0                   # +-inf and NaN (0/0) lanes
    num[:8] = 0.0
    with np.errstate(divide="ignore", invalid="ignore"):
        want = num / den
    got = cuda_solver.canary_divide(to_dev(num), to_dev(den)).cpu().numpy()
    # NaN payloads differ between x86 and the card; the solver only
    # tests NaN-ness (the C cast maps every NaN to INT32_MIN)
    nan = np.isnan(want)
    bad = int(np.count_nonzero(nan != np.isnan(got))) + int(np.count_nonzero(
        got[~nan].view(np.int32) != want[~nan].view(np.int32)))
    assert bad == 0, f"divide canary: {bad}/{n} lanes differ from IEEE"
    log(f"canaries: muladd, fold(242), divide: {n} lanes each, all exact")


def _random_case(rng, B, random_pix):
    qtbl = rng.integers(1, 120, 64).astype(np.uint16)
    tabs = [to_dev(t) for t in make_quant_tables(qtbl)]
    coef = to_dev(np.clip(rng.integers(-40, 41, (64, B))
                          * qtbl.astype(np.int32)[:, None], -32768,
                          32767).astype(np.int32))
    if random_pix:
        pix = to_dev(rng.integers(0, 256, (64, B)).astype(np.int32))
    else:
        pix = plain_idct_pix(coef)
    return coef, pix, tabs


def check_pair(torch, coef, pix, tabs, flags, reb, hb, wb, want_pix=True):
    """B1 and B2 vs their plain versions on one input; returns the
    max |err| of each."""
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


def check_fused(torch, coef, pix, image2, tabs, flags, reb, hb, wb, n=1,
                want_pix=True):
    """B3 (image2 given) or B4 vs the plain version on one input of n
    hb x wb images back to back (the plain version runs each image on
    its own); returns the max |err|."""
    got = cuda_solver.solve_fused_pix(coef, pix, image2, *tabs, flags, reb,
                                      hb, wb, want_pix)
    B = hb * wb
    parts = [plain_solve_fused_pix(
        coef[:, k * B:(k + 1) * B].contiguous(),
        pix[:, k * B:(k + 1) * B].contiguous(),
        None if image2 is None else image2[:, k * B:(k + 1) * B].contiguous(),
        *tabs, flags, reb, hb, wb, want_pix) for k in range(n)]
    torch.cuda.synchronize()
    err = max_abs_err(got[0], torch.cat([p[0] for p in parts], 1))
    if want_pix:
        err = max(err, max_abs_err(got[1], torch.cat([p[1] for p in parts],
                                                     1)))
    name = "B3 (joint)" if image2 is not None else "B4 (lq)"
    assert err == 0, (f"{name} differs from plain at hb={hb} wb={wb} n={n} "
                      f"flags={flags} reb={reb} want_pix={want_pix} "
                      f"(max |err| {err})")
    return err


def phase_kernels_vs_plain(torch, stats):
    rng = np.random.default_rng(7)
    n = 0
    for hb, wb in ((1, 13), (9, 1), (1, 1), (9, 13), (40, 57)):
        for flags in (0, DIAGONALS):
            for reb in (True, False):
                for random_pix in (False, True):
                    coef, pix, tabs = _random_case(rng, hb * wb, random_pix)
                    e1, e2 = check_pair(torch, coef, pix, tabs, flags, reb,
                                        hb, wb, want_pix=random_pix)
                    stats["idct_pix"]["max_abs_err"] = max(
                        stats["idct_pix"]["max_abs_err"], e1)
                    stats["solve_rebalance_pix"]["max_abs_err"] = max(
                        stats["solve_rebalance_pix"]["max_abs_err"], e2)
                    n += 1
    log(f"B1/B2 vs plain: {n} small cases bit-identical "
        f"(hb,wb in 1x13, 9x1, 1x1, 9x13, 40x57; flags 0/DIAGONALS; "
        f"rebalance on/off)")
    n = 0
    for flags, joint in FUSED_FLAG_SETS:
        for hb, wb, nimg in ((1, 13, 1), (9, 1, 1), (1, 1, 1), (9, 13, 1),
                             (5, 7, 2)):
            for reb in (True, False):
                for want_pix in (True, False):
                    B = hb * wb * nimg
                    coef, pix, tabs = _random_case(rng, B, want_pix)
                    image2 = (to_dev(rng.integers(0, 256, (100, B)).astype(
                        np.int32)) if joint else None)
                    err = check_fused(torch, coef, pix, image2, tabs, flags,
                                      reb, hb, wb, nimg, want_pix)
                    key = ("solve_fused_pix_joint" if joint
                           else "solve_fused_pix_lq")
                    stats[key]["max_abs_err"] = max(
                        stats[key]["max_abs_err"], err)
                    n += 1
    log(f"B3/B4 vs plain: {n} small cases bit-identical (flags "
        f"{', '.join(FLAG_NAMES[f] for f, _ in FUSED_FLAG_SETS)}; hb,wb in "
        f"1x13, 9x1, 1x1, 9x13 and two 5x7 images back to back; rebalance "
        f"on/off; pixels emitted or not)")


def phase_golden(torch):
    for case in GOLDEN_CASES:
        res = engine.smooth(golden_image(case), golden_opts(case), DEVICE)
        got = digest(res.coefs, res.stop, res.upsampled)
        assert got == GOLDEN[case[0]], (
            f"golden {case[0]}: {got} != {GOLDEN[case[0]]}")
    log(f"golden digests of the JAX package reproduced on the card: "
        f"{len(GOLDEN_CASES)} cases")


def _plane_inputs(img, ci):
    """Component ci's first-pass kernel inputs (dequantized, int16-
    wrapped coefficients, their IDCT, the quant tables), as the engine
    makes them."""
    comp = img.components[ci]
    hb, wb = comp.height_in_blocks, comp.width_in_blocks
    qraw = np.asarray(comp.quantval, np.int32)
    prod = (np.ascontiguousarray(comp.coefs).reshape(hb * wb, 64).T.astype(
        np.int32) * qraw[:, None])
    coef = engine.int16_wrap(to_dev(prod))
    tabs = [to_dev(t) for t in make_quant_tables(qraw)]
    return coef, plain_idct_pix(coef), tabs, hb, wb


def phase_full_plane(torch, img, stats, card):
    """Every kernel vs plain on the main path's largest planes of the
    12 MP photo -- B1, B2 and B4 on its 375x500 luma plane, B3 on its
    188x250 chroma plane, image2 from the luma -- and the per-kernel
    numbers of the JSON line."""
    coef, pix, tabs, hb, wb = _plane_inputs(img, 0)
    B = hb * wb
    for flags in (0, DIAGONALS):
        e1, e2 = check_pair(torch, coef, pix, tabs, flags, True, hb, wb)
    stats["solve_fused_pix_lq"]["max_abs_err"] = max(
        stats["solve_fused_pix_lq"]["max_abs_err"],
        check_fused(torch, coef, pix, None, tabs, Q_FLAGS[0], True, hb, wb))
    ccoef, cpix, ctabs, hbc, wbc = _plane_inputs(img, 1)
    Bc = hbc * wbc
    image2 = planar.blocks_halo10(planar.downsample_blocks(
        pix.reshape(8, 8, B), hb, wb, hbc, wbc, 2, 2), hbc, wbc).reshape(
        100, Bc)
    for flags in (Q_FLAGS[6], Q_FLAGS[5], Q_FLAGS[2]):
        err = check_fused(torch, ccoef, cpix, image2, ctabs, flags, True,
                          hbc, wbc)
        stats["solve_fused_pix_joint"]["max_abs_err"] = max(
            stats["solve_fused_pix_joint"]["max_abs_err"], err)
    log(f"kernels vs plain: full {hb}x{wb} luma plane (B1; B2 at flags 0 "
        f"and DIAGONALS; B4 at q0) and {hbc}x{wbc} chroma plane (B3 at q6, "
        f"q5 and q2 flags) bit-identical")

    def timed(name, fn, plain, nbytes, ops, what, plain_reps=3):
        row = {"ms": cuda_ms(fn), "plain_ms": cuda_ms(plain, plain_reps)}
        row["bound_ms"], row["bound_by"] = bound(nbytes, ops)
        log(f"{name} {what}: kernel {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}) [{card}]")
        return row

    # bytes: each input read once, each output written once (coefficient
    # and pixel planes int32[64, B], image2 int32[100, B], tables once)
    blk = 64 * 4
    stats["idct_pix"].update(timed(
        "B1 idct_pix", lambda: cuda_solver.idct_pix(coef),
        lambda: plain_idct_pix(coef), B * blk * 2, 0,
        f"on {B} blocks"))
    args = (coef, pix, *tabs, 0, True, hb, wb)
    stats["solve_rebalance_pix"].update(timed(
        "B2 solve_rebalance_pix",
        lambda: cuda_solver.solve_rebalance_pix(*args),
        lambda: plain_solve_rebalance_pix(*args),
        B * blk * 4 + 64 * 144 * 4,
        B * sweep_terms(0) * FP32_OPS_PER_TERM,
        f"on {B} blocks (q3 pass, NT 144)"))
    args242 = (coef, pix, *tabs, DIAGONALS, True, hb, wb)
    timed("B2 solve_rebalance_pix", lambda: cuda_solver.solve_rebalance_pix(
        *args242), lambda: plain_solve_rebalance_pix(*args242),
        B * blk * 4 + 64 * 242 * 4,
        B * sweep_terms(DIAGONALS) * FP32_OPS_PER_TERM,
        f"on {B} blocks (q4-q6 luma pass, NT 242)", plain_reps=1)
    lq = (coef, pix, None, *tabs, Q_FLAGS[0], True, hb, wb)
    stats["solve_fused_pix_lq"].update(timed(
        "B4 solve_fused_pix (lq)", lambda: cuda_solver.solve_fused_pix(*lq),
        lambda: plain_solve_fused_pix(*lq), B * blk * 4,
        B * LQ_PREAMBLE_OPS, f"on {B} blocks (q0 pass)"))
    j6 = (ccoef, cpix, image2, *ctabs, Q_FLAGS[6], True, hbc, wbc)
    stats["solve_fused_pix_joint"].update(timed(
        "B3 solve_fused_pix (joint)",
        lambda: cuda_solver.solve_fused_pix(*j6),
        lambda: plain_solve_fused_pix(*j6),
        Bc * (blk * 4 + 100 * 4) + 64 * 242 * 4,
        Bc * (JOINT_PREAMBLE_OPS
              + sweep_terms(DIAGONALS) * FP32_OPS_PER_TERM),
        f"on {Bc} blocks (q6 chroma pass, sweep NT 242)"))
    j2 = (ccoef, cpix, image2, *ctabs, Q_FLAGS[2], True, hbc, wbc)
    timed("B3 solve_fused_pix (joint)",
          lambda: cuda_solver.solve_fused_pix(*j2),
          lambda: plain_solve_fused_pix(*j2), Bc * (blk * 4 + 100 * 4),
          Bc * JOINT_PREAMBLE_OPS, f"on {Bc} blocks (q2 chroma pass, no "
          f"sweep)")
    log(f"  bounds count {sweep_terms(0)} / {sweep_terms(DIAGONALS)} "
        f"non-zero-weight sweep terms per block and pass (NT 144 / 242) x "
        f"{FP32_OPS_PER_TERM} fp32 ops, {JOINT_PREAMBLE_OPS} fp32 ops of "
        f"JOINT preamble + FDCT, {LQ_PREAMBLE_OPS} of LQ preamble + FDCT")


def _check_planes(img, res, opts):
    assert res.stop == 0, "unexpected stop on a clean image"
    for comp, out in zip(img.components, res.coefs):
        shape = (comp.height_in_blocks, comp.width_in_blocks, 64)
        assert out.shape == shape and out.dtype == np.int16, out.shape
        assert np.abs(out.astype(np.int32)).max() <= 1023
    upsample = (opts.flags & UPSAMPLE_UV and img.is_ycbcr
                and img.components[0].h_samp_factor
                * img.components[0].v_samp_factor > 1)
    assert (res.upsampled is not None) == bool(upsample)
    if res.upsampled is not None:
        luma = img.components[0]
        for up in res.upsampled:
            assert up.shape == (luma.height_in_blocks, luma.width_in_blocks,
                                64) and up.dtype == np.int16
            assert np.abs(up.astype(np.int32)).max() <= 1024


def _same(a, b):
    if a.upsampled is None or b.upsampled is None:
        ups = a.upsampled is b.upsampled
    else:
        ups = all(np.array_equal(x, y)
                  for x, y in zip(a.upsampled, b.upsampled))
    return ups and a.stop == b.stop and all(
        np.array_equal(x, y) for x, y in zip(a.coefs, b.coefs))


def phase_main(torch, runs, card):
    """The main path through the user entry point: per run, the launch
    counts (reset just before the run, read just after), bit-identity
    with the plain path on the card (upsampled planes included), and
    times.  Returns the summed launch counts and one summary line per
    run."""
    total = dict.fromkeys(cuda_solver.LAUNCHES, 0)
    summaries = []
    for name, img, quality, niter, want in runs:
        opts = QsOptions.from_quality(quality, niter)
        cuda_solver.reset_launches()
        res = jpegqs_tpu_torch.smooth(img, opts)
        torch.cuda.synchronize()
        counts = dict(cuda_solver.LAUNCHES)
        expect = dict.fromkeys(counts, 0)
        expect.update(want)
        assert counts == expect, f"{name}: launches {counts} != {expect}"
        for k, v in counts.items():
            total[k] += v
        _check_planes(img, res, opts)
        with plain_kernels():
            plain = engine.smooth(img, opts)
        assert _same(res, plain), f"{name}: kernel path != plain path"
        changed = sum(int(np.count_nonzero(
            a != (c.coefs.astype(np.int32) * c.quantval.astype(np.int32)
                  ).astype(np.int16)))
            for a, c in zip(res.coefs, img.components))
        plan = engine.plan_image(img, opts)
        inputs = engine.upload(img, plan.comps, engine.resolve_device())
        run = lambda: engine.run_image(plan, inputs)
        dev_ms = cuda_ms(run)
        with plain_kernels():
            plain_ms = cuda_ms(run, 3)
        e2e_ms = host_ms(lambda: jpegqs_tpu_torch.smooth(img, opts))
        up_ms = host_ms(lambda: (engine.upload(img, plan.comps,
                                               inputs[0][0].device),
                                 torch.cuda.synchronize()))
        outs, _, ups = run()
        down_ms = host_ms(lambda: [o.cpu().numpy()
                                   for o in outs + list(ups.values())])
        mp = img.width * img.height / 1e6
        tag = f"q{quality} n{niter}"
        log(f"{name}: {img.width}x{img.height} ({mp:.2f} MP), {tag}, "
            f"{len(img.components)} comps, {changed} coefs moved off the "
            f"lattice, upsampled planes: {res.upsampled is not None}; "
            f"launches {counts}; bit-identical to the plain path on the card")
        log(f"  device {dev_ms:.3f} ms ({mp / dev_ms * 1e3:.1f} MP/s), "
            f"end-to-end smooth() {e2e_ms:.3f} ms "
            f"({mp / e2e_ms * 1e3:.1f} MP/s), plain device "
            f"{plain_ms:.3f} ms [{card}]")
        rest_ms = e2e_ms - up_ms - dev_ms - down_ms
        log(f"  host: upload {up_ms:.3f} ms, download {down_ms:.3f} ms, "
            f"rest of smooth() {rest_ms:.3f} ms")
        busy, n_launch, by_kernel = device_breakdown(torch, run, dev_ms,
                                                     card)
        split = ", ".join(f"{k} {v:.3f} ms" for k, v in by_kernel.items()
                          if v > 0)
        summaries.append(
            f"summary {name} {tag}: device {dev_ms:.3f} ms, smooth() "
            f"{e2e_ms:.3f} ms = upload {up_ms:.3f} + device + download "
            f"{down_ms:.3f} + rest {rest_ms:.3f}; card busy "
            f"{100 * busy / dev_ms:.1f}%, {n_launch} kernels, {split}, glue "
            f"{busy - sum(by_kernel.values()):.3f} ms [{card}]")
    log(f"main path launches (all runs): {total}")
    return total, summaries


def device_breakdown(torch, run, dev_ms, card):
    """Kernel time by name over one device run (torch.profiler), and the
    share of the CUDA-event time the card was busy.  Returns the busy ms,
    the kernel launches and the ms of each of B1-B4."""
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
        f" kernel launches [{card}]; top:")
    for t, n, k in rows[:6]:
        log(f"    {t:.3f} ms x{n} {k[:90]}")
    by_kernel = {
        name: sum(r[0] for r in rows if marker in r[2])
        for name, marker in (("B1", "idct_pix_kernel"),
                             ("B2", "solve_rebalance_pix_kernel"),
                             ("B3", "solve_fused_pix_kernel<0"),
                             ("B4", "solve_fused_pix_kernel<1"))}
    return busy, sum(r[1] for r in rows), by_kernel


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
    data = jpegio.encode_pixels(synth.synth_image(*GRAY_HW, seed=0),
                                quality=75)
    opts = QsOptions.from_quality(3, 3)
    out = jpegqs_tpu_torch.smooth_jpeg_bytes(data, opts)
    with plain_kernels():
        plain = jpegqs_tpu_torch.smooth_jpeg_bytes(data, opts)
    assert out == plain, "smooth_jpeg_bytes: kernel path != plain path"
    assert all(np.all(c.quantval == 1)
               for c in jpegio.read_coefficients(out).components)
    ms = host_ms(lambda: jpegqs_tpu_torch.smooth_jpeg_bytes(data, opts), 3)
    log(f"transcode (smooth_jpeg_bytes) {GRAY_HW[1]}x{GRAY_HW[0]} gray: "
        f"{len(data)} -> {len(out)} bytes, {ms:.3f} ms, bit-identical to "
        f"the plain path [{card}]")


REPLACES = {
    "idct_pix": "jpegqs_tpu/ops/pallas_solver.py:883",
    "solve_rebalance_pix": "jpegqs_tpu/ops/pallas_solver.py:902",
    "solve_fused_pix_joint": "jpegqs_tpu/ops/pallas_solver.py:919",
    "solve_fused_pix_lq": "jpegqs_tpu/ops/pallas_solver.py:919",
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    t_start = time.perf_counter()

    def stamp(what):
        log(f"[{time.perf_counter() - t_start:.1f} s] {what} done")

    phase_card(torch)
    card = nvidia_smi()
    stats = {name: {"max_abs_err": 0} for name in cuda_solver.LAUNCHES}
    phase_build()
    phase_canaries(torch)
    stamp("build, canaries")
    phase_kernels_vs_plain(torch, stats)
    stamp("small kernel-vs-plain cases")
    phase_golden(torch)
    stamp("golden digests")
    t0 = time.perf_counter()
    color = synth.make_image(*COLOR_HW, color=True, seed=0)
    gray = synth.make_image(*GRAY_HW, color=False, seed=0)
    log(f"inputs: synthetic {COLOR_HW[1]}x{COLOR_HW[0]} 4:2:0 and "
        f"{GRAY_HW[1]}x{GRAY_HW[0]} gray, IJG q75, "
        f"{time.perf_counter() - t0:.1f} s")
    phase_full_plane(torch, color, stats, card)
    stamp("full planes")
    # the q3 runs of the first slice at depth 1, to keep the whole script
    # near its first run time as paths are added
    launches, summaries = phase_main(torch, (
        ("color_12mp", color, 3, 1, {"idct_pix": 3,
                                     "solve_rebalance_pix": 3}),
        ("gray_2mp", gray, 3, 1, {"idct_pix": 1, "solve_rebalance_pix": 1}),
        ("color_12mp", color, 6, 3, {"idct_pix": 3, "solve_rebalance_pix": 3,
                                     "solve_fused_pix_joint": 6}),
        ("color_12mp", color, 2, 3, {"idct_pix": 3, "solve_fused_pix_lq": 3,
                                     "solve_fused_pix_joint": 6}),
        ("gray_2mp", gray, 0, 3, {"idct_pix": 1, "solve_fused_pix_lq": 3}),
    ), card)
    stamp("main path")
    phase_transcode(torch, card)
    for line in summaries:
        log(line)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": "jpegqs_tpu_torch/csrc/solver.cu",
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": stats[name]["max_abs_err"],
         "ms": stats[name]["ms"], "plain_ms": stats[name]["plain_ms"],
         "bound_ms": stats[name]["bound_ms"],
         "bound_by": stats[name]["bound_by"], "library_ms": None}
        for name in cuda_solver.LAUNCHES]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
