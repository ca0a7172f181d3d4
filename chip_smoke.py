#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (jpegqs_tpu_torch) on one NVIDIA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from csrc/ and, failing loudly (non-zero exit)
on any mismatch:

1. prints the card (nvidia-smi name, power limit) and the versions;
2. builds the kernels and prints the build time and the ptxas report of
   every kernel instantiation (registers, spills, static shared memory),
   the solver passes' (B2-B7) marked with the CTAs of 128 threads an SM
   holds;
3. runs the arithmetic canaries: no mul+add contraction, an exact fp32
   left fold, IEEE division;
4. T3, the fp32 peak probe: bit-identical to its plain version on a small
   launch, then the rate of separate fp32 operations the card sustains at
   1, 4 and 16 chains per thread, beside the data-sheet rate;
5. holds every kernel bit for bit against its plain PyTorch version on the
   card (the upsample_fdct kernel on random small geometries with and
   without its replicate tails, and on one chroma component of 16 12 MP
   photos back to back, the benchmark cell's batch, timed beside its byte
   bound and its plain version): B1/B2 at flags 0 and DIAGONALS, B3 (JOINT_YUV preamble) with the
   sweep at NT 242 and 144 and without it, B4 (LOW_QUALITY preamble);
   rebalance on and off, pixels emitted or not, edge shapes (hb=1, wb=1,
   1x1, a 37x53 grid of partial CTAs), two images back to back, and for
   B4 CTA tiles that cross image rows and images (n = 2 and 3); B5/B6
   (the same passes on given border lines / halos; B5 on each of its two
   bodies) at B = 1, 13, 37, 117 and on row-chunk and block-slice views
   of a 9x13 plane (n no multiple of B6-lq's 16-block tile); and the main
   path's full-size planes, B3 and B7-joint also on a chroma plane of
   4:4:4 size (187,500 blocks; the joint passes of B6 and B7 take B3's
   design above two CTAs an SM, a one-thread body below), B4 also on the
   2.1 MP gray plane (32,400 blocks), B5 also on row chunks of the luma
   plane on each side of the size at which it changes body;
6. reproduces the golden SHA-256 digests of the JAX package's output
   planes, upsampled planes and stop flag (GOLDEN below;
   tests/test_torch_isolation.py recomputes them with jpegqs_tpu.engine)
   with the kernels, q0-q6, gray and 4:4:4 / 4:2:2 / 4:2:0 / 4:1:1, on
   the fused path and on the progress path (a counting callback, with
   and without PRECISE_PROGRESS row chunks);
7. drives the main path, ``jpegqs_tpu_torch.smooth``, on a 12 MP 4:2:0
   colour photo at q3 n1, q6 n3 and q2 n3 and on the 2.1 MP gray frame of
   bench.py at q3 n1 and q0 n3: launch counts per run, bit-identity with
   the plain path on the card, device and end-to-end times, MP/s;
8. drives the batch engine, ``jpegqs_tpu_torch.smooth_image_batch`` /
   ``smooth_plane_batch``, on distinct synthetic images (seeds 0..N-1):
   8 of the 12 MP photos at q6 n3 and q2 n3, 16 of the 2.1 MP frames at
   q3 n3 and as planes at q0 n3, and 5 frames at q3 n3 of which one trips
   the dequantization guard: launch counts worked out from the plan (one
   image's, for any N), bit-identity with per-image smooth() on the card
   and, on small batches of each kind, with the plain path; device and
   end-to-end times and MP/s beside N sequential smooth() calls, the
   card's busy share; and that a batch's dispatch waits for nothing;
9. the decode path (``engine._decode_native``): the golden SHA-256
   digests of jpegqs_tpu's decoded pixels (DECODE_GOLDEN) on the card,
   then the 12 MP photo at q3 n1 and q6 n3 and the 2.1 MP frame at q3
   n3, one B1 per component, pixels bit-identical to the CPU path, times;
10. drives the progress path on the 12 MP photo: q6 n3 per iteration and
   with row chunks (progprec 20), q2 n3 per iteration, and a cancel at
   the third callback: the (cur, max) trace and the launch counts worked
   out from the image, the planes against the plain path on the card and
   the fused run, times;
11. the sharded path, with its shards on this one card: B7 bit for bit
   against its plain version on every shard of small random planes (2-4
   shards, dead pad rows, every edge position, split ranges, ranges that
   start and end inside a 16-block tile, a single block, rows 1 and 37
   blocks wide) and on the
   last of 4 shards of the 12 MP planes at each variant, with its time
   there; the auto-sharded engine (``engine._try_smooth_sharded``) on a
   4032x3024 4:2:0 frame at q6 n3 over 2 and 4 shards with JPEGQS_OVERLAP
   off and on, the 12 MP photo at q3 n3 over 3 and the 2.1 MP frame at q0
   n3 over 4: launch counts worked out from the image, bit-identity with
   the single-device run, times beside the single-device ones, the ghost
   exchange's time; and the golden digests through the sharded path;
12. the 2-D row x column grid on shards of this card: B7 with column
   edges bit for bit against its plain version on every shard of small
   random planes on 2-D grids (right and bottom edges mid-shard, ghosts and
   dead blocks random) and on a shard of the 65520x32 4:2:0 strip, with
   its time; the strip at q6 n3 and q2 n3 and the 65520x16 gray strip at
   q3 n3 through ``engine._try_smooth_sharded`` on a 2 x 2 grid of 4
   shards: launch counts, bit-identity with the single-device run, times;
13. batch data parallelism: 16 gray frames at q3 n3 through the batch form
   of ``make_sharded_smooth`` on data 2 x row 2, 8 colour photos at q6 n3
   through ``smooth_batch_sharded`` on data 2 x row 1, each against
   ``smooth_image_batch`` on one device, times; ``dryrun_multichip(4)``;
14. the multi-process engine: the launcher's --local 2 (two gloo ranks on
   this card, two shards each) on the 4032x3024 photo and the strip at q6
   n3 and on two gray frames a rank at q3 n3 (smooth_batch_distributed),
   each against the single-process run, with rank 0's launches and the
   host time of its exchanges; NCCL where there are two cards;
15. where the machine has libjpeg's headers, the transcode path,
   smooth_many and the CLI's --batch against smooth_jpeg_bytes;
16. the differential fuzz, tools/fuzz_port.py's card mode: the digests of
   tools/fuzz_port_golden.json (jpegqs_tpu's output on 48 fixed cases),
   then random synthetic cases for FUZZ_SECONDS, each through the fused,
   progress (with cancels), grid, batch and decode paths on the card, bit
   for bit against the port's CPU run and its single-device run; B1-B7
   each launched.

Its last line is {"ok": true, "device": {...}}; the line before it is
nvidia-smi's name and power limit, and before that one JSON line of
per-kernel numbers (B1-B7, T3, T1/T2), and before that one summary line
per main-path, batch, progress-path, sharded, 2-D grid, batch data
parallel and multi-process run; the fuzz phase's line comes before
those.  Without a CUDA device it
exits 1 and prints no result.
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
from jpegqs_tpu_torch import batch
from jpegqs_tpu_torch.ops import _build, colorout, cuda_solver, dct, planar
from jpegqs_tpu_torch.ops.quant import make_quant_tables
from jpegqs_tpu_torch.parallel import sharded

# H100 SXM peaks (NVIDIA data sheet, at a 700 W limit): 3.35 TB/s of HBM;
# 67 TFLOP/s fp32 counts an FMA as two operations, so separate fp32 adds
# and multiplies (the solver's fold never fuses) issue at half that.
# bound_ms uses these; bound_ms_t3 uses the rate T3 measures on this card.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12 / 2
# T3's launch: 4 waves of full SMs (132 x 2048 threads), each thread
# 2 x 65536 fp32 operations split over its chains
PEAK_THREADS = 4 * 132 * 2048
PEAK_CHAIN_STEPS = 65536
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
# the upsample_fdct kernel per luma block, counted from csrc/solver.cu: 8
# a pixel (luma conversion, mul, add, trunc, max, min, conversion back,
# the centred value's conversion), 10 a chroma pixel's regression (4
# int->float conversions, the divide, 2 clamps, mul, sub, add; hs x ws
# luma pixels share it) and the FDCT's 16 butterflies of 44 ops, 64
# x0.125 scalings and 64 roundf
def upsample_fdct_ops(hs, ws):
    return 64 * 8 + 64 // (hs * ws) * 10 + FDCT_CLAMP_OPS


# the upsample's batch at the benchmark cell's shape: 16 of the 12 MP
# photos back to back, one chroma component
UPSAMPLE_BATCH = 16

DEVICE = "cuda"
# the main path's images: a 12 MP phone-camera frame (4:2:0) and the
# 2.1 MP frame of bench.py (gray), (height, width)
COLOR_HW = (3000, 4000)
GRAY_HW = (1080, 1920)
# the 12 MP frame of a phone camera whose 4:2:0 planes are aligned (378
# luma block rows = 2 x 189 chroma), which the YCbCr flow shards
ALIGNED_HW = (3024, 4032)

Q_FLAGS = {q: quality_to_flags(q) for q in range(7)}
# (flags, JOINT_YUV preamble) of the B3/B4 checks: B3 with the sweep at
# NT 242 (q6 chroma) and NT 144, B3 without it (q1/q2 chroma), B4 (q0)
FUSED_FLAG_SETS = ((JOINT_YUV | DIAGONALS, True), (JOINT_YUV, True),
                   (JOINT_YUV | LOW_QUALITY | DIAGONALS, True),
                   (LOW_QUALITY | DIAGONALS, False))
# B4's extra shapes (hb, wb, n images back to back): block counts that are
# no multiple of its 16-block CTA tile, tiles that cross image rows and
# image boundaries
LQ_TILE_SHAPES = ((3, 7, 3), (1, 17, 2), (5, 6, 3), (2, 9, 3))
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


# SHA-256 of jpegqs_tpu.engine._decode_native's pixels (pixel_digest) of
# three golden cases' smoothed planes: gray, 4:2:0 and 4:2:0 with the
# upsampled planes
DECODE_GOLDEN = {
    "gray_q3_n3":
        "08a1f01d7fec89959796ae1aa71007e712b884562d74b2146299bf130f4b1eb0",
    "c420_q3_n3":
        "5f0dfbabfefbe5de6fb8f4415759440407939fbbad5e4713b6d733256d937a46",
    "c420_q6_n3":
        "ae1a1464e9f65ef46fd44f0c084a7d0a1fdc87709af1dfd74180ea7d2ec42c41",
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


def pixel_digest(pixels) -> str:
    """SHA-256 over the shape (as text) and the uint8 pixels in C order."""
    h = hashlib.sha256(str(tuple(pixels.shape)).encode())
    h.update(np.ascontiguousarray(pixels, dtype=np.uint8).tobytes())
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


KERNEL_MS_WINDOWS = 6


def kernel_ms(fn, reps=5):
    """Device time of one launch of the one kernel fn() launches:
    torch.profiler over ``reps`` warm runs, the kernel's time summed over
    the launches the profiler recorded, divided by their count (it may
    record fewer than ran, or none: then the window is tried again, up to
    KERNEL_MS_WINDOWS times, and after that the time is None, "not
    measured": three empty device-only windows in a row have been seen,
    on a 2-D shard's B7 launches).  Device activity only: late in a run a
    window that also traces the host has recorded the host's calls and
    none of the kernels, window after window, where a device-only window
    records them.  Kernel time only: an event pair around one launch also
    counts the gap while the host wrapper enqueues it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(KERNEL_MS_WINDOWS):  # a window may record nothing
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total]
        launches = sum(e.count for e in rows)
        if launches:
            return (sum(e.self_device_time_total for e in rows) / 1e3
                    / launches)
    log(f"kernel_ms: the profiler recorded no kernel in "
        f"{KERNEL_MS_WINDOWS} windows: not measured")
    return None


def ms_text(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


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


def plain_solve_rebalance(coef, borders, div, x1, qshr, flags, do_rebalance,
                          want_pix=False):
    tab = cuda_solver.solver_tables(flags, coef.device)
    return planar.solve_rebalance(coef, borders, div, x1, qshr, tab,
                                  do_rebalance, want_pix)


def plain_solve_fused(coef, halo, image2, div, x1, qshr, flags, do_rebalance,
                      want_pix=False):
    tab = (None if flags & LOW_QUALITY
           else cuda_solver.solver_tables(flags, coef.device))
    return planar.solve_fused(coef, halo, image2, div, x1, qshr, tab, flags,
                              do_rebalance, want_pix)


def plain_solve_range_pix(coef, pix, image2, div, x1, qshr, flags,
                          do_rebalance, wb, b0, b1, edges, coef_out,
                          pix_out=None):
    cuda_solver.check_range(coef.shape[1], wb, b0, b1, edges)
    tab = (None if flags & LOW_QUALITY
           else cuda_solver.solver_tables(flags, coef.device))
    planar.solve_range_pix(coef, pix, image2, div, x1, qshr, tab, flags,
                           do_rebalance, wb, b0, b1, edges, coef_out, pix_out)


KERNELS = ("idct_pix", "solve_rebalance_pix", "solve_fused_pix",
           "solve_rebalance", "solve_fused", "solve_range_pix",
           "upsample_fdct_blocks")
PLAIN = {"idct_pix": plain_idct_pix,
         "solve_rebalance_pix": plain_solve_rebalance_pix,
         "solve_fused_pix": plain_solve_fused_pix,
         "solve_rebalance": plain_solve_rebalance,
         "solve_fused": plain_solve_fused,
         "solve_range_pix": plain_solve_range_pix,
         "upsample_fdct_blocks": planar.upsample_fdct_blocks}


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


def bound(nbytes, ops, fp32_rate=PEAK_FP32_OPS_PER_S):
    """(bound_ms, bound_by): the larger of bytes over the memory rate
    and fp32 operations over the non-FMA fp32 rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / fp32_rate * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bound_row(nbytes, ops, t3_rate):
    """The bound at the data-sheet rates and, as bound_ms_t3, with the
    fp32 rate T3 measured on this card in place of the data sheet's."""
    row = dict(zip(("bound_ms", "bound_by"), bound(nbytes, ops)))
    row["bound_ms_t3"] = bound(nbytes, ops, t3_rate)[0]
    return row


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


# the joint kernels' dynamic shared memory per CTA (kJointSmem in
# csrc/solver.cu); ptxas reports static shared memory only
JOINT_SMEM = 100 * 128 * 4

# Each pass's instantiations, marked in the ptxas report with the CTAs of
# 128 threads an SM holds: B2's body (B2 and B7's B2 form <NT,0>, B5
# <NT,1>) and the joint ones (B3, B6-joint <NT,1>, B7-joint <NT,0>) aim at
# 4, the LOW_QUALITY ones (B4 and B7-lq <0>, B6-lq <1>; static shared
# memory) at 8; B5's lane body (static shared memory) is marked too
OCCUPANCY_MARKED = {
    "solve_lq_kernel<0>": ("B4/B7-lq", 0),
    "solve_lq_kernel<1>": ("B6-lq", 0),
    **{f"solve_borders_kernel<{nt},0>": ("B2/B7", 0) for nt in (144, 242)},
    **{f"solve_borders_kernel<{nt},1>": ("B5", 0) for nt in (144, 242)},
    **{f"solve_borders_lanes_kernel<{nt}>": ("B5 lanes", 0)
       for nt in (144, 242)},
    **{f"solve_joint_kernel<{nt},0>": ("B3/B7-joint", JOINT_SMEM)
       for nt in (0, 144, 242)},
    **{f"solve_joint_kernel<{nt},1>": ("B6-joint", JOINT_SMEM)
       for nt in (0, 144, 242)}}


def ctas_per_sm(registers, smem, threads=128):
    """CTAs of ``threads`` threads that one H100 SM holds at ``registers``
    a thread and ``smem`` bytes of shared memory a CTA: 65,536 registers,
    allocated per warp in units of 256; 228 KB of shared memory, 1 KB of
    it reserved per CTA; 2,048 threads; 32 CTAs."""
    warp_regs = -(-registers * 32 // 256) * 256
    return min(65536 // (warp_regs * (threads // 32)),
               228 * 1024 // (smem + 1024), 2048 // threads, 32)


def ptxas_lines(report, card):
    """One line per kernel instantiation of a ptxas report
    (``_build.ptxas_report``), the solver passes' first, marked with the
    CTAs an SM holds."""
    lines = []
    for r in sorted(report, key=lambda r: (r["name"] not in OCCUPANCY_MARKED,
                                           r["name"])):
        line = (f"{r['name']}: {r['registers']} registers, spill stores "
                f"{r['spill_stores']} B, spill loads {r['spill_loads']} B, "
                f"static smem {r['smem']} B")
        if r["name"] in OCCUPANCY_MARKED:
            tag, dynamic = OCCUPANCY_MARKED[r["name"]]
            n = ctas_per_sm(r["registers"], r["smem"] + dynamic)
            line = (f">> {tag} {line}, dynamic smem {dynamic} B, {n} CTAs "
                    f"of 128 threads per SM [{card}]")
        lines.append(line)
    return lines


def phase_build(card):
    t0 = time.perf_counter()
    path = _build.build()
    _build.load()
    log(f"build: {time.perf_counter() - t0:.1f} s -> {path}")
    with open(path + ".log") as f:
        for line in ptxas_lines(_build.ptxas_report(f.read()), card):
            log(f"  ptxas: {line}")


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
    # T1/T2's times on the lanes of the check, beside their plain versions
    # (separate torch ops on the card); their bounds come with T3's rate
    dev = [to_dev(x) for x in (a, b, c, terms)]

    def fold_plain():
        acc = torch.zeros_like(dev[3][0])
        for j in range(242):
            acc = acc + dev[3][j]
        return acc

    return {"canary_muladd": {
                "ms": cuda_ms(lambda: cuda_solver.canary_muladd(*dev[:3])),
                "plain_ms": cuda_ms(lambda: dev[0] * dev[1] + dev[2]),
                "nbytes": 4 * 4 * n, "ops": 2 * n},
            "canary_fold": {
                "ms": cuda_ms(lambda: cuda_solver.canary_fold(dev[3])),
                "plain_ms": cuda_ms(fold_plain), "nbytes": 243 * 4 * n,
                "ops": 242 * n}}


def phase_peak(torch, stats, card):
    """T3 against its plain version on a small launch (bit for bit), then
    the rate of separate fp32 operations at 1, 4 and 16 chains per thread
    over PEAK_THREADS threads; T3's row is the 16-chain launch.  Returns
    the best measured rate (fp32 operations per second)."""
    rng = np.random.default_rng(9)
    small = to_dev(rng.uniform(0.5, 1.5, 4096).astype(np.float32))
    for nch in cuda_solver.PEAK_CHAINS:
        got = cuda_solver.peak_chains(small, nch, 64)
        want = cuda_solver.peak_chains_plain(small, nch, 64)
        bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        assert bad == 0, f"T3 at {nch} chains: {bad} lanes differ from plain"
    stats["peak"]["max_abs_err"] = 0
    x = to_dev(rng.uniform(0.5, 1.5, PEAK_THREADS).astype(np.float32))
    rates, times = {}, {}
    for nch in cuda_solver.PEAK_CHAINS:
        steps = PEAK_CHAIN_STEPS // nch
        times[nch] = cuda_ms(lambda: cuda_solver.peak_chains(x, nch, steps))
        rates[nch] = 2 * PEAK_THREADS * steps * nch / (times[nch] * 1e-3)
        log(f"T3 fp32 peak: {nch:2d} chains x {steps} steps on "
            f"{PEAK_THREADS} threads: {times[nch]:.4f} ms, {rates[nch]:.4e} "
            f"separate fp32 ops/s [{card}]")
    rate = max(rates.values())
    steps = PEAK_CHAIN_STEPS // 16
    stats["peak"].update(ms=times[16], plain_ms=cuda_ms(
        lambda: cuda_solver.peak_chains_plain(x, 16, steps), 1),
        **bound_row(2 * PEAK_THREADS * 4, 2 * PEAK_THREADS * steps * 16,
                    rate),
        variants=[{"what": f"{nch} chains x {PEAK_CHAIN_STEPS // nch} steps "
                           f"on {PEAK_THREADS} threads", "ms": times[nch],
                   "fp32_ops_per_s": rates[nch]}
                  for nch in cuda_solver.PEAK_CHAINS])
    log(f"T3 fp32 peak: {rate:.4e} separate fp32 ops/s measured, "
        f"{PEAK_FP32_OPS_PER_S:.4e} from the data sheet "
        f"({100 * rate / PEAK_FP32_OPS_PER_S:.1f}%) [{card}]")
    return rate


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
                             (5, 7, 2), (37, 53, 1)):
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
        f"1x13, 9x1, 1x1, 9x13, 37x53 and two 5x7 images back to back; "
        f"rebalance on/off; pixels emitted or not)")
    n = 0
    lq_flags = LOW_QUALITY | DIAGONALS
    for hb, wb, nimg in LQ_TILE_SHAPES:
        for reb in (True, False):
            for want_pix in (True, False):
                coef, pix, tabs = _random_case(rng, hb * wb * nimg, want_pix)
                err = check_fused(torch, coef, pix, None, tabs, lq_flags, reb,
                                  hb, wb, nimg, want_pix)
                stats["solve_fused_pix_lq"]["max_abs_err"] = max(
                    stats["solve_fused_pix_lq"]["max_abs_err"], err)
                n += 1
    log(f"B4 vs plain: {n} cases of CTA tiles across image rows and images "
        f"bit-identical ((hb, wb, n) in {LQ_TILE_SHAPES}; rebalance on/off; "
        f"pixels emitted or not)")
    n = 0
    # (flags, fused, joint, lanes): B5 on each body, B6
    given_sets = ([(f, False, False, lanes) for f in (0, DIAGONALS)
                   for lanes in (True, False)]
                  + [(f, True, joint, None) for f, joint in FUSED_FLAG_SETS])
    for flags, fused, joint, lanes in given_sets:
        for reb in (True, False):
            for want_pix in (True, False):
                for B in (1, 13, 37, 117):
                    case = _given_case(rng, B, fused, joint)
                    views = [case]
                    if B == 117:        # row chunks and slices of 9x13
                        views += [_chunk(case, r0 * 13, (r0 + nrows) * 13)
                                  for r0, nrows in CHUNKS]
                        views += [_chunk(case, a, b) for a, b in SLICES]
                    for coef, nbhd, image2, tabs in views:
                        err = check_given(torch, fused, coef, nbhd, image2,
                                          tabs, flags, reb, want_pix, lanes)
                        key = given_key(fused, joint, lanes)
                        stats[key]["max_abs_err"] = max(
                            stats[key]["max_abs_err"], err)
                        n += 1
    names = ", ".join(FLAG_NAMES[f] for f, _ in FUSED_FLAG_SETS)
    n_up = UPSAMPLE_SMALL_CASES
    for i in range(n_up):
        args, geom = _upsample_case(rng, i)
        err = max_abs_err(cuda_solver.upsample_fdct_blocks(*args, *geom),
                          planar.upsample_fdct_blocks(*args, *geom))
        assert err == 0, f"upsample_fdct differs from plain at {geom}"
        stats["upsample_fdct"]["max_abs_err"] = max(
            stats["upsample_fdct"]["max_abs_err"], err)
    log(f"upsample_fdct vs plain: {n_up} small random cases bit-identical "
        f"(sampling 2x2, 2x1, 1x2; 1-5 chroma blocks a side, odd luma "
        f"grids, 1-3 images, images and shards with and without either "
        f"replicate tail; flat, two-level and noisy halos)")
    log(f"B5/B6 vs plain: {n} small cases bit-identical (B5 at flags 0 and "
        f"DIAGONALS on each body, B6 at {names}; B = 1, 13, 37, 117 and row "
        f"chunks (r0, "
        f"rows) {CHUNKS} and block slices {SLICES} of a 9x13 plane as "
        f"column-slice views; rebalance on/off; pixels emitted or not)")


UPSAMPLE_SMALL_CASES = 90


def _upsample_case(rng, i):
    """A random block-form upsample: (chroma halos, image2 halos, luma
    pixels) on the card and the geometry upsample_fdct_blocks takes after
    them.  Sampling 2x2, 2x1, 1x2 in turn; odd luma grids; the image
    height and width anywhere in their last two block rows / columns, so
    either tail may run; 40% of cases a shard of a grid of up to 3 x 3;
    halos flat (s_aa == 0), two-level 0 / 255 (clamped slopes, saturated
    pixels), near-constant or noise."""
    hs, ws = ((2, 2), (2, 1), (1, 2))[i % 3]
    hb_c, wb_c = (int(v) for v in rng.integers(1, 6, 2))
    hb_l = max(1, hb_c * hs - int(rng.integers(0, 2))) if hs == 2 else hb_c
    wb_l = max(1, wb_c * ws - int(rng.integers(0, 2))) if ws == 2 else wb_c
    n = int(rng.integers(1, 4))
    R, C = (int(v) for v in rng.integers(1, 4, 2))
    if rng.random() >= 0.4:
        R = C = 1
    r, c = int(rng.integers(0, R)), int(rng.integers(0, C))
    hbt, wbt = hb_l * R, wb_l * C
    img_h = int(rng.integers(max(1, (hbt - 2) * 8 + 1), hbt * 8 + 1))
    img_w = int(rng.integers(max(1, (wbt - 2) * 8 + 1), wbt * 8 + 1))

    def halos(shape):
        kind = int(rng.integers(0, 4))
        if kind == 0:
            return np.full(shape, rng.integers(0, 256), np.int32)
        if kind == 1:
            return (rng.integers(0, 2, shape) * 255).astype(np.int32)
        if kind == 2:
            return rng.integers(100, 102, shape).astype(np.int32)
        return rng.integers(0, 256, shape).astype(np.int32)

    Bc, Bl = n * hb_c * wb_c, n * hb_l * wb_l
    args = tuple(to_dev(halos(sh)) for sh in ((100, Bc), (100, Bc), (64, Bl)))
    return args, (img_w, img_h, ws, hs, hb_l, wb_l, hb_c, wb_c,
                  r * hb_l * 8, hbt, c * wb_l * 8, wbt)


# row chunks (first row, rows) of the 9x13 plane: the first, middle and
# last rows; and block slices [a, b) of it that start and end inside a
# 16-block tile of B6-lq (37 and 17 blocks: no multiple of 16)
CHUNKS = ((0, 2), (4, 3), (8, 1))
SLICES = ((3, 40), (100, 117))


def given_key(fused, joint, lanes=False):
    if not fused:
        return "solve_rebalance_lanes" if lanes else "solve_rebalance"
    return "solve_fused_joint" if joint else "solve_fused_lq"


def _given_case(rng, B, fused, joint):
    """Random coefficients and a random materialised neighbourhood: the
    border lines int32[32, B] (B5) or halos int32[100, B] (B6), and
    image2 int32[100, B] under JOINT_YUV."""
    coef, _, tabs = _random_case(rng, B, True)
    nbhd = to_dev(rng.integers(0, 256, (100 if fused else 32, B)).astype(
        np.int32))
    image2 = (to_dev(rng.integers(0, 256, (100, B)).astype(np.int32))
              if joint else None)
    return coef, nbhd, image2, tabs


def _chunk(case, a, b):
    """Blocks [a, b) of a whole-plane case, as column-slice views."""
    coef, nbhd, image2, tabs = case
    s = slice(a, b)
    return (coef[:, s], nbhd[:, s], None if image2 is None else image2[:, s],
            tabs)


def check_given(torch, fused, coef, nbhd, image2, tabs, flags, reb,
                want_pix=False, lanes=None):
    """B6 (``fused``) or B5 (its lane body when ``lanes``, B2's when not,
    by size when None) vs the plain version on one input; returns the max
    |err|."""
    if fused:
        got = cuda_solver.solve_fused(coef, nbhd, image2, *tabs, flags, reb,
                                      want_pix)
        want = plain_solve_fused(coef, nbhd, image2, *tabs, flags, reb,
                                 want_pix)
    else:
        got = cuda_solver.solve_rebalance(coef, nbhd, *tabs, flags, reb,
                                          want_pix, lanes)
        want = plain_solve_rebalance(coef, nbhd, *tabs, flags, reb, want_pix)
    torch.cuda.synchronize()
    assert (got[1] is None) == (not want_pix)
    err = max_abs_err(got[0], want[0])
    if want_pix:
        err = max(err, max_abs_err(got[1], want[1]))
    name = ("B6" if fused else "B5") + (" (joint)" if image2 is not None
                                        else "") + (" (lanes)" if lanes
                                                    else "")
    assert err == 0, (f"{name} differs from plain at n={coef.shape[1]} "
                      f"ld={coef.stride(0)} flags={flags} reb={reb} "
                      f"want_pix={want_pix} (max |err| {err})")
    return err


def phase_golden(torch):
    """Each golden case on the fused path and on the progress path, per
    iteration and with row chunks at the finest precision: a callback
    that never cancels leaves the output as without one."""
    calls = []

    def count(userdata, cur, mx):
        calls.append((cur, mx))
        return 0

    for case in GOLDEN_CASES:
        img, opts = golden_image(case), golden_opts(case)
        for path, kw in (("fused", {}), ("progress", {"progress": count}),
                         ("precise", {"progress": count, "precise": True,
                                      "progprec": -1})):
            res = engine.smooth(img, QsOptions(flags=opts.flags,
                                               niter=opts.niter, **kw),
                                DEVICE)
            got = digest(res.coefs, res.stop, res.upsampled)
            assert got == GOLDEN[case[0]], (
                f"golden {case[0]} ({path} path): {got} != "
                f"{GOLDEN[case[0]]}")
    log(f"golden digests of the JAX package reproduced on the card: "
        f"{len(GOLDEN_CASES)} cases, each on the fused path and on the "
        f"progress path per iteration and with row chunks ({len(calls)} "
        f"callbacks)")


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


def main_path_planes(img):
    """The main path's largest kernel inputs on the 4:2:0 photo img: its
    luma plane's (coef, pix, tabs, hb, wb), its first chroma plane's, the
    chroma passes' image2 from the downsampled luma, and a chroma plane of
    4:4:4 size's image2: the luma plane's own halo (at 4:4:4 the
    downsampled luma is the luma itself)."""
    coef, pix, tabs, hb, wb = _plane_inputs(img, 0)
    ccoef, cpix, ctabs, hbc, wbc = _plane_inputs(img, 1)
    B, Bc = hb * wb, hbc * wbc
    image2 = planar.blocks_halo10(planar.downsample_blocks(
        pix.reshape(8, 8, B), hb, wb, hbc, wbc, 2, 2), hbc, wbc).reshape(
        100, Bc)
    image2_444 = planar.blocks_halo10(pix.reshape(8, 8, B), hb, wb).reshape(
        100, B)
    return (coef, pix, tabs, hb, wb, ccoef, cpix, ctabs, hbc, wbc, image2,
            image2_444)


def phase_full_plane(torch, img, gray, stats, card, t3_rate):
    """Every kernel vs plain on the main path's largest planes of the
    12 MP photo -- B1, B2, B4, B5 and B6 (LQ) on its 375x500 luma plane,
    B3 and B6 (JOINT) on its 188x250 chroma plane, image2 from the luma,
    B5/B6's neighbourhoods materialised from the whole plane as the
    progress path does -- and B4 on the 135x240 plane of the gray frame;
    then the per-kernel numbers of the JSON line: each kernel's first
    timed configuration, the others as variants."""
    (coef, pix, tabs, hb, wb, ccoef, cpix, ctabs, hbc, wbc, image2,
     image2_444) = main_path_planes(img)
    gcoef, gpix, gtabs, hbg, wbg = _plane_inputs(gray, 0)
    B, Bc, Bg = hb * wb, hbc * wbc, hbg * wbg
    for flags in (0, DIAGONALS):
        e1, e2 = check_pair(torch, coef, pix, tabs, flags, True, hb, wb)
    for args in ((coef, pix, None, tabs, Q_FLAGS[0], True, hb, wb),
                 (gcoef, gpix, None, gtabs, Q_FLAGS[0], True, hbg, wbg)):
        stats["solve_fused_pix_lq"]["max_abs_err"] = max(
            stats["solve_fused_pix_lq"]["max_abs_err"],
            check_fused(torch, *args))
    for c, p, i2, t, h, w, flags in (
            [(ccoef, cpix, image2, ctabs, hbc, wbc, f)
             for f in (Q_FLAGS[6], Q_FLAGS[5], Q_FLAGS[2])]
            + [(coef, pix, image2_444, tabs, hb, wb, f)
               for f in (Q_FLAGS[6], Q_FLAGS[2])]):
        err = check_fused(torch, c, p, i2, t, flags, True, h, w)
        stats["solve_fused_pix_joint"]["max_abs_err"] = max(
            stats["solve_fused_pix_joint"]["max_abs_err"], err)
    borders = engine.neighbourhood(pix, None, 0, hb, wb)
    halo = engine.neighbourhood(pix, None, Q_FLAGS[0], hb, wb)
    chalo = engine.neighbourhood(cpix, image2, Q_FLAGS[6], hbc, wbc)
    given = [(False, coef, borders, None, tabs, f) for f in (0, DIAGONALS)]
    given += [(True, coef, halo, None, tabs, Q_FLAGS[0])]
    given += [(True, ccoef, chalo, image2, ctabs, f)
              for f in (Q_FLAGS[6], JOINT_YUV, Q_FLAGS[2])]
    for fused, c, nbhd, i2, t, flags in given:
        err = check_given(torch, fused, c, nbhd, i2, t, flags, True)
        key = given_key(fused, i2 is not None)
        stats[key]["max_abs_err"] = max(stats[key]["max_abs_err"], err)
    # B5 on row chunks of the luma plane (column-slice views), each body
    # by size: the progress run's 85- and 11-row chunks, and the chunks of
    # the most rows that take the lane body and of one row more
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    edge = max(r for r in range(1, hb)
               if cuda_solver.use_lane_body(r * wb, sms))
    b5_chunks = ((100, 85), (300, 11), (0, edge), (hb - edge - 1, edge + 1))
    for r0, rows in b5_chunks:
        s = slice(r0 * wb, (r0 + rows) * wb)
        lanes = cuda_solver.use_lane_body(rows * wb, sms)
        for flags in (0, DIAGONALS):
            err = check_given(torch, False, coef[:, s], borders[:, s], None,
                              tabs, flags, True)
            key = given_key(False, False, lanes)
            stats[key]["max_abs_err"] = max(stats[key]["max_abs_err"], err)
    # B6-joint (above) and B7-joint take B3's design on launches of more
    # than two CTAs an SM, the one-thread body on smaller ones (the small
    # cases): B7-joint here over the 4:4:4-sized plane in two ranges
    for flags in (Q_FLAGS[6], JOINT_YUV, Q_FLAGS[2]):
        err = check_range(torch, (coef, pix, image2_444), tabs, flags, True,
                          wb, (0, B // 2, B), (0, hb - 1, 0, wb - 1), True)
        stats["solve_range_pix_joint"]["max_abs_err"] = max(
            stats["solve_range_pix_joint"]["max_abs_err"], err)
    log(f"kernels vs plain: full {hb}x{wb} luma plane (B1; B2 and B5 at "
        f"flags 0 and DIAGONALS, B5 also on row chunks (r0, rows) "
        f"{b5_chunks}, the lane body up to {edge} rows on {sms} SMs; B4 and "
        f"B6 at q0; B3 at q6 and q2 and B7 "
        f"joint at q6, JOINT and q2 as a 4:4:4-sized chroma plane), "
        f"{hbc}x{wbc} chroma plane (B3 at q6, q5 and q2 flags; B6 at q6, "
        f"JOINT and q2) and {hbg}x{wbg} gray plane (B4 at q0) "
        f"bit-identical")

    def timed(key, name, fn, plain, nbytes, ops, what, plain_reps=3):
        row = {"ms": cuda_ms(fn), "kernel_ms": kernel_ms(fn),
               "plain_ms": cuda_ms(plain, plain_reps),
               **bound_row(nbytes, ops, t3_rate)}
        log(f"{name} {what}: kernel {row['ms']:.4f} ms (profiler: "
            f"{ms_text(row['kernel_ms'])} kernel only), plain "
            f"{row['plain_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}; {row['bound_ms_t3']:.4f} ms at T3's fp32 "
            f"rate) [{card}]")
        variant = {"what": what, **row}
        if "ms" in stats[key]:
            stats[key].setdefault("variants", []).append(variant)
        else:
            stats[key].update(row, variants=[variant])

    # bytes: each input read once, each output written once (coefficient
    # and pixel planes int32[64, B], image2 int32[100, B], tables once)
    blk = 64 * 4
    terms144 = sweep_terms(0) * FP32_OPS_PER_TERM
    terms242 = sweep_terms(DIAGONALS) * FP32_OPS_PER_TERM
    timed("idct_pix", "B1 idct_pix", lambda: cuda_solver.idct_pix(coef),
          lambda: plain_idct_pix(coef), B * blk * 2, 0, f"on {B} blocks")
    args = (coef, pix, *tabs, 0, True, hb, wb)
    timed("solve_rebalance_pix", "B2 solve_rebalance_pix",
          lambda: cuda_solver.solve_rebalance_pix(*args),
          lambda: plain_solve_rebalance_pix(*args),
          B * blk * 4 + 64 * 144 * 4, B * terms144,
          f"on {B} blocks (q3 pass, NT 144)")
    args242 = (coef, pix, *tabs, DIAGONALS, True, hb, wb)
    timed("solve_rebalance_pix", "B2 solve_rebalance_pix",
          lambda: cuda_solver.solve_rebalance_pix(*args242),
          lambda: plain_solve_rebalance_pix(*args242),
          B * blk * 4 + 64 * 242 * 4, B * terms242,
          f"on {B} blocks (q4-q6 luma pass, NT 242)", plain_reps=1)
    lq = (coef, pix, None, *tabs, Q_FLAGS[0], True, hb, wb)
    timed("solve_fused_pix_lq", "B4 solve_fused_pix (lq)",
          lambda: cuda_solver.solve_fused_pix(*lq),
          lambda: plain_solve_fused_pix(*lq), B * blk * 4,
          B * LQ_PREAMBLE_OPS, f"on {B} blocks (q0 pass)")
    lqg = (gcoef, gpix, None, *gtabs, Q_FLAGS[0], True, hbg, wbg)
    timed("solve_fused_pix_lq", "B4 solve_fused_pix (lq)",
          lambda: cuda_solver.solve_fused_pix(*lqg),
          lambda: plain_solve_fused_pix(*lqg), Bg * blk * 4,
          Bg * LQ_PREAMBLE_OPS, f"on {Bg} blocks (q0 pass, the gray plane)")
    j6 = (ccoef, cpix, image2, *ctabs, Q_FLAGS[6], True, hbc, wbc)
    timed("solve_fused_pix_joint", "B3 solve_fused_pix (joint)",
          lambda: cuda_solver.solve_fused_pix(*j6),
          lambda: plain_solve_fused_pix(*j6),
          Bc * (blk * 4 + 100 * 4) + 64 * 242 * 4,
          Bc * (JOINT_PREAMBLE_OPS + terms242),
          f"on {Bc} blocks (q6 chroma pass, sweep NT 242)")
    j2 = (ccoef, cpix, image2, *ctabs, Q_FLAGS[2], True, hbc, wbc)
    timed("solve_fused_pix_joint", "B3 solve_fused_pix (joint)",
          lambda: cuda_solver.solve_fused_pix(*j2),
          lambda: plain_solve_fused_pix(*j2), Bc * (blk * 4 + 100 * 4),
          Bc * JOINT_PREAMBLE_OPS, f"on {Bc} blocks (q2 chroma pass, no "
          f"sweep)")
    for q, nt, terms, sweep in ((6, 242, terms242, "sweep NT 242"),
                                (2, 0, 0, "no sweep")):
        j444 = (coef, pix, image2_444, *tabs, Q_FLAGS[q], True, hb, wb)
        timed("solve_fused_pix_joint", "B3 solve_fused_pix (joint)",
              lambda: cuda_solver.solve_fused_pix(*j444),
              lambda: plain_solve_fused_pix(*j444),
              B * (blk * 4 + 100 * 4) + 64 * nt * 4,
              B * (JOINT_PREAMBLE_OPS + terms),
              f"on {B} blocks (q{q} pass on a 4:4:4-sized chroma plane, "
              f"{sweep})", plain_reps=1)
    # B5/B6 as the progress path calls them: materialised neighbourhoods
    # (borders int32[32, B], halos int32[100, B]) in, coefficients out
    for flags, nt, terms in ((0, 144, terms144), (DIAGONALS, 242, terms242)):
        a5 = (coef, borders, *tabs, flags, True)
        timed("solve_rebalance", "B5 solve_rebalance",
              lambda: cuda_solver.solve_rebalance(*a5),
              lambda: plain_solve_rebalance(*a5),
              B * (64 + 32 + 64) * 4 + 64 * nt * 4, B * terms,
              f"on {B} blocks (NT {nt})", plain_reps=1)
    # and on the progress run's PRECISE_PROGRESS row chunks (the lane
    # body's first timed configuration: the 11-row chunk at NT 242)
    for r0, rows in ((300, 11), (100, 85)):
        n = rows * wb
        s = slice(r0 * wb, (r0 + rows) * wb)
        lanes = cuda_solver.use_lane_body(n, sms)
        for flags, nt, terms in ((DIAGONALS, 242, terms242),
                                 (0, 144, terms144)):
            a5 = (coef[:, s], borders[:, s], *tabs, flags, True)
            timed(given_key(False, False, lanes),
                  "B5 solve_rebalance" + (" (lanes)" if lanes else ""),
                  lambda: cuda_solver.solve_rebalance(*a5),
                  lambda: plain_solve_rebalance(*a5),
                  n * (64 + 32 + 64) * 4 + 64 * nt * 4, n * terms,
                  f"on a {n}-block row chunk (NT {nt})", plain_reps=1)
    a6 = (ccoef, chalo, image2, *ctabs, Q_FLAGS[6], True)
    timed("solve_fused_joint", "B6 solve_fused (joint)",
          lambda: cuda_solver.solve_fused(*a6),
          lambda: plain_solve_fused(*a6),
          Bc * (64 + 100 + 100 + 64) * 4 + 64 * 242 * 4,
          Bc * (JOINT_PREAMBLE_OPS + terms242),
          f"on {Bc} blocks (q6 chroma pass, sweep NT 242)", plain_reps=1)
    a2 = (ccoef, chalo, image2, *ctabs, Q_FLAGS[2], True)
    timed("solve_fused_joint", "B6 solve_fused (joint)",
          lambda: cuda_solver.solve_fused(*a2),
          lambda: plain_solve_fused(*a2), Bc * (64 + 100 + 100 + 64) * 4,
          Bc * JOINT_PREAMBLE_OPS,
          f"on {Bc} blocks (q2 chroma pass, no sweep)")
    a0 = (coef, halo, None, *tabs, Q_FLAGS[0], True)
    timed("solve_fused_lq", "B6 solve_fused (lq)",
          lambda: cuda_solver.solve_fused(*a0),
          lambda: plain_solve_fused(*a0), B * (64 + 100 + 64) * 4,
          B * LQ_PREAMBLE_OPS, f"on {B} blocks (q0 pass)")
    # the upsample of one chroma component at the benchmark cell's shape:
    # the photo's planes UPSAMPLE_BATCH times back to back
    chalo10 = planar.blocks_halo10(cpix.reshape(8, 8, Bc), hbc,
                                   wbc).reshape(100, Bc)
    nu = UPSAMPLE_BATCH
    up = tuple(torch.cat([x] * nu, dim=1) for x in (chalo10, image2, pix))
    geom = (img.width, img.height, 2, 2, hb, wb, hbc, wbc)
    err = max_abs_err(cuda_solver.upsample_fdct_blocks(*up, *geom),
                      planar.upsample_fdct_blocks(*up, *geom))
    assert err == 0, f"upsample_fdct differs from plain on {nu} photos"
    timed("upsample_fdct", "upsample_fdct_blocks",
          lambda: cuda_solver.upsample_fdct_blocks(*up, *geom),
          lambda: planar.upsample_fdct_blocks(*up, *geom),
          nu * (B * (64 * 4 + 64 * 2) + Bc * 2 * 100 * 4),
          nu * B * upsample_fdct_ops(2, 2),
          f"on {nu} x {B} luma blocks (one chroma component of {nu} "
          f"4:2:0 photos, bit-identical to plain)", plain_reps=1)
    del up
    log(f"  bounds count {sweep_terms(0)} / {sweep_terms(DIAGONALS)} "
        f"non-zero-weight sweep terms per block and pass (NT 144 / 242) x "
        f"{FP32_OPS_PER_TERM} fp32 ops, {JOINT_PREAMBLE_OPS} fp32 ops of "
        f"JOINT preamble + FDCT, {LQ_PREAMBLE_OPS} of LQ preamble + FDCT, "
        f"{upsample_fdct_ops(2, 2)} a luma block of the 4:2:0 upsample + "
        f"FDCT")


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
        inputs = engine.upload([img], plan.comps, engine.resolve_device())
        run = lambda: engine.run_image(plan, inputs)
        dev_ms = cuda_ms(run)
        with plain_kernels():
            plain_ms = cuda_ms(run, 3)
        e2e_ms = host_ms(lambda: jpegqs_tpu_torch.smooth(img, opts))
        up_ms = host_ms(lambda: (engine.upload([img], plan.comps,
                                               inputs[0][0].device),
                                 torch.cuda.synchronize()))
        outs, _, ups = run()
        down_ms = host_ms(lambda: engine.download(outs + list(ups.values()))())
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
            f"{glue_ms(busy, by_kernel):.3f} ms [{card}]")
    log(f"main path launches (all runs): {total}")
    return total, summaries


# the batch phase's batches: N distinct synthetic images of one shape
# (seeds 0..N-1, IJG q75, so they share tables and geometry)
BATCH_COLOR = 8
BATCH_GRAY = 16
BATCH_GUARD = 5
# the small batches the plain path runs (its intermediates grow with B)
SMALL_COLOR_HW = (480, 640)
SMALL_GRAY_HW = (270, 480)


def expected_launches(plan):
    """One image's kernel launches, worked out from its plan: one B1 per
    component that smooths, then per pass one B3 (a component after the
    luma when JOINT_YUV reads the downsampled luma), B4 (LOW_QUALITY) or
    B2, and after it, on a component that UPSAMPLE_UV upsamples in block
    form, one upsample_fdct."""
    want = {}
    for k, p in enumerate(plan.comps):
        if p.mode != "smooth":
            continue
        joint = k > 0 and plan.need_downsample and plan.flags & JOINT_YUV
        key = ("solve_fused_pix_joint" if joint
               else "solve_fused_pix_lq" if plan.flags & LOW_QUALITY
               else "solve_rebalance_pix")
        want["idct_pix"] = want.get("idct_pix", 0) + 1
        want[key] = want.get(key, 0) + p.niter
        if k > 0 and plan.image1_live and plan.ds_blocks:
            want["upsample_fdct"] = want.get("upsample_fdct", 0) + 1
    return want


def counted(torch, fn):
    """(fn(), the kernel launches it made): the counts set to 0 just
    before, read just after."""
    cuda_solver.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v for k, v in cuda_solver.LAUNCHES.items() if v}


def tripped(img, seed):
    """A copy of gray image img whose plane trips the dequantization
    guard: one coefficient at 1000 (x its quantizer >= 2048)."""
    out = JpegImage(width=img.width, height=img.height,
                    jpeg_color_space=img.jpeg_color_space, progressive=False,
                    max_h_samp_factor=1, max_v_samp_factor=1)
    c = img.components[0]
    coefs = c.coefs.copy()
    rng = np.random.default_rng(seed)
    coefs[rng.integers(c.height_in_blocks), rng.integers(c.width_in_blocks),
          rng.integers(64)] = 1000
    out.components.append(ComponentData(
        component_id=c.component_id, h_samp_factor=1, v_samp_factor=1,
        quant_tbl_no=0, width_in_blocks=c.width_in_blocks,
        height_in_blocks=c.height_in_blocks, quantval=c.quantval.copy(),
        coefs=coefs))
    return out


def batch_inputs(color, gray):
    """The batch phase's images: BATCH_COLOR 12 MP 4:2:0 photos and
    BATCH_GRAY 2.1 MP gray frames (seeds 0..N-1; seed 0 is the main
    path's), the first BATCH_GUARD frames with the third tripping the
    guard, and the small batches of each kind for the plain path."""
    t0 = time.perf_counter()
    colors = [color] + [synth.make_image(*COLOR_HW, color=True, seed=s)
                        for s in range(1, BATCH_COLOR)]
    grays = [gray] + [synth.make_image(*GRAY_HW, color=False, seed=s)
                      for s in range(1, BATCH_GRAY)]
    guard = list(grays[:BATCH_GUARD])
    guard[2] = tripped(guard[2], 2)
    small_c = [synth.make_image(*SMALL_COLOR_HW, color=True, seed=s)
               for s in range(3)]
    small_g = [synth.make_image(*SMALL_GRAY_HW, color=False, seed=s)
               for s in range(3)]
    small_guard = [small_g[0], tripped(small_g[1], 1), small_g[2]]
    log(f"batch inputs: {BATCH_COLOR} x {COLOR_HW[1]}x{COLOR_HW[0]} 4:2:0 and "
        f"{BATCH_GRAY} x {GRAY_HW[1]}x{GRAY_HW[0]} gray, IJG q75, seeds "
        f"0..N-1, and the small batches, {time.perf_counter() - t0:.1f} s "
        f"(host)")
    return colors, grays, guard, small_c, small_g, small_guard


def phase_batch(torch, card, color, gray):
    """The batch engine at full size, through its entry points: per case
    the launch counts (worked out from the plan: one image's, for any N),
    bit-identity with per-image smooth() on the card and, on a small batch
    of the same kind, with the plain path; device time (CUDA events, the
    inputs resident), end-to-end time and MP/s beside N sequential
    smooth() calls, and the card's busy share.  Returns the summed launch
    counts and one summary line per case."""
    dev = engine.resolve_device()
    colors, grays, guard, small_c, small_g, small_guard = batch_inputs(
        color, gray)
    coefs16 = np.stack([g.components[0].coefs for g in grays])
    qtbl = grays[0].components[0].quantval
    total = dict.fromkeys(cuda_solver.LAUNCHES, 0)
    summaries = []
    # (name, images, small images, quality, reps, plane batch)
    cases = ((f"color_12mp x{BATCH_COLOR}", colors, small_c, 6, 3, False),
             (f"color_12mp x{BATCH_COLOR}", colors, small_c, 2, 3, False),
             (f"gray_2mp x{BATCH_GRAY}", grays, small_g, 3, 5, False),
             (f"gray_2mp x{BATCH_GRAY} planes", grays, small_g, 0, 5, True),
             (f"gray_2mp x{BATCH_GUARD}, one tripped", guard, small_guard, 3,
              5, False))
    for name, imgs, small, quality, reps, plane in cases:
        opts = QsOptions.from_quality(quality, 3)
        n = len(imgs)
        plan = engine.plan_image(imgs[0], opts)
        want = expected_launches(plan)
        def run_batch(ims):
            if plane:
                return list(batch.smooth_plane_batch(
                    np.stack([g.components[0].coefs for g in ims]),
                    ims[0].components[0].quantval, opts.flags, opts.niter))
            return batch.smooth_image_batch(ims, opts)

        same = np.array_equal if plane else _same
        got, counts = counted(torch, lambda: run_batch(imgs))
        assert counts == want, f"{name}: batch launches {counts} != {want}"
        for k, v in counts.items():
            total[k] += v
        # per image on the card: one image's launches, the same planes
        for i, im in enumerate(imgs):
            one, c1 = counted(torch, lambda: jpegqs_tpu_torch.smooth(im, opts))
            assert c1 == want, f"{name} image {i}: launches {c1} != {want}"
            assert same(got[i], one.coefs[0] if plane else one), \
                f"{name} image {i}: batch != per-image smooth()"
        stops = [0] * n if plane else [g.stop for g in got]
        if imgs is guard:
            assert stops == [0, 0, 1, 0, 0], stops
        elif not plane:
            for im, g in zip(imgs, got):
                _check_planes(im, g, opts)
        small_got = run_batch(small)
        with plain_kernels():
            small_plain = run_batch(small)
        for i, (a, b) in enumerate(zip(small_got, small_plain)):
            assert same(a, b), \
                f"{name} small image {i}: kernel path != plain path"

        # times: the device run on resident inputs, the entry point end to
        # end, and the same images one smooth() at a time
        if plane:
            tabs = [to_dev(t) for t in (qtbl.astype(np.int32),
                                        *make_quant_tables(qtbl))]
            c16 = to_dev(coefs16.reshape(-1, 64))
            hb, wb = coefs16.shape[1:3]
            run = lambda: engine.component_smooth(
                c16, *tabs, hb=hb, wb=wb, flags=opts.flags,
                niter=opts.niter, luma=True, n=n)
        else:
            inputs = engine.upload(imgs, plan.comps, dev)
            run = lambda: engine.run_image(plan, inputs, n)
        if name.startswith("color") and quality == 6:
            # the dispatch queues every launch: nothing in it waits for
            # the card (PyTorch raises on a synchronizing call)
            torch.cuda.set_sync_debug_mode("error")
            try:
                asm = batch._batch_dispatch(imgs, opts, dev)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            assert all(_same(a, b) for a, b in zip(asm(), got))
        if plane:
            entry = lambda: batch.smooth_plane_batch(coefs16, qtbl,
                                                     opts.flags, opts.niter)
        else:
            entry = lambda: batch.smooth_image_batch(imgs, opts)
        dev_ms = cuda_ms(run, reps)
        e2e_ms = host_ms(entry, reps)
        seq_inputs = [engine.upload([im], plan.comps, dev) for im in imgs]
        seq_dev_ms = cuda_ms(lambda: [engine.run_image(plan, x)
                                      for x in seq_inputs], reps)
        seq_ms = host_ms(lambda: [jpegqs_tpu_torch.smooth(im, opts)
                                  for im in imgs], reps)
        del seq_inputs
        mp = n * imgs[0].width * imgs[0].height / 1e6
        rate = lambda ms: mp / ms * 1e3
        log(f"batch {name}: q{quality} n3, {n} images ({mp:.2f} MP), "
            f"launches {counts} (one image's, from the plan), stops "
            f"{stops}; bit-identical to per-image smooth() on the card and, "
            f"on {len(small)} smaller images, to the plain path")
        log(f"  device {dev_ms:.3f} ms ({rate(dev_ms):.1f} MP/s), "
            f"end-to-end {e2e_ms:.3f} ms ({rate(e2e_ms):.1f} MP/s); "
            f"sequential: device {seq_dev_ms:.3f} ms "
            f"({rate(seq_dev_ms):.1f} MP/s), smooth() x{n} {seq_ms:.3f} ms "
            f"({rate(seq_ms):.1f} MP/s) [{card}]")
        busy, n_launch, by_kernel = device_breakdown(torch, run, dev_ms,
                                                     card)
        split = ", ".join(f"{k} {v:.3f} ms" for k, v in by_kernel.items()
                          if v > 0)
        summaries.append(
            f"summary batch {name} q{quality} n3: device {dev_ms:.3f} ms "
            f"({rate(dev_ms):.1f} MP/s; sequential {seq_dev_ms:.3f}), "
            f"end-to-end {e2e_ms:.3f} ms ({rate(e2e_ms):.1f} MP/s; "
            f"sequential smooth() {seq_ms:.3f}, {rate(seq_ms):.1f} MP/s); "
            f"card busy {100 * busy / dev_ms:.1f}%, {n_launch} kernels, "
            f"{split}, glue {glue_ms(busy, by_kernel):.3f} ms [{card}]")
        del run, got
        torch.cuda.empty_cache()
    summaries.append(check_window(torch, card, grays,
                                  QsOptions.from_quality(3, 3)))
    log(f"batch launches (all cases): {total}")
    return total, summaries, (colors, grays)


# batches in flight in check_window (the corpus pipeline's window)
WINDOW = 4


def check_window(torch, card, imgs, opts):
    """WINDOW batches of imgs dispatched ahead of their assemble() calls,
    as smooth_corpus queues them, against each batch dispatched and
    assembled in turn: the same planes; a batch's assemble() waits for
    its own batch alone (with a spin of the card queued behind the first
    batch, its assemble() returns while the card still spins); and the
    batches in flight take less time than the batches in turn, medians
    of 7 on the host clock, the two timed in alternation (which goes
    first alternates too) so that a slower spell of the host falls on
    both.  Returns a summary line."""
    dev = engine.resolve_device()
    plan = engine.plan_image(imgs[0], opts)

    def in_turn():
        return [engine.dispatch(imgs, plan, dev)() for _ in range(WINDOW)]

    def ahead():
        pending = [engine.dispatch(imgs, plan, dev) for _ in range(WINDOW)]
        return [asm() for asm in pending]

    want = in_turn()[0]
    for got in ahead():
        assert all(_same(a, b) for a, b in zip(got, want)), \
            "window: a batch in flight != the batch in turn"
    first = engine.dispatch(imgs, plan, dev)
    torch.cuda._sleep(1 << 31)      # ~1 s of the card's clock
    later = engine.dispatch(imgs, plan, dev)
    first()
    spinning = not torch.cuda.current_stream().query()
    later()
    assert spinning, "window: assemble() waited for the batches after its own"
    times = {in_turn: [], ahead: []}
    for i in range(7):
        for fn in ((in_turn, ahead) if i % 2 == 0 else (ahead, in_turn)):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[fn].append((time.perf_counter() - t0) * 1e3)
    turn_ms = statistics.median(times[in_turn])
    ahead_ms = statistics.median(times[ahead])
    line = (f"summary batch window: {WINDOW} batches of {len(imgs)} x "
            f"{imgs[0].width}x{imgs[0].height} gray q3 n3 in flight "
            f"{ahead_ms:.3f} ms, in turn {turn_ms:.3f} ms "
            f"({turn_ms / ahead_ms:.2f}x); assemble() waits for its own "
            f"batch alone [{card}]")
    log(line)
    assert ahead_ms < turn_ms, "window: batches in flight were not faster"
    return line


def phase_decode(torch, card, color, gray):
    """decode_smoothed's device decode (engine._decode_native): the
    golden digests of jpegqs_tpu's pixels on small cases, then the 12 MP
    photo at q3 n1 and q6 n3 (the upsampled planes) and the 2.1 MP gray
    frame at q3 n3 -- one B1 per component, pixels bit-identical to the
    CPU path on the same planes, device and end-to-end times."""
    for case in GOLDEN_CASES:
        if case[0] not in DECODE_GOLDEN:
            continue
        img = golden_image(case)
        res = engine.smooth(img, golden_opts(case), DEVICE)
        got = pixel_digest(engine._decode_native(img, res, DEVICE))
        assert got == DECODE_GOLDEN[case[0]], (
            f"decode golden {case[0]}: {got} != {DECODE_GOLDEN[case[0]]}")
    log(f"decode golden digests of the JAX package reproduced on the card: "
        f"{', '.join(DECODE_GOLDEN)}")
    total = dict.fromkeys(cuda_solver.LAUNCHES, 0)
    for name, img, quality, niter in (("color_12mp", color, 3, 1),
                                      ("color_12mp", color, 6, 3),
                                      ("gray_2mp", gray, 3, 3)):
        res = engine.smooth(img, QsOptions.from_quality(quality, niter))
        px, counts = counted(torch, lambda: engine._decode_native(img, res))
        assert counts == {"idct_pix": len(img.components)}, counts
        for k, v in counts.items():
            total[k] += v
        cpu = engine._decode_native(img, res, "cpu")
        assert px.dtype == np.uint8 and np.array_equal(px, cpu), \
            f"decode {name}: card != CPU path"
        planes, dims, ws, hs = engine.decode_layout(img, res)
        dev_planes = [to_dev(p) for p in planes]
        dev_ms = cuda_ms(lambda: colorout.decode(dev_planes, dims, ws, hs,
                                                 img.height, img.width))
        e2e_ms = host_ms(lambda: engine._decode_native(img, res))
        mp = img.width * img.height / 1e6
        log(f"decode {name} q{quality} n{niter} ({mp:.2f} MP, "
            f"{'upsampled planes' if res.upsampled is not None else 'planes'}"
            f" {ws}x{hs}): {px.shape} pixels bit-identical to the CPU path, "
            f"launches {counts}; device {dev_ms:.3f} ms "
            f"({mp / dev_ms * 1e3:.1f} MP/s), _decode_native() "
            f"{e2e_ms:.3f} ms [{card}]")
    return total


def recorder(calls, cancel_at=0):
    """A progress callback that records (cur, max) and cancels at call
    ``cancel_at`` (never when 0)."""
    def cb(userdata, cur, mx):
        calls.append((cur, mx))
        return bool(cancel_at) and len(calls) >= cancel_at
    return cb


def expected_progress(img, opts):
    """The (cur, max) trace, the solver passes of each component and the
    block rows of each of them, of a progress run that never cancels,
    worked out from the image's geometry and the reference's accounting
    (quantsmooth.h:2474-2482, 2632-2665; libjpegqs.h:42-44), for an image
    whose every quant table is above 1 and below 0x800."""
    comps, n = img.components, opts.niter
    prog_max = sum(c.height_in_blocks * c.v_samp_factor * n for c in comps)
    prec = 20 if opts.progprec == 0 else opts.progprec
    prec = prog_max if prec < 0 else prec
    thr = -(-prog_max // prec)
    count, trace, passes, steps = 0, [], [], []
    for c in comps:
        hb, v = c.height_in_blocks, c.v_samp_factor
        k = 0
        steps.append([])
        for _ in range(n):
            rows = 0
            while rows < hb:
                step = (min(max(1, -(-(thr - count) // v)), hb - rows)
                        if opts.precise else hb)
                rows += step
                count += step * v
                k += 1
                steps[-1].append(step)
                if count >= thr:
                    cur = prec * count // prog_max
                    thr = -(-((cur + 1) * prog_max) // prec)
                    trace.append((cur, prec))
        passes.append(k)
    return trace, passes, steps


def phase_progress(torch, img, card):
    """The progress path at full width, through ``smooth`` with a
    recording callback: q6 n3 per iteration and with PRECISE_PROGRESS row
    chunks (progprec 20), q2 n3 per iteration.  Per run: the trace and
    the launch counts (reset just before, read just after) against
    expected_progress, the planes against the fused run and, trace too,
    against the plain path on the card; then a q6 precise run cancelled
    at its third callback against the plain path.  Returns the summed
    launch counts and one summary line per run."""
    total = dict.fromkeys(cuda_solver.LAUNCHES, 0)
    summaries = []
    fused = {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, q, kw in (("q6 n3", 6, {}),
                        ("q6 n3 precise", 6, {"precise": True}),
                        ("q2 n3", 2, {})):
        calls = []
        opts = QsOptions.from_quality(q, 3, progress=recorder(calls), **kw)
        cuda_solver.reset_launches()
        res = jpegqs_tpu_torch.smooth(img, opts)
        torch.cuda.synchronize()
        counts = dict(cuda_solver.LAUNCHES)
        trace, passes, steps = expected_progress(img, opts)
        assert calls == trace, f"progress {name}: trace {calls} != {trace}"
        expect = dict.fromkeys(counts, 0)
        # B1: each iteration's pixels, then the plane the colour path reads
        expect["idct_pix"] = sum(opts.niter + 1 for _ in img.components)
        if q == 6:      # B5 on the luma, each pass's body by its size
            wb = img.components[0].width_in_blocks
            lanes = sum(cuda_solver.use_lane_body(r * wb, sms)
                        for r in steps[0])
            expect["solve_rebalance_lanes"] = lanes
            expect["solve_rebalance"] = passes[0] - lanes
        else:
            expect["solve_fused_lq"] = passes[0]
        expect["solve_fused_joint"] = passes[1] + passes[2]
        assert counts == expect, f"progress {name}: launches {counts} != " \
                                 f"{expect}"
        for k, v in counts.items():
            total[k] += v
        _check_planes(img, res, opts)
        if q not in fused:
            fused[q] = jpegqs_tpu_torch.smooth(img,
                                               QsOptions.from_quality(q, 3))
        assert _same(res, fused[q]), f"progress {name}: != the fused path"
        plain_calls = []
        with plain_kernels():
            plain = engine.smooth(img, QsOptions.from_quality(
                q, 3, progress=recorder(plain_calls), **kw))
        assert plain_calls == calls and _same(res, plain), (
            f"progress {name}: kernel path != plain path")
        quiet = QsOptions.from_quality(q, 3, progress=recorder([]), **kw)
        e2e_ms = host_ms(lambda: jpegqs_tpu_torch.smooth(img, quiet), 3)
        busy, n_launch, by_kernel = device_breakdown(
            torch, lambda: jpegqs_tpu_torch.smooth(img, quiet), e2e_ms, card,
            "smooth() run")
        mp = img.width * img.height / 1e6
        log(f"progress {name}: {len(calls)} callbacks, passes per component "
            f"{passes}, launches {counts}; trace and launches as worked out, "
            f"bit-identical to the fused run and to the plain path on the "
            f"card")
        log(f"  smooth() {e2e_ms:.3f} ms ({mp / e2e_ms * 1e3:.1f} MP/s), "
            f"kernels {busy:.3f} ms busy [{card}]")
        split = ", ".join(f"{k} {v:.3f} ms" for k, v in by_kernel.items()
                          if v > 0)
        summaries.append(
            f"summary progress {name}: smooth() {e2e_ms:.3f} ms, "
            f"{len(calls)} callbacks, card busy {busy:.3f} ms "
            f"({100 * busy / e2e_ms:.1f}%), {n_launch} kernels, {split}, "
            f"glue {glue_ms(busy, by_kernel):.3f} ms [{card}]")
    calls, plain_calls = [], []
    res = jpegqs_tpu_torch.smooth(img, QsOptions.from_quality(
        6, 3, precise=True, progress=recorder(calls, 3)))
    with plain_kernels():
        plain = engine.smooth(img, QsOptions.from_quality(
            6, 3, precise=True, progress=recorder(plain_calls, 3)))
    want = expected_progress(img, QsOptions.from_quality(6, 3,
                                                         precise=True))[0]
    assert calls == plain_calls == want[:3], f"cancel: trace {calls}"
    assert res.stop == 1 and res.upsampled is None and _same(res, plain), \
        "cancel: kernel path != plain path"
    moved = sum(int(np.count_nonzero(a != b))
                for a, b in zip(res.coefs, fused[6].coefs))
    log(f"progress q6 n3 precise, cancelled at the 3rd callback {calls[-1]}: "
        f"stop 1, no upsampled planes, {moved} coefficients differ from the "
        f"full run; bit-identical to the plain path on the card")
    log(f"progress path launches (all runs): {total}")
    return total, summaries


# ---------------------------------------------------------------------------
# The sharded path: B7 and the row-sharded engine on shards of one card
# ---------------------------------------------------------------------------

# (flags, JOINT_YUV preamble) of the B7 checks: the B2 form at NT 144 and
# 242, B3 with the sweep at NT 242 and 144 and without it, B4
RANGE_FLAG_SETS = ((0, False), (DIAGONALS, False)) + FUSED_FLAG_SETS
FLAG_NAMES.update({0: "0", DIAGONALS: "DIAGONALS", Q_FLAGS[6]: "q6",
                   Q_FLAGS[2]: "q2"})


def range_key(flags, joint):
    if joint:
        return "solve_range_pix_joint"
    return "solve_range_pix_lq" if flags & LOW_QUALITY else "solve_range_pix"


def shard_rows(r, hb, hb_loc):
    """(real rows, row edges (top_row, bot_row)) of shard r of a plane of
    hb real block rows cut into shards of hb_loc rows, as
    parallel/sharded.py cuts it (the last shards may hold dead pad rows);
    the same for the columns of a grid's column shards."""
    er, el = sharded._edge_pos(hb, hb_loc)
    real = hb_loc if r < er else (el + 1 if r == er else 0)
    return real, (1 if r == 0 else -1, el + 1 if r == er else -1)


def shard_ext(x, r, n, wb, rng=None):
    """Shard r of n of plane x int32[R, hb*wb] as the sharded loop holds
    it, its rows between a ghost row above and one below holding the
    neighbours' boundary rows; rows outside the plane (ghosts at the
    image's edges, dead pad rows) random when ``rng`` is given (no edge
    may let a pass read them), else zero."""
    import torch
    if x is None:
        return None
    R, hb = x.shape[0], x.shape[1] // wb
    hb_loc = sharded._pad_to(hb, n) // n
    out = (to_dev(rng.integers(0, 256, (R, hb_loc + 2, wb)).astype(np.int32))
           if rng is not None else torch.zeros(
               (R, hb_loc + 2, wb), dtype=torch.int32, device=x.device))
    lo = r * hb_loc - 1
    a, b = max(lo, 0), min(lo + hb_loc + 2, hb)
    if a < b:
        out[:, a - lo:b - lo] = x.reshape(R, hb, wb)[:, a:b]
    return out.reshape(R, -1)


def check_range(torch, ext, tabs, flags, reb, wb, cuts, edges, want_pix):
    """B7 vs its plain version over the ranges between consecutive
    ``cuts`` of one shard, each writing its range of one whole-size
    output; returns the max |err|."""
    return check_ranges(torch, ext, tabs, flags, reb, wb,
                        list(zip(cuts, cuts[1:])), edges, want_pix)


def check_ranges(torch, ext, tabs, flags, reb, wb, ranges, edges, want_pix):
    """B7 vs its plain version over the block ranges [b0, b1) of one
    shard, each writing its range of one whole-size output; returns the
    max |err|."""
    coef, pix, image2 = ext
    got = [torch.zeros_like(coef) for _ in range(2)]
    want = [torch.zeros_like(coef) for _ in range(2)]
    for b0, b1 in ranges:
        cuda_solver.solve_range_pix(coef, pix, image2, *tabs, flags, reb, wb,
                                    b0, b1, edges, got[0],
                                    got[1] if want_pix else None)
        plain_solve_range_pix(coef, pix, image2, *tabs, flags, reb, wb, b0,
                              b1, edges, want[0],
                              want[1] if want_pix else None)
    torch.cuda.synchronize()
    err = max(max_abs_err(g, w) for g, w in zip(got, want))
    assert err == 0, (f"B7 differs from plain at flags={flags} wb={wb} "
                      f"ranges={ranges} edges={edges} reb={reb} (max |err| "
                      f"{err})")
    return err


# B7's small shard grids (hb, wb, shards): wb under B4's 16-block tile,
# wb = 1 and wb above it; prime row counts leave dead pad rows below the
# bottom edge, so the last range's tile straddles it
B7_SHAPES = ((7, 5, 2), (11, 9, 3), (13, 4, 4), (5, 13, 2), (9, 1, 2),
             (10, 37, 3))


def mid_tile_cuts(wb, last):
    """Cuts of a shard's real blocks [wb, last) into ranges that start and
    end inside B4's 16-block tiles: 3 blocks, a single block, 12 blocks
    (shorter than a tile) and the rest, from wb + 16 (clipped at last)."""
    return sorted({min(c, last) for c in (wb, wb + 3, wb + 4, wb + 16, last)})


def phase_b7_vs_plain(torch, stats):
    """B7 vs its plain version on every shard of small random planes: 2, 3
    and 4 shards over prime row counts (dead pad rows, the bottom edge
    mid-shard), every edge position (the top, the bottom, none), each
    shard's real rows whole, split at the first, an interior and the last
    row, and split into ranges that start and end mid-tile (a single block,
    one shorter than a tile); ghost and dead rows random."""
    rng = np.random.default_rng(13)
    n_cases = 0
    for flags, joint in RANGE_FLAG_SETS:
        for hb, wb, n in B7_SHAPES:
            coef, pix, tabs = _random_case(rng, hb * wb, True)
            image2 = (to_dev(rng.integers(0, 256, (100, hb * wb)).astype(
                np.int32)) if joint else None)
            for r in range(n):
                real, edges = shard_rows(r, hb, sharded._pad_to(hb, n) // n)
                edges = (*edges, 0, wb - 1)
                if not real:
                    continue
                ext = [shard_ext(x, r, n, wb, rng)
                       for x in (coef, pix, image2)]
                last = (real + 1) * wb
                for cuts, reb, want_pix in (
                        ((wb, last), True, True),
                        (sorted({wb, 2 * wb, wb + real * wb // 2, real * wb,
                                 last}), False, False),
                        (mid_tile_cuts(wb, last), True, True)):
                    err = check_range(torch, ext, tabs, flags, reb, wb, cuts,
                                      edges, want_pix)
                    key = range_key(flags, joint)
                    stats[key]["max_abs_err"] = max(stats[key]["max_abs_err"],
                                                    err)
                    n_cases += 1
    log(f"B7 vs plain: {n_cases} small shard cases bit-identical (flags "
        f"{', '.join(FLAG_NAMES[f] for f, _ in RANGE_FLAG_SETS)}; (hb, wb, "
        f"shards) in {B7_SHAPES}; every shard, whole, split at rows and "
        f"split mid-tile (3, 1, 12 blocks and the rest); ghosts and dead "
        f"rows random)")


def phase_b7_full_shard(torch, img, stats, card, t3_rate):
    """B7 vs plain on one full shard of the 12 MP photo's planes -- the
    last of 4: 93 real luma rows of 94 (the 375-row plane is padded to
    376, so the bottom edge is mid-shard) and 47 chroma rows -- at each
    variant, whole and split as JPEGQS_OVERLAP splits it; then the
    kernel's time per variant on the whole shard."""
    coef, pix, tabs, hb, wb = _plane_inputs(img, 0)
    ccoef, cpix, ctabs, hbc, wbc = _plane_inputs(img, 1)
    image2 = planar.blocks_halo10(planar.downsample_blocks(
        pix.reshape(8, 8, hb * wb), hb, wb, hbc, wbc, 2, 2), hbc, wbc).reshape(
        100, hbc * wbc)
    n, r = 4, 3
    luma = [shard_ext(x, r, n, wb) for x in (coef, pix)] + [None]
    chroma = [shard_ext(x, r, n, wbc) for x in (ccoef, cpix, image2)]
    plans = (("luma", luma, tabs, wb, hb, ((0, False), (DIAGONALS, False),
                                          (Q_FLAGS[0], False))),
             ("chroma", chroma, ctabs, wbc, hbc,
              ((Q_FLAGS[6], True), (JOINT_YUV, True), (Q_FLAGS[2], True))))
    blk = 64 * 4
    timed = []
    for plane, ext, t, w, h, sets in plans:
        real, edges = shard_rows(r, h, sharded._pad_to(h, n) // n)
        edges = (*edges, 0, w - 1)
        last = (real + 1) * w
        for flags, joint in sets:
            if not joint:
                ext = ext[:2] + [None]
            for cuts in ((w, last), sorted({w, 2 * w, real * w, last})):
                err = check_range(torch, ext, t, flags, True, w, cuts, edges,
                                  True)
                key = range_key(flags, joint)
                stats[key]["max_abs_err"] = max(stats[key]["max_abs_err"], err)
            nb = real * w
            if flags & LOW_QUALITY and not joint:
                nbytes, ops = nb * blk * 4, nb * LQ_PREAMBLE_OPS
            elif joint:
                nbytes = nb * (blk * 4 + 100 * 4)
                ops = nb * JOINT_PREAMBLE_OPS
                if not flags & LOW_QUALITY:
                    nt = cuda_solver.nt_for(flags)
                    nbytes += 64 * nt * 4
                    ops += nb * sweep_terms(flags) * FP32_OPS_PER_TERM
            else:
                nt = cuda_solver.nt_for(flags)
                nbytes = nb * blk * 4 + 64 * nt * 4
                ops = nb * sweep_terms(flags) * FP32_OPS_PER_TERM
            timed.append((range_key(flags, joint), plane, flags, ext, t, w,
                          (w, last), edges, nbytes, ops, nb))
    log(f"B7 vs plain: the last of 4 shards of the {hb}x{wb} luma plane "
        f"(B2 form at flags 0 and DIAGONALS, B4 at q0) and of the "
        f"{hbc}x{wbc} chroma plane (B3 at q6, JOINT, q2), whole and split, "
        f"bit-identical")
    for key, plane, flags, ext, t, w, (b0, b1), edges, nbytes, ops, nb in \
            timed:
        outs = [torch.empty_like(ext[0]) for _ in range(2)]
        args = (*ext, *t, flags, True, w, b0, b1, edges, *outs)

        def run():
            return cuda_solver.solve_range_pix(*args)
        row = {"ms": cuda_ms(run), "kernel_ms": kernel_ms(run),
               "plain_ms": cuda_ms(lambda: plain_solve_range_pix(*args), 1),
               **bound_row(nbytes, ops, t3_rate)}
        what = (f"on {nb} blocks (last of 4 {plane} shards, flags "
                f"{FLAG_NAMES.get(flags, flags)})")
        log(f"B7 {key} {what}: kernel {row['ms']:.4f} ms (profiler: "
            f"{ms_text(row['kernel_ms'])} kernel only), plain "
            f"{row['plain_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}; {row['bound_ms_t3']:.4f} ms at T3's fp32 "
            f"rate) [{card}]")
        variant = {"what": what, **row}
        if "ms" in stats[key]:
            stats[key].setdefault("variants", []).append(variant)
        else:
            stats[key].update(row, variants=[variant])


def expected_sharded(img, opts, n, overlap):
    """The launches of an auto-sharded run over up to n shards that no
    stop cuts short, worked out from the image, and its (rows, cols)
    grid: per component B1 on each shard, and per iteration on each shard
    with real blocks, on a grid of one column one B7 launch, or three
    (interior rows, first row, last row) under JPEGQS_OVERLAP when it has
    three real rows or more, on a grid of several columns one launch per
    real row; under UPSAMPLE_UV (sampling factors above 1x1) one
    upsample_fdct per chroma component and shard."""
    flags, comps = opts.flags, img.components
    r, c = grid = engine.choose_grid(img, opts, n)
    ycbcr = engine._need_downsample(img, flags)
    want = {"idct_pix": r * c * len(comps)}
    for ci, comp in enumerate(comps):
        hb, wb = comp.height_in_blocks, comp.width_in_blocks
        if ycbcr:       # the luma is padded to samp x the chroma's blocks
            hb_pad = sharded._pad_to(comps[1].height_in_blocks, r) * (
                comp.v_samp_factor if ci == 0 else 1)
            wb_pad = sharded._pad_to(comps[1].width_in_blocks, c) * (
                comp.h_samp_factor if ci == 0 else 1)
        else:
            hb_pad, wb_pad = sharded._pad_to(hb, r), sharded._pad_to(wb, c)
        key = range_key(flags, ycbcr and ci > 0 and bool(flags & JOINT_YUV))
        cols = sum(shard_rows(j, wb, wb_pad // c)[0] > 0 for j in range(c))
        for k in range(r):
            real = shard_rows(k, hb, hb_pad // r)[0]
            if c > 1:
                per = real * cols
            else:
                per = 3 if overlap and real >= 3 else int(real > 0)
            want[key] = want.get(key, 0) + per * opts.niter
    y = comps[0]
    if (ycbcr and flags & UPSAMPLE_UV
            and (y.h_samp_factor, y.v_samp_factor) != (1, 1)):
        want["upsample_fdct"] = 2 * r * c
    return want, grid


def sharded_device_run(img, opts, devices):
    """The device work of ``engine._try_smooth_sharded(img, opts,
    devices)`` on inputs already on the card: the same builders, called
    with device tensors (outputs stay on the card)."""
    flags, comps = opts.flags, img.components
    devices = engine.shard_layout(devices, engine.choose_grid(
        img, opts, len(devices)))

    def dev_inputs(c):
        qraw = np.asarray(c.quantval, np.int32)
        return (to_dev(np.asarray(c.coefs, np.int16).reshape(
            c.height_in_blocks, c.width_in_blocks, 64)),
            [to_dev(t) for t in (qraw, *make_quant_tables(qraw))])

    if engine._need_downsample(img, flags):
        y, cb = comps[:2]
        fn = sharded.make_sharded_ycbcr_smooth(
            devices, hb_l=y.height_in_blocks, wb_l=y.width_in_blocks,
            hb_c=cb.height_in_blocks, wb_c=cb.width_in_blocks,
            ws=y.h_samp_factor, hs=y.v_samp_factor, flags=flags,
            niter=opts.niter, img_w=img.width, img_h=img.height)
        ins = [dev_inputs(c) for c in comps]
        return lambda: fn(*(p for p, _ in ins), *(t for _, t in ins))
    fns = [(sharded.make_sharded_smooth(
        devices, hb=c.height_in_blocks, wb=c.width_in_blocks, flags=flags,
        niter=opts.niter, luma=ci == 0 or not img.is_ycbcr), *dev_inputs(c))
        for ci, c in enumerate(comps)]
    return lambda: [fn(p, *t) for fn, p, t in fns]


def single_device_numbers(torch, img, opts, cache):
    """The single-device run of the same image: its result, device ms (the
    whole-image run on resident inputs) and smooth() ms, once per
    image and options."""
    key = (id(img), opts.flags, opts.niter)
    if key not in cache:
        dev = engine.resolve_device()
        res = engine._smooth_fused(img, opts, dev)
        plan = engine.plan_image(img, opts)
        inputs = engine.upload([img], plan.comps, dev)
        cache[key] = (res, cuda_ms(lambda: engine.run_image(plan, inputs)),
                      host_ms(lambda: engine._smooth_fused(img, opts, dev)))
    return cache[key]


def phase_sharded(torch, runs, card):
    """The auto-sharded path, ``engine._try_smooth_sharded``, with its
    shards on this one card: per run the launch counts (reset just
    before, read just after) against expected_sharded, bit-identity with
    the single-device run of the same image, device and smooth() times,
    the profiler's split (B7, the exchange copies) and the single-device
    numbers beside them.  Returns the summed launch counts and one
    summary line per run."""
    import os
    total = dict.fromkeys(cuda_solver.LAUNCHES, 0)
    summaries, cache = [], {}
    for name, img, quality, niter, n, overlap in runs:
        opts = QsOptions.from_quality(quality, niter)
        os.environ["JPEGQS_OVERLAP"] = overlap
        devices = [DEVICE] * n
        cuda_solver.reset_launches()
        res = engine._try_smooth_sharded(img, opts, devices)
        torch.cuda.synchronize()
        counts = dict(cuda_solver.LAUNCHES)
        tag = f"q{quality} n{niter}, {n} shards, overlap {overlap}"
        assert res is not None, f"{name} {tag}: sharding declined"
        want, grid = expected_sharded(img, opts, n, overlap == "1")
        expect = dict.fromkeys(counts, 0)
        expect.update(want)
        assert counts == expect, f"{name} {tag}: launches {counts} != {expect}"
        for k, v in counts.items():
            total[k] += v
        _check_planes(img, res, opts)
        single, dev1_ms, e2e1_ms = single_device_numbers(torch, img, opts,
                                                         cache)
        assert _same(res, single), f"{name} {tag}: sharded != single device"
        run = sharded_device_run(img, opts, devices)
        dev_ms = cuda_ms(run)
        e2e_ms = host_ms(lambda: engine._try_smooth_sharded(img, opts,
                                                            devices))
        busy, n_launch, by_kernel = device_breakdown(torch, run, dev_ms, card,
                                                     sharded=True)
        mp = img.width * img.height / 1e6
        log(f"sharded {name} {tag}: {img.width}x{img.height}, grid "
            f"{grid[0]}x{grid[1]} used, launches {counts}; bit-identical to "
            f"the single-device run")
        log(f"  device {dev_ms:.3f} ms ({mp / dev_ms * 1e3:.1f} MP/s), "
            f"_try_smooth_sharded() {e2e_ms:.3f} ms; single device "
            f"{dev1_ms:.3f} ms, smooth() {e2e1_ms:.3f} ms [{card}]")
        summaries.append(
            f"summary sharded {name} {tag}, grid {grid[0]}x{grid[1]}: "
            f"device {dev_ms:.3f} ms, "
            f"smooth() {e2e_ms:.3f} ms; card busy {100 * busy / dev_ms:.1f}%, "
            f"{n_launch} kernels, B7 {by_kernel['B7']:.3f} ms in "
            f"{sum(v for k, v in counts.items() if 'range' in k)} launches, "
            f"exchange {by_kernel['exchange']:.3f} ms, B1 "
            f"{by_kernel['B1']:.3f} ms, glue "
            f"{glue_ms(busy, by_kernel):.3f} ms; single device "
            f"{dev1_ms:.3f} / {e2e1_ms:.3f} ms [{card}]")
    os.environ.pop("JPEGQS_OVERLAP", None)
    log(f"sharded path launches (all runs): {total}")
    return total, summaries


def phase_exchange(torch, img, card):
    """The ghost exchange alone (_exchange_ghosts, one iteration's copies)
    on the luma pixels of ``img`` cut into 2 and 4 shards of this card,
    CUDA events around it: it moves 2 x (n-1) lines of 8 x wb pixels."""
    coef, pix, _, hb, wb = _plane_inputs(img, 0)
    for n in (2, 4):
        shards = sharded.Shards([DEVICE] * n)
        hb_loc = sharded._pad_to(hb, n) // n
        ext = [shard_ext(pix, r, n, wb) for r in range(n)]
        ms = cuda_ms(lambda: sharded._exchange_ghosts(ext, hb_loc, wb,
                                                      shards))
        nbytes = 2 * (n - 1) * 8 * wb * 4
        log(f"exchange over {n} shards of the {hb}x{wb} luma plane: "
            f"{ms:.4f} ms for {2 * (n - 1)} copies of 8 x {wb} pixels "
            f"({nbytes} B read and as many written) [{card}]")


def phase_multicard(torch, runs, card):
    """``smooth()`` as a user calls it on a machine with several cards:
    its automatic sharding over every card (real cards, not shards of
    one). Per run: the launch counts against expected_sharded,
    bit-identity with the single-device run on the first card, and
    host-clock times of both (device work on resident inputs, and the
    whole call), every card synchronised; then the ghost exchange across
    the cards, timed alone.  On a one-card machine it says so and runs
    nothing.  Returns the launch counts and one summary line per run."""
    devices = engine.shard_devices(torch.device("cuda"))
    if not devices:
        log("multi-card: one card here, so smooth() does not shard; the "
            "sharded path ran on shards of this card above")
        return {}, []
    n = len(devices)

    def sync():
        for d in devices:
            torch.cuda.synchronize(d)

    total = dict.fromkeys(cuda_solver.LAUNCHES, 0)
    summaries = []
    for name, img, quality, niter in runs:
        opts = QsOptions.from_quality(quality, niter)
        cuda_solver.reset_launches()
        res = jpegqs_tpu_torch.smooth(img, opts)
        sync()
        counts = dict(cuda_solver.LAUNCHES)
        want, grid = expected_sharded(img, opts, n, False)
        expect = dict.fromkeys(counts, 0)
        expect.update(want)
        tag = (f"q{quality} n{niter} over {grid[0] * grid[1]} cards (grid "
               f"{grid[0]}x{grid[1]})")
        assert counts == expect, f"{name} {tag}: launches {counts} != {expect}"
        for k, v in counts.items():
            total[k] += v
        single = engine._smooth_fused(img, opts, devices[0])
        assert _same(res, single), f"{name} {tag}: != the single-card run"
        run = sharded_device_run(img, opts, devices)
        dev_ms = host_ms(lambda: (run(), sync()))
        plan = engine.plan_image(img, opts)
        inputs = engine.upload([img], plan.comps, devices[0])
        dev1_ms = host_ms(lambda: (engine.run_image(plan, inputs), sync()))
        e2e_ms = host_ms(lambda: jpegqs_tpu_torch.smooth(img, opts))
        e2e1_ms = host_ms(lambda: engine._smooth_fused(img, opts, devices[0]))
        mp = img.width * img.height / 1e6
        summaries.append(
            f"summary multi-card {name} {tag}: device {dev_ms:.3f} ms "
            f"({mp / dev_ms * 1e3:.1f} MP/s), smooth() {e2e_ms:.3f} ms; one "
            f"card {dev1_ms:.3f} / {e2e1_ms:.3f} ms; launches {counts}; "
            f"bit-identical [{card} x{n}]")
        log(summaries[-1])
    coef, pix, _, hb, wb = _plane_inputs(runs[0][1], 0)
    shards = sharded.Shards(devices)
    hb_loc = sharded._pad_to(hb, n) // n
    ext = [shard_ext(pix, r, n, wb).to(d) for r, d in enumerate(devices)]
    ms = host_ms(lambda: (sharded._exchange_ghosts(ext, hb_loc, wb, shards),
                          sync()))
    log(f"exchange across {n} cards ({hb}x{wb} luma plane): {ms:.4f} ms "
        f"for {2 * (n - 1)} copies of 8 x {wb} pixels, host clock [{card}]")
    return total, summaries


def phase_golden_sharded(torch):
    """The golden cases through ``engine._try_smooth_sharded`` on 2 shards
    of this card with the shard threshold at 0; where it declines (no
    iteration, sampling factors above 2, unaligned YCbCr planes) the
    fused path runs, as smooth() would.  Returns the launch counts."""
    import os
    os.environ["JPEGQS_SHARD_MIN_BLOCKS"] = "0"
    cuda_solver.reset_launches()
    n_sharded = 0
    for case in GOLDEN_CASES:
        img, opts = golden_image(case), golden_opts(case)
        res = engine._try_smooth_sharded(img, opts, [DEVICE] * 2)
        n_sharded += res is not None
        if res is None:
            res = engine._smooth_fused(img, opts, engine.resolve_device())
        got = digest(res.coefs, res.stop, res.upsampled)
        assert got == GOLDEN[case[0]], (
            f"golden {case[0]} (sharded path): {got} != {GOLDEN[case[0]]}")
    torch.cuda.synchronize()
    del os.environ["JPEGQS_SHARD_MIN_BLOCKS"]
    log(f"golden digests through the sharded path on 2 shards: "
        f"{len(GOLDEN_CASES)} cases reproduced, {n_sharded} of them sharded "
        f"(the others declined, as jpegqs_tpu declines them)")
    return dict(cuda_solver.LAUNCHES)


# B7's 2-D shard grids (hb, wb, grid rows, grid columns): the right and
# bottom edges mid-shard (dead pad blocks beyond), one-row shards, rows under
# and over B4's 16-block tile
B7_GRIDS = ((7, 41, 2, 3), (3, 70, 1, 4), (11, 9, 3, 2), (5, 37, 2, 2))
# the line-scan / panorama strips the 2-D grid exists for, (height, width):
# a 4:2:0 strip of 4 x 8190 luma and 2 x 4095 chroma blocks (49,140 in
# all), and a gray strip of 2 x 8190 (16,380: under the default threshold)
STRIP_HW = (32, 65520)
GRAY_STRIP_HW = (16, 65520)
GRAY_STRIP_MIN_BLOCKS = 16000


def grid_shard(r, c, hb, wb, nr, nc):
    """(real rows, real columns, edges, hb_loc, wb_loc) of shard (r, c) of
    an hb x wb plane on an nr x nc grid, as parallel/sharded.py cuts it:
    the edges (top_row, bot_row, left_col, right_col) of its
    ghost-extended grid."""
    hb_loc, wb_loc = sharded._pad_to(hb, nr) // nr, sharded._pad_to(wb, nc) // nc
    rows, (top, bot) = shard_rows(r, hb, hb_loc)
    cols, (left, right) = shard_rows(c, wb, wb_loc)
    return rows, cols, (top, bot, left, right), hb_loc, wb_loc


def shard_ext2d(x, r, c, nr, nc, wb, rng=None):
    """Shard (r, c) of an nr x nc grid over plane x int32[R, hb*wb] as the
    2-D loop holds it: its blocks inside a ring of ghost blocks holding
    the neighbour shards' (corners the diagonal shards'); outside the
    image and on dead pad blocks random when ``rng`` is given (no edge may
    let a pass read them), else zero."""
    import torch
    if x is None:
        return None
    R, hb = x.shape[0], x.shape[1] // wb
    hb_loc, wb_loc = sharded._pad_to(hb, nr) // nr, sharded._pad_to(wb, nc) // nc
    shape = (R, hb_loc + 2, wb_loc + 2)
    out = (to_dev(rng.integers(0, 256, shape).astype(np.int32))
           if rng is not None else torch.zeros(shape, dtype=torch.int32,
                                               device=x.device))
    y0, x0 = r * hb_loc - 1, c * wb_loc - 1
    ya, yb = max(y0, 0), min(y0 + hb_loc + 2, hb)
    xa, xb = max(x0, 0), min(x0 + wb_loc + 2, wb)
    if ya < yb and xa < xb:
        out[:, ya - y0:yb - y0, xa - x0:xb - x0] = x.reshape(R, hb, wb)[
            :, ya:yb, xa:xb]
    return out.reshape(R, -1)


def row_ranges(rows, cols, wb_eff):
    """The 2-D loop's B7 ranges of a shard: one a real row, its real
    columns (from column 1 of the ghost-extended grid)."""
    return [(i * wb_eff + 1, i * wb_eff + 1 + cols)
            for i in range(1, rows + 1)] if cols else []


def phase_b7_grid(torch, stats, card, t3_rate, strip):
    """B7 with column edges vs its plain version on every shard of small
    random planes on 2-D grids (B7_GRIDS: the right and bottom edges
    mid-shard, ghosts and dead blocks random), one range per real row as
    the 2-D loop launches it, with rebalance and pixels on and off; then
    on shard (1, 1) of the 4:2:0 strip's planes on its 2 x 2 grid (the
    chroma's right edge mid-shard) at each variant, with the time of the shard's
    pass (its per-row launches) beside its bound."""
    rng = np.random.default_rng(17)
    n_cases = 0
    for flags, joint in RANGE_FLAG_SETS:
        for hb, wb, nr, nc in B7_GRIDS:
            coef, pix, tabs = _random_case(rng, hb * wb, True)
            image2 = (to_dev(rng.integers(0, 256, (100, hb * wb)).astype(
                np.int32)) if joint else None)
            for r in range(nr):
                for c in range(nc):
                    rows, cols, edges, _, wb_loc = grid_shard(r, c, hb, wb,
                                                              nr, nc)
                    if not rows or not cols:
                        continue
                    ext = [shard_ext2d(x, r, c, nr, nc, wb, rng)
                           for x in (coef, pix, image2)]
                    ranges = row_ranges(rows, cols, wb_loc + 2)
                    key = range_key(flags, joint)
                    for reb, want_pix in ((True, True), (False, False)):
                        err = check_ranges(torch, ext, tabs, flags, reb,
                                           wb_loc + 2, ranges, edges,
                                           want_pix)
                        stats[key]["max_abs_err"] = max(
                            stats[key]["max_abs_err"], err)
                        n_cases += 1
    log(f"B7 with column edges vs plain: {n_cases} small 2-D shard cases "
        f"bit-identical (flags "
        f"{', '.join(FLAG_NAMES[f] for f, _ in RANGE_FLAG_SETS)}; (hb, wb, "
        f"rows, cols) in {B7_GRIDS}; every shard, one range a real row; "
        f"ghosts and dead blocks random)")
    coef, pix, tabs, hb, wb = _plane_inputs(strip, 0)
    ccoef, cpix, ctabs, hbc, wbc = _plane_inputs(strip, 1)
    image2 = planar.blocks_halo10(planar.downsample_blocks(
        pix.reshape(8, 8, hb * wb), hb, wb, hbc, wbc, 2, 2), hbc, wbc).reshape(
        100, hbc * wbc)
    r = c = 1
    blk = 64 * 4
    for plane, xs, t, w, h, sets in (
            ("luma", (coef, pix, None), tabs, wb, hb,
             ((Q_FLAGS[3], False), (Q_FLAGS[6], False), (Q_FLAGS[0], False))),
            ("chroma", (ccoef, cpix, image2), ctabs, wbc, hbc,
             ((Q_FLAGS[6], True), (Q_FLAGS[2], True)))):
        rows, cols, edges, _, wb_loc = grid_shard(r, c, h, w, 2, 2)
        ext = [shard_ext2d(x, r, c, 2, 2, w) for x in xs]
        wb_eff = wb_loc + 2
        ranges = row_ranges(rows, cols, wb_eff)
        for flags, joint in sets:
            e = ext if joint else ext[:2] + [None]
            key = range_key(flags, joint)
            err = check_ranges(torch, e, t, flags, True, wb_eff, ranges,
                               edges, True)
            stats[key]["max_abs_err"] = max(stats[key]["max_abs_err"], err)
            nb = rows * cols
            if flags & LOW_QUALITY and not joint:
                nbytes, ops = nb * blk * 4, nb * LQ_PREAMBLE_OPS
            elif joint:
                nbytes = nb * (blk * 4 + 100 * 4)
                ops = nb * JOINT_PREAMBLE_OPS
                if not flags & LOW_QUALITY:
                    nbytes += 64 * cuda_solver.nt_for(flags) * 4
                    ops += nb * sweep_terms(flags) * FP32_OPS_PER_TERM
            else:
                nbytes = nb * blk * 4 + 64 * cuda_solver.nt_for(flags) * 4
                ops = nb * sweep_terms(flags) * FP32_OPS_PER_TERM
            outs = [torch.empty_like(e[0]) for _ in range(2)]

            def run(e=e, t=t, flags=flags, ranges=ranges, edges=edges,
                    outs=outs, wb_eff=wb_eff):
                for b0, b1 in ranges:
                    cuda_solver.solve_range_pix(*e, *t, flags, True, wb_eff,
                                                b0, b1, edges, *outs)

            def plain(e=e, t=t, flags=flags, ranges=ranges, edges=edges,
                      outs=outs, wb_eff=wb_eff):
                for b0, b1 in ranges:
                    plain_solve_range_pix(*e, *t, flags, True, wb_eff, b0,
                                          b1, edges, *outs)
            row = {"ms": cuda_ms(run), "kernel_ms": kernel_ms(run),
                   "plain_ms": cuda_ms(plain, 1), "launches": len(ranges),
                   **bound_row(nbytes, ops, t3_rate)}
            what = (f"2-D shard: {nb} blocks of shard (1, 1) of the "
                    f"{h}x{w} {plane} strip plane on a 2 x 2 grid, "
                    f"{len(ranges)} launches of one row, flags "
                    f"{FLAG_NAMES.get(flags, flags)}")
            log(f"B7 {key} {what}: {row['ms']:.4f} ms a pass (profiler: "
                f"{ms_text(row['kernel_ms'])} a launch, kernel only), plain "
                f"{row['plain_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms "
                f"({row['bound_by']}; {row['bound_ms_t3']:.4f} ms at T3's "
                f"fp32 rate) [{card}]")
            stats[key].setdefault("variants", []).append({"what": what,
                                                          **row})


def strip_images():
    """The 4:2:0 and gray strips (STRIP_HW, GRAY_STRIP_HW), IJG q75."""
    t0 = time.perf_counter()
    strip = synth.make_image(*STRIP_HW, color=True, seed=0)
    gray_strip = synth.make_image(*GRAY_STRIP_HW, color=False, seed=0)
    log(f"inputs: synthetic {STRIP_HW[1]}x{STRIP_HW[0]} 4:2:0 and "
        f"{GRAY_STRIP_HW[1]}x{GRAY_STRIP_HW[0]} gray strips, IJG q75, "
        f"{time.perf_counter() - t0:.1f} s")
    return strip, gray_strip


def phase_grid(torch, card, strip, gray_strip):
    """The 2-D grid through ``engine._try_smooth_sharded`` on 4 shards of
    this card (phase_sharded's checks and times): the 4:2:0 strip at q6
    n3 and q2 n3 and, with JPEGQS_SHARD_MIN_BLOCKS lowered under its
    16,380 blocks, the gray strip at q3 n3.  Each takes the 2 x 2 grid."""
    import os
    for img in (strip, gray_strip):
        grid = engine.choose_grid(img, QsOptions.from_quality(3, 3), 4)
        assert grid in (None, (2, 2)), grid
    assert engine.choose_grid(strip, QsOptions.from_quality(6, 3),
                              4) == (2, 2)
    launches, summaries = phase_sharded(torch, (
        ("strip_420", strip, 6, 3, 4, "0"),
        ("strip_420", strip, 2, 3, 4, "0")), card)
    os.environ["JPEGQS_SHARD_MIN_BLOCKS"] = str(GRAY_STRIP_MIN_BLOCKS)
    log(f"JPEGQS_SHARD_MIN_BLOCKS={GRAY_STRIP_MIN_BLOCKS} for the gray strip "
        f"({GRAY_STRIP_HW[1]}x{GRAY_STRIP_HW[0]}: 16,380 blocks, under the "
        f"default 16,384)")
    try:
        more, lines = phase_sharded(torch, (
            ("strip_gray", gray_strip, 3, 3, 4, "0"),), card)
    finally:
        del os.environ["JPEGQS_SHARD_MIN_BLOCKS"]
    for k, v in more.items():
        launches[k] += v
    return launches, summaries + lines


def phase_batch_dp(torch, card, colors, grays):
    """Batch data parallelism on shards of this card: the batch form of
    ``make_sharded_smooth`` (the JAX package's batch_axis) over data 2 x
    row 2 on the 16 gray frames at q3 n3, and ``smooth_batch_sharded``
    over data 2 x row 1 on the 8 colour photos at q6 n3: launch counts,
    bit-identity with ``smooth_image_batch`` on one device, device and
    end-to-end times beside it; then ``dryrun_multichip(4)``.  Returns the
    summed launch counts and the summary lines."""
    dev = engine.resolve_device()
    total = dict.fromkeys(cuda_solver.LAUNCHES, 0)
    summaries = []
    opts = QsOptions.from_quality(3, 3)
    comp = grays[0].components[0]
    hb, wb = comp.height_in_blocks, comp.width_in_blocks
    qraw = np.asarray(comp.quantval, np.int32)
    coefs16 = np.stack([np.asarray(g.components[0].coefs, np.int16).reshape(
        hb, wb, 64) for g in grays])
    n = len(grays)
    fn = sharded.make_sharded_smooth([[DEVICE] * 2] * 2, hb=hb, wb=wb,
                                     flags=opts.flags, niter=opts.niter,
                                     batch=True)
    want = batch.smooth_image_batch(grays, opts)
    (out, bad), counts = counted(torch, lambda: fn(
        coefs16, qraw, *make_quant_tables(qraw)))
    per = {"idct_pix": 2, "solve_range_pix": 2 * opts.niter}
    assert counts == {k: v * n for k, v in per.items()}, counts
    for k, v in counts.items():
        total[k] += v
    assert not bool(bad.any())
    assert np.array_equal(out.cpu().numpy(),
                          np.stack([w.coefs[0] for w in want])), \
        "data x row batch != smooth_image_batch"
    c16 = to_dev(coefs16)
    tabs = [to_dev(t) for t in (qraw, *make_quant_tables(qraw))]
    plan = engine.plan_image(grays[0], opts)
    inputs = engine.upload(grays, plan.comps, dev)
    rows = [("gray_2mp", f"x{n} q3 n3, data 2 x row 2 (make_sharded_smooth "
             f"batch form)", cuda_ms(lambda: fn(c16, *tabs), 3),
             cuda_ms(lambda: engine.run_image(plan, inputs, n), 3),
             host_ms(lambda: fn(coefs16, qraw, *make_quant_tables(
                 qraw))[0].cpu(), 3),
             host_ms(lambda: batch.smooth_image_batch(grays, opts), 3),
             n * grays[0].width * grays[0].height / 1e6)]
    del inputs, c16
    opts = QsOptions.from_quality(6, 3)
    groups = [[DEVICE], [DEVICE]]
    got, counts = counted(torch, lambda: sharded.smooth_batch_sharded(
        colors, opts, groups))
    plan = engine.plan_image(colors[0], opts)
    want_counts = {k: 2 * v for k, v in expected_launches(plan).items()}
    assert counts == want_counts, f"{counts} != {want_counts}"
    for k, v in counts.items():
        total[k] += v
    want = batch.smooth_image_batch(colors, opts)
    assert all(_same(a, b) for a, b in zip(got, want)), \
        "data x row colour batch != smooth_image_batch"
    half = len(colors) // 2
    shares = [engine.upload(colors[:half], plan.comps, dev),
              engine.upload(colors[half:], plan.comps, dev)]
    whole = engine.upload(colors, plan.comps, dev)
    rows.append(("color_12mp", f"x{len(colors)} q6 n3, data 2 x row 1 "
                 f"(smooth_batch_sharded)",
                 cuda_ms(lambda: [engine.run_image(plan, x, half)
                                  for x in shares], 3),
                 cuda_ms(lambda: engine.run_image(plan, whole, len(colors)),
                         3),
                 host_ms(lambda: sharded.smooth_batch_sharded(colors, opts,
                                                              groups), 3),
                 host_ms(lambda: batch.smooth_image_batch(colors, opts), 3),
                 len(colors) * colors[0].width * colors[0].height / 1e6))
    del shares, whole
    for name, what, dp_dev, one_dev, dp_e2e, one_e2e, mp in rows:
        summaries.append(
            f"summary batch-dp {name} {what}: device {dp_dev:.3f} ms "
            f"({mp / dp_dev * 1e3:.1f} MP/s), end-to-end {dp_e2e:.3f} ms; "
            f"one device (smooth_image_batch): device {one_dev:.3f} ms, "
            f"end-to-end {one_e2e:.3f} ms; bit-identical [{card}]")
        log(summaries[-1])
    line, counts = counted(torch, lambda: sharded.dryrun_multichip(4))
    log(f"{line}; launches {counts}")
    torch.cuda.empty_cache()
    return total, summaries


def _launch_ranks(args, timeout, backend="gloo"):
    """The launcher's --local 2 fan-out through tools/multihost_worker.py
    (two ranks, under gloo sharing this card, two shards each) with
    ``args``; returns its stderr and rank 0's launches.  Raises when a
    rank fails or the run outlasts its time."""
    import os
    here = os.path.dirname(os.path.abspath(__file__))
    r = subprocess.run(
        [sys.executable, os.path.join(here, "tools", "multihost_worker.py"),
         "--local", "2", "--shards-per-rank", "2", "--timeout",
         str(timeout), *args], cwd=here, capture_output=True, text=True,
        timeout=timeout + 60)
    assert r.returncode == 0, f"ranks failed: {r.stderr[-3000:]}"
    assert r.stderr.count(f"joined, backend {backend}") == 2, \
        r.stderr[-3000:]
    launches = {}
    for line in r.stderr.splitlines():
        if line.startswith("multihost_worker: rank 0 launches "):
            launches = json.loads(line.split("launches ", 1)[1])
    return r.stderr, launches


def phase_multiprocess(torch, card, aligned, strip, grays):
    """The multi-process engine: the launcher's --local 2, two gloo ranks
    on this card with two shards each (NCCL refuses two ranks on one
    card), each rank building its inputs from their seeds:
    smooth_image_distributed of the 4032x3024 photo at q6 n3 (a 4 x 1
    grid across the ranks) and of the 4:2:0 strip at q6 n3 (2 x 2), then
    smooth_batch_distributed of two gray frames a rank at q3 n3, each 3
    times (the first also loads the kernels).  Rank 0's planes (each
    rank's, for the batch) against the single-process run, rank 0's kernel
    launches, each run's time and the host time of the last run's
    point-to-point exchanges.  The NCCL path needs a card a rank: on a
    one-card machine it says so."""
    import os
    import tempfile
    dev = engine.resolve_device()
    summaries = []
    with tempfile.TemporaryDirectory() as d:
        save = os.path.join(d, "planes.npz")
        for name, hw, img in (("color_12mp_aligned", ALIGNED_HW, aligned),
                              ("strip_420", STRIP_HW, strip)):
            opts = QsOptions.from_quality(6, 3)
            t0 = time.perf_counter()
            err, launches = _launch_ranks(
                ["--synth", f"{hw[0]},{hw[1]},1,0", "-q", "6", "-n", "3",
                 "--reps", "3", "--save", save], 300)
            wall = time.perf_counter() - t0
            assert launches.get("idct_pix") and any(
                v for k, v in launches.items() if k.startswith(
                    "solve_range")), f"rank 0 launched {launches}"
            planes = np.load(save)
            want = engine._smooth_fused(img, opts, dev)
            assert int(planes["stop"]) == want.stop
            assert all(np.array_equal(planes[f"coef{i}"], c)
                       for i, c in enumerate(want.coefs)), \
                f"{name}: two ranks != one process"
            assert np.array_equal(planes["up1"], want.upsampled[0]) and \
                np.array_equal(planes["up2"], want.upsampled[1])
            report = [ln for ln in err.splitlines()
                      if ln.startswith("multihost_worker: 2 ranks")]
            summaries.append(
                f"summary multi-process {name} q6 n3: {report[-1][18:]}; "
                f"rank 0 launches {launches}; whole fan-out {wall:.1f} s "
                f"(two processes' start, inputs and build load "
                f"included); bit-identical to one process [{card}]")
            log(summaries[-1])
        base = os.path.join(d, "batch")
        err, launches = _launch_ranks(
            ["--synth", f"{GRAY_HW[0]},{GRAY_HW[1]},0,0", "--batch", "2",
             "-q", "3", "-n", "3", "--reps", "3", "--save", base], 300)
        opts = QsOptions.from_quality(3, 3)
        for rank in range(2):
            got = np.load(f"{base}.rank{rank}.npz")["coefs"]
            for i in range(2):
                want = engine._smooth_fused(grays[rank * 2 + i], opts, dev)
                assert np.array_equal(got[i], want.coefs[0]), \
                    f"batch rank {rank} frame {i} != one process"
        times = [ln for ln in err.splitlines() if "frames in" in ln]
        summaries.append(
            f"summary multi-process batch gray_2mp 2 x 2 frames q3 n3: "
            f"{'; '.join(t[18:] for t in times)}; rank 0 launches "
            f"{launches}; bit-identical to one process [{card}]")
        log(summaries[-1])
    if torch.cuda.device_count() < 2:
        log("multi-process over NCCL: not run: one card here, and NCCL "
            "refuses two ranks on one card")
    else:
        err, launches = _launch_ranks(
            ["--backend", "nccl", "--synth",
             f"{STRIP_HW[0]},{STRIP_HW[1]},1,0", "-q", "6", "-n", "3"], 300,
            backend="nccl")
        log(f"multi-process over NCCL, strip q6 n3: "
            f"{[ln for ln in err.splitlines() if 'backend nccl' in ln]}")
    return summaries


def device_breakdown(torch, run, dev_ms, card, window="device run",
                     sharded=False):
    """Kernel time by name over one run (torch.profiler), and the share
    of the ``dev_ms`` window the card was busy.  Returns the busy ms, the
    kernel launches and the ms of each of B1-B7 (``kernel_label``), of the
    exchange's range and of the copies between host and card (pageable
    ones last as long as the host's page faults)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0)
        # the exchange's range spans copies that have rows of their own
        if e.device_type == DeviceType.CUDA and t > 0 and \
                e.key != "jpegqs_exchange":
            rows.append((t / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    # the sharded loop's ghost copies, by their profiler range
    exchange = sum(e.device_time_total for e in prof.key_averages()
                   if e.key == "jpegqs_exchange") / 1e3
    log(f"  profiler: kernels {busy:.3f} ms busy in a {dev_ms:.3f} ms "
        f"{window} ({100 * busy / dev_ms:.1f}%), {sum(r[1] for r in rows)}"
        f" kernel launches [{card}]; top:")
    for t, n, k in rows[:6]:
        log(f"    {t:.3f} ms x{n} {k[:90]}")
    by_kernel = dict.fromkeys(("B1", "B2", "B3", "B4", "B5", "B6 joint",
                               "B6 lq", "B7"), 0.0)
    for t, _, key in rows:
        label = kernel_label(key, sharded)
        if label:
            by_kernel[label] += t
    by_kernel["exchange"] = exchange
    by_kernel["host copies"] = sum(t for t, _, key in rows
                                   if "HtoD" in key or "DtoH" in key)
    return busy, sum(r[1] for r in rows), by_kernel


def glue_ms(busy, by_kernel):
    """The busy time outside B1-B7 and the host copies: the glue's kernels
    and the copies between device buffers, the exchange's among them (its
    range also spans the waits on its side streams, so it is not
    subtracted)."""
    return busy - sum(v for k, v in by_kernel.items() if k != "exchange")


def kernel_label(key, sharded):
    """The B-number of a profiler kernel name, or None for the glue.  B7's
    B2 and LOW_QUALITY forms are B2's and B4's kernels over a block range:
    in a sharded run, which launches no B2 or B4, they count as B7.  The
    one-thread joint body runs B6-joint (given halos) and B7-joint, B2's
    body on given border lines B5."""
    given = "true>" in key or "(bool)1>" in key
    for marker, label in (("idct_pix_kernel", "B1"),
                          ("solve_joint_thread_kernel",
                           "B6 joint" if given else "B7"),
                          ("solve_borders_lanes_kernel", "B5"),
                          ("solve_borders_kernel",
                           "B5" if given else "B7" if sharded else "B2"),
                          ("solve_lq_kernel",
                           "B6 lq" if given else "B7" if sharded else "B4"),
                          ("solve_joint_kernel",
                           "B6 joint" if given else "B3")):
        if marker in key:
            return label
    return None


def phase_transcode(torch, card):
    """smooth_jpeg_bytes on a JPEG of the 2.1 MP gray frame, then
    smooth_many and the CLI's --batch on four.  The host codec needs
    libjpeg; where the machine has no jpeglib.h the phase says so and
    does not run."""
    import os
    from jpegqs_tpu_torch.host import jpegio
    incs = ("/usr/include", "/usr/local/include",
            "/usr/include/x86_64-linux-gnu")
    if not any(os.path.exists(os.path.join(d, "jpeglib.h")) for d in incs):
        log("transcode (smooth_jpeg_bytes), smooth_many and --batch: not "
            "run: this machine has no libjpeg headers (jpeglib.h), which "
            "the host codec needs")
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
    # the corpus pipeline and the CLI's --batch: 4 gray frames in one
    # bucket, bit-identical to one smooth_jpeg_bytes() each
    import tempfile
    from jpegqs_tpu_torch import cli
    datas = [jpegio.encode_pixels(synth.synth_image(*GRAY_HW, seed=s),
                                  quality=75) for s in range(4)]
    seq = [jpegqs_tpu_torch.smooth_jpeg_bytes(d, opts) for d in datas]
    assert jpegqs_tpu_torch.smooth_many(datas, opts) == seq, \
        "smooth_many != smooth_jpeg_bytes"
    with tempfile.TemporaryDirectory() as d:
        paths = []
        for i, data_i in enumerate(datas):
            paths.append(os.path.join(d, f"in{i}.jpg"))
            with open(paths[-1], "wb") as f:
                f.write(data_i)
        assert cli.main(["--batch", "-i", "0", *paths,
                         os.path.join(d, "out")]) == 0
        for i, want in enumerate(seq):
            with open(os.path.join(d, "out", f"in{i}.jpg"), "rb") as f:
                assert f.read() == want, "--batch != smooth_jpeg_bytes"
    ms = host_ms(lambda: jpegqs_tpu_torch.smooth_many(datas, opts), 3)
    log(f"smooth_many / --batch, 4 x {GRAY_HW[1]}x{GRAY_HW[0]} gray: "
        f"bit-identical to smooth_jpeg_bytes, smooth_many {ms:.3f} ms "
        f"[{card}]")


FUZZ_SEED = 11
FUZZ_SECONDS = 60
# B1-B7 by the launch counters that stand for each
FUZZ_KERNELS = {
    "B1": ("idct_pix",), "B2": ("solve_rebalance_pix",),
    "B3": ("solve_fused_pix_joint",), "B4": ("solve_fused_pix_lq",),
    "B5": ("solve_rebalance", "solve_rebalance_lanes"),
    "B6": ("solve_fused_joint", "solve_fused_lq"),
    "B7": ("solve_range_pix", "solve_range_pix_joint", "solve_range_pix_lq")}


def phase_fuzz(torch, card):
    """tools/fuzz_port.py's card mode in this process: every entry of
    tools/fuzz_port_golden.json (jpegqs_tpu's digests), then random synth
    cases of FUZZ_SEED for FUZZ_SECONDS, every path on the card against
    the port's CPU run and its single-device run.  Nothing is caught: a
    mismatch raises with its repro line.  B1-B7 must each have launched."""
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "fuzz_port", os.path.join(os.path.dirname(os.path.abspath(
            __file__)), "tools", "fuzz_port.py"))
    fuzz_port = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fuzz_port)
    cuda_solver.reset_launches()
    stats = fuzz_port.fuzz(DEVICE, FUZZ_SEED, seconds=FUZZ_SECONDS, log=None)
    torch.cuda.synchronize()
    launches = {k: v for k, v in cuda_solver.LAUNCHES.items() if v}
    idle = [b for b, keys in FUZZ_KERNELS.items()
            if not any(launches.get(k) for k in keys)]
    assert not idle, f"fuzz: kernels never launched: {idle}"
    log(f"fuzz (tools/fuzz_port.py, the card against the port's CPU run): "
        f"{stats['golden']} golden entries in {stats['golden_s']:.1f} s, "
        f"then {stats['cases']} random synth cases of seed {FUZZ_SEED} in "
        f"{stats['seconds']:.1f} s, 0 mismatches; paths: "
        f"{fuzz_port.paths_line(stats)}; launches {launches} [{card}]")


REPLACES = {
    "idct_pix": "jpegqs_tpu/ops/pallas_solver.py:883",
    "solve_rebalance_pix": "jpegqs_tpu/ops/pallas_solver.py:902",
    "solve_fused_pix_joint": "jpegqs_tpu/ops/pallas_solver.py:919",
    "solve_fused_pix_lq": "jpegqs_tpu/ops/pallas_solver.py:919",
    "solve_rebalance": "jpegqs_tpu/ops/pallas_solver.py:782",
    "solve_rebalance_lanes": "jpegqs_tpu/ops/pallas_solver.py:782",
    "solve_fused_joint": "jpegqs_tpu/ops/pallas_solver.py:824",
    "solve_fused_lq": "jpegqs_tpu/ops/pallas_solver.py:824",
    "solve_range_pix": "jpegqs_tpu/ops/pallas_solver.py:647",
    "solve_range_pix_joint": "jpegqs_tpu/ops/pallas_solver.py:647",
    "solve_range_pix_lq": "jpegqs_tpu/ops/pallas_solver.py:647",
    "upsample_fdct": "none: XLA ops at jpegqs_tpu/engine.py:430-437",
    "peak": "tools/vpu_peak.py:50",
    "canary_muladd": "tests/test_canary.py:47",
    "canary_fold": "tests/test_canary.py:73",
}
# T3 measures the card and T1/T2 check the build; no path runs them
OFF_PATH = ("peak", "canary_muladd", "canary_fold")


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
    phase_build(card)
    canaries = phase_canaries(torch)
    stamp("build, canaries")
    t3_rate = phase_peak(torch, stats, card)
    stamp("T3 fp32 peak")
    for name, c in canaries.items():
        stats[name] = {"max_abs_err": 0, "ms": c["ms"],
                       "plain_ms": c["plain_ms"],
                       **bound_row(c["nbytes"], c["ops"], t3_rate)}
        log(f"{name}: {c['ms']:.4f} ms on {1 << 16} lanes, plain "
            f"{c['plain_ms']:.4f} ms, bound {stats[name]['bound_ms']:.6f} ms "
            f"({stats[name]['bound_by']}) [{card}]")
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
    phase_full_plane(torch, color, gray, stats, card, t3_rate)
    stamp("full planes")
    # the q3 runs of the first slice at depth 1, to keep the whole script
    # near its first run time as paths are added
    launches, summaries = phase_main(torch, (
        ("color_12mp", color, 3, 1, {"idct_pix": 3,
                                     "solve_rebalance_pix": 3}),
        ("gray_2mp", gray, 3, 1, {"idct_pix": 1, "solve_rebalance_pix": 1}),
        ("color_12mp", color, 6, 3, {"idct_pix": 3, "solve_rebalance_pix": 3,
                                     "solve_fused_pix_joint": 6,
                                     "upsample_fdct": 2}),
        ("color_12mp", color, 2, 3, {"idct_pix": 3, "solve_fused_pix_lq": 3,
                                     "solve_fused_pix_joint": 6,
                                     "upsample_fdct": 2}),
        ("gray_2mp", gray, 0, 3, {"idct_pix": 1, "solve_fused_pix_lq": 3}),
    ), card)
    stamp("main path")
    main_launches = dict(launches)
    batch_launches, batch_summaries, (colors, grays) = phase_batch(
        torch, card, color, gray)
    stamp("batch engine")
    decode_launches = phase_decode(torch, card, color, gray)
    stamp("decode path")
    progress_launches, progress_summaries = phase_progress(torch, color, card)
    stamp("progress path")
    phase_b7_vs_plain(torch, stats)
    phase_b7_full_shard(torch, color, stats, card, t3_rate)
    stamp("B7 vs plain")
    # the 4000x3000 photo's planes are not aligned (375 luma block rows, 2 x
    # 188 chroma): jpegqs_tpu declines to shard its YCbCr flow, and so does
    # the port; the YCbCr runs take the 4032x3024 frame (378 = 2 x 189)
    assert engine._try_smooth_sharded(color, QsOptions.from_quality(6, 3),
                                      [DEVICE] * 4) is None
    t0 = time.perf_counter()
    aligned = synth.make_image(*ALIGNED_HW, color=True, seed=0)
    log(f"inputs: synthetic {ALIGNED_HW[1]}x{ALIGNED_HW[0]} 4:2:0, IJG q75, "
        f"{time.perf_counter() - t0:.1f} s")
    sharded_launches, sharded_summaries = phase_sharded(torch, (
        ("color_12mp_aligned", aligned, 6, 3, 2, "0"),
        ("color_12mp_aligned", aligned, 6, 3, 2, "1"),
        ("color_12mp_aligned", aligned, 6, 3, 4, "0"),
        ("color_12mp_aligned", aligned, 6, 3, 4, "1"),
        ("color_12mp", color, 3, 3, 3, "0"),
        ("gray_2mp", gray, 0, 3, 4, "0"),
    ), card)
    phase_exchange(torch, aligned, card)
    golden_launches = phase_golden_sharded(torch)
    multicard_launches, multicard_summaries = phase_multicard(torch, (
        ("color_12mp_aligned", aligned, 6, 3), ("color_12mp", color, 3, 3),
        ("gray_2mp", gray, 0, 3)), card)
    sharded_summaries += multicard_summaries
    stamp("sharded path")
    strip, gray_strip = strip_images()
    phase_b7_grid(torch, stats, card, t3_rate, strip)
    grid_launches, grid_summaries = phase_grid(torch, card, strip, gray_strip)
    stamp("2-D grid")
    dp_launches, dp_summaries = phase_batch_dp(torch, card, colors, grays)
    del colors
    stamp("batch data parallelism")
    mp_summaries = phase_multiprocess(torch, card, aligned, strip, grays)
    stamp("multi-process")
    sharded_summaries += grid_summaries + dp_summaries + mp_summaries
    for counts in (batch_launches, decode_launches, progress_launches,
                   sharded_launches, golden_launches, multicard_launches,
                   grid_launches, dp_launches):
        for k, v in counts.items():
            launches[k] += v
    unused = [k for k in launches if k not in OFF_PATH and not launches[k]]
    assert not unused, f"kernels the main paths never launched: {unused}"
    phase_transcode(torch, card)
    phase_fuzz(torch, card)
    stamp("fuzz")
    for line in (summaries + batch_summaries + progress_summaries
                 + sharded_summaries):
        log(line)
    rows = []
    for name in list(cuda_solver.LAUNCHES) + list(canaries):
        s = stats[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": "jpegqs_tpu_torch/csrc/solver.cu",
            "replaces": REPLACES[name], "launches": launches.get(name, 0),
            "main_path_launches": main_launches.get(name, 0),
            "on_path": name not in OFF_PATH,
            "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "kernel_ms": s.get("kernel_ms"), "plain_ms": s["plain_ms"],
            "bound_ms": s["bound_ms"], "bound_by": s["bound_by"],
            "bound_ms_t3": s["bound_ms_t3"],
            "library_ms": None,
            **({"variants": s["variants"]} if "variants" in s else {})})
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
