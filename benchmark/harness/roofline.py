"""The least time the card could take for the smoothing work of an image:
the larger of its bytes over the memory rate and its fp32 operations
over the fp32 rate, with the card's data-sheet peaks.

H100 SXM (NVIDIA data sheet, at a 700 W limit): 3.35 TB/s of HBM; 67
TFLOP/s fp32 counts a fused multiply-add as two operations.  The program
compiles with -fmad=false to stay bit-exact, so every fp32 add and
multiply issues alone: half that rate.

Operations: 9 a sweep term of non-zero weight, a block and a pass (sub,
max, t*t, d*t, tab*t, u*w, +, w*w, +); a zero-weight term cannot change
the folds, so the work the function needs skips it.  The fused
preambles per block and pass, counted from the kernels' source: the
FDCT and clamp is 16 butterflies of 44 operations, 64 scalings and 64
roundf; JOINT_YUV 13 a pixel (4 conversions, the divide, 2 clamps, mul,
add, mul, max, sub, min); LOW_QUALITY the range fold (63 conversions and
63 adds, divide, mul, min, roundf) and per pixel 8 neighbours x 11 plus
divide, 2 conversions, sub and cast.  Bytes: each input coefficient read
once, each output coefficient written once.
"""

from __future__ import annotations

import numpy as np

from ..reference.tables import (ITER_MAX, JOINT_YUV, LOW_QUALITY,
                                UPSAMPLE_UV, solver_tables)

PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12 / 2
FP32_OPS_PER_TERM = 9
FDCT_CLAMP_OPS = 16 * 44 + 64 + 64
JOINT_PREAMBLE_OPS = 64 * 13 + FDCT_CLAMP_OPS
LQ_PREAMBLE_OPS = 130 + 64 * (8 * 11 + 5) + FDCT_CLAMP_OPS


def sweep_terms(flags: int) -> int:
    """Terms of non-zero weight over the 63 sweep steps (k = 63..1) of a
    block and a pass."""
    return int(np.count_nonzero(solver_tables(flags)[1:]))


def _passes(niter: int) -> int:
    return min(max(niter, 0), ITER_MAX)


def _colour(photo) -> bool:
    """Whether the luma feeds the chroma's JOINT_YUV preamble: a YCbCr
    image of three or more components whose chroma is sampled 1x1."""
    comps = photo.comps
    return bool(photo.ycbcr and len(comps) >= 3
                and all(c.h_samp == 1 and c.v_samp == 1
                        for c in comps[1:3]))


def image_work(photo, flags: int, niter: int):
    """(fp32 operations, bytes) of smoothing one image: per component
    and pass the preamble (JOINT_YUV on the chroma when the luma feeds
    it, else LOW_QUALITY under that flag) and the sweep (unless
    LOW_QUALITY)."""
    comps = photo.comps
    niter = _passes(niter)
    colour = _colour(photo)
    joint = colour and bool(flags & JOINT_YUV)
    sweep = 0 if flags & LOW_QUALITY else sweep_terms(flags)
    ops = nbytes = 0
    for ci, c in enumerate(comps):
        blocks = c.hb * c.wb
        nbytes += 2 * blocks * 64 * 2
        if joint and ci > 0:
            pre = JOINT_PREAMBLE_OPS
        elif flags & LOW_QUALITY:
            pre = LQ_PREAMBLE_OPS
        else:
            pre = 0
        ops += niter * blocks * (pre + sweep * FP32_OPS_PER_TERM)
    y = comps[0]
    if colour and flags & UPSAMPLE_UV and (y.h_samp, y.v_samp) != (1, 1):
        nbytes += 2 * y.hb * y.wb * 64 * 2   # the upsampled Cb and Cr
    return ops, nbytes


def b2_work(photo, flags: int, niter: int):
    """(fp32 operations, bytes) of B2's own share of smoothing one image,
    the passes of ``solve_borders_kernel``: the sweep of every component
    that it solves, which is none under LOW_QUALITY (B4 solves them), the
    luma alone where the JOINT_YUV preamble takes the chroma to B3, and
    else every component.  Bytes as ``image_work`` counts them: each
    solved plane's coefficients read once and written once."""
    if flags & LOW_QUALITY:
        return 0, 0
    comps = photo.comps
    if _colour(photo) and flags & JOINT_YUV:
        comps = comps[:1]
    blocks = sum(c.hb * c.wb for c in comps)
    return (_passes(niter) * blocks * sweep_terms(flags) * FP32_OPS_PER_TERM,
            2 * blocks * 64 * 2)


def least_seconds(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_FP32_OPS_PER_S, nbytes / PEAK_BYTES_PER_S)
