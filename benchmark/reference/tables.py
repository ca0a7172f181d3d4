"""Flags and tables of the quantization-constrained smoothing algorithm
(jpeg-quantsmooth, libjpegqs.h and quantsmooth.h), worked out in numpy:
the quality ladder, the zigzag tables, the per-coefficient weights of
the sweep and the quantizers' fixed-point division tables."""

from __future__ import annotations

import numpy as np

# algorithm flags (libjpegqs.h:16-23)
DIAGONALS = 1
JOINT_YUV = 2
UPSAMPLE_UV = 4
LOW_QUALITY = 8
NO_REBALANCE = 16
NO_REBALANCE_UV = 32
ITER_MAX = 100  # libjpegqs.h:15

F = np.float32


def quality_to_flags(quality: int) -> int:
    """The CLI's -q 0..6 ladder (quantsmooth.c:380-393)."""
    flags = 0
    if quality < 3:
        flags |= LOW_QUALITY
        quality += 4
    if quality >= 4:
        flags |= DIAGONALS
    if quality >= 5:
        flags |= JOINT_YUV
    if quality >= 6:
        flags |= UPSAMPLE_UV
    return flags


# idct.h:24-33
NATURAL_ORDER = np.array([
    0, 1, 8, 16, 9, 2, 3, 10,
    17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46,
    53, 60, 61, 54, 47, 55, 62, 63], dtype=np.int32)

# quantsmooth.h:313-322
ZIGZAG_REFRESH = np.array([
    1, 0, 1, 0, 1, 0, 1, 0,
    1, 0, 0, 0, 0, 0, 0, 1,
    0, 0, 0, 0, 0, 0, 0, 0,
    1, 0, 0, 0, 0, 0, 0, 1,
    0, 0, 0, 0, 0, 0, 0, 0,
    1, 0, 0, 0, 0, 0, 0, 1,
    0, 0, 0, 0, 0, 0, 0, 0,
    1, 0, 1, 0, 1, 0, 1, 1], dtype=np.int32)

# sweep terms in the scalar fold order (quantsmooth.h:1527-1541): 56
# horizontal, 32 border, 56 vertical and 98 diagonal differences
N_TERMS = 56 + 32 + 56 + 98


def nt_for(flags: int) -> int:
    """Terms a sweep folds: without DIAGONALS the diagonal terms weigh
    nothing and are left out."""
    return N_TERMS if flags & DIAGONALS else 56 + 32 + 56


def _idct_float_pass(x):
    """One 8-point float IDCT butterfly in the exact fp32 order
    (idct.h:568-592)."""
    z2 = x[2]; z3 = x[6]
    z1 = (z2 + z3) * F(0.541196100)
    t2 = z1 - z3 * F(1.847759065)
    t3 = z1 + z2 * F(0.765366865)
    z2 = x[0]; z3 = x[4]
    t0 = z2 + z3; t1 = z2 - z3
    t4 = t0 + t3; t7 = t0 - t3
    t5 = t1 + t2; t6 = t1 - t2
    t0 = x[7]; t1 = x[5]; t2 = x[3]; t3 = x[1]
    z1 = t0 + t3; z2 = t1 + t2
    z3 = t0 + t2; z4 = t1 + t3
    z5 = (z3 + z4) * F(1.175875602)
    t0 = t0 * F(0.298631336); t1 = t1 * F(2.053119869)
    t2 = t2 * F(3.072711026); t3 = t3 * F(1.501321110)
    z1 = z1 * F(0.899976223); z2 = z2 * F(2.562915447)
    z3 = z3 * F(1.961570560); z4 = z4 * F(0.390180644)
    z3 = z3 - z5
    t0 = t0 - (z1 + z3)
    t2 = t2 - (z2 + z3)
    z4 = z4 - z5
    t1 = t1 - (z2 + z4)
    t3 = t3 - (z1 + z4)
    return [t4 + t3, t5 + t2, t6 + t1, t7 + t0,
            t7 - t0, t6 - t1, t5 - t2, t4 - t3]


def _idct_float(block):
    """Float IDCT of one 8x8 block, columns then rows, times 0.125
    (idct.h:565-604)."""
    b = np.asarray(block, dtype=F)
    ws = np.stack(_idct_float_pass([b[i, :] for i in range(8)]), axis=0)
    rows = _idct_float_pass([ws[:, i] for i in range(8)])
    return np.stack([r * F(0.125) for r in rows], axis=-1)


def solver_tables(flags: int) -> np.ndarray:
    """The sweep's weights f32[64, nt_for(flags)]: per coefficient, the
    differences of its basis image in the scalar term order (56 h, 32
    border, 56 v, 98 diagonal).  Terms the scalar code skips for a
    coefficient (horizontal ones when it has no horizontal frequency,
    vertical ones when i < 8, diagonals without the flag) weigh 0."""
    bcoef = F(4.0) if flags & DIAGONALS else F(2.0)
    tw = np.zeros((64, N_TERMS), dtype=F)
    for i in range(64):
        unit = np.zeros((8, 8), dtype=F)
        unit[i // 8, i % 8] = F(1)
        b = _idct_float(unit)
        h = (b[:, :7] - b[:, 1:]).reshape(-1)
        border = np.concatenate([b[0, :] * bcoef, b[7, :] * bcoef,
                                 b[:, 0] * bcoef, b[:, 7] * bcoef])
        v = (b[:7, :] - b[1:, :]).reshape(-1)
        d1 = b[:7, :7] - b[1:, 1:]
        d2 = b[:7, 1:] - b[1:, :7]
        diag = np.stack([d1, d2], axis=-1).reshape(-1)
        if not i & 7:
            h = np.zeros_like(h)
        if i <= 7:
            v = np.zeros_like(v)
        if not flags & DIAGONALS:
            diag = np.zeros_like(diag)
        tw[i] = np.concatenate([h, border, v, diag])
    return np.ascontiguousarray(tw[:, :nt_for(flags)])


def quant_tables(qtbl):
    """(div, x1, qshr) int32[64]: the zero-repaired quantizers
    (quantsmooth.h:2508-2511) and the round-half-away division tables
    (2513-2539, non-NEON), reinterpreted as int16 as the C code does."""
    q = np.asarray(qtbl, dtype=np.int64)
    q = q - ((q - 1) >> 16)
    div = q.astype(np.int32)
    x1s = np.zeros(64, dtype=np.int32)
    qshrs = np.zeros(64, dtype=np.int32)
    for i in range(64):
        qi = int(q[i])
        n = qi.bit_length() - 1
        x1 = (((0x10000 << n) + qi - 1) // qi) & 0xFFFFFFFF
        if n:
            x1 |= x1 >> 16
        x1s[i] = np.uint16(x1 & 0xFFFF).astype(np.int16)
        qshrs[i] = np.uint16((-0x8000 >> n) & 0xFFFF).astype(np.int16)
    return div, x1s, qshrs
