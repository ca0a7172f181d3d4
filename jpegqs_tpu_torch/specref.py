"""The pieces of the NumPy algorithm specification this package needs.

A copy of the matching parts of ``jpegqs_tpu/specref.py`` (the in-repo
bit-exact transliteration of the reference's scalar code paths), kept
here so the PyTorch port imports nothing of the JAX package: the zigzag
tables, the float IDCT that defines the diff-basis weights, and the
solver tables themselves.
"""

from __future__ import annotations

import numpy as np

from .options import DIAGONALS

F = np.float32

# reference: idct.h:24-33
NATURAL_ORDER = np.array([
    0,  1,  8, 16,  9,  2,  3, 10,
    17, 24, 32, 25, 18, 11,  4,  5,
    12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13,  6,  7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46,
    53, 60, 61, 54, 47, 55, 62, 63], dtype=np.int32)

# reference: quantsmooth.h:313-322
ZIGZAG_REFRESH = np.array([
    1, 0, 1, 0, 1, 0, 1, 0,
    1, 0, 0, 0, 0, 0, 0, 1,
    0, 0, 0, 0, 0, 0, 0, 0,
    1, 0, 0, 0, 0, 0, 0, 1,
    0, 0, 0, 0, 0, 0, 0, 0,
    1, 0, 0, 0, 0, 0, 0, 1,
    0, 0, 0, 0, 0, 0, 0, 0,
    1, 0, 1, 0, 1, 0, 1, 1], dtype=np.int32)

# Terms of the per-coefficient weighted-LS accumulation, in the exact
# scalar order (quantsmooth.h:1527-1541): 56 horizontal diffs, 32
# border diffs, 56 vertical diffs, 98 diagonal diffs.
N_TERMS_H = 56
N_TERMS_B = 32
N_TERMS_V = 56
N_TERMS_D = 98
N_TERMS = N_TERMS_H + N_TERMS_B + N_TERMS_V + N_TERMS_D  # 242


def _idct_float_pass(x):
    """One 8-point float IDCT butterfly, exact fp32 order (idct.h:568-592)."""
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


def idct_float(blocks):
    """Float IDCT, columns then rows, output scaled by 0.125
    (idct.h:565-604).  blocks: f32[..., 8, 8] -> f32[..., 8, 8]."""
    b = np.asarray(blocks, dtype=F)
    cols = _idct_float_pass([b[..., i, :] for i in range(8)])
    ws = np.stack(cols, axis=-2)
    rows = _idct_float_pass([ws[..., :, i] for i in range(8)])
    return np.stack([r * F(0.125) for r in rows], axis=-1)


def make_solver_tables(flags):
    """Per-DCT-basis gradient tables, flattened to the exact scalar term
    order (56 h, 32 border, 56 v, 98 diag) -> f32[64, 242].

    Terms of groups the scalar code skips for a coefficient (h-diffs
    when i has no horizontal frequency, v-diffs when i < 8, diagonals
    without the flag) are zero-weighted; a zero weight adds +-0.0f to
    both accumulators, which cannot change a strict left fold that
    starts at +0.0f.
    """
    bcoef = F(4.0) if flags & DIAGONALS else F(2.0)
    tw = np.zeros((64, N_TERMS), dtype=F)
    for i in range(64):
        unit = np.zeros((8, 8), dtype=F)
        unit[i // 8, i % 8] = F(1)
        b = idct_float(unit)
        h = (b[:, :7] - b[:, 1:]).reshape(-1)
        border = np.concatenate([b[0, :] * bcoef, b[7, :] * bcoef,
                                 b[:, 0] * bcoef, b[:, 7] * bcoef])
        v = (b[:7, :] - b[1:, :]).reshape(-1)
        d1 = b[:7, :7] - b[1:, 1:]
        d2 = b[:7, 1:] - b[1:, :7]
        diag = np.stack([d1, d2], axis=-1).reshape(-1)
        if not (i & 7):
            h = np.zeros_like(h)
        if i <= 7:
            v = np.zeros_like(v)
        if not (flags & DIAGONALS):
            diag = np.zeros_like(diag)
        tw[i] = np.concatenate([h, border, v, diag])
    return tw
