"""The DCTs on planar blocks, eager torch.

- ``idct_islow``: the libjpeg islow integer IDCT, counterpart of
  ``jpegqs_tpu.ops.planar.idct_islow_p`` (reference: idct.h:468-539,
  full path; the AC-all-zero shortcuts there are pure optimizations
  that provably equal the full path).  The plain version of the
  bootstrap kernel ``idct_pix`` (csrc/solver.cu); int32 arithmetic
  wraps as in the C build.
- ``fdct_float``: the float FDCT, counterpart of
  ``planar.fdct_float_p`` (reference: idct.h:606-923, scalar 895-916).
  Every add, sub and mul is its own eager torch op, so each result is
  rounded once, in the scalar order; the constants are the exact fp32
  values the C literals round to.
"""

from __future__ import annotations

import numpy as np
import torch


def _f32(v) -> float:
    """The fp32 value of a C float literal, as an exact Python float."""
    return float(np.float32(v))


def _idct_islow_pass1(x):
    """libjpeg islow even/odd butterfly, int32 (reference: idct.h:59-89)."""
    z2 = x[2]; z3 = x[6]
    z1 = (z2 + z3) * 4433           # FIX_0_541196100
    tmp2 = z1 - z3 * 15137          # FIX_1_847759065
    tmp3 = z1 + z2 * 6270           # FIX_0_765366865
    z2 = x[0]; z3 = x[4]
    tmp0 = (z2 + z3) << 13
    tmp1 = (z2 - z3) << 13
    tmp10 = tmp0 + tmp3; tmp13 = tmp0 - tmp3
    tmp11 = tmp1 + tmp2; tmp12 = tmp1 - tmp2
    tmp0 = x[7]; tmp1 = x[5]; tmp2 = x[3]; tmp3 = x[1]
    z1 = tmp0 + tmp3; z2 = tmp1 + tmp2
    z3 = tmp0 + tmp2; z4 = tmp1 + tmp3
    z5 = (z3 + z4) * 9633           # FIX_1_175875602
    tmp0 = tmp0 * 2446              # FIX_0_298631336
    tmp1 = tmp1 * 16819             # FIX_2_053119869
    tmp2 = tmp2 * 25172             # FIX_3_072711026
    tmp3 = tmp3 * 12299             # FIX_1_501321110
    z1 = z1 * 7373                  # FIX_0_899976223
    z2 = z2 * 20995                 # FIX_2_562915447
    z3 = z3 * 16069                 # FIX_1_961570560
    z4 = z4 * 3196                  # FIX_0_390180644
    z3 = z5 - z3; z4 = z5 - z4
    tmp0 = tmp0 + (z3 - z1)
    tmp1 = tmp1 + (z4 - z2)
    tmp2 = tmp2 + (z3 - z2)
    tmp3 = tmp3 + (z4 - z1)
    return [tmp10 + tmp3, tmp11 + tmp2, tmp12 + tmp1, tmp13 + tmp0,
            tmp13 - tmp0, tmp12 - tmp1, tmp11 - tmp2, tmp10 - tmp3]


def idct_islow(coef):
    """Integer IDCT on planar blocks: int32[8, 8, B] -> int32[8, 8, B]
    in [0, 255]: columns, DESCALE by 2^11, rows, +CENTER rounding
    shift by 2^18 and clamp (idct.h:54, 509-511)."""
    c = coef.to(torch.int32)
    cols = _idct_islow_pass1([c[i] for i in range(8)])           # over rows
    ws = torch.stack([(v + (1 << 10)) >> 11 for v in cols])      # [r, c, B]
    rows = _idct_islow_pass1([ws[:, i] for i in range(8)])       # over cols
    return torch.stack([torch.clamp((v + (257 << 17)) >> 18, 0, 255)
                        for v in rows], dim=1)


_K = {k: _f32(k) for k in (
    "0.541196100", "0.765366865", "1.847759065", "1.175875602",
    "0.298631336", "2.053119869", "3.072711026", "1.501321110",
    "0.899976223", "2.562915447", "1.961570560", "0.390180644")}


def _fdct_float_pass(x, scale=None):
    """8-point float FDCT butterfly, exact fp32 order (idct.h:608-628)."""
    z1 = x[0]; z2 = x[7]; t0 = z1 + z2; t7 = z1 - z2
    z1 = x[1]; z2 = x[6]; t1 = z1 + z2; t6 = z1 - z2
    z1 = x[2]; z2 = x[5]; t2 = z1 + z2; t5 = z1 - z2
    z1 = x[3]; z2 = x[4]; t3 = z1 + z2; t4 = z1 - z2
    z1 = t0 + t3; z4 = t0 - t3
    z2 = t1 + t2; z3 = t1 - t2
    o0 = z1 + z2; o4 = z1 - z2
    z1 = (z3 + z4) * _K["0.541196100"]
    o2 = z1 + z4 * _K["0.765366865"]
    o6 = z1 - z3 * _K["1.847759065"]
    z1 = t4 + t7; z2 = t5 + t6
    z3 = t4 + t6; z4 = t5 + t7
    z5 = (z3 + z4) * _K["1.175875602"]
    t4 = t4 * _K["0.298631336"]; t5 = t5 * _K["2.053119869"]
    t6 = t6 * _K["3.072711026"]; t7 = t7 * _K["1.501321110"]
    z1 = z1 * _K["0.899976223"]; z2 = z2 * _K["2.562915447"]
    z3 = z3 * _K["1.961570560"] - z5
    z4 = z4 * _K["0.390180644"] - z5
    o7 = t4 - (z1 + z3); o5 = t5 - (z2 + z4)
    o3 = t6 - (z2 + z3); o1 = t7 - (z1 + z4)
    out = [o0, o1, o2, o3, o4, o5, o6, o7]
    if scale is not None:
        out = [o * scale for o in out]
    return out


def fdct_float(blocks):
    """Float FDCT on planar blocks: f32[8, 8, B] -> f32[8, 8, B]
    (columns, then rows scaled by 0.125 as a separate rounded step)."""
    b = blocks.to(torch.float32)
    cols = _fdct_float_pass([b[i] for i in range(8)])             # over rows
    ws = torch.stack(cols)                                       # [u, c, B]
    rows = _fdct_float_pass([ws[:, i] for i in range(8)], scale=0.125)
    return torch.stack(rows, dim=1)
