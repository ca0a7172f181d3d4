"""The libjpeg islow integer IDCT on planar blocks, eager torch.

Counterpart of ``jpegqs_tpu.ops.planar.idct_islow_p``
(reference: idct.h:468-539, full path; the AC-all-zero shortcuts there
are pure optimizations that provably equal the full path).  This is
the plain version of the bootstrap kernel ``idct_pix``
(csrc/solver.cu); int32 arithmetic wraps as in the C build.
"""

from __future__ import annotations

import torch


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
