"""The solver pass on planar data, eager torch: the plain version of the
sweep + rebalance kernel ``solve_rebalance_pix`` (csrc/solver.cu).

Layouts follow the JAX package's public functions:

- pixel blocks:       [8, 8, B]  (row, col, block)
- flat coefficients:  [64, B]    (natural position, block)
- diff terms:         [NT, B]    (term in scalar fold order, block)

Bit-exactness: integer math is int32 with two's-complement wraparound
(the rebalance is int64, as ``specref.rebalance_blocks``); every fp32
product and sum is its own torch op, so it is rounded once, and the
a2/a3 accumulations are explicit left folds over the terms (never
``torch.sum``/``cumsum``, whose order is unspecified on the card).
"""

from __future__ import annotations

import numpy as np
import torch

from ..specref import NATURAL_ORDER, ZIGZAG_REFRESH
from .dct import idct_islow
from .quant import (roundf, c_f32_to_i32, get_orig_coef, interval_clamp,
                    wrap_i32)

F32 = torch.float32
I32 = torch.int32

_I_SEQ = NATURAL_ORDER[63:0:-1].astype(np.int64)            # [63]
_REFRESH_SEQ = ZIGZAG_REFRESH[_I_SEQ].astype(bool)          # [63]


def _make_groups():
    """Refresh groups of the k=63..1 sweep.

    Between two zigzag_refresh points no pixel state changes, so the
    coefficient steps inside one interval are independent: their a2/a3
    folds read the same frozen diffs and each writes only its own
    coefficient (quantsmooth.h:1403-1564; coupling is solely through
    the IDCT refresh at 1407-1409).  A group is therefore one
    vectorized step here, with each coefficient's fold kept in order.
    """
    groups, cur = [], []
    for i, refresh in zip(_I_SEQ, _REFRESH_SEQ):
        if refresh and cur:
            groups.append(tuple(cur))
            cur = []
        cur.append(int(i))
    groups.append(tuple(cur))
    return tuple(groups)


GROUPS = _make_groups()   # 14 groups, sizes 1..8; each opens a refresh


def borders_from_blocks(pix, hb, wb):
    """Solver border lines from neighbor blocks: pix int32[8, 8, hb*wb]
    -> (top, bottom, left, right), each int32[8, B].

    Models the padded-plane reads (quantsmooth.h:1396-1401) with edge
    replication (2612-2620): at the image edge the adjacent line is the
    block's own edge line."""
    p = pix.reshape(8, 8, hb, wb)
    top = torch.cat([p[0, :, :1, :], p[7, :, :-1, :]], dim=1)
    bottom = torch.cat([p[0, :, 1:, :], p[7, :, -1:, :]], dim=1)
    left = torch.cat([p[:, 0, :, :1], p[:, 7, :, :-1]], dim=2)
    right = torch.cat([p[:, 0, :, 1:], p[:, 7, :, -1:]], dim=2)
    B = hb * wb
    return (top.reshape(8, B), bottom.reshape(8, B),
            left.reshape(8, B), right.reshape(8, B))


def block_diffs_p(pix, borders, nt):
    """Diff terms in the exact scalar fold order -> f32[nt, B]
    (reference: quantsmooth.h:1416-1488, scalar 1521-1541): 56
    horizontal, 32 border, 56 vertical and, when nt == 242, the 98
    diagonal terms."""
    b = pix.to(I32)
    B = b.shape[-1]
    bt, bb, bl, br = borders
    h = (b[:, :7] - b[:, 1:]).reshape(56, B)
    bd = torch.cat([b[0] - bt, b[7] - bb, b[:, 0] - bl, b[:, 7] - br])
    v = (b[:7] - b[1:]).reshape(56, B)
    parts = [h, bd, v]
    if nt == 242:
        d1 = b[:7, :7] - b[1:, 1:]
        d2 = b[:7, 1:] - b[1:, :7]
        parts.append(torch.stack([d1, d2], dim=2).reshape(98, B))
    return torch.cat(parts).to(F32)


def left_fold(terms):
    """Strict left fold over axis 0, one rounding per add: the scalar
    accumulation order of a2/a3 (quantsmooth.h:1543-1546)."""
    acc = torch.zeros(terms.shape[1:], dtype=terms.dtype,
                      device=terms.device)
    for j in range(terms.shape[0]):
        acc = acc + terms[j]
    return acc


def solve_blocks_p(coef, borders, div, x1, qshr, tab):
    """The k=63..1 reverse-zigzag sweep: coef int32[64, B] ->
    int32[64, B] (reference: quantsmooth.h:1403-1565).

    tab f32[64, NT] are the solver tables (NT 144 without DIAGONALS,
    242 with: the omitted diagonal terms have zero weight).  Each group
    refreshes the pixels and diffs of every block; for a block whose
    coefficients did not change this recomputes the same values, so it
    equals the reference's selective refresh."""
    B = coef.shape[-1]
    nt = tab.shape[1]
    coef = coef.clone()
    for g in GROUPS:
        idx = torch.tensor(g, device=coef.device)
        d = block_diffs_p(idct_islow(coef.reshape(8, 8, B)), borders, nt)
        rng = (div[idx] * 2).to(F32)                          # [m]
        # rng and the diffs are integral; the sub and t*t (< 2^24) are
        # exact.  u*w and w*w are single-rounded products.
        t = torch.clamp_min(rng[None, :, None] - d.abs()[:, None, :], 0)
        t = t * t                                             # [nt, m, B]
        u = d[:, None, :] * t
        w = tab[idx].T[:, :, None] * t
        a2, a3 = left_fold(torch.stack([u * w, w * w], dim=1))
        delta = c_f32_to_i32(roundf(a2 / a3))
        coef1 = coef[idx]
        dv = div[idx, None]
        a0 = get_orig_coef(coef1, dv, x1[idx, None], qshr[idx, None])
        # coef1 - delta wraps in C when delta is INT32_MIN (a3 == 0)
        add = interval_clamp(wrap_i32(coef1.long() - delta.long()), a0, dv)
        coef[idx] = torch.where(delta != 0, add, coef1)
    return coef


def rebalance_blocks_p(coef, div, x1, qshr):
    """AC energy restore: coef int32[64, B] -> int32[64, B], DC kept
    (reference: quantsmooth.h:1823-1848), in int64 exactly as
    ``specref.rebalance_blocks``: C truncating division and the int
    truncation of ``mul`` and of ``coef * mul``."""
    c_ac = coef[1:]
    d_ac = div[1:, None]
    a0 = get_orig_coef(c_ac, d_ac, x1[1:, None], qshr[1:, None])
    c64, a64 = c_ac.long(), a0.long()
    m0 = (c64 * a64).sum(0)          # integer sums: order-free, exact
    m1 = (a64 * a64).sum(0)
    do = m1 > m0
    num = (m1 << 13) + (m0 >> 1)
    safe = torch.where(m0 == 0, torch.ones_like(m0), m0)
    mul = wrap_i32(torch.div(num, safe, rounding_mode="trunc"))
    prod = wrap_i32(c64 * mul.long()[None])
    add = ((prod.long() + 0x1000) >> 13).to(I32)
    add = interval_clamp(add, a0, d_ac)
    return torch.cat([coef[:1], torch.where(do[None], add, c_ac)])


def solve_rebalance_pix(coef, pix, div, x1, qshr, tab, do_rebalance, hb,
                        wb, want_pix=True):
    """One resident solver pass, the plain version of the kernel:
    coef/pix int32[64, B] (pix = the previous pass's pixels, the source
    of the border lines) -> (coef', pix' or None), where pix' is the
    IDCT of coef' (the next pass's pixels)."""
    B = coef.shape[1]
    borders = borders_from_blocks(pix.reshape(8, 8, B), hb, wb)
    out = solve_blocks_p(coef, borders, div, x1, qshr, tab)
    if do_rebalance:
        out = rebalance_blocks_p(out, div, x1, qshr)
    if not want_pix:
        return out, None
    return out, idct_islow(out.reshape(8, 8, B)).reshape(64, B)
