"""Planar-layout passes, eager torch: the plain versions of the solver
kernels (csrc/solver.cu) and the block-wise colour glue.

- ``solve_rebalance``: plain version of B5 (sweep + rebalance on given
  border lines); ``solve_rebalance_pix``, the plain version of B2,
  gathers the borders from the previous pass's pixels and calls it;
- ``solve_fused``: plain version of B6 (the JOINT_YUV or LOW_QUALITY
  preamble, sweep, rebalance on a given 10x10 halo), the non-Pallas
  branch of ``jpegqs_tpu.engine.block_pass_p``; ``solve_fused_pix``,
  the plain version of B3/B4, gathers the halo and calls it;
- ``solve_range_pix``: plain version of B7, the pass of B2/B3/B4 over a
  block range with the edges given (``range_halo10``), the sharded
  loop's pass;
- ``upsample_fdct_blocks``: plain version of the upsample_fdct kernel
  (UPSAMPLE_UV in block form with its float FDCT, roundf and int16);
- the 10x10 halos and the downsample, which run as this same eager torch
  on the card (the JAX package runs these and the upsample as XLA ops,
  outside any Pallas kernel).

The passes from pixels and the block-form colour glue take several
same-shape images back to back on the block axis (the batch engine),
each with its own image edges, in the same number of torch ops as one.

Layouts follow the JAX package's public functions:

- pixel blocks:       [8, 8, B]    (row, col, block)
- pixel halos:        [10, 10, B]  (the block with its 1-pixel ring)
- flat coefficients:  [64, B]      (natural position, block)
- diff terms:         [NT, B]      (term in scalar fold order, block)

Bit-exactness: integer math is int32 with two's-complement wraparound
(the rebalance is int64, as ``specref.rebalance_blocks``); every fp32
product and sum is its own torch op, so it is rounded once, and the
fp32 accumulations are explicit left folds (never ``torch.sum``/
``cumsum``, whose order is unspecified on the card).  No convolution
or matmul is used: they may run in TF32 or reassociate.
"""

from __future__ import annotations

import numpy as np
import torch

from ..options import LOW_QUALITY
from ..specref import NATURAL_ORDER, ZIGZAG_REFRESH
from .dct import fdct_float, idct_islow
from .quant import (roundf, c_f32_to_i32, get_orig_coef, interval_clamp,
                    wrap_i32)

F32 = torch.float32
I32 = torch.int32
I16 = torch.int16
CENTERJSAMPLE = 128

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
    """Solver border lines from neighbor blocks: pix int32[8, 8, B] ->
    (top, bottom, left, right), each int32[8, B].  B may hold several
    hb x wb images back to back; each has its own edges.

    Models the padded-plane reads (quantsmooth.h:1396-1401) with edge
    replication (2612-2620): at the image edge the adjacent line is the
    block's own edge line."""
    p = pix.reshape(8, 8, -1, hb, wb)
    top = torch.cat([p[0, :, :, :1], p[7, :, :, :-1]], dim=2)
    bottom = torch.cat([p[0, :, :, 1:], p[7, :, :, -1:]], dim=2)
    left = torch.cat([p[:, 0, ..., :1], p[:, 7, ..., :-1]], dim=3)
    right = torch.cat([p[:, 0, ..., 1:], p[:, 7, ..., -1:]], dim=3)
    return tuple(x.reshape(8, -1) for x in (top, bottom, left, right))


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


def _with_pix(out, want_pix):
    """(coef', its IDCT int32[64, B] -- the next pass's pixels) or
    (coef', None)."""
    if not want_pix:
        return out, None
    B = out.shape[1]
    return out, idct_islow(out.reshape(8, 8, B)).reshape(64, B)


def solve_rebalance(coef, borders, div, x1, qshr, tab, do_rebalance,
                    want_pix=False):
    """One solver pass on given border lines, the plain version of
    kernels B5 and B2: coef int32[64, B]; borders int32[32, B], the
    top, bottom, left and right lines of each block, eight rows each
    (``torch.cat(borders_from_blocks(...))``); tab f32[64, NT].
    Returns (coef', pix' or None) like solve_rebalance_pix.  The inputs
    may be column slices of larger planes (a row chunk)."""
    out = solve_blocks_p(coef, tuple(borders.reshape(4, 8, -1).unbind(0)),
                         div, x1, qshr, tab)
    if do_rebalance:
        out = rebalance_blocks_p(out, div, x1, qshr)
    return _with_pix(out, want_pix)


def solve_rebalance_pix(coef, pix, div, x1, qshr, tab, do_rebalance, hb,
                        wb, want_pix=True):
    """One resident solver pass, the plain version of the kernel:
    coef/pix int32[64, B] (pix = the previous pass's pixels, the source
    of the border lines) -> (coef', pix' or None), where pix' is the
    IDCT of coef' (the next pass's pixels)."""
    borders = borders_from_blocks(pix.reshape(8, 8, -1), hb, wb)
    return solve_rebalance(coef, torch.cat(borders), div, x1, qshr, tab,
                           do_rebalance, want_pix)


# ---------------------------------------------------------------------------
# 10x10 halos and the 3x3 cross-block paths
# ---------------------------------------------------------------------------

def blocks_halo10(pix, hb, wb):
    """int32[8, 8, B] blocks -> int32[10, 10, B]: each block with its
    1-pixel ring (image-edge replicated), gathered from neighbouring
    blocks -- the reference's padded-plane reads (quantsmooth.h:
    2612-2620).  B may hold several hb x wb images back to back.

    Corners: the vertical halo goes on first, so the horizontal gather
    of a neighbour's edge column includes that neighbour's own vertical
    halo rows (at a top-row block not in the left column the top-left
    corner is pixel 7 of the left neighbour)."""
    p4 = pix.reshape(8, 8, -1, hb, wb)
    up = torch.cat([p4[0:1, :, :, :1], p4[7:8, :, :, :-1]], dim=3)
    dn = torch.cat([p4[0:1, :, :, 1:], p4[7:8, :, :, -1:]], dim=3)
    mid = torch.cat([up, p4, dn], dim=0)                  # [10, 8, n, hb, wb]
    left = torch.cat([mid[:, 0:1, ..., :1], mid[:, 7:8, ..., :-1]], dim=4)
    right = torch.cat([mid[:, 0:1, ..., 1:], mid[:, 7:8, ..., -1:]], dim=4)
    return torch.cat([left, mid, right], dim=1).reshape(10, 10, -1)


_W3 = ((1, 2, 1), (2, 4, 2), (1, 2, 1))


def _conv3x3_f(halo):
    """Weighted 3x3 sums over a [10, 10, B] halo in f32 -> [8, 8, B].
    Exact: the inputs are pixels (<= 255) or their products, so every
    partial sum is an integer far below 2^24."""
    out = torch.zeros((8, 8) + tuple(halo.shape[2:]), dtype=F32,
                      device=halo.device)
    for dy in range(3):
        for dx in range(3):
            out = out + float(_W3[dy][dx]) * halo[dy:dy + 8, dx:dx + 8]
    return out


def _regression_f(a, b):
    """The 3x3 (1,2,1)^2 weighted regression of halo b on halo a, both
    f32[10, 10, B] (reference: quantsmooth.h:893-912): (slope, sumA,
    sumB) per pixel, [8, 8, B].  The statistics are exact integers below
    2^24; the slope is an IEEE divide guarded by sAA != 0, clamped to
    +-16."""
    sum_a = _conv3x3_f(a)
    sum_b = _conv3x3_f(b)
    s_aa = _conv3x3_f(a * a) * 16.0 - sum_a * sum_a
    s_ab = _conv3x3_f(a * b) * 16.0 - sum_a * sum_b
    scale = torch.where(s_aa != 0, s_ab / s_aa, 0.0)
    return torch.clamp(scale, -16.0, 16.0), sum_a, sum_b


def joint_yuv_fblocks(chroma_halo, luma2_halo):
    """JOINT_YUV predicted chroma: the regression of chroma on the
    downsampled luma, centred, f32[8, 8, B] ready for fdct_clamp_p
    (reference: quantsmooth.h:893-920)."""
    a = luma2_halo.to(F32)
    scale, sum_a, sum_b = _regression_f(a, chroma_halo.to(F32))
    av = ((a[1:9, 1:9] * 16.0 - sum_a) * scale + sum_b) * 0.0625
    av = torch.clamp_min(av, 0.0) - 128.0
    return torch.clamp_max(av, 128.0)


# fp32(2 * sqrt(fp32(0.5))): the diagonal weight of the LQ shrink, a
# float32 product as the reference computes it (bits 0x3FB504F3)
LQ_C1 = float(np.float32(np.float32(2.0) * np.sqrt(np.float32(0.5))))

# 8-neighbour order of the LQ shrink (quantsmooth.h:1164-1171):
# (dx, dy, diagonal)
_LQ_NEIGHBORS = ((-1, -1, 1), (0, -1, 0), (1, -1, 1),
                 (-1, 0, 0), (1, 0, 0),
                 (-1, 1, 1), (0, 1, 0), (1, 1, 1))


def low_quality_range_p(coef, div):
    """Per-block range estimate on coef int32[64, B] -> f32[B]
    (reference: quantsmooth.h:929-938): a strict fp32 left fold of
    (float)(div * |AC|) with the product in 32-bit int, times 4/sum|AC|
    when that sum is not 0, min 128, roundf."""
    a = coef[1:].abs()                                       # [63, B]
    prod = wrap_i32(div[1:, None].long() * a.long()).to(F32)
    acc = torch.zeros(coef.shape[1:], dtype=F32, device=coef.device)
    for i in range(63):
        acc = acc + prod[i]
    s = wrap_i32(a.long().sum(0)).to(F32)      # integer sum: order-free
    mul = torch.full_like(s, 4.0) / s          # IEEE (never 4.0 / s:
    rng = torch.where(s != 0, acc * mul, acc)  # that is reciprocal * 4)
    return roundf(torch.clamp_max(rng, 128.0))


def low_quality_fblocks(halo, rng):
    """LOW_QUALITY 3x3 weighted gradient shrink (reference:
    quantsmooth.h:1161-1175), fp32 folds in the exact 8-neighbour
    order.  halo int32[10, 10, B]; rng f32[B] from low_quality_range_p.
    Returns the centred f32[8, 8, B] for fdct_clamp_p."""
    p = halo.to(I32)
    a = p[1:9, 1:9]
    rmap = rng[None, None]
    acc0 = torch.zeros(a.shape, dtype=F32, device=a.device)
    accn = torch.zeros(a.shape, dtype=F32, device=a.device)
    for dx, dy, diag in _LQ_NEIGHBORS:
        t0 = (a - p[1 + dy:9 + dy, 1 + dx:9 + dx]).to(F32)
        t = torch.clamp_min(rmap - t0.abs(), 0.0)   # integral: exact
        t = t * t                                   # < 2^24: exact
        aw = (LQ_C1 if diag else 2.0) * t
        acc0 = acc0 + (t0 * t) * aw                 # t0 * t: exact
        accn = accn + aw * aw
    shifted = a.to(F32) - acc0 / accn
    newa = torch.where(accn > 0, c_f32_to_i32(shifted), a)
    return (newa - 128).to(F32)


def fdct_clamp_p(fblocks, coef, div, x1, qshr):
    """FDCT of fblocks f32[8, 8, B], roundf, C cast, then the clamp of
    each coefficient to the interval around the incoming coef
    int32[64, B] (reference: quantsmooth.h:343-562, scalar 551-561)."""
    buf = fdct_float(fblocks).reshape(64, -1)
    a0 = get_orig_coef(coef, div[:, None], x1[:, None], qshr[:, None])
    return interval_clamp(c_f32_to_i32(roundf(buf)), a0, div[:, None])


def solve_fused(coef, halo, image2, div, x1, qshr, tab, flags, do_rebalance,
                want_pix=False):
    """One fused pass on given halos, the plain version of kernels B6
    and B3/B4 (the non-Pallas branch of
    ``jpegqs_tpu.engine.block_pass_p``).

    coef int32[64, B]; halo int32[100, B] the 10x10 pixel neighbourhood
    of each block (``blocks_halo10``, row-major, flattened); image2
    int32[100, B] downsampled-luma halos (JOINT_YUV preamble) or None
    (LOW_QUALITY preamble); tab f32[64, NT] the solver tables, used
    unless ``flags & LOW_QUALITY``.  Returns (coef', pix' or None) like
    solve_rebalance.  The inputs may be column slices of larger planes."""
    B = coef.shape[1]
    halo = halo.reshape(10, 10, B)
    if image2 is not None:
        fb = joint_yuv_fblocks(halo, image2.reshape(10, 10, B))
    elif flags & LOW_QUALITY:
        fb = low_quality_fblocks(halo, low_quality_range_p(coef, div))
    else:
        raise ValueError("a fused pass needs image2 or LOW_QUALITY")
    out = fdct_clamp_p(fb, coef, div, x1, qshr)
    if not flags & LOW_QUALITY:
        # the solver borders are the halo's edge lines
        borders = (halo[0, 1:9], halo[9, 1:9], halo[1:9, 0], halo[1:9, 9])
        out = solve_blocks_p(out, borders, div, x1, qshr, tab)
    if do_rebalance:
        out = rebalance_blocks_p(out, div, x1, qshr)
    return _with_pix(out, want_pix)


def solve_fused_pix(coef, pix, image2, div, x1, qshr, tab, flags,
                    do_rebalance, hb, wb, want_pix=True):
    """One fused pass, the plain version of kernels B3/B4.

    coef, pix int32[64, B] (pix: the previous pass's pixels, the source
    of the 10x10 halo); image2, tab and the result as solve_fused."""
    halo = blocks_halo10(pix.reshape(8, 8, -1), hb, wb)
    return solve_fused(coef, halo.reshape(100, -1), image2, div, x1, qshr,
                       tab, flags, do_rebalance, want_pix)


# ---------------------------------------------------------------------------
# B7: a resident pass over a block range with explicit edges
# ---------------------------------------------------------------------------

def range_halo10(pix, wb, b0, b1, edges):
    """The 10x10 halos int32[100, b1-b0] of blocks [b0, b1) of a plane
    pix int32[64, S] whose rows are wb blocks wide, read from the whole
    plane with the edges given, not derived from the position:
    ``edges = (top_row, bot_row, left_col, right_col)``, the block row
    whose top line replicates (no neighbour above is read) and the one
    whose bottom line does, the block column whose left line replicates
    and the one whose right line does; -1 for none.  Corners as in
    blocks_halo10: the vertical ring goes on first, so at a block whose
    side edge is not flagged the corner is the side neighbour's (on a
    ghost-extended 2-D shard, the ghost column's, which holds the
    diagonal shard's pixels)."""
    top_row, bot_row, left_col, right_col = edges
    dev = pix.device
    b = torch.arange(b0, b1, device=dev)
    row, col = b // wb, b % wb
    t, d = row == top_row, row == bot_row
    lft, rgt = col == left_col, col == right_col
    cols = torch.arange(8, device=dev)

    def column(x, c):
        """Pixel column c of blocks x with their vertical ring -> [10, n]
        (x shares b's row, so b's row edges are its own)."""
        up = pix[torch.where(t, c, 56 + c), torch.where(t, x, x - wb)]
        dn = pix[torch.where(d, 56 + c, c), torch.where(d, x, x + wb)]
        return torch.cat([up[None], pix[cols[:, None] * 8 + c, x[None]],
                          dn[None]])

    mid = torch.stack([column(b, c) for c in range(8)], dim=1)  # [10, 8, n]
    left = torch.where(lft, column(b, 0), column(torch.where(lft, b, b - 1),
                                                 7))
    right = torch.where(rgt, column(b, 7),
                        column(torch.where(rgt, b, b + 1), 0))
    return torch.cat([left[:, None], mid, right[:, None]], dim=1).reshape(
        100, -1)


def solve_range_pix(coef, pix, image2, div, x1, qshr, tab, flags,
                    do_rebalance, wb, b0, b1, edges, coef_out, pix_out=None):
    """One resident pass over blocks [b0, b1) only, the plain version of
    kernel B7: B2 (``image2`` None and no LOW_QUALITY), B3 (``image2``
    given) or B4 (LOW_QUALITY) on the blocks of the range, their
    neighbours read from the whole planes coef/pix int32[64, S] (image2
    int32[100, S]) with the edges of ``edges`` (range_halo10).  Writes
    the range of coef_out (and of pix_out, the IDCT of the result, when
    given) in place; the rest of both is left as it was."""
    s = slice(b0, b1)
    halo = range_halo10(pix, wb, b0, b1, edges)
    want_pix = pix_out is not None
    if image2 is not None or flags & LOW_QUALITY:
        out, new_pix = solve_fused(
            coef[:, s], halo, None if image2 is None else image2[:, s], div,
            x1, qshr, tab, flags, do_rebalance, want_pix)
    else:
        h = halo.reshape(10, 10, -1)
        borders = torch.cat([h[0, 1:9], h[9, 1:9], h[1:9, 0], h[1:9, 9]])
        out, new_pix = solve_rebalance(coef[:, s], borders, div, x1, qshr,
                                       tab, do_rebalance, want_pix)
    coef_out[:, s] = out
    if want_pix:
        pix_out[:, s] = new_pix


# ---------------------------------------------------------------------------
# Downsample and UPSAMPLE_UV in block form (sampling factors 1 and 2)
# ---------------------------------------------------------------------------

def downsample_blocks(pix_l, hb_l, wb_l, hb_c, wb_c, ws, hs):
    """Box-downsample luma blocks int32[8, 8, n*hb_l*wb_l] straight to
    chroma-sized blocks int32[8, 8, n*hb_c*wb_c] (reference:
    quantsmooth.h:2753-2813, even-box path), ws, hs in {1, 2}, for each
    of n images back to back; an odd block grid is edge-extended by its
    last computed line, as the reference's replicate tail does."""
    assert ws in (1, 2) and hs in (1, 2)
    if ws == 1 and hs == 1:
        return pix_l
    p5 = pix_l.reshape(8, 8, -1, hb_l, wb_l)
    n = p5.shape[2]
    rh, rw = 8 // hs, 8 // ws
    if hs == 2 and ws == 2:
        d = (p5[0::2, 0::2] + p5[0::2, 1::2]
             + p5[1::2, 0::2] + p5[1::2, 1::2] + 2) >> 2
    elif hs == 2:
        d = (p5[0::2] + p5[1::2] + 1) >> 1
    else:
        d = (p5[:, 0::2] + p5[:, 1::2] + 1) >> 1
    if hs == 2 and hb_l % 2:
        d = torch.cat([d, d[rh - 1:rh, :, :, -1:].expand(rh, -1, -1, -1,
                                                          -1)], dim=3)
    if ws == 2 and wb_l % 2:
        d = torch.cat([d, d[:, rw - 1:rw, ..., -1:].expand(-1, rw, -1, -1,
                                                            -1)], dim=4)
    t = d.reshape(rh, rw, n, hb_c, hs, wb_c, ws)
    return t.permute(4, 0, 6, 1, 2, 3, 5).reshape(8, 8, n * hb_c * wb_c)


def _lowres_to_hires_blocks(x, hb_l, wb_l, hb_c, wb_c, ws, hs):
    """Broadcast a chroma-grid quantity [8, 8, n*Bc] to the luma grid
    [8, 8, n*Bl]: full-res pixel (y, x) reads low-res (y//hs, x//ws)."""
    rh, rw = 8 // hs, 8 // ws
    t = x.reshape(hs, rh, ws, rw, -1, hb_c, wb_c)
    n = t.shape[4]
    t = t.permute(1, 3, 4, 5, 0, 6, 2).reshape(rh, rw, n, hb_c * hs,
                                               wb_c * ws)
    t = t[:, :, :, :hb_l, :wb_l]
    t = t.repeat_interleave(hs, dim=0).repeat_interleave(ws, dim=1)
    return t.reshape(8, 8, n * hb_l * wb_l)


def upsample_chroma_blocks(chroma_halo, luma2_halo, luma_pix, img_w, img_h,
                           ws, hs, hb_l, wb_l, hb_c, wb_c, row0=0,
                           hb_l_total=None, col0=0, wb_l_total=None):
    """UPSAMPLE_UV in block form (reference: quantsmooth.h:1851-2394,
    2691-2752): chroma_halo / luma2_halo int32[10, 10, n*Bc] (the
    component's pixels and the downsampled luma), luma_pix
    int32[8, 8, n*Bl], n images back to back; ws, hs in {1, 2}.  Returns
    the full-resolution chroma pixels int32[8, 8, n*Bl].

    Per low-res pixel the JOINT regression slope gives offset = chroma -
    luma_ds*scale + 0.5; the output is trunc(luma*scale + offset)
    clamped to 0..255, then the replicate tails: the right edge for the
    first min(8, h1)*hs rows only (the reference quirk), then the
    bottom rows.

    Row-sharded use: hb_l/hb_c are the shard's block rows, ``row0`` its
    first global pixel row and ``hb_l_total`` the image's luma block
    rows.  Both tails stay inside one shard: the bottom tail and its
    source row lie in the last real block row, and the right tail's
    source column in every row of the shard.  On a 2-D grid ``col0`` is
    the shard's first global pixel column and ``wb_l_total`` the image's
    luma block columns: the right tail spans less than a block column and
    its source column lies at most one block column to its left, so it
    stays inside the shard when the shard has two luma block columns or
    more (the engine's narrow-plane fallback sees to it)."""
    w1 = (img_w + ws - 1) // ws
    h1 = (img_h + hs - 1) // hs
    if hb_l_total is None:
        hb_l_total = hb_l
    if wb_l_total is None:
        wb_l_total = wb_l
    a = luma2_halo.to(F32)
    b = chroma_halo.to(F32)
    scale, _, _ = _regression_f(a, b)
    # offset = chroma - luma_ds*scale + 0.5 (quantsmooth.h:2367)
    offset = (b[1:9, 1:9] - a[1:9, 1:9] * scale) + 0.5
    scale_hi = _lowres_to_hires_blocks(scale, hb_l, wb_l, hb_c, wb_c, ws,
                                       hs)
    offset_hi = _lowres_to_hires_blocks(offset, hb_l, wb_l, hb_c, wb_c,
                                        ws, hs)
    val = luma_pix.to(F32) * scale_hi + offset_hi
    out = torch.clamp(torch.trunc(val), 0, 255).to(I32)

    o5 = out.reshape(8, 8, -1, hb_l, wb_l)
    hh, ww = hb_l_total * 8, wb_l_total * 8
    dev = out.device
    row_g = (torch.arange(8, device=dev).reshape(8, 1, 1, 1, 1)
             + 8 * torch.arange(hb_l, device=dev).reshape(1, 1, 1, hb_l, 1)
             + row0)
    col_g = (torch.arange(8, device=dev).reshape(1, 8, 1, 1, 1)
             + 8 * torch.arange(wb_l, device=dev).reshape(1, 1, 1, 1, wb_l))
    if col0:
        col_g = col_g + col0
    if w1 * ws < ww:
        # right-edge replicate from col w1*ws-1, first min(8,h1)*hs rows
        # only (reference quirk, quantsmooth.h:1861 + 2390-2393); a shard
        # that does not hold that column masks its result away
        rep_rows = min(min(8, h1) * hs, min(h1 * hs, hh))
        sc = w1 * ws - 1
        lbc = min(max(sc // 8 - col0 // 8, 0), wb_l - 1)
        src_col = o5[:, sc % 8, :, :, lbc]                      # [8, n, hb_l]
        mask = (row_g < rep_rows) & (col_g >= w1 * ws)
        o5 = torch.where(mask, src_col[:, None, :, :, None], o5)
    if h1 * hs < hh:
        # bottom replicate from row h1*hs-1 (quantsmooth.h:2729-2730); a
        # shard that does not hold that row masks its result away
        sr = h1 * hs - 1
        lb = min(max(sr // 8 - row0 // 8, 0), hb_l - 1)
        src_row = o5[sr % 8, :, :, lb]                          # [8, n, wb_l]
        mask = row_g >= h1 * hs
        o5 = torch.where(mask, src_row[None, :, :, None, :], o5)
    return o5.reshape(8, 8, -1)


def fdct_round_i16(fblocks, hb, wb):
    """Luma-size coefficients of upsampled chroma: float FDCT of the
    centred blocks f32[8, 8, B], roundf, C cast, int16 [hb, wb, 64]
    (reference: quantsmooth.h:2732-2750)."""
    c = c_f32_to_i32(roundf(fdct_float(fblocks).reshape(64, hb * wb)))
    # contiguous on the device: the host copy is then one plain memcpy
    return c.to(I16).T.contiguous().reshape(hb, wb, 64)


def upsample_fdct_blocks(chroma_halo, luma2_halo, luma_pix, img_w, img_h,
                         ws, hs, hb_l, wb_l, hb_c, wb_c, row0=0,
                         hb_l_total=None, col0=0, wb_l_total=None):
    """UPSAMPLE_UV of one chroma component in block form, the plain
    version of the upsample_fdct kernel (csrc/solver.cu): the arguments of
    upsample_chroma_blocks (the halos as [100, n*Bc] or [10, 10, n*Bc],
    the luma pixels as [64, n*Bl] or [8, 8, n*Bl]), its pixels centred,
    then fdct_round_i16 -> int16[n*Bl, 64]."""
    up = upsample_chroma_blocks(
        chroma_halo.reshape(10, 10, -1), luma2_halo.reshape(10, 10, -1),
        luma_pix.reshape(8, 8, -1), img_w, img_h, ws, hs, hb_l, wb_l, hb_c,
        wb_c, row0, hb_l_total, col0, wb_l_total)
    return fdct_round_i16((up - CENTERJSAMPLE).to(F32),
                          up.shape[-1] // wb_l, wb_l).reshape(-1, 64)


# ---------------------------------------------------------------------------
# Layout conversions
# ---------------------------------------------------------------------------

def edge_pad1(plane):
    """[H, W] -> [H+2, W+2], the border replicated (numpy's "edge")."""
    p = torch.cat([plane[:1], plane, plane[-1:]], dim=0)
    return torch.cat([p[:, :1], p, p[:, -1:]], dim=1)


def pix_to_plane(pix, hb, wb):
    """pix int32[8, 8, B] -> padded plane int32[hb*8+2, wb*8+2] (the
    reference scratch plane, quantsmooth.h:2612-2620)."""
    interior = pix.reshape(8, 8, hb, wb).permute(2, 0, 3, 1).reshape(
        hb * 8, wb * 8)
    return edge_pad1(interior)


def plane_to_fblocks_p(fplane, hb, wb):
    """Unpadded plane [hb*8, wb*8] -> planar blocks [8, 8, B]."""
    return fplane.reshape(hb, 8, wb, 8).permute(1, 3, 0, 2).reshape(
        8, 8, hb * wb)


def padded_plane_to_halo10(padded, hb, wb):
    """Padded (+1 px) plane -> [10, 10, B] halos (image2 of the plane
    path, computed once per image)."""
    interior = padded[1:hb * 8 + 1, 1:wb * 8 + 1]
    return blocks_halo10(plane_to_fblocks_p(interior, hb, wb).to(I32),
                         hb, wb)
