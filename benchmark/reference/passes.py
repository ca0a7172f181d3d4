"""The smoothing passes in plain torch: integer math in int32 with C's
two's-complement wraparound (the rebalance in int64), every
floating-point product and sum its own torch operation in the float
type of its inputs, so that each is rounded once in the scalar order of
quantsmooth.h, and the weighted sums as explicit left folds (never
``torch.sum``, whose order is not specified).  No matmul or convolution:
they may run in TF32 or reassociate.

Layouts: pixel blocks [8, 8, B]; halos [10, 10, B]; coefficients
[64, B] (natural order); B blocks of one hb x wb image, row-major.
"""

from __future__ import annotations

import numpy as np
import torch

from .tables import LOW_QUALITY, NATURAL_ORDER, ZIGZAG_REFRESH

I32 = torch.int32
INT32_MIN = -(1 << 31)
TWO31 = 2147483648.0

# blocks a sweep or a fused pass works on at once: bounds the memory of
# the [terms, group, blocks] temporaries (about 30 KB a block at 242
# terms) while keeping the launches few
CHUNK = 1 << 18


# -- C arithmetic --------------------------------------------------------

def roundf(x):
    """C roundf: half away from zero, from the exact split into integer
    and fraction."""
    t = torch.trunc(x)
    f = x - t
    one = torch.ones((), dtype=x.dtype, device=x.device)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return (t + torch.where(f >= 0.5, one, zero)) - torch.where(
        f <= -0.5, one, zero)


def c_to_i32(x):
    """C's (int) cast of a float on x86: truncation; NaN and values out
    of range give INT32_MIN."""
    t = torch.trunc(x)
    ok = (t >= -TWO31) & (t < TWO31)
    safe = torch.where(ok, t, torch.zeros_like(t))
    return torch.where(ok, safe.to(I32),
                       torch.full_like(safe, INT32_MIN, dtype=I32))


def wrap_i32(x):
    """int64 -> int32 with two's-complement wraparound."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(I32)


def orig_coef(coef, div, x1, qshr):
    """The nearest dequantized lattice point (quantsmooth.h:332-336)."""
    c = coef.to(I32)
    a0 = ((x1 * c) >> 16) + c
    a0 = ((-a0) * qshr + 0x4000) >> 15
    return a0 * div


def interval_clamp(v, a0, div):
    """Clamp to the quantization interval around a0 (555-560)."""
    d0 = (div - 1) >> 1
    d1 = div >> 1
    hi = a0 + torch.where(a0 < 0, d1, d0)
    lo = a0 - torch.where(a0 > 0, d1, d0)
    return torch.maximum(torch.minimum(v, hi), lo)


# -- DCTs ----------------------------------------------------------------

def _islow_pass(x):
    """libjpeg's islow butterfly in int32 (idct.h:59-89)."""
    z2 = x[2]; z3 = x[6]
    z1 = (z2 + z3) * 4433
    t2 = z1 - z3 * 15137
    t3 = z1 + z2 * 6270
    z2 = x[0]; z3 = x[4]
    t0 = (z2 + z3) << 13
    t1 = (z2 - z3) << 13
    t10 = t0 + t3; t13 = t0 - t3
    t11 = t1 + t2; t12 = t1 - t2
    t0 = x[7]; t1 = x[5]; t2 = x[3]; t3 = x[1]
    z1 = t0 + t3; z2 = t1 + t2
    z3 = t0 + t2; z4 = t1 + t3
    z5 = (z3 + z4) * 9633
    t0 = t0 * 2446; t1 = t1 * 16819
    t2 = t2 * 25172; t3 = t3 * 12299
    z1 = z1 * 7373; z2 = z2 * 20995
    z3 = z3 * 16069; z4 = z4 * 3196
    z3 = z5 - z3; z4 = z5 - z4
    t0 = t0 + (z3 - z1)
    t1 = t1 + (z4 - z2)
    t2 = t2 + (z3 - z2)
    t3 = t3 + (z4 - z1)
    return [t10 + t3, t11 + t2, t12 + t1, t13 + t0,
            t13 - t0, t12 - t1, t11 - t2, t10 - t3]


def idct_islow(coef):
    """int32[8, 8, B] -> pixels int32[8, 8, B] in 0..255 (idct.h:468-539)."""
    c = coef.to(I32)
    cols = _islow_pass([c[i] for i in range(8)])
    ws = torch.stack([(v + (1 << 10)) >> 11 for v in cols])
    rows = _islow_pass([ws[:, i] for i in range(8)])
    return torch.stack([torch.clamp((v + (257 << 17)) >> 18, 0, 255)
                        for v in rows], dim=1)


def idct64(coef):
    """Coefficients int32[64, B] -> pixels int32[64, B]."""
    return idct_islow(coef.reshape(8, 8, -1)).reshape(64, -1)


_K = {k: float(np.float32(k)) for k in (
    "0.541196100", "0.765366865", "1.847759065", "1.175875602",
    "0.298631336", "2.053119869", "3.072711026", "1.501321110",
    "0.899976223", "2.562915447", "1.961570560", "0.390180644")}


def _fdct_pass(x, scale=None):
    """The 8-point float FDCT butterfly in scalar order (idct.h:608-628)."""
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
    out = [o0, t7 - (z1 + z4), o2, t6 - (z2 + z3), o4, t5 - (z2 + z4), o6,
           t4 - (z1 + z3)]
    return out if scale is None else [o * scale for o in out]


def fdct(fblocks):
    """Float FDCT of [8, 8, B] in its own float type: columns, then rows
    times 0.125 as a separate rounded step (idct.h:606-923)."""
    ws = torch.stack(_fdct_pass([fblocks[i] for i in range(8)]))
    rows = _fdct_pass([ws[:, i] for i in range(8)], scale=0.125)
    return torch.stack(rows, dim=1)


# -- the sweep and the rebalance -----------------------------------------

def _groups():
    """Refresh groups of the k = 63..1 sweep: between two refresh points
    no pixel changes, so the steps of a group are independent."""
    seq = NATURAL_ORDER[63:0:-1]
    groups, cur = [], []
    for i in seq:
        if ZIGZAG_REFRESH[i] and cur:
            groups.append(tuple(cur))
            cur = []
        cur.append(int(i))
    groups.append(tuple(cur))
    return tuple(groups)


GROUPS = _groups()


def borders_from_blocks(pix, hb, wb):
    """Border lines of each block from its neighbours, the image edge
    replicated (quantsmooth.h:1396-1401, 2612-2620): pix int32[8, 8, B]
    -> int32[32, B] (top, bottom, left, right)."""
    p = pix.reshape(8, 8, hb, wb)
    top = torch.cat([p[0, :, :1], p[7, :, :-1]], dim=1)
    bottom = torch.cat([p[0, :, 1:], p[7, :, -1:]], dim=1)
    left = torch.cat([p[:, 0, :, :1], p[:, 7, :, :-1]], dim=2)
    right = torch.cat([p[:, 0, :, 1:], p[:, 7, :, -1:]], dim=2)
    return torch.cat([x.reshape(8, -1) for x in (top, bottom, left, right)])


def _diffs(pix, borders, nt, ft):
    """Difference terms in the scalar fold order -> ft[nt, B]."""
    b = pix
    B = b.shape[-1]
    bt, bb, bl, br = borders.reshape(4, 8, B).unbind(0)
    parts = [(b[:, :7] - b[:, 1:]).reshape(56, B),
             torch.cat([b[0] - bt, b[7] - bb, b[:, 0] - bl, b[:, 7] - br]),
             (b[:7] - b[1:]).reshape(56, B)]
    if nt > 144:
        d1 = b[:7, :7] - b[1:, 1:]
        d2 = b[:7, 1:] - b[1:, :7]
        parts.append(torch.stack([d1, d2], dim=2).reshape(98, B))
    return torch.cat(parts).to(ft)


def sweep(coef, borders, div, x1, qshr, tab):
    """The k = 63..1 reverse-zigzag sweep (quantsmooth.h:1403-1565) on
    coef int32[64, B] with border lines int32[32, B]; tab [64, NT] holds
    the weights in the float type of the pass."""
    B = coef.shape[1]
    ft, nt = tab.dtype, tab.shape[1]
    coef = coef.clone()
    for g in GROUPS:
        idx = torch.tensor(g, device=coef.device)
        d = _diffs(idct_islow(coef.reshape(8, 8, B)), borders, nt, ft)
        rng = (div[idx] * 2).to(ft)
        t = torch.clamp_min(rng[None, :, None] - d.abs()[:, None, :], 0)
        t = t * t                                     # [nt, m, B]
        u = d[:, None, :] * t
        w = tab[idx].T[:, :, None] * t
        uw, ww = u * w, w * w
        a2 = torch.zeros(uw.shape[1:], dtype=ft, device=coef.device)
        a3 = torch.zeros_like(a2)
        for j in range(nt):                           # strict left folds
            a2 = a2 + uw[j]
            a3 = a3 + ww[j]
        delta = c_to_i32(roundf(a2 / a3))
        c1 = coef[idx]
        dv = div[idx, None]
        a0 = orig_coef(c1, dv, x1[idx, None], qshr[idx, None])
        # c1 - delta wraps in C when delta is INT32_MIN (a3 == 0)
        moved = interval_clamp(wrap_i32(c1.long() - delta.long()), a0, dv)
        coef[idx] = torch.where(delta != 0, moved, c1)
    return coef


def rebalance(coef, div, x1, qshr):
    """AC energy restore in int64 with C's truncations, DC kept
    (quantsmooth.h:1823-1848)."""
    c_ac = coef[1:]
    d_ac = div[1:, None]
    a0 = orig_coef(c_ac, d_ac, x1[1:, None], qshr[1:, None])
    c64, a64 = c_ac.long(), a0.long()
    m0 = (c64 * a64).sum(0)
    m1 = (a64 * a64).sum(0)
    num = (m1 << 13) + (m0 >> 1)
    safe = torch.where(m0 == 0, torch.ones_like(m0), m0)
    mul = wrap_i32(torch.div(num, safe, rounding_mode="trunc"))
    prod = wrap_i32(c64 * mul.long()[None])
    add = interval_clamp(((prod.long() + 0x1000) >> 13).to(I32), a0, d_ac)
    return torch.cat([coef[:1], torch.where((m1 > m0)[None], add, c_ac)])


# -- halos and the fused preambles ---------------------------------------

def halo10(pix, hb, wb):
    """Each block with its 1-pixel ring, the image edge replicated:
    int32[8, 8, B] -> int32[10, 10, B]; the vertical ring goes on first,
    so a corner is the side neighbour's vertical ring pixel."""
    p = pix.reshape(8, 8, hb, wb)
    up = torch.cat([p[0:1, :, :1], p[7:8, :, :-1]], dim=2)
    dn = torch.cat([p[0:1, :, 1:], p[7:8, :, -1:]], dim=2)
    mid = torch.cat([up, p, dn], dim=0)
    left = torch.cat([mid[:, 0:1, :, :1], mid[:, 7:8, :, :-1]], dim=3)
    right = torch.cat([mid[:, 0:1, :, 1:], mid[:, 7:8, :, -1:]], dim=3)
    return torch.cat([left, mid, right], dim=1).reshape(10, 10, -1)


_W3 = ((1, 2, 1), (2, 4, 2), (1, 2, 1))


def _conv3x3(halo):
    """The (1, 2, 1)^2 weighted 3x3 sums over [10, 10, B] -> [8, 8, B]."""
    out = torch.zeros((8, 8) + tuple(halo.shape[2:]), dtype=halo.dtype,
                      device=halo.device)
    for dy in range(3):
        for dx in range(3):
            out = out + float(_W3[dy][dx]) * halo[dy:dy + 8, dx:dx + 8]
    return out


def regression(a, b):
    """The weighted 3x3 regression of halo b on halo a (quantsmooth.h:
    893-912): (slope clamped to +-16, sum a, sum b), [8, 8, B]."""
    sum_a = _conv3x3(a)
    sum_b = _conv3x3(b)
    s_aa = _conv3x3(a * a) * 16.0 - sum_a * sum_a
    s_ab = _conv3x3(a * b) * 16.0 - sum_a * sum_b
    scale = torch.where(s_aa != 0, s_ab / s_aa, 0.0)
    return torch.clamp(scale, -16.0, 16.0), sum_a, sum_b


def joint_fblocks(chroma_halo, luma2_halo, ft):
    """JOINT_YUV: the chroma predicted from the downsampled luma,
    centred, ft[8, 8, B] (quantsmooth.h:893-920)."""
    a = luma2_halo.to(ft)
    scale, sum_a, sum_b = regression(a, chroma_halo.to(ft))
    av = ((a[1:9, 1:9] * 16.0 - sum_a) * scale + sum_b) * 0.0625
    return torch.clamp_max(torch.clamp_min(av, 0.0) - 128.0, 128.0)


# fp32(2 * sqrt(fp32(0.5))), the diagonal weight of the LQ shrink
LQ_C1 = float(np.float32(np.float32(2.0) * np.sqrt(np.float32(0.5))))
_LQ_NEIGHBOURS = ((-1, -1, 1), (0, -1, 0), (1, -1, 1), (-1, 0, 0),
                  (1, 0, 0), (-1, 1, 1), (0, 1, 0), (1, 1, 1))


def lq_range(coef, div, ft):
    """Per-block range estimate of the LOW_QUALITY preamble
    (quantsmooth.h:929-938) -> ft[B]."""
    a = coef[1:].abs()
    prod = wrap_i32(div[1:, None].long() * a.long()).to(ft)
    acc = torch.zeros(coef.shape[1:], dtype=ft, device=coef.device)
    for i in range(63):
        acc = acc + prod[i]
    s = wrap_i32(a.long().sum(0)).to(ft)
    mul = torch.full_like(s, 4.0) / s
    return roundf(torch.clamp_max(torch.where(s != 0, acc * mul, acc),
                                  128.0))


def lq_fblocks(halo, rng):
    """The LOW_QUALITY 3x3 weighted gradient shrink (quantsmooth.h:
    1161-1175): halo int32[10, 10, B], rng [B] -> centred [8, 8, B]."""
    ft = rng.dtype
    a = halo[1:9, 1:9]
    acc0 = torch.zeros(a.shape, dtype=ft, device=a.device)
    accn = torch.zeros_like(acc0)
    for dx, dy, diag in _LQ_NEIGHBOURS:
        t0 = (a - halo[1 + dy:9 + dy, 1 + dx:9 + dx]).to(ft)
        t = torch.clamp_min(rng[None, None] - t0.abs(), 0.0)
        t = t * t
        aw = (LQ_C1 if diag else 2.0) * t
        acc0 = acc0 + (t0 * t) * aw
        accn = accn + aw * aw
    moved = c_to_i32(a.to(ft) - acc0 / accn)
    return (torch.where(accn > 0, moved, a) - 128).to(ft)


def fdct_clamp(fblocks, coef, div, x1, qshr):
    """FDCT, roundf, C cast, then the clamp of each coefficient to the
    interval around the incoming one (quantsmooth.h:343-562)."""
    v = c_to_i32(roundf(fdct(fblocks).reshape(64, -1)))
    a0 = orig_coef(coef, div[:, None], x1[:, None], qshr[:, None])
    return interval_clamp(v, a0, div[:, None])


def _pass_chunk(coef, nbhd, image2, div, x1, qshr, tab, flags, ft,
                do_rebalance):
    """One pass over a chunk of blocks: with a halo ``nbhd``
    int32[100, n] the fused pass (the JOINT_YUV preamble when image2 is
    given, else the LOW_QUALITY one; the sweep unless LOW_QUALITY), with
    border lines int32[32, n] the sweep alone; then the rebalance."""
    n = coef.shape[1]
    if nbhd.shape[0] == 100:
        halo = nbhd.reshape(10, 10, n)
        if image2 is not None:
            fb = joint_fblocks(halo, image2.reshape(10, 10, n), ft)
        else:
            fb = lq_fblocks(halo, lq_range(coef, div, ft))
        coef = fdct_clamp(fb, coef, div, x1, qshr)
        nbhd = torch.cat([halo[0, 1:9], halo[9, 1:9], halo[1:9, 0],
                          halo[1:9, 9]])
    if not flags & LOW_QUALITY:
        coef = sweep(coef, nbhd, div, x1, qshr, tab)
    if do_rebalance:
        coef = rebalance(coef, div, x1, qshr)
    return coef


def smooth_pass(coef, pix, image2, div, x1, qshr, tab, flags, ft,
                do_rebalance, hb, wb):
    """One pass over a component: coef, pix int32[64, B] (pix: the
    previous pass's pixels); image2 int32[100, B] or None; tab the
    sweep's weights (None under LOW_QUALITY).  Fused (a 10x10 halo) when
    image2 is given or under LOW_QUALITY, else on border lines.  Runs in
    chunks of CHUNK blocks.  Returns the new coefficients int32[64, B]."""
    fused = image2 is not None or bool(flags & LOW_QUALITY)
    px = pix.reshape(8, 8, -1)
    nbhd = (halo10(px, hb, wb).reshape(100, -1) if fused
            else borders_from_blocks(px, hb, wb))
    out = []
    for s0 in range(0, coef.shape[1], CHUNK):
        s = slice(s0, s0 + CHUNK)
        out.append(_pass_chunk(coef[:, s], nbhd[:, s],
                               None if image2 is None else image2[:, s],
                               div, x1, qshr, tab, flags, ft, do_rebalance))
    return torch.cat(out, dim=1)


# -- downsample and UPSAMPLE_UV in block form ----------------------------

def downsample_blocks(pix_l, hb_l, wb_l, hb_c, wb_c, ws, hs):
    """Box-downsample luma blocks int32[8, 8, Bl] to chroma-size blocks
    int32[8, 8, Bc], ws, hs in {1, 2} (quantsmooth.h:2753-2813); an odd
    block grid is extended by its last computed line."""
    if ws == 1 and hs == 1:
        return pix_l
    p = pix_l.reshape(8, 8, hb_l, wb_l)
    rh, rw = 8 // hs, 8 // ws
    if hs == 2 and ws == 2:
        d = (p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2]
             + p[1::2, 1::2] + 2) >> 2
    elif hs == 2:
        d = (p[0::2] + p[1::2] + 1) >> 1
    else:
        d = (p[:, 0::2] + p[:, 1::2] + 1) >> 1
    if hs == 2 and hb_l % 2:
        d = torch.cat([d, d[rh - 1:rh, :, -1:].expand(rh, -1, -1, -1)],
                      dim=2)
    if ws == 2 and wb_l % 2:
        d = torch.cat([d, d[:, rw - 1:rw, :, -1:].expand(-1, rw, -1, -1)],
                      dim=3)
    t = d.reshape(rh, rw, hb_c, hs, wb_c, ws)
    return t.permute(3, 0, 5, 1, 2, 4).reshape(8, 8, hb_c * wb_c)


def _to_luma_grid(x, hb_l, wb_l, hb_c, wb_c, ws, hs):
    """A chroma-grid quantity [8, 8, Bc] on the luma grid [8, 8, Bl]:
    luma pixel (y, x) reads chroma pixel (y // hs, x // ws)."""
    rh, rw = 8 // hs, 8 // ws
    t = x.reshape(hs, rh, ws, rw, hb_c, wb_c)
    t = t.permute(1, 3, 4, 0, 5, 2).reshape(rh, rw, hb_c * hs, wb_c * ws)
    t = t[:, :, :hb_l, :wb_l]
    t = t.repeat_interleave(hs, dim=0).repeat_interleave(ws, dim=1)
    return t.reshape(8, 8, hb_l * wb_l)


def upsample_chroma(chroma_halo, luma2_halo, luma_pix, img_w, img_h, ws, hs,
                    hb_l, wb_l, hb_c, wb_c, ft):
    """UPSAMPLE_UV in block form (quantsmooth.h:1851-2394, 2691-2752):
    the chroma component's halos and the downsampled luma's int32[10, 10,
    Bc], the luma pixels int32[8, 8, Bl] -> full-resolution chroma pixels
    int32[8, 8, Bl].  Per chroma pixel the regression slope gives offset
    = chroma - luma_ds * scale + 0.5; the output is trunc(luma * scale +
    offset) clamped to 0..255, then the replicate tails: the right edge
    for the first min(8, h1) * hs rows only (the reference's quirk), then
    the bottom rows."""
    w1 = (img_w + ws - 1) // ws
    h1 = (img_h + hs - 1) // hs
    a = luma2_halo.to(ft)
    b = chroma_halo.to(ft)
    scale, _, _ = regression(a, b)
    offset = (b[1:9, 1:9] - a[1:9, 1:9] * scale) + 0.5
    grid = (hb_l, wb_l, hb_c, wb_c, ws, hs)
    val = luma_pix.to(ft) * _to_luma_grid(scale, *grid) \
        + _to_luma_grid(offset, *grid)
    out = torch.clamp(torch.trunc(val), 0, 255).to(I32)
    o = out.reshape(8, 8, hb_l, wb_l)
    dev = out.device
    row = (torch.arange(8, device=dev).reshape(8, 1, 1, 1)
           + 8 * torch.arange(hb_l, device=dev).reshape(1, 1, hb_l, 1))
    col = (torch.arange(8, device=dev).reshape(1, 8, 1, 1)
           + 8 * torch.arange(wb_l, device=dev).reshape(1, 1, 1, wb_l))
    hh, ww = hb_l * 8, wb_l * 8
    if w1 * ws < ww:
        rep_rows = min(min(8, h1) * hs, min(h1 * hs, hh))
        sc = w1 * ws - 1
        src = o[:, sc % 8, :, sc // 8]                        # [8, hb_l]
        mask = (row < rep_rows) & (col >= w1 * ws)
        o = torch.where(mask, src[:, None, :, None], o)
    if h1 * hs < hh:
        sr = h1 * hs - 1
        src = o[sr % 8, :, sr // 8]                           # [8, wb_l]
        o = torch.where(row >= h1 * hs, src[None, :, None, :], o)
    return o.reshape(8, 8, -1)
