"""The premises of the Hopper design of B4 (``solve_lq_pix_kernel`` in
jpegqs_tpu_torch/csrc/solver.cu), each held against the plain version on
the CPU: numpy and torch only, no JAX.

- (a) the rebalance's u64 sums m0 / m1 split over the 8 lanes of a block
  (lane r: coefficients 8r..8r+7, the DC left out) and combined with xor
  shuffles equal the sequential sums, wraparound included;
- (b) the fp32 difference of two pixels, each converted to fp32, equals
  the conversion of their int difference, for every pair in 0..255;
- (c) a torch emulation of the kernel's maps -- the 16-block CTA tile, the
  staged window (each tile block's rows with the row above and the row
  below, the tile's two outside neighbours' columns), the halo rows built
  from it with each block's own edge flags, the range fold handed from
  lane to lane, the lane-split integer sum and rebalance sums -- gives
  ``planar.solve_fused_pix``'s LOW_QUALITY output.  What the kernel does
  not stage is NaN here, so a read of it shows.  Two more sources, as
  ``solve_lq_kernel`` takes them: a block range of a shard (B7-lq: tiles
  from b0, not a multiple of 16, the edges from the descriptor's
  (top_row, bot_row), ghost and dead rows NaN where an edge forbids their
  reading) against ``planar.solve_range_pix``, and given halos (B6-lq:
  each block's 100 rows staged through the kernel's map, from column-slice
  views of n blocks, n no multiple of 16) against ``planar.solve_fused``;
- (d) the staging map covers the tile once (thread t: block j, rows k0,
  k0 + 8, ..., k0 + 56), a warp taking 8 consecutive blocks of 4
  consecutive planar rows at each step, and the shared-memory pitches give
  a lane group's row and column accesses 32 different banks; so does the
  given halo's padded row pitch.

The design's optional pair-symmetry lever is not built, so nothing here
tests it.  The kernel's constants are read from solver.cu.
"""

import os
import re

import numpy as np
import pytest
import torch

from jpegqs_tpu_torch import DIAGONALS, LOW_QUALITY
from jpegqs_tpu_torch.ops import planar
from jpegqs_tpu_torch.ops.dct import idct_islow
from jpegqs_tpu_torch.ops.quant import (c_f32_to_i32, get_orig_coef,
                                        interval_clamp, make_quant_tables,
                                        roundf, wrap_i32)

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "jpegqs_tpu_torch", "csrc", "solver.cu")
FLAGS = LOW_QUALITY | DIAGONALS
F32 = torch.float32


def _constants():
    text = open(SOURCE).read()
    val = {name: int(v) for name, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", text)}
    lanes, pitch = val["kLqLanes"], val["kLqPitch"]
    return {"threads": val["kThreads"], "lanes": lanes,
            "tile": val["kThreads"] // lanes, "pitch": pitch,
            "mat": 8 * pitch, "halo": val["kLqHalo"], "row": val["kLqRow"],
            "given": val["kLqGiven"]}


K = _constants()
LANES, TILE = K["lanes"], K["tile"]


def _butterfly(parts, mask):
    """Lane partials [LANES, ...] combined as the xor shuffles do: every
    lane adds its partner's value at distance 1, 2, 4, wrapping at mask."""
    lanes = np.arange(LANES)
    for off in (1, 2, 4):
        parts = (parts + parts[lanes ^ off]) & mask
    return parts


# ---------------------------------------------------------------------------
# (a) lane-split u64 sums


@pytest.mark.parametrize("seed", [0, 1])
def test_lane_split_rebalance_sums_equal_sequential(seed):
    rng = np.random.default_rng(seed)
    B = 257
    c = rng.integers(-32768, 32768, (64, B)).astype(np.int64)
    a0 = rng.integers(-2 ** 31, 2 ** 31, (64, B)).astype(np.int64)
    a0[:, :3] = -2 ** 31                                 # extreme lattice
    m0_terms = (c * a0).astype(np.uint64)                # (u64)(c * a0)
    m1_terms = (a0 * a0).astype(np.uint64)               # < 2^62 each
    m0_terms[0] = m1_terms[0] = 0                        # the DC is kept
    seq0 = np.zeros(B, np.uint64)
    seq1 = np.zeros(B, np.uint64)
    for k in range(1, 64):                               # the scalar order
        seq0 = seq0 + m0_terms[k]
        seq1 = seq1 + m1_terms[k]
    mask = np.uint64(2 ** 64 - 1)
    lanes0 = _butterfly(m0_terms.reshape(LANES, 8, B).sum(1), mask)
    lanes1 = _butterfly(m1_terms.reshape(LANES, 8, B).sum(1), mask)
    assert (lanes0 == seq0).all() and (lanes1 == seq1).all()
    # the sums wrapped: m1 is a sum of 63 squares near 2^62
    assert (seq1 < m1_terms[1:].max(0)).any()
    # the signed view the kernel compares is the plain version's int64 sum
    plain0 = torch.from_numpy(m0_terms.view(np.int64)).sum(0).numpy()
    assert (lanes0[0].view(np.int64) == plain0).all()


# ---------------------------------------------------------------------------
# (b) differences of converted pixels


def test_difference_of_converted_pixels_is_exact():
    a, nb = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    got = a.astype(np.float32) - nb.astype(np.float32)
    want = (a - nb).astype(np.float32)
    assert (got.view(np.int32) == want.view(np.int32)).all()   # +0, not -0


# ---------------------------------------------------------------------------
# (c) the kernel's maps, emulated


def staged_window(pix, wb, b0=0, b1=None):
    """f32[ntiles, TILE + 2, 10, 8]: for tile T (blocks b0 + 16 T ..., up
    to b1) and its block jj (index jj + 1, jj = -1..TILE) row 0 the block
    above's row 7, rows 1..8 the block's own, row 9 the block below's row
    0; of jj = -1 only column 7, of jj = TILE only column 0; NaN where the
    kernel stages nothing or reads past the plane (and where pix, given as
    floats, is NaN)."""
    S = pix.shape[1]
    b1 = S if b1 is None else b1
    ntiles = -(-(b1 - b0) // TILE)
    T = np.arange(ntiles)[:, None, None, None]
    jj = np.arange(-1, TILE + 1)[None, :, None, None]
    R = np.arange(10)[None, None, :, None]
    c = np.arange(8)[None, None, None, :]
    base = b0 + T * TILE + jj
    blk = np.where(R == 0, base - wb, np.where(R == 9, base + wb, base))
    k = np.where(R == 0, 56 + c, np.where(R == 9, c, (R - 1) * 8 + c))
    staged = (((jj >= 0) & (jj < TILE)) | ((jj == -1) & (c == 7))
              | ((jj == TILE) & (c == 0)))
    ok = staged & (blk >= 0) & (blk < S)
    vals = pix.to(F32)[torch.from_numpy(np.where(ok, k, 0)),
                       torch.from_numpy(np.where(ok, blk, 0))]
    return torch.where(torch.from_numpy(ok), vals, torch.tensor(np.nan))


def position_edges(b, hb, wb):
    """B4's edge flags (top, bottom, left, right) of blocks b: from each
    block's place in its own hb x wb image."""
    loc = b % (hb * wb)
    by, bx = loc // wb, loc % wb
    return by == 0, by == hb - 1, bx == 0, bx == wb - 1


def descriptor_edges(b, wb, edges):
    """B7's edge flags of blocks b: the rows of the descriptor's
    (top_row, bot_row), the grid's columns."""
    by, bx = b // wb, b % wb
    return by == edges[0], by == edges[1], bx == 0, bx == wb - 1


def halo_from_window(v, b, b0, flags):
    """f32[10, 10, n]: the halos of blocks b (of tiles from b0) built from
    the staged window as their lanes do: row R of the block's matrix (at a
    flagged top / bottom edge its own first / last row), the ring from the
    neighbours' row R or the block's own at a flagged side edge."""
    T, j = (b - b0) // TILE, (b - b0) % TILE
    et, ed, el, er = flags
    rows = []
    for hr in range(10):
        R = torch.where(et & (hr == 0), 1, torch.where(ed & (hr == 9), 8, hr))
        own = v[T, j + 1, R]                                     # [n, 8]
        left = torch.where(el, own[:, 0], v[T, j, R, 7])
        right = torch.where(er, own[:, 7], v[T, j + 2, R, 0])
        rows.append(torch.cat([left[:, None], own, right[:, None]], 1))
    return torch.stack(rows).permute(0, 2, 1)                    # [10, 10, n]


def range_lanes(coef, div):
    """lq_range as the lanes run it: the fold over k = 0..63 with the DC's
    term +0, stage after stage; the integer sum from lane partials."""
    a = coef.long().abs()
    a[0] = 0
    p = wrap_i32(div[:, None].long() * a).to(F32)
    acc = torch.zeros(coef.shape[1], dtype=F32)
    for st in range(LANES):                    # lane st's terms, in order
        for k in range(8):
            acc = acc + p[8 * st + k]
    parts = _butterfly(a.reshape(LANES, 8, -1).sum(1).numpy(), 2 ** 32 - 1)
    assert (parts == parts[0]).all()
    s = wrap_i32(torch.from_numpy(parts[0])).to(F32)
    rng = torch.where(s != 0, acc * (torch.full_like(s, 4.0) / s), acc)
    return roundf(torch.clamp_max(rng, 128.0))


def shrink_lanes(halo, rng):
    """lq_fblock on the fp32 halo: each difference of two converted
    pixels, the 8 neighbours in row-major order."""
    a = halo[1:9, 1:9]
    acc0 = torch.zeros_like(a)
    accn = torch.zeros_like(a)
    for dx, dy, diag in planar._LQ_NEIGHBORS:
        t0 = a - halo[1 + dy:9 + dy, 1 + dx:9 + dx]
        t = torch.clamp_min(rng[None, None] - t0.abs(), 0.0)
        t = t * t
        aw = (planar.LQ_C1 if diag else 2.0) * t
        acc0 = acc0 + (t0 * t) * aw
        accn = accn + aw * aw
    na = torch.where(accn > 0, c_f32_to_i32(a - acc0 / accn), a.to(
        torch.int32))
    return (na - 128).to(F32)


def rebalance_lanes(coef, div, x1, qshr):
    """planar.rebalance_blocks_p with m0 / m1 summed per lane (the DC
    left out) and combined as the xor shuffles do."""
    a0 = get_orig_coef(coef, div[:, None], x1[:, None], qshr[:, None])
    c64, a64 = coef.long(), a0.long()
    mask = np.uint64(2 ** 64 - 1)
    sums = []
    for terms in (c64 * a64, a64 * a64):
        terms[0] = 0
        parts = terms.reshape(LANES, 8, -1).sum(1).numpy().view(np.uint64)
        sums.append(torch.from_numpy(_butterfly(parts, mask)[0].view(
            np.int64)))
    m0, m1 = sums
    num = (m1 << 13) + (m0 >> 1)
    safe = torch.where(m0 == 0, torch.ones_like(m0), m0)
    mul = wrap_i32(torch.div(num, safe, rounding_mode="trunc"))
    add = ((wrap_i32(c64 * mul.long()[None]).long() + 0x1000) >> 13).to(
        torch.int32)
    add = interval_clamp(add, a0, div[:, None])
    return torch.where((m1 > m0)[None] & (torch.arange(64) > 0)[:, None],
                       add, coef)


def lanes_pass(coef, halo, div, x1, qshr, do_rebalance):
    """The lanes' work on blocks with their fp32 halos f32[10, 10, n]:
    (coefficients, pixels) int32[64, n]."""
    assert not torch.isnan(halo).any(), "a lane read a value never staged"
    n = coef.shape[1]
    fb = shrink_lanes(halo, range_lanes(coef, div))
    out = planar.fdct_clamp_p(fb, coef, div, x1, qshr)
    if do_rebalance:
        out = rebalance_lanes(out, div, x1, qshr)
    return out, idct_islow(out.reshape(8, 8, n)).reshape(64, n)


def emulate_b4(coef, pix, div, x1, qshr, hb, wb, do_rebalance):
    b = torch.arange(coef.shape[1])
    halo = halo_from_window(staged_window(pix, wb), b, 0,
                            position_edges(b, hb, wb))
    return (*lanes_pass(coef, halo, div, x1, qshr, do_rebalance), halo)


def emulate_b7(coef, pix, div, x1, qshr, wb, b0, b1, edges, do_rebalance):
    """B7-lq over blocks [b0, b1): pix may be floats with NaN in the rows
    the edges forbid."""
    b = torch.arange(b0, b1)
    halo = halo_from_window(staged_window(pix, wb, b0, b1), b, b0,
                            descriptor_edges(b, wb, edges))
    return lanes_pass(coef[:, b0:b1], halo, div, x1, qshr, do_rebalance)


def stage_given(halo):
    """Given halos int32[100, n] (maybe a column-slice view) staged as
    solve_lq_kernel<true> stages them, and read back as the lanes read
    them: f32[10, 10, n].  Each CTA's shared array starts NaN; thread t
    writes rows k = k0 + 8 i (k0 = t / 16) of block j = t % 16 at
    j * kLqGiven + k + (k / 10) * (kLqRow - 10); lane ln of block j reads
    rows ln .. ln + 2, ten words from j * kLqGiven + row * kLqRow."""
    n = halo.shape[1]
    G, P = K["given"], K["row"]
    out = torch.empty((10, 10, n), dtype=F32)
    t = np.arange(K["threads"])
    j, k0 = t % TILE, t // TILE
    for b0 in range(0, n, TILE):
        v = torch.full((TILE * G,), np.nan, dtype=F32)
        for i in range(13):
            k = k0 + 8 * i
            ok = (k < 100) & (b0 + j < n)
            kk, jj = k[ok], j[ok]
            v[torch.from_numpy(jj * G + kk + (kk // 10) * (P - 10))] = \
                halo[torch.from_numpy(kk), torch.from_numpy(b0 + jj)].to(F32)
        for jb in range(min(TILE, n - b0)):      # rows ln .. ln + 2
            for R in range(10):
                out[R, :, b0 + jb] = v[jb * G + R * P:jb * G + R * P + 10]
    return out


def _case(hb, wb, n, table, seed):
    rng = np.random.default_rng(seed)
    hi = {"random": 120, "small": 8}[table]   # small: ranges below 128
    q = rng.integers(1, hi, 64).astype(np.uint16)
    tabs = [torch.from_numpy(t) for t in make_quant_tables(q)]
    B = hb * wb * n
    coef = np.clip(rng.integers(-40, 41, (64, B)) * q.astype(np.int32)[
        :, None], -32768, 32767).astype(np.int32)
    pix = rng.integers(0, 256, (64, B)).astype(np.int32)
    return torch.from_numpy(coef), torch.from_numpy(pix), tabs


# edge shapes (one row, one column, one block), a grid of partial tiles,
# two 5x7 images back to back, and three 3x7 images:
# 63 blocks, no multiple of the tile, tiles across image boundaries
SHAPES = [(1, 13, 1), (9, 1, 1), (1, 1, 1), (9, 13, 1), (37, 53, 1),
          (5, 7, 2), (3, 7, 3)]


@pytest.mark.parametrize("table,reb", [("random", True), ("small", False)])
@pytest.mark.parametrize("hb,wb,n", SHAPES)
def test_emulated_maps_match_plain(hb, wb, n, table, reb):
    torch.set_num_threads(1)
    coef, pix, tabs = _case(hb, wb, n, table, hb * 100 + wb + n)
    got, got_pix, halo = emulate_b4(coef, pix, *tabs, hb, wb, reb)
    B = hb * wb
    for k in range(n):
        s = slice(k * B, (k + 1) * B)
        want = planar.solve_fused_pix(coef[:, s].contiguous(),
                                      pix[:, s].contiguous(), None, *tabs,
                                      None, FLAGS, reb, hb, wb, True)
        assert torch.equal(halo[..., s].to(torch.int32), planar.blocks_halo10(
            pix[:, s].reshape(8, 8, -1), hb, wb))
        assert torch.equal(got[:, s], want[0])
        assert torch.equal(got_pix[:, s], want[1])
    assert not torch.equal(got, coef)          # the pass moved something
    if table == "small":                       # some ranges below 128
        assert (planar.low_quality_range_p(coef, tabs[0]) < 128).any()


# B7-lq's ranges of a shard's grid (hb rows with the ghosts, wb, b0, b1,
# (top_row, bot_row)): tiles from b0 = wb + 3 (not a multiple of 16), a
# single block, a range shorter than a tile, a one-block-wide grid, a grid
# wider than a tile, and a bottom edge above dead rows that the last tile
# reaches into
RANGES = [(8, 5, 8, 30, (1, 5)), (7, 9, 12, 13, (-1, -1)),
          (6, 7, 8, 20, (1, -1)), (9, 1, 2, 6, (1, 5)),
          (5, 37, 40, 148, (-1, 3)), (9, 13, 13, 104, (1, 7))]


@pytest.mark.parametrize("reb", [True, False])
@pytest.mark.parametrize("hb,wb,b0,b1,edges", RANGES)
def test_emulated_range_matches_plain(hb, wb, b0, b1, edges, reb):
    torch.set_num_threads(1)
    coef, pix, tabs = _case(hb, wb, 1, "random", hb * 100 + wb + b0)
    S = hb * wb
    # rows an edge forbids reading: above top_row, below bot_row
    row = torch.arange(S) // wb
    top, bot = edges
    banned = (row < top) | ((row > bot) & (bot >= 0))
    pixf = torch.where(banned[None], torch.tensor(np.nan), pix.to(F32))
    got, got_pix = emulate_b7(coef, pixf, *tabs, wb, b0, b1, edges, reb)
    want = [torch.zeros_like(coef) for _ in range(2)]
    planar.solve_range_pix(coef, pix, None, *tabs, None, FLAGS, reb, wb, b0,
                           b1, edges, *want)
    assert torch.equal(got, want[0][:, b0:b1])
    assert torch.equal(got_pix, want[1][:, b0:b1])


# B6-lq's inputs: block slices [s0, s1) of a 117-block plane's halos and
# coefficients as column-slice views: the whole plane, rows 4-6, and
# slices that start and end inside a 16-block tile (37, 17 and 1 blocks)
SLICES = [(0, 117), (52, 91), (3, 40), (100, 117), (5, 6)]


@pytest.mark.parametrize("reb", [True, False])
@pytest.mark.parametrize("s0,s1", SLICES)
def test_emulated_given_matches_plain(s0, s1, reb):
    torch.set_num_threads(1)
    coef, pix, tabs = _case(9, 13, 1, "random", s0 * 7 + s1)
    halo = torch.from_numpy(np.random.default_rng(s1).integers(
        0, 256, (100, 117)).astype(np.int32))
    c, h = coef[:, s0:s1], halo[:, s0:s1]
    staged = stage_given(h)
    assert torch.equal(staged.to(torch.int32), h.reshape(10, 10, -1))
    got, got_pix = lanes_pass(c, staged, *tabs, reb)
    want = planar.solve_fused(c, h, None, *tabs, None, FLAGS, reb, True)
    assert torch.equal(got, want[0]) and torch.equal(got_pix, want[1])


# ---------------------------------------------------------------------------
# (d) the staging map and the shared-memory banks


def tile_elem(t):
    """lq_tile_elem of solver.cu: thread t -> (block, first planar row)."""
    return (t & 7) + 8 * ((t >> 5) & 1), ((t >> 3) & 3) + 4 * (t >> 6)


def test_staging_map_covers_tile_coalesced():
    assert K["threads"] == 128 and TILE == 16 and LANES == 8
    t = np.arange(K["threads"])
    j0, k0 = tile_elem(t)
    j = np.concatenate([j0] * 8)                 # step i: rows k0 + 8 i
    k = np.concatenate([k0 + 8 * i for i in range(8)])
    assert len(set(zip(j.tolist(), k.tolist()))) == 64 * TILE
    assert j.max() == TILE - 1 and k.max() == 63
    for w in range(0, 64 * TILE, 32):     # one warp's 32 elements, one step
        jw, kw = j[w:w + 32], k[w:w + 32]
        assert sorted(set(jw.tolist())) == list(range(jw.min(),
                                                      jw.min() + 8))
        assert jw.min() % 8 == 0
        assert sorted(set(kw.tolist())) == list(range(kw.min(),
                                                      kw.min() + 4))
        # the tile store's banks: at most 2 lanes on one bank
        addr = jw * K["mat"] + (kw >> 3) * K["pitch"] + (kw & 7)
        assert np.bincount(addr % 32).max() <= 2


def test_lane_accesses_hit_distinct_banks():
    P, M, H = K["pitch"], K["mat"], K["halo"]
    assert M % 32 == 8 and H % 32 == 8 and H >= 10 * P
    # v, c, w, edge, tab
    smem = 4 * ((TILE + 2) * H + 2 * TILE * M + TILE + 3 * 64)
    assert smem == 17536 and smem <= 48 * 1024     # static shared memory
    for warp in range(K["threads"] // 32):
        t = np.arange(32 * warp, 32 * warp + 32)
        j, ln = t // LANES, t % LANES
        for q in range(8):
            for addr in (j * M + ln * P + q,            # row ln of w / c
                         j * M + q * P + ln):            # column ln
                assert len(set((addr % 32).tolist())) == 32
        for dr in range(3):                              # halo rows
            for q in range(8):
                assert len(set((((j + 1) * H + (ln + dr) * P + q) % 32)
                               .tolist())) == 32
            for addr in (j * H + (ln + dr) * P + 7,      # left ring
                         (j + 2) * H + (ln + dr) * P):   # right ring
                assert len(set((addr % 32).tolist())) == 32


def test_given_halo_accesses_hit_distinct_banks():
    P, G = K["row"], K["given"]
    assert P % 2 == 1 and P >= 10 and G % 16 == 8 and G >= 10 * P
    # v, c, w, edge, tab
    smem = 4 * (TILE * G + 2 * TILE * K["mat"] + TILE + 3 * 64)
    assert smem == 17728 and smem <= 48 * 1024     # static shared memory
    for warp in range(K["threads"] // 32):
        t = np.arange(32 * warp, 32 * warp + 32)
        j, ln = t // LANES, t % LANES
        for dr in range(3):                              # halo rows
            for q in range(10):
                addr = j * G + (ln + dr) * P + q
                assert len(set((addr % 32).tolist())) == 32
        # the staging stores: thread t, rows k0 + 8 i of block t % 16
        jb, k0 = t % TILE, t // TILE
        for i in range(13):
            k = k0 + 8 * i
            addr = (jb * G + k + (k // 10) * (P - 10))[k < 100]
            assert not addr.size or np.bincount(addr % 32).max() <= 4
