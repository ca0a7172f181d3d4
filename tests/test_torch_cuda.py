"""The CUDA kernels vs their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card (a CUDA kernel has no CPU mode):
they carry the ``cuda`` marker and skip without one.  The file imports
no JAX, so it also runs on a machine with only PyTorch; there, skip the
repository conftest (which sets JAX up):

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from jpegqs_tpu_torch import DIAGONALS, JOINT_YUV, LOW_QUALITY
from jpegqs_tpu_torch.ops import cuda_solver, planar
from jpegqs_tpu_torch.ops.quant import make_quant_tables
from upsample_cases import UPSAMPLE_TAILS, upsample_tail_inputs


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(hb, wb, seed, device):
    """Coefficients near lattice points (the reachable state), random
    pixels and the quant tables, on ``device``."""
    B = hb * wb
    rng = np.random.default_rng(seed)
    qtbl = rng.integers(1, 120, 64).astype(np.uint16)
    coef = np.clip(rng.integers(-40, 41, (64, B))
                   * qtbl.astype(np.int32)[:, None], -32768, 32767)
    pix = rng.integers(0, 256, (64, B))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(
        a, dtype=np.int32)).to(device)
    return t(coef), t(pix), [t(a) for a in make_quant_tables(qtbl)]


# 37 x 53 = 1,961 blocks: 15 full CTAs of 128 threads and a partial one,
# CTAs that span block rows and hold image edges and corners
@pytest.mark.cuda
@pytest.mark.parametrize("hb,wb", [(1, 13), (9, 1), (1, 1), (9, 13),
                                   (37, 53)])
@pytest.mark.parametrize("flags", [0, DIAGONALS])
def test_kernels_vs_plain_on_card(cuda, hb, wb, flags):
    coef, pix, tabs = _inputs(hb, wb, hb * 100 + wb, cuda)
    assert torch.equal(cuda_solver.idct_pix(coef).cpu(),
                       cuda_solver.idct_pix(coef.cpu()))
    tab = cuda_solver.solver_tables(flags, cuda)
    for reb in (True, False):
        got = cuda_solver.solve_rebalance_pix(coef, pix, *tabs, flags, reb,
                                              hb, wb)
        want = planar.solve_rebalance_pix(coef, pix, *tabs, tab, reb, hb, wb)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# (3, 7, 3), (1, 17, 2): block counts that are no multiple of B4's 16-block
# CTA tile, tiles that cross image rows and image boundaries
@pytest.mark.cuda
@pytest.mark.parametrize("hb,wb,n", [(1, 13, 1), (9, 1, 1), (1, 1, 1),
                                     (9, 13, 1), (4, 5, 2), (37, 53, 1),
                                     (3, 7, 3), (1, 17, 2)])
@pytest.mark.parametrize("flags,joint", [
    (JOINT_YUV | DIAGONALS, True), (JOINT_YUV, True),
    (JOINT_YUV | LOW_QUALITY | DIAGONALS, True),
    (LOW_QUALITY | DIAGONALS, False)])
def test_fused_kernels_vs_plain_on_card(cuda, hb, wb, n, flags, joint):
    """B3 (JOINT_YUV preamble, with the sweep at NT 242/144 or without)
    and B4 (LOW_QUALITY) vs the plain version, n images back to back
    (the plain version runs each image on its own)."""
    coef, pix, tabs = _inputs(hb, wb * n, hb * 100 + wb + flags, cuda)
    B = hb * wb
    rng = np.random.default_rng(flags)
    image2 = (torch.from_numpy(rng.integers(0, 256, (100, B * n)).astype(
        np.int32)).to(cuda) if joint else None)
    tab = (None if flags & LOW_QUALITY
           else cuda_solver.solver_tables(flags, cuda))
    for reb in (True, False):
        for want_pix in (True, False):
            got = cuda_solver.solve_fused_pix(coef, pix, image2, *tabs, flags,
                                              reb, hb, wb, want_pix)
            for k in range(n):
                s = slice(k * B, (k + 1) * B)
                want = planar.solve_fused_pix(
                    coef[:, s].contiguous(), pix[:, s].contiguous(),
                    None if image2 is None else image2[:, s].contiguous(),
                    *tabs, tab, flags, reb, hb, wb, want_pix)
                assert torch.equal(got[0][:, s], want[0])
                if want_pix:
                    assert torch.equal(got[1][:, s], want[1])
                else:
                    assert got[1] is None and want[1] is None


@pytest.mark.cuda
def test_launch_counts(cuda):
    coef, pix, tabs = _inputs(4, 5, 0, cuda)
    image2 = torch.zeros((100, 20), dtype=torch.int32, device=cuda)
    cuda_solver.reset_launches()
    cuda_solver.idct_pix(coef)
    cuda_solver.solve_rebalance_pix(coef, pix, *tabs, 0, True, 4, 5,
                                    want_pix=False)
    cuda_solver.solve_fused_pix(coef, pix, image2, *tabs, JOINT_YUV, True, 4,
                                5)
    cuda_solver.solve_fused_pix(coef, pix, None, *tabs, LOW_QUALITY, True, 4,
                                5)
    borders = torch.cat(planar.borders_from_blocks(pix.reshape(8, 8, -1), 4,
                                                   5))
    halo = planar.blocks_halo10(pix.reshape(8, 8, -1), 4, 5).reshape(100, -1)
    cuda_solver.solve_rebalance(coef, borders, *tabs, 0, True)  # lane body
    cuda_solver.solve_rebalance(coef, borders, *tabs, 0, True, lanes=False)
    cuda_solver.solve_fused(coef, halo, image2, *tabs, JOINT_YUV, True)
    cuda_solver.solve_fused(coef, halo, None, *tabs, LOW_QUALITY, True)
    cuda_solver.peak_chains(torch.ones(256, device=cuda), 4, 8)
    out = torch.zeros_like(coef)
    for i2, flags in ((None, 0), (image2, JOINT_YUV), (None, LOW_QUALITY)):
        cuda_solver.solve_range_pix(coef, pix, i2, *tabs, flags, True, 5, 5,
                                    15, (1, 2, 0, 4), out)
    cuda_solver.solve_range_pix(coef, pix, None, *tabs, 0, True, 5, 5, 5,
                                (1, 2, 0, 4), out)  # empty range: no launch
    halo = image2[:, :6].contiguous()                # a 2x3 chroma grid
    cuda_solver.upsample_fdct_blocks(halo, halo, pix, 40, 32, 2, 2, 4, 5, 2,
                                     3, 0, 4, 0, 5)
    cuda_solver.upsample_fdct_blocks(halo.cpu(), halo.cpu(), pix.cpu(), 40,
                                     32, 2, 2, 4, 5, 2, 3)  # plain
    cuda_solver.idct_pix(coef.cpu())                 # plain: not counted
    assert cuda_solver.LAUNCHES == {
        "idct_pix": 1, "solve_rebalance_pix": 1,
        "solve_fused_pix_joint": 1, "solve_fused_pix_lq": 1,
        "solve_rebalance": 1, "solve_rebalance_lanes": 1,
        "solve_fused_joint": 1, "solve_fused_lq": 1,
        "solve_range_pix": 1, "solve_range_pix_joint": 1,
        "solve_range_pix_lq": 1, "upsample_fdct": 1, "peak": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("sampling,quality,n,launches", [
    ((2, 2), 6, 1, 2), ((2, 2), 2, 1, 2), ((2, 1), 6, 1, 2),
    ((1, 2), 2, 3, 2), ((2, 2), 6, 3, 2), ((2, 2), 5, 1, 0),
    ((2, 2), 4, 1, 0), ((2, 2), 3, 1, 0), ((1, 1), 6, 1, 0),
    ((4, 1), 6, 1, 0), (None, 6, 1, 0)])
def test_upsample_launches_on_card(cuda, sampling, quality, n, launches):
    """The upsample_fdct kernel runs once per chroma component where
    UPSAMPLE_UV upsamples in block form (q6 and q2 on 4:2:0, 4:2:2,
    4:4:0; one image or a batch) and never elsewhere: q3-q5, 4:4:4, the
    plane form (4:1:1) and gray images; the results equal the CPU path."""
    from jpegqs_tpu_torch import QsOptions, batch, synth
    imgs = [synth.make_image(40, 56, color=sampling is not None, seed=s,
                             sampling=sampling or (2, 2)) for s in range(n)]
    opts = QsOptions.from_quality(quality, 2)
    cuda_solver.reset_launches()
    got = batch.smooth_image_batch(imgs, opts)
    torch.cuda.synchronize()
    assert cuda_solver.LAUNCHES["upsample_fdct"] == launches
    assert got[0].upsampled is not None or not launches
    cpu = batch.smooth_image_batch(imgs, opts, device="cpu")
    assert all(_same_result(a, b) for a, b in zip(got, cpu))


# beside the tails of tests/upsample_cases.py: planes of many CTAs of 128
# luma blocks, the last one partial, odd grids and both tails
UPSAMPLE_LARGE = [
    (2, 2, 20, 29, 39, 57, 310, 451, 2, None),
    (2, 1, 19, 40, 37, 40, 290, 317, 1, None),
    (1, 2, 37, 20, 37, 40, 293, 315, 3, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", UPSAMPLE_TAILS + UPSAMPLE_LARGE)
def test_upsample_fdct_vs_plain_on_card(cuda, case):
    """The upsample_fdct kernel vs its plain version on the card and on
    the CPU: sampling 2x2, 2x1 and 1x2, odd grids, both replicate tails
    (the right one over the first rows only), 1-3 images back to back,
    shards with row0 / col0, s_aa == 0, slopes clamped, outputs
    saturating at 0 and 255; the luma pixels contiguous or a view."""
    hs, ws, hb_c, wb_c, hb_l, wb_l, img_h, img_w, n, shard = case
    row0, hb_lt, col0, wb_lt = shard or (0, None, 0, None)
    ins = upsample_tail_inputs(hs, ws, hb_c, wb_c, hb_l, wb_l, n,
                               sum(case[:9]))
    geom = (img_w, img_h, ws, hs, hb_l, wb_l, hb_c, wb_c, row0, hb_lt,
            col0, wb_lt)
    dev = [torch.from_numpy(a).to(cuda) for a in ins]
    cuda_solver.reset_launches()
    got = cuda_solver.upsample_fdct_blocks(*dev, *geom)
    assert cuda_solver.LAUNCHES["upsample_fdct"] == 1
    assert got.dtype == torch.int16 and got.shape == (n * hb_l * wb_l, 64)
    assert torch.equal(got, planar.upsample_fdct_blocks(*dev, *geom))
    assert torch.equal(got.cpu(), cuda_solver.upsample_fdct_blocks(
        *(torch.from_numpy(a) for a in ins), *geom))
    # the luma pixels as a column-slice view of a wider plane, as a row
    # shard's real blocks in its ghost-extended grid are
    wide = torch.zeros((64, dev[2].shape[1] + 11), dtype=torch.int32,
                       device=cuda)
    wide[:, 7:-4] = dev[2]
    assert torch.equal(got, cuda_solver.upsample_fdct_blocks(
        dev[0], dev[1], wide[:, 7:-4], *geom))


def _chunk_inputs(cuda, seed, joint, hb=9, wb=13):
    """A plane's coefficients and materialised neighbourhoods (9x13 unless
    given)."""
    coef, pix, tabs = _inputs(hb, wb, seed, cuda)
    B = hb * wb
    borders = torch.cat(planar.borders_from_blocks(pix.reshape(8, 8, B), hb,
                                                   wb))
    halo = planar.blocks_halo10(pix.reshape(8, 8, B), hb, wb).reshape(100, B)
    rng = np.random.default_rng(seed)
    image2 = (torch.from_numpy(rng.integers(0, 256, (100, B)).astype(
        np.int32)).to(cuda) if joint else None)
    return coef, borders, halo, image2, tabs, wb


# row chunks (r0, n) of a 9x13 plane (the whole plane, the first, a middle
# and the last rows) and of a 210x130 plane: the whole plane (27,300
# blocks, 214 CTAs of 128: above the lane body's size on an H100) and 100
# rows of it (13,000 blocks, no multiple of 128)
@pytest.mark.cuda
@pytest.mark.parametrize("hb,wb,r0,n", [(9, 13, 0, 9), (9, 13, 0, 2),
                                        (9, 13, 4, 3), (9, 13, 8, 1),
                                        (210, 130, 0, 210),
                                        (210, 130, 60, 100)])
@pytest.mark.parametrize("flags", [0, DIAGONALS])
def test_solve_rebalance_chunks_on_card(cuda, hb, wb, r0, n, flags):
    """B5 vs its plain version on a row chunk given as column-slice
    views of the whole plane, on its lane body, on B2's body and on the
    body its size picks; rebalance and pixels on and off."""
    coef, borders, _, _, tabs, wb = _chunk_inputs(cuda, 3 + flags, False,
                                                  hb, wb)
    s = slice(r0 * wb, (r0 + n) * wb)
    tab = cuda_solver.solver_tables(flags, cuda)
    for reb in (True, False):
        for want_pix in (True, False):
            want = planar.solve_rebalance(coef[:, s], borders[:, s], *tabs,
                                          tab, reb, want_pix)
            for lanes in (True, False, None):
                got = cuda_solver.solve_rebalance(coef[:, s], borders[:, s],
                                                  *tabs, flags, reb,
                                                  want_pix, lanes)
                assert torch.equal(got[0], want[0])
                assert (got[1] is None) == (not want_pix)
                if want_pix:
                    assert torch.equal(got[1], want[1])


# block slices [s0, s1) of the 9x13 plane: its rows 0-8, 4-6 and 8, and
# slices that start and end inside a 16-block tile of B6-lq (37, 17 and 1
# blocks: no multiple of 16)
@pytest.mark.cuda
@pytest.mark.parametrize("s0,s1", [(0, 117), (52, 91), (104, 117), (3, 40),
                                   (100, 117), (5, 6)])
@pytest.mark.parametrize("flags,joint", [
    (JOINT_YUV | DIAGONALS, True), (JOINT_YUV, True),
    (JOINT_YUV | LOW_QUALITY | DIAGONALS, True),
    (LOW_QUALITY | DIAGONALS, False)])
def test_solve_fused_chunks_on_card(cuda, s0, s1, flags, joint):
    """B6 vs its plain version on a row chunk or block slice of the whole
    plane's halos (and image2), rebalance and pixels on and off."""
    coef, _, halo, image2, tabs, wb = _chunk_inputs(cuda, 5 + flags, joint)
    s = slice(s0, s1)
    tab = (None if flags & LOW_QUALITY
           else cuda_solver.solver_tables(flags, cuda))
    i2 = None if image2 is None else image2[:, s]
    for reb in (True, False):
        for want_pix in (True, False):
            got = cuda_solver.solve_fused(coef[:, s], halo[:, s], i2, *tabs,
                                          flags, reb, want_pix)
            want = planar.solve_fused(coef[:, s], halo[:, s], i2, *tabs, tab,
                                      flags, reb, want_pix)
            assert torch.equal(got[0], want[0])
            assert (got[1] is None) == (not want_pix)
            if want_pix:
                assert torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("nch", cuda_solver.PEAK_CHAINS)
def test_peak_vs_plain_on_card(cuda, nch):
    """T3 vs its plain version, bit for bit (separate mul and add)."""
    x = torch.from_numpy(np.random.default_rng(nch).uniform(
        0.5, 1.5, 1000).astype(np.float32)).to(cuda)
    got = cuda_solver.peak_chains(x, nch, 50)
    want = cuda_solver.peak_chains_plain(x, nch, 50)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_progress_run_launches(cuda):
    """A 4:2:0 q6 n3 progress run: per component three B1 + one for the
    plane, three passes (B5 on the luma -- 48 blocks, its lane body --, B6
    JOINT on the chroma), and the same output as the run without a
    callback; with ``precise`` at progprec -1, one pass per block row and
    progress step."""
    from jpegqs_tpu_torch import QsOptions, engine, synth
    img = synth.make_image(64, 48, color=True, seed=3)
    calls = []
    opts = QsOptions.from_quality(6, 3, progress=lambda u, c, m:
                                  calls.append((c, m)) and 0)
    cuda_solver.reset_launches()
    res = engine.smooth(img, opts)
    assert cuda_solver.LAUNCHES["idct_pix"] == 12
    assert cuda_solver.LAUNCHES["solve_rebalance_lanes"] == 3
    assert cuda_solver.LAUNCHES["solve_rebalance"] == 0
    assert cuda_solver.LAUNCHES["solve_fused_joint"] == 6
    plain = engine.smooth(img, QsOptions.from_quality(6, 3))
    assert all(np.array_equal(a, b) for a, b in zip(res.coefs, plain.coefs))
    assert all(np.array_equal(a, b)
               for a, b in zip(res.upsampled, plain.upsampled))
    opts.precise, opts.progprec = True, -1
    cuda_solver.reset_launches()
    res = engine.smooth(img, opts)
    hb = [c.height_in_blocks for c in img.components]
    assert cuda_solver.LAUNCHES["solve_rebalance_lanes"] == 3 * hb[0]
    assert cuda_solver.LAUNCHES["solve_fused_joint"] == 3 * (hb[1] + hb[2])
    assert all(np.array_equal(a, b) for a, b in zip(res.coefs, plain.coefs))


# grids (hb, wb): rows narrower than B4's 16-block tile, one block wide,
# and wider than a tile
@pytest.mark.cuda
@pytest.mark.parametrize("hb,wb", [(11, 7), (9, 1), (6, 37)])
@pytest.mark.parametrize("flags,joint", [
    (0, False), (DIAGONALS, False), (JOINT_YUV | DIAGONALS, True),
    (JOINT_YUV, True), (JOINT_YUV | LOW_QUALITY | DIAGONALS, True),
    (LOW_QUALITY | DIAGONALS, False)])
def test_solve_range_on_card(cuda, hb, wb, flags, joint):
    """B7 vs its plain version on block ranges of a grid with given edges:
    ranges that start and end inside a 16-block tile (wb + 3 on), a single
    block, one shorter than a tile, one ending at a bottom edge above the
    last row (its tile reaches into the rows below, which no block may
    read), and random ranges with random edges (a range that starts in the
    first row has its top edge there, one that ends in the last row its
    bottom edge); rebalance and pixels on and off."""
    S = hb * wb
    coef, pix, tabs = _inputs(hb, wb, 40 + flags + wb, cuda)
    rng = np.random.default_rng(flags + wb)
    image2 = (torch.from_numpy(rng.integers(0, 256, (100, S)).astype(
        np.int32)).to(cuda) if joint else None)
    tab = (None if flags & LOW_QUALITY
           else cuda_solver.solver_tables(flags, cuda))
    cols = (0, wb - 1)
    ranges = [(wb + 3, S - wb, (-1, -1, *cols)),
              (wb + 3, wb + 4, (-1, -1, *cols)),
              (wb + 1, min(wb + 13, S - wb), (-1, -1, *cols)),
              (wb, (hb - 2) * wb, (1, hb - 3, *cols))]
    if wb > 2:      # one row's inner columns, side edges inside the grid
        ranges += [(2 * wb + 1, 3 * wb - 1, (-1, -1, 1, wb - 2)),
                   (2 * wb + 1, 3 * wb - 1, (-1, -1, -1, -1))]
    for _ in range(8):
        b0 = int(rng.integers(0, S))
        b1 = int(rng.integers(b0 + 1, S + 1))
        top = 0 if b0 < wb else int(rng.integers(-1, hb))
        bot = hb - 1 if b1 > S - wb else int(rng.integers(-1, hb))
        first_col = -(-b0 // wb) * wb < b1
        last_col = b0 + (wb - 1 - b0 % wb) < b1
        left = 0 if first_col else int(rng.integers(-1, wb))
        right = wb - 1 if last_col else int(rng.integers(-1, wb))
        ranges.append((b0, b1, (top, bot, left, right)))
    for b0, b1, edges in ranges:
        for reb, want_pix in ((True, True), (False, False)):
            got = [torch.zeros_like(coef) for _ in range(2)]
            want = [torch.zeros_like(coef) for _ in range(2)]
            cuda_solver.solve_range_pix(coef, pix, image2, *tabs, flags, reb,
                                        wb, b0, b1, edges, got[0],
                                        got[1] if want_pix else None)
            planar.solve_range_pix(coef, pix, image2, *tabs, tab, flags, reb,
                                   wb, b0, b1, edges, want[0],
                                   want[1] if want_pix else None)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                                want[1])


# 41,000 blocks: 321 CTAs of 128, above two an SM on a 132-SM card, where
# the joint passes of B6 and B7 take B3's design (below, the one-thread
# body the small cases above run)
@pytest.mark.cuda
@pytest.mark.parametrize("flags", [JOINT_YUV | DIAGONALS,
                                   JOINT_YUV | LOW_QUALITY | DIAGONALS])
def test_joint_passes_on_large_launches_on_card(cuda, flags):
    """B6-joint and B7-joint vs their plain versions on a launch of many
    CTAs an SM."""
    hb, wb = 205, 200
    S = hb * wb
    coef, pix, tabs = _inputs(hb, wb, 60 + flags, cuda)
    rng = np.random.default_rng(flags)
    image2 = torch.from_numpy(rng.integers(0, 256, (100, S)).astype(
        np.int32)).to(cuda)
    halo = planar.blocks_halo10(pix.reshape(8, 8, S), hb, wb).reshape(100, S)
    tab = (None if flags & LOW_QUALITY
           else cuda_solver.solver_tables(flags, cuda))
    got = cuda_solver.solve_fused(coef, halo, image2, *tabs, flags, True,
                                  True)
    want = planar.solve_fused(coef, halo, image2, *tabs, tab, flags, True,
                              True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    got = [torch.zeros_like(coef) for _ in range(2)]
    want = [torch.zeros_like(coef) for _ in range(2)]
    cuda_solver.solve_range_pix(coef, pix, image2, *tabs, flags, True, wb, 0,
                                S, (0, hb - 1, 0, wb - 1), *got)
    planar.solve_range_pix(coef, pix, image2, *tabs, tab, flags, True, wb, 0,
                           S, (0, hb - 1, 0, wb - 1), *want)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("overlap", ["0", "1"])
def test_sharded_run_on_card(cuda, monkeypatch, overlap):
    """Two shards of one card through engine._try_smooth_sharded (the
    YCbCr flow at q6 and q2, the per-component flow at q3; 6 chroma rows
    over 2 shards, exchange/compute overlap off and on) equal the
    single-device run, and the passes went through B7."""
    from jpegqs_tpu_torch import QsOptions, engine, synth
    img = synth.make_image(96, 112, color=True, seed=3)
    monkeypatch.setenv("JPEGQS_SHARD_MIN_BLOCKS", "0")
    monkeypatch.setenv("JPEGQS_OVERLAP", overlap)
    for q in (6, 2, 3):
        opts = QsOptions.from_quality(q, 3)
        cuda_solver.reset_launches()
        got = engine._try_smooth_sharded(img, opts, [cuda] * 2)
        assert sum(v for k, v in cuda_solver.LAUNCHES.items()
                   if k.startswith("solve_range")) > 0
        want = engine.smooth(img, opts)
        assert got.stop == want.stop == 0
        assert all(np.array_equal(a, b) for a, b in zip(got.coefs,
                                                        want.coefs))
        assert (got.upsampled is None) == (want.upsampled is None)
        for a, b in zip(got.upsampled or (), want.upsampled or ()):
            assert np.array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("flags,joint", [
    (0, False), (DIAGONALS, False), (JOINT_YUV | DIAGONALS, True),
    (JOINT_YUV | LOW_QUALITY | DIAGONALS, True),
    (LOW_QUALITY | DIAGONALS, False)])
@pytest.mark.parametrize("hb,wb,nr,nc", [(7, 41, 2, 3), (3, 70, 1, 4)])
def test_solve_range_column_edges_on_card(cuda, hb, wb, nr, nc, flags,
                                          joint):
    """B7 vs its plain version on hand-built shards of a rows x columns
    grid (ghost rows and columns, random where outside the image or dead;
    right and bottom edges mid-shard), one range per local row over its
    real columns, as the 2-D sharded loop launches it."""
    rng = np.random.default_rng(hb + wb + flags)
    hb_loc, wb_loc = -(-hb // nr), -(-wb // nc)
    wb_eff = wb_loc + 2
    S = (hb_loc + 2) * wb_eff
    er, el = (hb - 1) // hb_loc, (hb - 1) % hb_loc
    ecr, ecl = (wb - 1) // wb_loc, (wb - 1) % wb_loc
    tab = (None if flags & LOW_QUALITY
           else cuda_solver.solver_tables(flags, cuda))
    for r in range(nr):
        for c in range(nc):
            coef, pix, tabs = _inputs(hb_loc + 2, wb_eff, r * nc + c, cuda)
            image2 = (torch.from_numpy(rng.integers(0, 256, (100, S)).astype(
                np.int32)).to(cuda) if joint else None)
            rows = hb_loc if r < er else (el + 1 if r == er else 0)
            cols = wb_loc if c < ecr else (ecl + 1 if c == ecr else 0)
            edges = (1 if r == 0 else -1, el + 1 if r == er else -1,
                     1 if c == 0 else -1, ecl + 1 if c == ecr else -1)
            got = [torch.zeros_like(coef) for _ in range(2)]
            want = [torch.zeros_like(coef) for _ in range(2)]
            for i in range(1, rows + 1):
                if not cols:
                    continue
                b0 = i * wb_eff + 1
                cuda_solver.solve_range_pix(coef, pix, image2, *tabs, flags,
                                            True, wb_eff, b0, b0 + cols,
                                            edges, *got)
                planar.solve_range_pix(coef, pix, image2, *tabs, tab, flags,
                                       True, wb_eff, b0, b0 + cols, edges,
                                       *want)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                                want[1])


def _same_planes(got, want):
    return (got.stop == want.stop
            and all(np.array_equal(a, b) for a, b in zip(got.coefs,
                                                         want.coefs))
            and (got.upsampled is None) == (want.upsampled is None)
            and all(np.array_equal(a, b) for a, b in
                    zip(got.upsampled or (), want.upsampled or ())))


@pytest.mark.cuda
def test_grid_run_on_card(cuda, monkeypatch):
    """Strips through engine._try_smooth_sharded on four shards of one
    card: a 4:2:0 strip with two chroma block rows at q6 and q2 takes the
    2 x 2 grid, a one-row gray strip the 1 x 4 grid; each equals the
    single-device run, and its passes went through B7, one launch per
    shard row a pass."""
    from jpegqs_tpu_torch import QsOptions, engine, synth
    monkeypatch.setenv("JPEGQS_SHARD_MIN_BLOCKS", "0")
    for img, q in ((synth.make_image(32, 1008, color=True, seed=4), 6),
                   (synth.make_image(32, 1008, color=True, seed=4), 2),
                   (synth.make_image(8, 1000, color=False, seed=5), 3)):
        opts = QsOptions.from_quality(q, 3)
        grid = engine._shard_grid(img, opts, 4)
        assert grid[1] > 1
        cuda_solver.reset_launches()
        got = engine._try_smooth_sharded(img, opts, [cuda] * 4)
        torch.cuda.synchronize()
        b7 = sum(v for k, v in cuda_solver.LAUNCHES.items()
                 if k.startswith("solve_range"))
        rows = sum(-(-c.height_in_blocks // grid[0]) * grid[0]
                   for c in img.components)
        assert b7 == rows * grid[1] * 3, (b7, grid)
        assert _same_planes(got, engine.smooth(img, opts))


@pytest.mark.cuda
def test_batch_forms_on_card(cuda):
    """make_sharded_smooth's batch form on a 2 (data) x 2 (row) layout of
    one card and smooth_batch_sharded on data 2 x row 1 equal the batch
    engine on one device; dryrun_multichip(4) runs."""
    from jpegqs_tpu_torch import QsOptions, batch, synth
    from jpegqs_tpu_torch.parallel import sharded
    imgs = [synth.make_image(64, 48, color=False, seed=s) for s in range(4)]
    comp = imgs[0].components[0]
    coefs = np.stack([np.asarray(im.components[0].coefs, np.int16).reshape(
        comp.height_in_blocks, comp.width_in_blocks, 64) for im in imgs])
    qraw = np.asarray(comp.quantval, np.int32)
    run = sharded.make_sharded_smooth([[cuda] * 2] * 2,
                                      hb=comp.height_in_blocks,
                                      wb=comp.width_in_blocks, flags=0,
                                      niter=3, batch=True)
    out, bad = run(coefs, qraw, *make_quant_tables(qraw))
    want = batch.smooth_plane_batch(coefs, comp.quantval, 0, 3)
    assert np.array_equal(out.cpu().numpy(), want) and not bad.any()
    colour = [synth.make_image(48, 64, color=True, seed=s) for s in range(3)]
    opts = QsOptions.from_quality(6, 3)
    got = sharded.smooth_batch_sharded(colour, opts, [[cuda], [cuda]])
    for a, b in zip(got, batch.smooth_image_batch(colour, opts)):
        assert _same_planes(a, b)
    assert "OK" in sharded.dryrun_multichip(4)


@pytest.mark.cuda
def test_two_ranks_on_card(cuda, tmp_path):
    """The launcher's --local 2 through tools/multihost_worker.py: two
    gloo ranks sharing the card, two shards each, on a synthetic 4:2:0
    strip at q6 (a 2 x 2 grid across the ranks); rank 0's planes equal
    the single-process run."""
    import os
    import subprocess
    import sys
    from jpegqs_tpu_torch import QsOptions, engine, synth
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    save = tmp_path / "planes.npz"
    r = subprocess.run(
        [sys.executable, os.path.join(repo, "tools", "multihost_worker.py"),
         "--local", "2", "--shards-per-rank", "2", "--timeout", "300",
         "--synth", "32,1008,1,4", "-q", "6", "-n", "3", "--save",
         str(save)], cwd=repo, capture_output=True, text=True, timeout=360)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stderr.count("joined, backend gloo") == 2, r.stderr[-3000:]
    img = synth.make_image(32, 1008, color=True, seed=4)
    want = engine.smooth(img, QsOptions.from_quality(6, 3))
    planes = np.load(save)
    assert int(planes["stop"]) == want.stop
    for i, c in enumerate(want.coefs):
        assert np.array_equal(planes[f"coef{i}"], c)
    assert np.array_equal(planes["up1"], want.upsampled[0])
    assert np.array_equal(planes["up2"], want.upsampled[1])


@pytest.mark.cuda
def test_canaries_on_card(cuda):
    rng = np.random.default_rng(1)
    a, b = (rng.uniform(1, 2, 4096).astype(np.float32) for _ in range(2))
    t = lambda x: torch.from_numpy(x).to(cuda)
    out = cuda_solver.canary_muladd(t(a), t(b), t(-(a * b)))
    assert int(torch.count_nonzero(out)) == 0
    terms = rng.uniform(-1e3, 1e3, (242, 4096)).astype(np.float32)
    want = np.zeros(4096, np.float32)
    for j in range(242):
        want = want + terms[j]
    got = cuda_solver.canary_fold(t(terms)).cpu().numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def _same_result(a, b):
    return (a.stop == b.stop
            and all(np.array_equal(x, y) for x, y in zip(a.coefs, b.coefs))
            and (a.upsampled is None) == (b.upsampled is None)
            and all(np.array_equal(x, y)
                    for x, y in zip(a.upsampled or (), b.upsampled or ())))


@pytest.mark.cuda
@pytest.mark.parametrize("quality", [0, 3, 6])
@pytest.mark.parametrize("n", [2, 5])
def test_image_batch_on_card(cuda, quality, n):
    """smooth_image_batch on the card equals per-image smooth() on the
    card and the CPU path, with one image's launch counts."""
    from jpegqs_tpu_torch import QsOptions, batch, engine, synth
    imgs = [synth.make_image(40, 56, color=True, seed=s) for s in range(n)]
    opts = QsOptions.from_quality(quality, 3)
    cuda_solver.reset_launches()
    got = batch.smooth_image_batch(imgs, opts)
    counts = dict(cuda_solver.LAUNCHES)
    cuda_solver.reset_launches()
    one = engine.smooth(imgs[0], opts)
    assert counts == cuda_solver.LAUNCHES and counts["idct_pix"] == 3
    assert _same_result(got[0], one)
    for im, g in zip(imgs, got):
        assert _same_result(g, engine.smooth(im, opts))
        assert _same_result(g, engine.smooth(im, opts, "cpu"))
    cpu = batch.smooth_image_batch(imgs, opts, device="cpu")
    assert all(_same_result(a, b) for a, b in zip(got, cpu))


@pytest.mark.cuda
@pytest.mark.parametrize("quality", [0, 3, 6])
@pytest.mark.parametrize("n", [2, 5])
def test_plane_batch_on_card(cuda, quality, n):
    from jpegqs_tpu_torch import QsOptions, batch, engine, quality_to_flags
    from jpegqs_tpu_torch import synth
    imgs = [synth.make_image(40, 48, seed=s) for s in range(n)]
    coefs = np.stack([im.components[0].coefs for im in imgs])
    qtbl = imgs[0].components[0].quantval
    flags = quality_to_flags(quality)
    got = batch.smooth_plane_batch(coefs, qtbl, flags, 3)
    cpu = batch.smooth_plane_batch(coefs, qtbl, flags, 3, device="cpu")
    assert np.array_equal(got, cpu)
    for i, im in enumerate(imgs):
        want = engine.smooth(im, QsOptions(flags=flags, niter=3))
        assert np.array_equal(got[i], want.coefs[0])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,color,sampling,quality", [
    ((45, 61), False, (2, 2), 3), ((45, 61), True, (2, 2), 3),
    ((48, 56), True, (2, 2), 6), ((50, 42), True, (2, 1), 5),
    ((40, 40), True, (1, 1), 5)])
def test_decode_on_card(cuda, shape, color, sampling, quality):
    """engine._decode_native on the card equals the CPU path on the same
    planes, with one B1 launch per component."""
    from jpegqs_tpu_torch import QsOptions, engine, synth
    img = synth.make_image(*shape, color=color, seed=4, sampling=sampling)
    res = engine.smooth(img, QsOptions.from_quality(quality, 2))
    cuda_solver.reset_launches()
    got = engine._decode_native(img, res)
    assert cuda_solver.LAUNCHES["idct_pix"] == len(img.components)
    assert got.dtype == np.uint8 and got.shape[:2] == shape
    assert np.array_equal(got, engine._decode_native(img, res, "cpu"))


@pytest.mark.cuda
def test_batches_in_flight_on_card(cuda):
    """Several batches dispatched before any is assembled (the corpus
    pipeline's window): their pinned staging buffers are not reused while
    a copy is queued, so each equals per-image smooth()."""
    from jpegqs_tpu_torch import QsOptions, batch, engine, synth
    opts = QsOptions.from_quality(6, 2)
    chunks = [[synth.make_image(40, 56, color=True, seed=10 * k + s)
               for s in range(3)] for k in range(4)]
    pending = [batch._batch_dispatch(imgs, opts, cuda) for imgs in chunks]
    for imgs, asm in zip(chunks, pending):
        for im, got in zip(imgs, asm()):
            assert _same_result(got, engine.smooth(im, opts))


@pytest.mark.cuda
def test_assemble_waits_for_its_own_batch(cuda):
    """A batch's assemble() waits for its own host copies alone: with a
    spin of the card queued behind the first batch and a second batch
    behind that, the first batch's assemble() returns while the card
    still spins, with that batch's planes."""
    from jpegqs_tpu_torch import QsOptions, engine, synth
    opts = QsOptions.from_quality(3, 2)
    imgs = [synth.make_image(48, 64, seed=s) for s in range(3)]
    plan = engine.plan_image(imgs[0], opts)
    first = engine.dispatch(imgs, plan, cuda)
    torch.cuda._sleep(1 << 30)
    later = engine.dispatch(imgs, plan, cuda)
    got = first()
    spinning = not torch.cuda.current_stream().query()
    later()
    assert spinning
    for im, res in zip(imgs, got):
        assert _same_result(res, engine.smooth(im, opts, "cpu"))


@pytest.mark.cuda
def test_fuzz_golden_replay_on_card(cuda):
    """tools/fuzz_port_golden.json on the card: every entry's digest of
    jpegqs_tpu's output on the fused and the progress path, and its
    decoded pixels' where recorded; B1-B6 launched."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "fuzz_port.py")
    spec = importlib.util.spec_from_file_location("fuzz_port", path)
    fuzz_port = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fuzz_port)
    cuda_solver.reset_launches()
    assert fuzz_port.replay_golden(cuda) == fuzz_port.GOLDEN_CASES
    for name in ("idct_pix", "solve_rebalance_pix", "solve_fused_pix_joint",
                 "solve_fused_pix_lq", "solve_fused_joint", "solve_fused_lq"):
        assert cuda_solver.LAUNCHES[name] > 0, name
    assert cuda_solver.LAUNCHES["solve_rebalance"] \
        + cuda_solver.LAUNCHES["solve_rebalance_lanes"] > 0
