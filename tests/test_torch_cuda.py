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
                                    15, (1, 2), out)
    cuda_solver.solve_range_pix(coef, pix, None, *tabs, 0, True, 5, 5, 5,
                                (1, 2), out)        # empty range: no launch
    cuda_solver.idct_pix(coef.cpu())                 # plain: not counted
    assert cuda_solver.LAUNCHES == {
        "idct_pix": 1, "solve_rebalance_pix": 1,
        "solve_fused_pix_joint": 1, "solve_fused_pix_lq": 1,
        "solve_rebalance": 1, "solve_rebalance_lanes": 1,
        "solve_fused_joint": 1, "solve_fused_lq": 1,
        "solve_range_pix": 1, "solve_range_pix_joint": 1,
        "solve_range_pix_lq": 1, "peak": 1}


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
    ranges = [(wb + 3, S - wb, (-1, -1)), (wb + 3, wb + 4, (-1, -1)),
              (wb + 1, min(wb + 13, S - wb), (-1, -1)),
              (wb, (hb - 2) * wb, (1, hb - 3))]
    for _ in range(8):
        b0 = int(rng.integers(0, S))
        b1 = int(rng.integers(b0 + 1, S + 1))
        top = 0 if b0 < wb else int(rng.integers(-1, hb))
        bot = hb - 1 if b1 > S - wb else int(rng.integers(-1, hb))
        ranges.append((b0, b1, (top, bot)))
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
                                S, (0, hb - 1), *got)
    planar.solve_range_pix(coef, pix, image2, *tabs, tab, flags, True, wb, 0,
                           S, (0, hb - 1), *want)
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
