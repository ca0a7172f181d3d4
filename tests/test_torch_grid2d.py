"""The port's 2-D shard grid and batch data parallelism vs jpegqs_tpu, on
the CPU.

- Kernel B7's plain version (``cuda_solver.solve_range_pix`` on CPU
  tensors) with column edges, on hand-built shards of a rows x columns
  grid, each ghost-extended by a block row and a block column on every
  side, one range per local row over its real columns, against the
  single-device plain B2/B3/B4 on the matching blocks of the unsharded
  plane; the ghosts at the image's edges and the dead pad blocks hold
  random garbage that no edge may let a pass read;
- ``parallel.sharded.make_sharded_smooth`` / ``make_sharded_ycbcr_smooth``
  on 2 x 2 and 2 x 3 grids of ``"cpu"`` against ``jpegqs_tpu.engine``'s
  single-device passes and ``jpegqs_tpu.parallel.sharded``'s on
  the 2-D JAX CPU mesh (``col_axis="col"``, its XLA path), padded right
  and bottom edges included, and the q6 4:2:0 strip with UPSAMPLE_UV;
- ``engine._shard_grid`` against ``jpegqs_tpu.engine._shard_grid`` over
  shapes and device counts, ``engine._try_smooth_sharded`` on strips and
  the narrow-plane UPSAMPLE fallback against ``jpegqs_tpu.engine.smooth``;
- the batch form of ``make_sharded_smooth`` (a data x row layout) against
  ``jpegqs_tpu``'s ``batch_axis`` run, and ``smooth_batch_sharded``
  against ``batch.smooth_image_batch``.

Every comparison is exact (tolerance 0).  B7 itself is held against this
plain version on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from jpegqs_tpu import engine as jax_engine
from jpegqs_tpu.host.jpegio import ComponentData as JaxComponent
from jpegqs_tpu.host.jpegio import JpegImage as JaxImage
from jpegqs_tpu.options import QsOptions as JaxOptions
from jpegqs_tpu.parallel import sharded as jax_sharded
from jpegqs_tpu_torch import (DIAGONALS, JOINT_YUV, LOW_QUALITY, QsOptions,
                              batch, engine)
from jpegqs_tpu_torch.host.jpegio import image_from_arrays
from jpegqs_tpu_torch.ops import cuda_solver
from jpegqs_tpu_torch.ops.quant import make_quant_tables
from jpegqs_tpu_torch.parallel import sharded

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture
def mesh2d():
    """The JAX CPU mesh of rows x cols devices (conftest makes 8)."""
    if len(jax.devices()) < 6:
        pytest.skip("needs the 8 virtual JAX devices of tests/conftest.py")
    return lambda r, c: Mesh(np.array(jax.devices()[:r * c]).reshape(r, c),
                             ("row", "col"))


def _grid(r, c):
    return [["cpu"] * c for _ in range(r)]


# ---------------------------------------------------------------------------
# B7's plain version with column edges on hand-built 2-D shards
# ---------------------------------------------------------------------------

def _ghosted2d(x, r, c, hb_loc, wb_loc, wb, rng):
    """Shard (r, c) of plane x int32[R, hb*wb] as the 2-D loop holds it:
    its hb_loc x wb_loc blocks inside a ring of ghost blocks, which hold
    the neighbour shards' blocks (corners the diagonal shards'); outside
    the image, and on dead pad blocks, random garbage."""
    R, B = x.shape
    hb = B // wb
    out = torch.from_numpy(rng.integers(0, 256, (R, hb_loc + 2, wb_loc + 2))
                           .astype(np.int32))
    g = x.reshape(R, hb, wb)
    for i in range(hb_loc + 2):
        for j in range(wb_loc + 2):
            gy, gx = r * hb_loc - 1 + i, c * wb_loc - 1 + j
            if 0 <= gy < hb and 0 <= gx < wb:
                out[:, i, j] = g[:, gy, gx]
    return out.reshape(R, -1)


@pytest.mark.parametrize("flags,joint", [
    (0, False), (DIAGONALS, False), (JOINT_YUV | DIAGONALS, True),
    (JOINT_YUV | LOW_QUALITY | DIAGONALS, True),
    (LOW_QUALITY | DIAGONALS, False)])
@pytest.mark.parametrize("hb,wb,nr,nc", [(7, 9, 2, 3), (5, 8, 2, 2),
                                         (3, 17, 1, 4)])
def test_b7_plain_column_edges(flags, joint, hb, wb, nr, nc):
    """Each shard's real blocks through B7, one range per local row with
    the shard's row and column edges, equal the single-device pass on
    those blocks of the unsharded plane; ghost and dead blocks are left
    as they were."""
    rng = np.random.default_rng(hb * 100 + wb + flags)
    B = hb * wb
    qtbl = rng.integers(1, 120, 64).astype(np.uint16)
    coef = _t(np.clip(rng.integers(-40, 41, (64, B))
                      * qtbl.astype(np.int32)[:, None],
                      -32768, 32767).astype(np.int32))
    pix = _t(rng.integers(0, 256, (64, B)).astype(np.int32))
    image2 = (_t(rng.integers(0, 256, (100, B)).astype(np.int32))
              if joint else None)
    tabs = [_t(a) for a in make_quant_tables(qtbl)]
    reb = not flags & LOW_QUALITY
    if image2 is None and not flags & LOW_QUALITY:
        want = cuda_solver.solve_rebalance_pix(coef, pix, *tabs, flags, reb,
                                               hb, wb)
    else:
        want = cuda_solver.solve_fused_pix(coef, pix, image2, *tabs, flags,
                                           reb, hb, wb)
    want = [w.reshape(64, hb, wb) for w in want]
    hb_loc, wb_loc = -(-hb // nr), -(-wb // nc)
    er, el = sharded._edge_pos(hb, hb_loc)
    ecr, ecl = sharded._edge_pos(wb, wb_loc)
    wb_eff = wb_loc + 2
    S = (hb_loc + 2) * wb_eff
    for r in range(nr):
        for c in range(nc):
            rows = hb_loc if r < er else (el + 1 if r == er else 0)
            cols = wb_loc if c < ecr else (ecl + 1 if c == ecr else 0)
            edges = (1 if r == 0 else -1, el + 1 if r == er else -1,
                     1 if c == 0 else -1, ecl + 1 if c == ecr else -1)
            ext = [None if x is None else
                   _ghosted2d(x, r, c, hb_loc, wb_loc, wb, rng)
                   for x in (coef, pix, image2)]
            outs = [torch.full((64, S), -7, dtype=torch.int32)
                    for _ in range(2)]
            for i in range(1, rows + 1):
                if cols:
                    cuda_solver.solve_range_pix(
                        *ext, *tabs, flags, reb, wb_eff, i * wb_eff + 1,
                        i * wb_eff + 1 + cols, edges, *outs)
            for k in range(2):
                got = outs[k].reshape(64, hb_loc + 2, wb_eff)
                real = got[:, 1:rows + 1, 1:cols + 1]
                assert torch.equal(real, want[k][
                    :, r * hb_loc:r * hb_loc + rows,
                    c * wb_loc:c * wb_loc + cols]), f"shard {r},{c}"
                untouched = torch.ones(got.shape[1:], dtype=torch.bool)
                untouched[1:rows + 1, 1:cols + 1] = False
                assert (got[:, untouched] == -7).all()


def test_b7_column_range_checks():
    """A range holding a grid-edge column needs that column's edge."""
    rng = np.random.default_rng(3)
    coef = _t(rng.integers(-50, 50, (64, 20)).astype(np.int32))
    pix = _t(rng.integers(0, 256, (64, 20)).astype(np.int32))
    tabs = [_t(a) for a in make_quant_tables(np.full(64, 8, np.uint16))]
    out = torch.zeros_like(coef)
    # the real columns of row 1 of a 4 x 5 ghost-extended grid
    cuda_solver.solve_range_pix(coef, pix, None, *tabs, 0, True, 5, 6, 9,
                                (-1, -1, 1, 3), out)
    for b0, b1, edges in ((5, 9, (-1, -1, 1, 3)), (6, 10, (-1, -1, 1, 3)),
                          (6, 10, (-1, -1, 1, -1))):
        with pytest.raises(ValueError, match="beyond"):
            cuda_solver.solve_range_pix(coef, pix, None, *tabs, 0, True, 5,
                                        b0, b1, edges, out)


# ---------------------------------------------------------------------------
# make_sharded_smooth / make_sharded_ycbcr_smooth on a 2-D grid vs the JAX
# package's
# ---------------------------------------------------------------------------

def _component(hb, wb, seed):
    """tests/test_sharded.py's component: quiet guard, decaying AC."""
    rng = np.random.default_rng(seed)
    qtbl = np.clip(rng.integers(4, 80, 64), 1, 255).astype(np.int32)
    cap = 2047 // qtbl
    coef16 = (rng.integers(-50, 51, (hb * wb, 64))
              // (1 + np.arange(64) // 8)).astype(np.int64)
    coef16 = np.clip(coef16, -cap[None, :], cap[None, :]).astype(np.int16)
    return coef16, qtbl, rng


def _jax_component(coef16, tabs, interior, hb, wb, flags, niter, image2):
    want, _, _ = jax_engine.component_smooth(
        *map(jnp.asarray, (coef16, *tabs)),
        jnp.asarray(np.pad(interior, 1, mode="edge")) if image2
        else jnp.zeros((1, 1), jnp.int32),
        hb=hb, wb=wb, flags=flags, niter=niter, extra_refresh=0,
        luma=not image2, use_image2=image2)
    return np.asarray(want).reshape(hb, wb, 64)


@pytest.mark.parametrize("flags,niter,hb,wb,nr,nc,image2,vs_mesh", [
    (0, 2, 6, 8, 2, 2, False, True),
    (DIAGONALS, 2, 5, 7, 2, 3, False, False),      # padded right and bottom
    (LOW_QUALITY | DIAGONALS, 2, 5, 7, 2, 3, False, False),
    (JOINT_YUV | DIAGONALS, 1, 7, 8, 2, 3, True, True)])
def test_grid_smooth_matches_jax(mesh2d, flags, niter, hb, wb, nr, nc, image2,
                                 vs_mesh):
    coef16, qtbl, rng = _component(hb, wb, hb * wb + flags)
    tabs = (qtbl, *make_quant_tables(qtbl))
    interior = (rng.integers(0, 256, (hb * 8, wb * 8)).astype(np.int32)
                if image2 else None)
    want = _jax_component(coef16, tabs, interior, hb, wb, flags, niter,
                          image2)
    run = sharded.make_sharded_smooth(
        _grid(nr, nc), hb=hb, wb=wb, flags=flags, niter=niter,
        luma=not image2, use_image2=image2)
    got, bad = run(coef16.reshape(hb, wb, 64), *tabs, interior)
    assert not bool(bad)
    assert np.array_equal(got.numpy(), want)
    if vs_mesh:
        fn = jax_sharded.make_sharded_smooth(
            mesh2d(nr, nc), hb=hb, wb=wb, flags=flags, niter=niter,
            luma=not image2, use_image2=image2, col_axis="col")
        args = [coef16.reshape(hb, wb, 64), *map(jnp.asarray, tabs)]
        jres = fn(*args, interior) if image2 else fn(*args)
        assert run.padded_dims == fn.padded_dims
        assert np.array_equal(np.asarray(jres[0]), want)


def _ycbcr_image(hb_l, wb_l, ws, hs, pad_h, pad_w, seed):
    """A JAX-package JpegImage of aligned planes (tests/test_sharded.py's
    image maker), its image pad_h/pad_w pixels short of the block grid."""
    rng = np.random.default_rng(seed)
    qt_y = np.clip(rng.integers(2, 60, 64), 1, 255).astype(np.uint16)
    qt_c = np.clip(rng.integers(2, 40, 64), 1, 255).astype(np.uint16)
    hb_c, wb_c = hb_l // hs, wb_l // ws
    img = JaxImage(width=wb_l * 8 - pad_w, height=hb_l * 8 - pad_h,
                   jpeg_color_space=3, progressive=False,
                   max_h_samp_factor=ws, max_v_samp_factor=hs)
    for ci, (h, w, qt) in enumerate(((hb_l, wb_l, qt_y), (hb_c, wb_c, qt_c),
                                     (hb_c, wb_c, qt_c))):
        cap = 2047 // qt.astype(np.int32)
        c = rng.integers(-40, 41, (h, w, 64)) // (1 + np.arange(64) // 8)
        sf = (ws, hs) if ci == 0 else (1, 1)
        img.components.append(JaxComponent(
            component_id=ci, h_samp_factor=sf[0], v_samp_factor=sf[1],
            quant_tbl_no=min(ci, 1), width_in_blocks=w, height_in_blocks=h,
            quantval=qt, coefs=np.clip(c, -cap, cap).astype(np.int16)))
    return img


def _assert_same(want, got):
    assert got.stop == want.stop
    for ci, (a, b) in enumerate(zip(want.coefs, got.coefs)):
        assert np.array_equal(np.asarray(a), np.asarray(b)), f"comp {ci}"
    assert (got.upsampled is None) == (want.upsampled is None)
    for a, b in zip(want.upsampled or (), got.upsampled or ()):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_grid_ycbcr_q6_strip_matches_jax(mesh2d):
    """The q6 (JOINT_YUV + UPSAMPLE_UV) 4:2:0 strip on a 2 x 2 grid: luma
    4 x 14 blocks, chroma 2 x 7 (padded to 2 x 8, so the right edges and
    the right tail fall mid-shard), the image 3 px short of its last block
    column and 5 px of its last row; against the JAX package's 2-D mesh
    run (which tests/test_sharded.py holds against its engine)."""
    img = _ycbcr_image(4, 14, 2, 2, 5, 3, 61)
    opts = JaxOptions.from_quality(6, 2)
    dims = dict(hb_l=4, wb_l=14, hb_c=2, wb_c=7, ws=2, hs=2, flags=opts.flags,
                niter=2, img_w=img.width, img_h=img.height)
    planes = [c.coefs for c in img.components]
    tabs = []
    for c in img.components:
        qraw = np.asarray(c.quantval, np.int32)
        tabs.append((qraw, *make_quant_tables(qraw)))
    fn = jax_sharded.make_sharded_ycbcr_smooth(mesh2d(2, 2), col_axis="col",
                                               **dims)
    jy, jcb, jcr, jbad, jups = fn(*planes, *[tuple(map(jnp.asarray, t))
                                             for t in tabs])
    run = sharded.make_sharded_ycbcr_smooth(_grid(2, 2), **dims)
    assert run.padded_dims == fn.padded_dims == (4, 16, 2, 8)
    y, cb, cr, bad, ups = run(*planes, *tabs)
    assert not bool(bad) and not bool(jbad) and ups is not None
    for a, b in zip((jy, jcb, jcr, *jups), (y, cb, cr, *ups)):
        assert np.array_equal(np.asarray(a), b.numpy())


# ---------------------------------------------------------------------------
# The grid choice and the engine's auto-sharding
# ---------------------------------------------------------------------------

def _gray_image(hb, wb, seed):
    rng = np.random.default_rng(seed)
    img = JaxImage(width=wb * 8, height=hb * 8, jpeg_color_space=1,
                   progressive=False, max_h_samp_factor=1,
                   max_v_samp_factor=1)
    qt = np.clip(rng.integers(2, 60, 64), 1, 255).astype(np.uint16)
    cap = 2047 // qt.astype(np.int32)
    c = rng.integers(-40, 41, (hb, wb, 64)) // (1 + np.arange(64) // 8)
    img.components.append(JaxComponent(
        component_id=0, h_samp_factor=1, v_samp_factor=1, quant_tbl_no=0,
        width_in_blocks=wb, height_in_blocks=hb, quantval=qt,
        coefs=np.clip(c, -cap, cap).astype(np.int16)))
    return img


@pytest.mark.parametrize("ndev", [1, 2, 3, 4, 6, 8])
def test_shard_grid_matches_jax(monkeypatch, ndev):
    """engine._shard_grid picks jpegqs_tpu.engine._shard_grid's (rows,
    cols), with and without columns, over gray and 4:2:0 shapes: tall,
    square, one-row and two-row strips, narrow planes."""
    monkeypatch.setenv("JPEGQS_SHARD_MIN_BLOCKS", "0")
    monkeypatch.setattr(jax, "devices", lambda *a: [None] * ndev)
    imgs = [_gray_image(hb, wb, 1) for hb, wb in
            ((9, 5), (1, 40), (2, 40), (3, 2), (2, 1), (16, 16))]
    imgs += [_ycbcr_image(hb, wb, 2, 2, 0, 0, 2) for hb, wb in
             ((2, 40), (4, 6), (2, 2), (8, 8))]
    for img in imgs:
        port = image_from_arrays(img)
        for q in (3, 6):
            jopts, opts = JaxOptions.from_quality(q, 2), QsOptions.from_quality(
                q, 2)
            for allow in (True, False):
                assert engine._shard_grid(port, opts, ndev, allow) == \
                    jax_engine._shard_grid(img, jopts, allow), (
                        [c.height_in_blocks for c in img.components], q)


def test_auto_sharding_strips(monkeypatch):
    """engine._try_smooth_sharded on 4 devices: a two-block-row gray
    strip takes the 2 x 2 grid; a 4:4:4 q6 image two block rows high and
    three wide would leave its luma one block column a shard, so it falls
    back to the best row-only split (2 x 1), as the JAX engine does; both
    equal jpegqs_tpu.engine.smooth."""
    monkeypatch.setenv("JPEGQS_SHARD_MIN_BLOCKS", "0")
    gray = _gray_image(2, 11, 5)
    opts, jopts = QsOptions.from_quality(3, 1), JaxOptions.from_quality(3, 1)
    assert engine._shard_grid(image_from_arrays(gray), opts, 4) == (2, 2)
    _assert_same(jax_engine.smooth(gray, jopts),
                 engine._try_smooth_sharded(image_from_arrays(gray), opts,
                                            ["cpu"] * 4))
    c444 = _ycbcr_image(2, 3, 1, 1, 0, 0, 7)
    opts, jopts = QsOptions.from_quality(6, 1), JaxOptions.from_quality(6, 1)
    port = image_from_arrays(c444)
    assert engine._shard_grid(port, opts, 4) == (2, 2)
    assert engine._shard_grid(port, opts, 4, allow_col=False) == (2, 1)
    calls = []
    make = sharded.make_sharded_ycbcr_smooth
    monkeypatch.setattr(sharded, "make_sharded_ycbcr_smooth",
                        lambda shards, **kw: calls.append(
                            (shards.rows, shards.cols, shards.devices))
                        or make(shards, **kw))
    got = engine._try_smooth_sharded(port, opts, ["cpu"] * 4)
    # the row-only fallback
    assert calls == [(2, 1, [torch.device("cpu")] * 2)]
    _assert_same(jax_engine.smooth(c444, jopts), got)


# ---------------------------------------------------------------------------
# Batch data parallelism
# ---------------------------------------------------------------------------

def test_batch_form_matches_jax_batch_axis():
    """make_sharded_smooth's batch form over a 2 (data) x 2 (row) layout
    equals jpegqs_tpu's batch_axis run on the ('data', 'row') CPU mesh:
    4 images, 5 block rows each (padded to 6 on 2 row shards)."""
    if len(jax.devices()) < 4:
        pytest.skip("needs the 8 virtual JAX devices of tests/conftest.py")
    hb, wb, n = 5, 4, 4
    planes, qtbl = [], None
    for i in range(n):
        c, q, _ = _component(hb, wb, 90)
        planes.append(np.roll(c, i, axis=0).reshape(hb, wb, 64))
        qtbl = q
    coefs = np.stack(planes)
    tabs = (qtbl, *make_quant_tables(qtbl))
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "row"))
    fn = jax_sharded.make_sharded_smooth(mesh, hb=hb, wb=wb, flags=DIAGONALS,
                                         niter=2, batch_axis="data")
    want, jbad = fn(coefs, *map(jnp.asarray, tabs))
    run = sharded.make_sharded_smooth([["cpu"] * 2] * 2, hb=hb, wb=wb,
                                      flags=DIAGONALS, niter=2, batch=True)
    got, bad = run(coefs, *tabs)
    assert tuple(got.shape) == (n, hb, wb, 64) and tuple(bad.shape) == (n,)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert not bad.any() and not np.asarray(jbad).any()


def test_smooth_batch_sharded_matches_batch():
    """smooth_batch_sharded over data 2 x row 1 (each group the batch
    engine) and data 2 x row 2 (each image auto-sharded over its group)
    equals batch.smooth_image_batch on one device, colour q6 and gray."""
    from jpegqs_tpu_torch import synth
    colour = [synth.make_image(32, 48, color=True, seed=s) for s in range(3)]
    opts = QsOptions.from_quality(6, 2)
    want = batch.smooth_image_batch(colour, opts, "cpu")
    for a, b in zip(want, sharded.smooth_batch_sharded(colour, opts,
                                                       [["cpu"], ["cpu"]])):
        _assert_same(a, b)
    gray = [synth.make_image(32, 24, color=False, seed=s) for s in range(4)]
    opts = QsOptions.from_quality(3, 2)
    want = batch.smooth_image_batch(gray, opts, "cpu")
    import os
    os.environ["JPEGQS_SHARD_MIN_BLOCKS"] = "0"
    try:
        got = sharded.smooth_batch_sharded(gray, opts, [["cpu"] * 2] * 2)
    finally:
        del os.environ["JPEGQS_SHARD_MIN_BLOCKS"]
    for a, b in zip(want, got):
        _assert_same(a, b)


def test_dryrun_multichip_cpu():
    """dryrun_multichip over 4 CPU shards: every flow runs and gives its
    shapes; the (data, row) factoring is the JAX dry run's."""
    assert "(data, row) = (2, 2)" in sharded.dryrun_multichip(4, "cpu")
    assert [sharded._data_row(n) for n in (1, 2, 3, 6, 8, 12)] == [
        (1, 1), (1, 2), (3, 1), (3, 2), (2, 4), (3, 4)]
