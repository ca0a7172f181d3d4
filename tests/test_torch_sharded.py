"""The port's row-sharded engine vs jpegqs_tpu, on the CPU.

- Kernel B7's plain version (``cuda_solver.solve_range_pix`` on CPU
  tensors) on hand-built ghost-extended shards, with any split of the
  range and the rank's edges, against the single-device plain B2/B3/B4
  on the matching rows of the unsharded plane;
- ``parallel.sharded.make_sharded_smooth`` on ``["cpu"] * n`` against
  ``jpegqs_tpu.parallel.sharded.make_sharded_smooth`` on the JAX CPU mesh
  (its XLA path, as tests/test_sharded.py runs it) and against
  ``jpegqs_tpu.engine.component_smooth``, exchange/compute overlap off
  and on;
- ``make_sharded_ycbcr_smooth`` at q6 4:2:0 and q5 4:2:2 with padded
  shards, and ``engine._try_smooth_sharded`` against
  ``jpegqs_tpu.engine.smooth`` (a crafted file's stop across components
  too).

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
from jpegqs_tpu_torch import (DIAGONALS, JOINT_YUV, LOW_QUALITY, UPSAMPLE_UV,
                              QsOptions, engine)
from jpegqs_tpu_torch.host.jpegio import image_from_arrays
from jpegqs_tpu_torch.ops import cuda_solver, planar
from jpegqs_tpu_torch.ops.quant import make_quant_tables
from jpegqs_tpu_torch.parallel import sharded

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture
def mesh():
    """The JAX CPU mesh of n row devices (conftest makes 8)."""
    if len(jax.devices()) < 4:
        pytest.skip("needs the 8 virtual JAX devices of tests/conftest.py")
    return lambda n: Mesh(np.array(jax.devices()[:n]), ("row",))


# ---------------------------------------------------------------------------
# B7's plain version on hand-built shards
# ---------------------------------------------------------------------------

def _plane_case(hb, wb, seed, joint):
    """Coefficients near lattice points, random pixels, quant tables and,
    under JOINT_YUV, random downsampled-luma halos of an hb x wb plane."""
    rng = np.random.default_rng(seed)
    B = hb * wb
    qtbl = rng.integers(1, 120, 64).astype(np.uint16)
    coef = np.clip(rng.integers(-40, 41, (64, B))
                   * qtbl.astype(np.int32)[:, None], -32768, 32767)
    pix = rng.integers(0, 256, (64, B))
    image2 = rng.integers(0, 256, (100, B)) if joint else None
    tabs = [_t(a) for a in make_quant_tables(qtbl)]
    cast = lambda a: None if a is None else _t(a.astype(np.int32))
    return cast(coef), cast(pix), cast(image2), tabs, rng


def _ghosted(x, r, hb_loc, wb, rng):
    """Shard r of plane x int32[R, hb*wb] as the sharded loop holds it:
    its hb_loc rows between a ghost row above and one below, which hold
    the neighbour shards' boundary rows; where there is no neighbour, and
    on dead pad rows, random garbage that no edge may let a pass read."""
    R, B = x.shape
    hb = B // wb
    rows = torch.from_numpy(rng.integers(0, 256, (R, hb_loc + 2, wb)).astype(
        np.int32))
    g = x.reshape(R, hb, wb)
    for k in range(hb_loc + 2):
        src = r * hb_loc - 1 + k          # the global row of local row k
        if 0 <= src < hb:
            rows[:, k] = g[:, src]
    return rows.reshape(R, -1)


@pytest.mark.parametrize("flags,joint", [
    (0, False), (DIAGONALS, False), (JOINT_YUV | DIAGONALS, True),
    (JOINT_YUV | LOW_QUALITY | DIAGONALS, True),
    (LOW_QUALITY | DIAGONALS, False)])
@pytest.mark.parametrize("hb,wb,n", [(13, 5, 4), (7, 3, 3), (6, 4, 2),
                                     (5, 1, 1)])
def test_b7_plain_matches_single_device(flags, joint, hb, wb, n):
    """Each shard's real rows through B7 -- whole, and split at the
    first, an interior and the last row -- equal the single-device pass
    on those rows of the unsharded plane; blocks outside the range are
    left as they were."""
    coef, pix, image2, tabs, rng = _plane_case(hb, wb, hb * 10 + n + flags,
                                               joint)
    reb = not flags & LOW_QUALITY
    if image2 is None and not flags & LOW_QUALITY:
        want = cuda_solver.solve_rebalance_pix(coef, pix, *tabs, flags, reb,
                                               hb, wb)
    else:
        want = cuda_solver.solve_fused_pix(coef, pix, image2, *tabs, flags,
                                           reb, hb, wb)
    hb_loc = sharded._pad_to(hb, n) // n
    er, el = sharded._edge_pos(hb, hb_loc)
    S = (hb_loc + 2) * wb
    for r in range(er + 1):
        real = hb_loc if r < er else el + 1
        edges = (1 if r == 0 else -1, el + 1 if r == er else -1, 0, wb - 1)
        ext = [None if x is None else _ghosted(x, r, hb_loc, wb, rng)
               for x in (coef, pix, image2)]
        whole = [torch.zeros((64, S), dtype=torch.int32) for _ in range(2)]
        cuda_solver.solve_range_pix(*ext, *tabs, flags, reb, wb, wb,
                                    (real + 1) * wb, edges, *whole)
        cuts = sorted({wb, wb + 1, 2 * wb, real * wb + wb // 2,
                       (real + 1) * wb})
        parts = [torch.zeros((64, S), dtype=torch.int32) for _ in range(2)]
        for b0, b1 in zip(cuts, cuts[1:]):
            cuda_solver.solve_range_pix(*ext, *tabs, flags, reb, wb, b0, b1,
                                        edges, *parts)
        rows = slice(r * hb_loc * wb, (r * hb_loc + real) * wb)
        for k in range(2):
            assert torch.equal(parts[k], whole[k]), f"shard {r}: split"
            assert torch.equal(whole[k][:, wb:(real + 1) * wb],
                               want[k][:, rows]), f"shard {r}"
            assert not whole[k][:, :wb].any() and \
                not whole[k][:, (real + 1) * wb:].any()


def test_b7_range_checks():
    """A range that would read beyond the grid raises before it runs."""
    coef, pix, _, tabs, _ = _plane_case(3, 4, 0, False)
    out = torch.zeros_like(coef)
    for b0, b1, edges in ((0, 4, (-1, 2, 0, 3)), (8, 12, (0, -1, 0, 3)),
                          (0, 13, (0, 2, 0, 3)), (5, 3, (0, 2, 0, 3)),
                          (4, 5, (0, 2, -1, 3)), (6, 8, (0, 2, 0, -1)),
                          (7, 9, (0, 2, 1, 2))):
        with pytest.raises(ValueError):
            cuda_solver.solve_range_pix(coef, pix, None, *tabs, 0, True, 4,
                                        b0, b1, edges, out)
    with pytest.raises(ValueError):
        cuda_solver.solve_range_pix(coef, pix, None, *tabs, 0, True, 4, 0,
                                    12, (0, 2, 0, 3), out, pix)
    # a range of inner columns reads its side neighbours, so needs no flag
    cuda_solver.solve_range_pix(coef, pix, None, *tabs, 0, True, 4, 5, 7,
                                (0, 2, -1, -1), out)


# ---------------------------------------------------------------------------
# make_sharded_smooth vs the JAX package's, and vs its single-device engine
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


@pytest.mark.parametrize("flags,niter,hb,wb,n,image2,want_pix", [
    (0, 3, 16, 6, 2, False, False),
    (DIAGONALS, 2, 13, 5, 4, False, True),       # a mid-shard bottom edge
    (LOW_QUALITY | DIAGONALS, 2, 11, 4, 3, False, False),
    (JOINT_YUV | DIAGONALS, 2, 11, 6, 4, True, False)])
def test_sharded_smooth_matches_jax(mesh, monkeypatch, flags, niter, hb, wb,
                                    n, image2, want_pix):
    coef16, qtbl, rng = _component(hb, wb, hb * wb + flags)
    div, x1, qshr = make_quant_tables(qtbl)
    tabs = (qtbl, div, x1, qshr)
    interior = (rng.integers(0, 256, (hb * 8, wb * 8)).astype(np.int32)
                if image2 else None)
    extra = int(want_pix)
    want, plane, _ = jax_engine.component_smooth(
        *map(jnp.asarray, (coef16, *tabs)),
        jnp.asarray(np.pad(interior, 1, mode="edge")) if image2
        else jnp.zeros((1, 1), jnp.int32),
        hb=hb, wb=wb, flags=flags, niter=niter, extra_refresh=extra,
        luma=not image2, use_image2=image2)
    want = np.asarray(want).reshape(hb, wb, 64)
    fn = jax_sharded.make_sharded_smooth(
        mesh(n), hb=hb, wb=wb, flags=flags, niter=niter, extra_refresh=extra,
        luma=not image2, use_image2=image2, want_pix=want_pix)
    args = [coef16.reshape(hb, wb, 64), *map(jnp.asarray, tabs)]
    jres = fn(*args, interior) if image2 else fn(*args)
    assert np.array_equal(np.asarray(jres[0]), want)
    for overlap in ("0", "1"):
        monkeypatch.setenv("JPEGQS_OVERLAP", overlap)
        run = sharded.make_sharded_smooth(
            ["cpu"] * n, hb=hb, wb=wb, flags=flags, niter=niter,
            extra_refresh=extra, luma=not image2, use_image2=image2,
            want_pix=want_pix)
        got = run(coef16.reshape(hb, wb, 64), *tabs, interior)
        assert run.padded_dims == fn.padded_dims
        assert np.array_equal(got[0].numpy(), want), f"overlap {overlap}"
        assert not bool(got[1]) and not bool(jres[1])
        if want_pix:
            assert np.array_equal(got[2].numpy(), np.asarray(jres[2]))
            assert np.array_equal(planar.pix_to_plane(got[2], hb, wb).numpy(),
                                  np.asarray(plane))


# ---------------------------------------------------------------------------
# The YCbCr flow and the engine's auto-sharding
# ---------------------------------------------------------------------------

def _ycbcr_image(hb_l, wb_l, ws, hs, pad_h, pad_w, seed):
    """A JAX-package JpegImage of aligned 4:2:0 / 4:2:2 planes (as
    tests/test_sharded.py builds them), its image pad_h/pad_w pixels
    short of the block grid."""
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


def _ycbcr_args(img):
    planes = [c.coefs for c in img.components]
    tabs = []
    for c in img.components:
        qraw = np.asarray(c.quantval, np.int32)
        tabs.append((qraw, *make_quant_tables(qraw)))
    return planes, tabs


def _assert_same(want, got):
    assert got.stop == want.stop
    for ci, (a, b) in enumerate(zip(want.coefs, got.coefs)):
        assert np.array_equal(np.asarray(a), np.asarray(b)), f"comp {ci}"
    assert (got.upsampled is None) == (want.upsampled is None)
    for a, b in zip(want.upsampled or (), got.upsampled or ()):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_sharded_ycbcr_q6_420_matches_jax(mesh, monkeypatch):
    """q6 (JOINT_YUV + UPSAMPLE_UV) 4:2:0 on 4 shards: chroma 9 rows padded
    to 12, luma 18 to 24, the image 5 px short of its last block row, so
    the bottom edges and both replicate tails fall mid-shard."""
    hb_l, wb_l, n = 18, 8, 4
    img = _ycbcr_image(hb_l, wb_l, 2, 2, 5, 3, 47)
    flags = UPSAMPLE_UV | JOINT_YUV | DIAGONALS
    dims = dict(hb_l=hb_l, wb_l=wb_l, hb_c=hb_l // 2, wb_c=wb_l // 2, ws=2,
                hs=2, flags=flags, niter=2, img_w=img.width,
                img_h=img.height)
    fn = jax_sharded.make_sharded_ycbcr_smooth(mesh(n), **dims)
    planes, tabs = _ycbcr_args(img)
    jy, jcb, jcr, jbad, jups = fn(*planes, *[tuple(map(jnp.asarray, t))
                                             for t in tabs])
    assert not bool(jbad) and jups is not None
    for overlap in ("0", "1"):
        monkeypatch.setenv("JPEGQS_OVERLAP", overlap)
        run = sharded.make_sharded_ycbcr_smooth(["cpu"] * n, **dims)
        assert run.padded_dims == fn.padded_dims == (24, 8, 12, 4)
        y, cb, cr, bad, ups = run(*planes, *tabs)
        assert not bool(bad)
        for a, b in zip((jy, jcb, jcr, *jups), (y, cb, cr, *ups)):
            assert np.array_equal(np.asarray(a), b.numpy()), overlap


def test_sharded_ycbcr_q5_422_and_auto_sharding(monkeypatch):
    """q5 (JOINT_YUV) 4:2:2 on 3 shards (7 block rows padded to 9):
    make_sharded_ycbcr_smooth and engine._try_smooth_sharded both equal
    jpegqs_tpu.engine.smooth, which runs on one device."""
    img = _ycbcr_image(7, 8, 2, 1, 2, 0, 53)
    opts = JaxOptions.from_quality(5, 2)
    want = jax_engine.smooth(img, opts)
    assert want.upsampled is None
    planes, tabs = _ycbcr_args(img)
    run = sharded.make_sharded_ycbcr_smooth(
        ["cpu"] * 3, hb_l=7, wb_l=8, hb_c=7, wb_c=4, ws=2, hs=1,
        flags=opts.flags, niter=2, img_w=img.width, img_h=img.height)
    y, cb, cr, bad, ups = run(*planes, *tabs)
    assert not bool(bad) and ups is None
    for a, b in zip(want.coefs, (y, cb, cr)):
        assert np.array_equal(a, b.numpy())
    monkeypatch.setenv("JPEGQS_SHARD_MIN_BLOCKS", "0")
    got = engine._try_smooth_sharded(image_from_arrays(img),
                                     QsOptions.from_quality(5, 2),
                                     ["cpu"] * 4)
    _assert_same(want, got)
    # below the block threshold, or with no iteration, it declines
    monkeypatch.setenv("JPEGQS_SHARD_MIN_BLOCKS", "16384")
    assert engine._try_smooth_sharded(image_from_arrays(img),
                                      QsOptions.from_quality(5, 2),
                                      ["cpu"] * 4) is None
    monkeypatch.setenv("JPEGQS_SHARD_MIN_BLOCKS", "0")
    assert engine._try_smooth_sharded(image_from_arrays(img),
                                      QsOptions.from_quality(5, 0),
                                      ["cpu"] * 4) is None


def test_auto_sharding_crafted_file(monkeypatch):
    """tests/test_sharded.py's crafted two-component file: the tripping
    component keeps its clamped dequantized fallback, the later one is
    plainly dequantized, stop is set -- as jpegqs_tpu's engine does."""
    rng = np.random.default_rng(31)
    qtbl = np.full(64, 64, np.uint16)
    coefs = rng.integers(-5, 6, (2, 8, 8, 64)).astype(np.int16)
    coefs[0, 0, 0, 3] = 1000
    img = JaxImage(width=64, height=64, jpeg_color_space=2,  # not YCbCr
                   progressive=False, max_h_samp_factor=1,
                   max_v_samp_factor=1)
    for ci in range(2):
        img.components.append(JaxComponent(
            component_id=ci, h_samp_factor=1, v_samp_factor=1,
            quant_tbl_no=0, width_in_blocks=8, height_in_blocks=8,
            quantval=qtbl, coefs=coefs[ci].copy()))
    opts = JaxOptions.from_quality(3, 2)
    want = jax_engine._smooth_fused(img, opts)
    monkeypatch.setenv("JPEGQS_SHARD_MIN_BLOCKS", "0")
    got = engine._try_smooth_sharded(image_from_arrays(img),
                                     QsOptions.from_quality(3, 2),
                                     ["cpu"] * 3)
    assert got is not None and got.stop == want.stop == 1
    _assert_same(want, got)
    # smooth() on the CPU never shards
    assert engine.shard_devices(torch.device("cpu")) == []


def test_unaligned_ycbcr_declines(monkeypatch):
    """A 4:2:0 image whose luma has an odd block-row count (9 rows, 2 x 5
    chroma) is not aligned: jpegqs_tpu declines to shard its YCbCr flow,
    and so does the port; at q3 (no colour path) both shard it."""
    from util import make_jpeg
    from jpegqs_tpu.host import jpegio as jax_jpegio
    img = jax_jpegio.read_coefficients(make_jpeg(72, 56, "photo", seed=3,
                                                 color=True, quality=70))
    assert [c.height_in_blocks for c in img.components] == [9, 5, 5]
    monkeypatch.setenv("JPEGQS_SHARD_MIN_BLOCKS", "0")
    port = image_from_arrays(img)
    for q in (6, 5):
        assert jax_engine._try_smooth_sharded(
            img, JaxOptions.from_quality(q, 2)) is None
        assert engine._try_smooth_sharded(
            port, QsOptions.from_quality(q, 2), ["cpu"] * 4) is None
    assert engine._try_smooth_sharded(port, QsOptions.from_quality(3, 0),
                                      ["cpu"] * 4) is None
    assert engine._try_smooth_sharded(port, QsOptions.from_quality(3, 2),
                                      ["cpu"] * 4) is not None


def test_smooth_shards_over_every_card(monkeypatch):
    """smooth() shards over cuda:0..N-1 when the card is asked for without
    an index and there are N > 1 of them, never on one named device or
    the CPU, and never with a progress callback."""
    from jpegqs_tpu_torch import synth
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert engine.shard_devices(torch.device("cuda")) == [
        torch.device("cuda", i) for i in range(3)]
    assert engine.shard_devices(torch.device("cuda", 1)) == []
    assert engine.shard_devices(torch.device("cpu")) == []
    # the dispatch itself, with the shards on the CPU
    calls = []
    sharded_run = engine._try_smooth_sharded
    monkeypatch.setattr(engine, "shard_devices", lambda dev: ["cpu"] * 2)
    monkeypatch.setattr(engine, "_try_smooth_sharded",
                        lambda *a: calls.append(a) or sharded_run(*a))
    monkeypatch.setenv("JPEGQS_SHARD_MIN_BLOCKS", "0")
    img = synth.make_image(40, 48, seed=2)
    opts = QsOptions.from_quality(3, 2)
    got = engine.smooth(img, opts, "cpu")
    assert len(calls) == 1
    _assert_same(engine._smooth_fused(img, opts, torch.device("cpu")), got)
    engine.smooth(img, QsOptions.from_quality(3, 2, progress=lambda *a: 0),
                  "cpu")
    assert len(calls) == 1


def test_sharded_oom_degrades(monkeypatch):
    """An allocation failure inside the sharded path degrades to host-side
    dequantization, as on one device; any other failure raises."""
    from jpegqs_tpu_torch import synth

    def fail(exc):
        def run(*a):
            raise exc
        return run

    monkeypatch.setattr(engine, "shard_devices", lambda dev: ["cpu"] * 2)
    img = synth.make_image(40, 48, seed=2)
    opts = QsOptions.from_quality(3, 2)
    monkeypatch.setattr(engine, "_try_smooth_sharded",
                        fail(torch.cuda.OutOfMemoryError("no memory")))
    _assert_same(engine._smooth_degraded(img, opts),
                 engine.smooth(img, opts, "cpu"))
    monkeypatch.setattr(engine, "_try_smooth_sharded",
                        fail(RuntimeError("kernel failed")))
    with pytest.raises(RuntimeError, match="kernel failed"):
        engine.smooth(img, opts, "cpu")
