"""The port's batch engine (plain path, device="cpu").

``smooth_image_batch`` / ``smooth_plane_batch`` / ``smooth_many`` and the
CLI's ``--batch`` against the port's own per-image ``smooth`` (already
held to jpegqs_tpu by tests/test_torch_engine.py and its neighbours), and
against ``jpegqs_tpu.batch`` in two configurations at tests/test_batch.py's
shapes, so the JAX programs are the ones that file compiles.  The block
glue's image axis against the same glue image by image.  Every comparison
is bit for bit (tolerance 0).
"""

import numpy as np
import pytest
import torch

import chip_smoke
import jpegqs_tpu_torch
from jpegqs_tpu import batch as jax_batch
from jpegqs_tpu.host import jpegio as jax_jpegio
from jpegqs_tpu.options import QsOptions as JaxOptions
from jpegqs_tpu_torch import QsOptions, batch, cli, engine, quality_to_flags
from jpegqs_tpu_torch.host.jpegio import (ComponentData, JpegImage,
                                          JCS_YCBCR, image_from_arrays,
                                          read_coefficients)
from jpegqs_tpu_torch.ops import planar
from util import make_jpeg

torch.set_num_threads(1)


def _color(n, subsamp=1, h=48, w=64, seed0=100):
    return [read_coefficients(make_jpeg(h, w, "photo", seed=seed0 + s,
                                        color=True, quality=70,
                                        subsamp=subsamp)) for s in range(n)]


def _gray(n, h=48, w=48):
    return [read_coefficients(make_jpeg(h, w, "photo", seed=s, quality=70))
            for s in range(n)]


def _assert_same(want, got, what=""):
    assert got.stop == want.stop, what
    assert len(got.coefs) == len(want.coefs), what
    for ci, (a, b) in enumerate(zip(want.coefs, got.coefs)):
        assert b.dtype == np.int16 and b.shape == a.shape, f"{what} comp {ci}"
        assert np.array_equal(a, b), f"{what} comp {ci}"
    assert (got.upsampled is None) == (want.upsampled is None), what
    for a, b in zip(want.upsampled or (), got.upsampled or ()):
        assert np.array_equal(a, b), f"{what} upsampled"


def _per_image(imgs, opts):
    return [engine.smooth(im, opts, "cpu") for im in imgs]


@pytest.mark.parametrize("quality", [0, 3, 5, 6])
def test_image_batch_matches_per_image(quality):
    imgs = _color(3)
    opts = QsOptions.from_quality(quality, 3)
    got = batch.smooth_image_batch(imgs, opts, device="cpu")
    for i, (w, g) in enumerate(zip(_per_image(imgs, opts), got)):
        _assert_same(w, g, f"image {i}")
    if quality == 6:
        assert all(g.upsampled is not None for g in got)


def test_image_batch_422_q6():
    imgs = _color(3, subsamp=2)
    assert imgs[0].components[0].h_samp_factor == 2
    assert imgs[0].components[0].v_samp_factor == 1
    opts = QsOptions.from_quality(6, 3)
    got = batch.smooth_image_batch(imgs, opts, device="cpu")
    for i, (w, g) in enumerate(zip(_per_image(imgs, opts), got)):
        _assert_same(w, g, f"image {i}")


def test_image_batch_of_five_is_exact_and_order_free():
    """N = 5 runs as 5 (no padding): each image's result depends on no
    neighbour on the block axis, so any order gives the same results."""
    imgs = _color(5)
    opts = QsOptions.from_quality(6, 2)
    got = batch.smooth_image_batch(imgs, opts, device="cpu")
    assert len(got) == 5
    for i, (w, g) in enumerate(zip(_per_image(imgs, opts), got)):
        _assert_same(w, g, f"image {i}")
    order = [3, 0, 4, 2, 1]
    shuffled = batch.smooth_image_batch([imgs[i] for i in order], opts,
                                        device="cpu")
    for k, i in enumerate(order):
        _assert_same(got[i], shuffled[k], f"image {i} at {k}")


def _crafted(seed, trip):
    """chip_smoke.crafted_image's geometry and flat table (64): three
    6x8-block YCbCr components; ``trip`` puts a dequantized coefficient
    past int16 (1000 * 64) in the second one."""
    rng = np.random.default_rng(seed)
    planes = rng.integers(-5, 6, (3, 6, 8, 64)).astype(np.int16)
    if trip:
        planes[1, 0, 0, 3] = 1000
    img = JpegImage(width=64, height=48, jpeg_color_space=JCS_YCBCR,
                    progressive=False, max_h_samp_factor=1,
                    max_v_samp_factor=1)
    for ci, plane in enumerate(planes):
        img.components.append(ComponentData(
            component_id=ci, h_samp_factor=1, v_samp_factor=1,
            quant_tbl_no=0, width_in_blocks=8, height_in_blocks=6,
            quantval=np.full(64, 64, np.uint16), coefs=plane.copy()))
    return img


@pytest.mark.parametrize("quality", [3, 6])
def test_image_batch_crafted_guard_stops_one_image(quality):
    ref = chip_smoke.crafted_image("bad_second_comp")
    imgs = [_crafted(11, False), _crafted(12, True), _crafted(13, False)]
    assert np.array_equal(imgs[0].components[0].quantval,
                          ref.components[0].quantval)
    opts = QsOptions.from_quality(quality, 3)
    got = batch.smooth_image_batch(imgs, opts, device="cpu")
    for i, (w, g) in enumerate(zip(_per_image(imgs, opts), got)):
        _assert_same(w, g, f"image {i}")
    assert [g.stop for g in got] == [0, 1, 0]
    bad = imgs[1].components
    # the tripping component keeps its guard fallback, clamped; the one
    # after it comes out plain-dequantized, unclamped
    dq = [(c.coefs.astype(np.int32) * 64).astype(np.int16) for c in bad]
    assert np.array_equal(got[1].coefs[1], np.clip(dq[1], -1023, 1023))
    assert np.array_equal(got[1].coefs[2], dq[2])
    assert not np.array_equal(got[1].coefs[0], dq[0])   # smoothed
    for i in (0, 2):
        assert any(not np.array_equal(
            g, (c.coefs.astype(np.int32) * 64).astype(np.int16))
            for g, c in zip(got[i].coefs, imgs[i].components))


@pytest.mark.parametrize("quality", [0, 3, 4])
def test_plane_batch_matches_per_image(quality):
    imgs = _gray(3)
    qtbl = imgs[0].components[0].quantval
    coefs = np.stack([im.components[0].coefs for im in imgs])
    flags = quality_to_flags(quality)
    got = batch.smooth_plane_batch(coefs, qtbl, flags, 3, device="cpu")
    assert got.shape == coefs.shape and got.dtype == np.int16
    want = _per_image(imgs, QsOptions(flags=flags, niter=3))
    for i, w in enumerate(want):
        assert np.array_equal(got[i], w.coefs[0]), f"image {i}"


def test_batches_match_jax():
    """jpegqs_tpu.batch on the same inputs: 4:2:0 q6 n3 through
    smooth_image_batch and gray q0 n3 through smooth_plane_batch."""
    datas = [make_jpeg(48, 64, "photo", seed=100 + s, color=True,
                       quality=70, subsamp=1) for s in range(3)]
    jimgs = [jax_jpegio.read_coefficients(d) for d in datas]
    want = jax_batch.smooth_image_batch(jimgs, JaxOptions.from_quality(6, 3))
    got = jpegqs_tpu_torch.smooth_image_batch(
        [image_from_arrays(im) for im in jimgs], QsOptions.from_quality(6, 3),
        device="cpu")
    for i, (w, g) in enumerate(zip(want, got)):
        _assert_same(w, g, f"image {i}")

    gimgs = [jax_jpegio.read_coefficients(make_jpeg(
        48, 48, "photo", seed=s, quality=70)) for s in range(3)]
    coefs = np.stack([im.components[0].coefs for im in gimgs])
    qtbl = gimgs[0].components[0].quantval
    flags = quality_to_flags(0)
    want = jax_batch.smooth_plane_batch(coefs, qtbl, flags, 3)
    got = jpegqs_tpu_torch.smooth_plane_batch(coefs, qtbl, flags, 3,
                                              device="cpu")
    assert np.array_equal(want, got)


def _corpus():
    """Two buckets (3 gray 48x48, 2 colour 4:2:0 64x48) and a singleton."""
    datas = [make_jpeg(48, 48, "photo", seed=s, quality=70)
             for s in range(3)]
    datas += [make_jpeg(64, 48, "photo", seed=10 + s, color=True,
                        quality=60, subsamp=1) for s in range(2)]
    datas.append(make_jpeg(40, 56, "edges", seed=20, quality=85))
    return datas


def test_smooth_many_matches_sequential_and_jax():
    datas = _corpus()
    opts = QsOptions.from_quality(3, 2)
    seq = [engine.smooth_jpeg_bytes(d, opts, device="cpu") for d in datas]
    got = jpegqs_tpu_torch.smooth_many(datas, opts, workers=3, device="cpu")
    assert got == seq
    jax_opts = JaxOptions.from_quality(3, 2)
    assert jax_batch.smooth_many(datas, jax_opts, workers=3) == got
    # an undecodable input raises, after the others ran, as in jpegqs_tpu
    bad = datas[:4] + [b"garbage"] + datas[4:]
    with pytest.raises(ValueError) as port_err:
        batch.smooth_corpus(bad, opts, workers=3, max_batch=2, window=1,
                            device="cpu")
    with pytest.raises(ValueError) as jax_err:
        jax_batch.smooth_corpus(bad, jax_opts, workers=3, max_batch=2,
                                window=1)
    assert str(port_err.value) == str(jax_err.value)


def test_cli_batch_matches_per_file_runs(tmp_path, capsys):
    datas = _corpus()[2:]
    src = tmp_path / "in"
    src.mkdir()
    paths = []
    for i, d in enumerate(datas):
        p = src / f"img{i}.jpg"
        p.write_bytes(d)
        paths.append(str(p))
    out = tmp_path / "out"
    args = ["-q", "3", "-n", "2", "-i", "0", "--backend", "cpu"]
    assert cli.main(["--batch", *args, *paths, str(out)]) == 0
    for i, p in enumerate(paths):
        single = tmp_path / f"single{i}.jpg"
        assert cli.main([*args, p, str(single)]) == 0
        assert (out / f"img{i}.jpg").read_bytes() == single.read_bytes()
    other = tmp_path / "other"
    other.mkdir()
    (other / "img0.jpg").write_bytes(datas[0])
    capsys.readouterr()
    assert cli.main(["--batch", *args, paths[0], str(other / "img0.jpg"),
                     str(tmp_path / "dup")]) == 1
    assert "duplicate output names in batch: img0.jpg" in \
        capsys.readouterr().err
    assert cli.main(["--batch", *args, paths[0]]) == 1       # usage


@pytest.mark.parametrize("ws,hs", [(1, 1), (2, 1), (2, 2)])
def test_block_glue_image_axis(ws, hs):
    """borders_from_blocks, downsample_blocks, blocks_halo10 and
    upsample_chroma_blocks on 3 images back to back equal the same glue
    image by image, on an odd block grid (the replicate tails)."""
    rng = np.random.default_rng(ws * 10 + hs)
    n, hbl, wbl = 3, 5, 7
    hbc, wbc = -(-hbl // hs), -(-wbl // ws)
    img_w, img_h = wbl * 8 - 5, hbl * 8 - 3
    pix = torch.from_numpy(rng.integers(0, 256, (8, 8, n, hbl * wbl)).astype(
        np.int32))
    chroma = torch.from_numpy(rng.integers(0, 256, (8, 8, n, hbc * wbc))
                              .astype(np.int32))
    flat = lambda t: t.reshape(t.shape[0], t.shape[1], -1)
    one = [pix[:, :, i] for i in range(n)]

    for got, parts in zip(planar.borders_from_blocks(flat(pix), hbl, wbl),
                          zip(*[planar.borders_from_blocks(p, hbl, wbl)
                                for p in one])):
        assert torch.equal(got, torch.cat(parts, dim=1))
    ds = planar.downsample_blocks(flat(pix), hbl, wbl, hbc, wbc, ws, hs)
    ds1 = [planar.downsample_blocks(p, hbl, wbl, hbc, wbc, ws, hs)
           for p in one]
    assert torch.equal(ds, torch.cat(ds1, dim=2))
    i2 = planar.blocks_halo10(ds, hbc, wbc)
    ch = planar.blocks_halo10(flat(chroma), hbc, wbc)
    up = planar.upsample_chroma_blocks(ch, i2, flat(pix), img_w, img_h, ws,
                                       hs, hbl, wbl, hbc, wbc)
    up1 = [planar.upsample_chroma_blocks(
        planar.blocks_halo10(chroma[:, :, i], hbc, wbc),
        planar.blocks_halo10(ds1[i], hbc, wbc), one[i], img_w, img_h, ws, hs,
        hbl, wbl, hbc, wbc) for i in range(n)]
    assert torch.equal(up, torch.cat(up1, dim=2))


def test_batch_entry_points_need_the_card():
    """Without a card the new entry points raise unless device="cpu"
    (skip where a card is present)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    imgs = _gray(2)
    coefs = np.stack([im.components[0].coefs for im in imgs])
    data = make_jpeg(16, 16, "photo", seed=1, quality=70)
    opts = QsOptions.from_quality(3, 1)
    for call in (
            lambda: jpegqs_tpu_torch.smooth_image_batch(imgs, opts),
            lambda: jpegqs_tpu_torch.smooth_plane_batch(
                coefs, imgs[0].components[0].quantval, 0, 1),
            lambda: jpegqs_tpu_torch.smooth_many([data, data], opts),
            lambda: jpegqs_tpu_torch.decode_smoothed(data, opts)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    for name in ("smooth_many", "smooth_plane_batch", "smooth_image_batch",
                 "decode_smoothed"):
        assert name in jpegqs_tpu_torch.__all__
