"""The port's decode path (plain path, device="cpu") vs jpegqs_tpu.

``jpegqs_tpu_torch.decode_smoothed`` against ``jpegqs_tpu.decode_smoothed``
on the same JPEG bytes, at tests/test_api.py's shapes and options (so the
JAX programs are the ones that file compiles): gray, 4:2:0, 4:2:2, 4:4:4,
q6 (the upsampled planes) and CMYK (the libjpeg fallback).  Then
ops/colorout.py function by function against jpegqs_tpu.ops.colorout on
seeded random planes.  Pixels must be identical (tolerance 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jpegqs_tpu
from jpegqs_tpu.ops import colorout as jax_colorout
from jpegqs_tpu.options import QsOptions as JaxOptions
import jpegqs_tpu_torch
from jpegqs_tpu_torch import QsOptions, engine
from jpegqs_tpu_torch.host.jpegio import read_coefficients
from jpegqs_tpu_torch.ops import colorout
from util import make_jpeg

torch.set_num_threads(1)


@pytest.mark.parametrize("h,w,color,subsamp,quality,native", [
    (103, 97, False, 1, 3, True),     # gray, odd dims
    (50, 42, True, 1, 3, True),       # 4:2:0, odd chroma crops
    (48, 56, True, 1, 6, True),       # q6: the upsampled planes, 1x1
    (50, 42, True, 2, 5, True),       # 4:2:2, h2v1 fancy
    (40, 40, True, 0, 5, True),       # 4:4:4, no upsampling
    (48, 48, "cmyk", 1, 3, False),    # CMYK: the libjpeg fallback
], ids=["gray", "c420", "c420_q6", "c422", "c444", "cmyk"])
def test_decode_smoothed_matches_jax(h, w, color, subsamp, quality, native):
    data = make_jpeg(h, w, "photo", seed=9 if color != "cmyk" else 25,
                     color=color, quality=70, subsamp=subsamp)
    want = jpegqs_tpu.decode_smoothed(data, JaxOptions.from_quality(
        quality, 2))
    opts = QsOptions.from_quality(quality, 2)
    got = jpegqs_tpu_torch.decode_smoothed(data, opts, device="cpu")
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want)
    img = read_coefficients(data)
    res = engine.smooth(img, opts, "cpu")
    assert (engine._decode_native(img, res, "cpu") is not None) == native
    if quality == 6:
        assert res.upsampled is not None


def _rng_plane(rng, shape, lo=0, hi=256):
    return rng.integers(lo, hi, shape).astype(np.int32)


def test_coefs_to_plane_matches_jax():
    rng = np.random.default_rng(1)
    hb, wb = 5, 7
    coef = rng.integers(-400, 401, (hb, wb, 64)).astype(np.int16)
    for oh, ow in ((40, 56), (37, 51)):
        want = np.asarray(jax_colorout.coefs_to_plane(jnp.asarray(coef), hb,
                                                      wb, oh, ow))
        got = colorout.coefs_to_plane(torch.from_numpy(coef), hb, wb, oh, ow)
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("ws,hs", [(1, 1), (2, 1), (2, 2)])
def test_fancy_upsample_matches_jax(ws, hs):
    rng = np.random.default_rng(ws + 3 * hs)
    for shape in ((9, 13), (1, 1), (2, 5)):
        plane = _rng_plane(rng, shape)
        want = np.asarray(jax_colorout.fancy_upsample(jnp.asarray(plane), ws,
                                                      hs))
        got = colorout.fancy_upsample(torch.from_numpy(plane), ws, hs)
        assert np.array_equal(got.numpy(), want)
    t = _rng_plane(rng, (6, 11), 0, 1021)
    for args in ((8, 7, 4), (1, 2, 2)):
        want = np.asarray(jax_colorout._h2_fancy_cols(jnp.asarray(t), *args))
        got = colorout._h2_fancy_cols(torch.from_numpy(t), *args)
        assert np.array_equal(got.numpy(), want)


def test_ycc_to_rgb_matches_jax():
    rng = np.random.default_rng(4)
    y, cb, cr = (_rng_plane(rng, (31, 45)) for _ in range(3))
    # every chroma value and the clamps' edges
    cb[0, :] = np.arange(45) * 255 // 44
    cr[1, :] = np.arange(45) * 255 // 44
    y[2, :] = 0
    y[3, :] = 255
    want = np.asarray(jax_colorout.ycc_to_rgb(*(jnp.asarray(a)
                                                for a in (y, cb, cr))))
    got = colorout.ycc_to_rgb(*(torch.from_numpy(a) for a in (y, cb, cr)))
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)


def test_decode_ycc_matches_jax():
    rng = np.random.default_rng(7)
    H, W, ws, hs = 37, 45, 2, 2
    dims = ((5, 6, 37, 45), (3, 3, 19, 23), (3, 3, 19, 23))
    planes = [rng.integers(-300, 301, (d[0], d[1], 64)).astype(np.int16)
              for d in dims]
    want = np.asarray(jax_colorout.decode_ycc_impl(
        *(jnp.asarray(p) for p in planes), dims=dims, ws=ws, hs=hs, H=H,
        W=W))
    got = colorout.decode_ycc(*(torch.from_numpy(p) for p in planes),
                              dims=dims, ws=ws, hs=hs, H=H, W=W)
    assert np.array_equal(got.numpy(), want)
    want = np.asarray(jax_colorout.decode_gray_impl(
        jnp.asarray(planes[0]), hb=5, wb=6, H=H, W=W))
    got = colorout.decode_gray(torch.from_numpy(planes[0]), 5, 6, H, W)
    assert np.array_equal(got.numpy(), want)
