"""The benchmark's frozen copies against the program's originals on the
CPU: the photo generator against ``synth.py``, and the plain reference
against the program's plain CPU path, bit for bit."""

import numpy as np
import pytest
import torch

from jpegqs_tpu_torch import QsOptions, smooth, synth

from benchmark.harness import photos
from benchmark.harness.cell import to_reference
from benchmark.reference import image, tables


def _photo_of(img):
    """A program JpegImage as the harness's Photo."""
    return photos.Photo(img.width, img.height, img.is_ycbcr, [
        photos.Component(c.component_id, c.h_samp_factor, c.v_samp_factor,
                         c.quant_tbl_no, c.height_in_blocks,
                         c.width_in_blocks, c.quantval, c.coefs)
        for c in img.components])


@pytest.mark.parametrize("h, w, seed", [(37, 53, 3), (64, 48, 2 ** 31 + 9)])
def test_photo_pixels_equal_synth(h, w, seed):
    noise = torch.from_numpy(np.random.default_rng(seed).normal(0, 4, (h, w)))
    gray, rgb = photos.photo_pixels(h, w, noise)
    assert np.array_equal(gray.numpy(), synth.synth_image(h, w, seed))
    assert np.array_equal(rgb.numpy(), synth.synth_image(h, w, seed, True))


@pytest.mark.parametrize("h, w, seed", [(43, 61, 7), (40, 64, 2 ** 31 + 5)])
def test_photo_coefs_equal_synth(h, w, seed):
    """Geometry, tables and coefficients as synth.make_image gives them
    at the traffic's 4:2:0.  The DCT sums in another order than numpy's
    einsum, so a coefficient whose quotient lies within rounding of a
    half may round the other way: at most 1 apart, and in few places."""
    fs = photos.SAMPLING["4:2:0"]
    noise = torch.from_numpy(np.random.default_rng(seed).normal(0, 4, (h, w)))
    _, rgb = photos.photo_pixels(h, w, noise)
    ours = photos.photo_image(rgb, fs, 75)
    theirs = synth.make_image(h, w, color=True, seed=seed, quality=75,
                              sampling=fs)
    assert (ours.width, ours.height, ours.ycbcr) == (
        theirs.width, theirs.height, theirs.is_ycbcr)
    assert len(ours.comps) == len(theirs.components)
    for a, b in zip(ours.comps, theirs.components):
        assert (a.h_samp, a.v_samp, a.hb, a.wb, a.quant_tbl_no) == (
            b.h_samp_factor, b.v_samp_factor, b.height_in_blocks,
            b.width_in_blocks, b.quant_tbl_no)
        assert np.array_equal(a.quantval, b.quantval)
        d = np.abs(a.coefs.astype(np.int32) - b.coefs.astype(np.int32))
        assert d.max() <= 1 and np.count_nonzero(d) <= d.size // 1000


def test_make_pool_is_seeded():
    t = {"image_wh": "40x24", "sampling": "4:2:0", "pool_images": 3,
         "source_quality": 75}
    a = photos.make_pool(t, 2 ** 31 + 11, "cpu")
    b = photos.make_pool(t, 2 ** 31 + 11, "cpu")
    c = photos.make_pool(t, 2 ** 31 + 12, "cpu")
    flat = lambda pool: [x.coefs for p in pool for x in p.comps]
    assert all(np.array_equal(x, y) for x, y in zip(flat(a), flat(b)))
    assert not all(np.array_equal(x, y) for x, y in zip(flat(a), flat(c)))
    # the images of one pool differ
    assert not np.array_equal(a[0].comps[0].coefs, a[1].comps[0].coefs)


CASES = [  # (h, w, colour, sampling, quality, niter)
    (40, 56, True, (2, 2), 3, 3),
    (43, 61, True, (2, 2), 6, 3),
    (48, 64, True, (2, 2), 6, 2),
    (40, 48, True, (2, 1), 6, 2),
    (32, 40, True, (1, 1), 5, 2),
    (37, 45, True, (2, 2), 2, 2),
    (40, 40, True, (2, 2), 0, 1),
    (29, 31, False, None, 3, 2),
    (33, 40, False, None, 4, 1),
]


@pytest.mark.parametrize("h, w, colour, sampling, quality, niter", CASES)
def test_reference_equals_the_program_plain_path(h, w, colour, sampling,
                                                 quality, niter):
    img = synth.make_image(h, w, color=colour, seed=h * w,
                           sampling=sampling or (2, 2))
    want = smooth(img, QsOptions.from_quality(quality, niter), device="cpu")
    got = image.smooth_image(to_reference(_photo_of(img)),
                             tables.quality_to_flags(quality), niter, "cpu")
    assert got.stop == want.stop
    for a, b in zip(got.coefs, want.coefs):
        assert a.dtype == np.int16 and np.array_equal(a, b)
    assert (got.upsampled is None) == (want.upsampled is None)
    if got.upsampled is not None:
        for a, b in zip(got.upsampled, want.upsampled):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("damage", ["coef", "qtable", "ones"])
def test_reference_equals_the_program_on_damaged_input(damage):
    """The guard's fallback, a crafted file's static stop and a table of
    ones take the same way in both."""
    img = synth.damage(synth.make_image(40, 48, color=True, seed=5),
                       damage, 0, seed=1)
    want = smooth(img, QsOptions.from_quality(6, 2), device="cpu")
    got = image.smooth_image(to_reference(_photo_of(img)),
                             tables.quality_to_flags(6), 2, "cpu")
    assert got.stop == want.stop
    for a, b in zip(got.coefs, want.coefs):
        assert np.array_equal(a, b)
    assert (got.upsampled is None) == (want.upsampled is None)


def test_quant_tables_equal_the_program():
    from jpegqs_tpu_torch.ops.quant import make_quant_tables
    q = synth.quality_table(synth.STD_LUMA, 75)
    for a, b in zip(tables.quant_tables(q), make_quant_tables(q)):
        assert np.array_equal(a, b)
