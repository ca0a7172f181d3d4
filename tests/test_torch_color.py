"""The PyTorch port's colour and low-quality ladder (plain path,
device="cpu") vs jpegqs_tpu on 4:2:0: q0-q2 (LOW_QUALITY, the JOINT_YUV
preamble without the sweep, UPSAMPLE_UV), q5/q6 (JOINT_YUV with the
sweep, UPSAMPLE_UV), the transcode bytes and the CLI.

Same decoded JPEGs (tests/util.make_jpeg at tests/test_engine.py's
4:2:0 shape, so the JAX programs are the ones that file compiles)
through ``jpegqs_tpu.engine.smooth`` and ``jpegqs_tpu_torch.smooth``;
the coefficient planes, the upsampled planes and the stop flag must be
identical (tolerance 0).  The other sampling modes are in
tests/test_torch_sampling.py.
"""

import numpy as np
import pytest
import torch

from jpegqs_tpu import engine as jax_engine
from jpegqs_tpu.host import jpegio as jax_jpegio
from jpegqs_tpu.options import QsOptions as JaxOptions
import jpegqs_tpu_torch
from jpegqs_tpu_torch import QsOptions, cli
from jpegqs_tpu_torch.host.jpegio import image_from_arrays
from util import make_jpeg

torch.set_num_threads(1)


def _c420():
    return make_jpeg(64, 48, "photo", seed=3, color=True, quality=70,
                     subsamp=1)


def assert_same(want, got):
    """Coefficient planes, upsampled planes and stop flag identical."""
    assert got.stop == want.stop
    assert len(got.coefs) == len(want.coefs)
    for ci, (a, b) in enumerate(zip(want.coefs, got.coefs)):
        assert b.dtype == np.int16 and b.shape == a.shape, f"comp {ci}"
        assert np.array_equal(a, b), (
            f"comp {ci}: {(a != b).sum()} mismatches, first at "
            f"{tuple(np.argwhere(a != b)[0])}")
    assert (got.upsampled is None) == (want.upsampled is None)
    if want.upsampled is not None:
        for a, b in zip(want.upsampled, got.upsampled):
            assert b.dtype == np.int16 and np.array_equal(a, b)


def compare(data, quality, niter):
    img = jax_jpegio.read_coefficients(data)
    want = jax_engine.smooth(img, JaxOptions.from_quality(quality, niter))
    got = jpegqs_tpu_torch.smooth(image_from_arrays(img),
                                  QsOptions.from_quality(quality, niter),
                                  device="cpu")
    assert_same(want, got)
    return got


@pytest.mark.parametrize("quality,niter", [
    (0, 3), (1, 3), (2, 3), (2, 0), (5, 3), (6, 3)])
def test_c420_ladder_matches_jax(quality, niter):
    got = compare(_c420(), quality, niter)
    # q2/q6 carry UPSAMPLE_UV: luma-size chroma planes come back
    assert (got.upsampled is not None) == (quality in (2, 6))


def test_smooth_jpeg_bytes_q6_matches_jax():
    """The transcode at q6 on 4:2:0: the output is 4:4:4 (the upsampled
    chroma planes replace the components) and byte-identical."""
    data = _c420()
    want = jax_engine.smooth_jpeg_bytes(data, JaxOptions.from_quality(6, 3))
    got = jpegqs_tpu_torch.smooth_jpeg_bytes(
        data, QsOptions.from_quality(6, 3), device="cpu")
    assert got == want
    comps = jax_jpegio.read_coefficients(got).components
    assert all(c.h_samp_factor == c.v_samp_factor == 1 for c in comps)
    assert comps[1].coefs.shape == comps[0].coefs.shape


def test_cli_q6_matches_jax(tmp_path):
    data = _c420()
    src, dst = tmp_path / "in.jpg", tmp_path / "out.jpg"
    src.write_bytes(data)
    rc = cli.main(["-q", "6", "-n", "3", "-i", "0", "--backend", "cpu",
                   str(src), str(dst)])
    assert rc == 0
    assert dst.read_bytes() == jax_engine.smooth_jpeg_bytes(
        data, JaxOptions.from_quality(6, 3))
    if not torch.cuda.is_available():
        # the default backend is the card: without one, exit 1, no output
        dst.unlink()
        assert cli.main(["-q", "0", "-i", "0", str(src), str(dst)]) == 1
        assert not dst.exists()
