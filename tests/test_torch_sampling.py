"""The PyTorch port (plain path, device="cpu") vs jpegqs_tpu across
sampling modes: gray q0, 4:4:4 q6, 4:2:2 q5, 4:4:0 q6 and 4:1:1 q5 (the
plane path for sampling factors above 2).

Same decoded JPEGs (tests/util.make_jpeg at tests/test_engine.py's
shapes and niter for each mode) through both engines; coefficient
planes, upsampled planes and the stop flag must be identical
(tolerance 0).  Kept apart from tests/test_torch_color.py so that each
file stays within about a minute on the CPU (every case compiles one
whole-image JAX program).
"""

import pytest
import torch

from util import make_jpeg
from test_torch_color import compare

torch.set_num_threads(1)

_CASES = {
    # name: (make_jpeg args, quality, niter)
    "gray_q0": (dict(h=64, w=64, seed=1, quality=70), 0, 3),
    "c444_q6": (dict(h=48, w=56, seed=5, color=True, quality=80,
                     subsamp=0), 6, 3),
    "c422_q5": (dict(h=48, w=56, seed=5, color=True, quality=80,
                     subsamp=2), 5, 3),
    "c440_q6": (dict(h=56, w=48, seed=17, color=True, quality=75,
                     subsamp=3), 6, 3),
    "c411_q5": (dict(h=48, w=72, seed=23, color=True, quality=75,
                     subsamp=4), 5, 2),
}


@pytest.mark.parametrize("name", list(_CASES))
def test_sampling_mode_matches_jax(name):
    args, quality, niter = _CASES[name]
    got = compare(make_jpeg(kind="photo", **args), quality, niter)
    # UPSAMPLE_UV output exists where the chroma is subsampled
    assert (got.upsampled is not None) == (name == "c440_q6")
