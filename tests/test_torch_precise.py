"""The port's PRECISE_PROGRESS path (plain path, device="cpu") vs
jpegqs_tpu: ``smooth`` with ``precise=True`` runs each iteration as row
chunks cut where the progress counter crosses its threshold (kernels
B5/B6 on column-slice views of the whole plane's neighbourhood).  The
(cur, max) trace, the coefficient planes, the upsampled planes, the
stop flag and the partial state after a mid-iteration cancel must be
identical to ``jpegqs_tpu.engine.smooth`` (tolerance 0).  Split from
tests/test_torch_progress.py, whose helpers it uses, to keep each file
near a minute on the CPU.
"""

import numpy as np
import pytest
import torch

import jpegqs_tpu_torch
from jpegqs_tpu_torch import QsOptions, quality_to_flags
from test_torch_progress import c420, compare, gray

torch.set_num_threads(1)


@pytest.mark.parametrize("progprec,calls", [(-1, 12), (0, 12), (5, 5)])
def test_gray_q3_precise_trace(progprec, calls):
    """4 block rows x 3 iterations: one callback per row at -1 and at 0
    (20 steps, finer than a row); chunks of two and three rows at 5."""
    trace, _ = compare(gray(), quality_to_flags(3), 3, progprec,
                       precise=True)
    assert len(trace) == calls


def test_c420_q6_precise_trace():
    """Row chunks of the luma (two rows of progress per block row at
    4:2:0) and of the JOINT_YUV chroma, then the plane-form colour
    chain."""
    trace, got = compare(c420(), quality_to_flags(6), 2, -1, precise=True)
    assert got.upsampled is not None
    assert [c for c, _ in trace] == sorted(c for c, _ in trace)


@pytest.mark.parametrize("cancel_at", [3, 6])
def test_precise_cancel_mid_iteration(cancel_at):
    """A cancel inside an iteration (one callback per block row of 4):
    the rows before the cancel row carry the new iteration, the rows
    after keep the previous one; stop is set."""
    img = gray()
    trace, got = compare(img, quality_to_flags(3), 3, -1, precise=True,
                         cancel_at=cancel_at)
    assert len(trace) == cancel_at and got.stop == 1
    if cancel_at < 4:       # in the first iteration: against one full one
        one = jpegqs_tpu_torch.smooth(img, QsOptions.from_quality(3, 1),
                                      "cpu")
        c = img.components[0]
        dq = np.clip(c.coefs.astype(np.int32)
                     * c.quantval.astype(np.int32), -1023, 1023)
        assert np.array_equal(got.coefs[0][:cancel_at],
                              one.coefs[0][:cancel_at])
        assert np.array_equal(got.coefs[0][cancel_at:], dq[cancel_at:])
