"""The port's progress-callback path (plain path, device="cpu") vs
jpegqs_tpu: kernels B5/B6 on given neighbourhoods, and ``smooth`` with a
recording callback, one device pass per iteration.

B5 (``solve_rebalance``) and B6 (``solve_fused``) take CPU tensors to
their plain versions; they are held against
``jpegqs_tpu.engine.block_pass_p`` (its XLA planar branch) with the
border lines or halos given, on a whole plane and on a row-chunk view.
``smooth`` with a callback is held against ``jpegqs_tpu.engine.smooth``
with one: the (cur, max) trace, the coefficient planes, the upsampled
planes and the stop flag must be identical (tolerance 0), cancels
included.  PRECISE_PROGRESS row chunks are in tests/test_torch_precise.py.
The images are tiny synthetic ones (jpegqs_tpu_torch.synth).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import chip_smoke
import jpegqs_tpu_torch
from jpegqs_tpu import engine as jax_engine
from jpegqs_tpu import specref as jax_specref
from jpegqs_tpu.host import jpegio as jax_jpegio
from jpegqs_tpu.ops.quant import make_quant_tables as jax_quant_tables
from jpegqs_tpu.options import QsOptions as JaxOptions
from jpegqs_tpu_torch import (DIAGONALS, JOINT_YUV, LOW_QUALITY, NO_REBALANCE,
                              QsOptions, quality_to_flags, synth)
from jpegqs_tpu_torch.ops import cuda_solver
from jpegqs_tpu_torch.ops.quant import make_quant_tables

torch.set_num_threads(1)


def gray():
    return synth.make_image(32, 40, color=False, seed=1)


def c420():
    return synth.make_image(32, 48, color=True, seed=3)


def c444():
    return synth.make_image(24, 32, color=True, seed=5, sampling=(1, 1))


def jax_image(img):
    """The same decoded image as jpegqs_tpu's own JpegImage."""
    out = jax_jpegio.JpegImage(
        width=img.width, height=img.height,
        jpeg_color_space=img.jpeg_color_space, progressive=img.progressive,
        max_h_samp_factor=img.max_h_samp_factor,
        max_v_samp_factor=img.max_v_samp_factor)
    for c in img.components:
        out.components.append(jax_jpegio.ComponentData(
            component_id=c.component_id, h_samp_factor=c.h_samp_factor,
            v_samp_factor=c.v_samp_factor, quant_tbl_no=c.quant_tbl_no,
            width_in_blocks=c.width_in_blocks,
            height_in_blocks=c.height_in_blocks,
            quantval=c.quantval.copy(), coefs=c.coefs.copy()))
    return out


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


def recorder(calls, cancel_at=0):
    """A callback that records (userdata, cur, max) and cancels at call
    ``cancel_at`` (never when 0)."""
    def cb(userdata, cur, mx):
        calls.append((userdata, cur, mx))
        return bool(cancel_at) and len(calls) >= cancel_at
    return cb


def compare(img, flags, niter, progprec=0, precise=False, cancel_at=0):
    """Run both engines with a recording callback; the traces and
    results must agree.  Returns (trace, port result)."""
    want_calls, got_calls = [], []
    kw = dict(flags=flags, niter=niter, progprec=progprec, precise=precise,
              userdata="u")
    want = jax_engine.smooth(jax_image(img), JaxOptions(
        progress=recorder(want_calls, cancel_at), **kw))
    got = jpegqs_tpu_torch.smooth(img, QsOptions(
        progress=recorder(got_calls, cancel_at), **kw), device="cpu")
    assert got_calls == want_calls
    assert_same(want, got)
    if not cancel_at:
        # a callback that never cancels leaves the output as without one
        assert_same(jpegqs_tpu_torch.smooth(
            img, QsOptions(flags=flags, niter=niter), device="cpu"), got)
    return [c[1:] for c in got_calls], got


# --- B5 / B6 plain versions vs block_pass_p on given neighbourhoods --------

HB, WB = 5, 7          # the plane; the chunk is block rows 2..3


def _pass_inputs(seed, joint):
    rng = np.random.default_rng(seed)
    B = HB * WB
    qtbl = rng.integers(1, 120, 64).astype(np.uint16)
    coef = np.clip(rng.integers(-40, 41, (64, B))
                   * qtbl.astype(np.int32)[:, None], -32768, 32767
                   ).astype(np.int32)
    borders = rng.integers(0, 256, (32, B)).astype(np.int32)
    halo = rng.integers(0, 256, (100, B)).astype(np.int32)
    image2 = (rng.integers(0, 256, (100, B)).astype(np.int32) if joint
              else None)
    return qtbl, coef, borders, halo, image2


def _jax_pass(qtbl, coef, borders, halo, image2, flags):
    """block_pass_p with the neighbourhood given: the borders, or the
    halo (whose edge lines are then the solver borders, as in
    pallas_solver.solve_fused)."""
    div, x1, qshr = (jnp.asarray(a) for a in jax_quant_tables(qtbl))
    B = coef.shape[1]
    tables = (None if flags & LOW_QUALITY
              else jax_specref.make_solver_tables(flags))
    if halo is not None:
        h = halo.reshape(10, 10, B)
        borders = np.concatenate([h[0, 1:9], h[9, 1:9], h[1:9, 0],
                                  h[1:9, 9]])
    out, _ = jax_engine.block_pass_p(
        jnp.asarray(coef), None,
        None if image2 is None else jnp.asarray(image2).reshape(10, 10, B),
        div, x1, qshr, flags, tables, True,
        lambda p: jnp.asarray(halo).reshape(10, 10, B),
        lambda p: tuple(jnp.asarray(borders[8 * j:8 * j + 8])
                        for j in range(4)), HB, WB)
    return np.asarray(out)


@pytest.mark.parametrize("flags", [0, DIAGONALS | NO_REBALANCE])
def test_plain_solve_rebalance_vs_block_pass(flags):
    """B5's plain version on given borders, the whole plane and a row
    chunk given as column-slice views (rebalance on and off)."""
    qtbl, coef, borders, _, _ = _pass_inputs(flags + 1, False)
    tabs = [torch.from_numpy(a) for a in make_quant_tables(qtbl)]
    reb = not flags & NO_REBALANCE
    got, pix = cuda_solver.solve_rebalance(
        torch.from_numpy(coef), torch.from_numpy(borders), *tabs, flags, reb,
        want_pix=True)
    want = _jax_pass(qtbl, coef, borders, None, None, flags)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(pix.numpy().reshape(8, 8, -1),
                          jax_specref.idct_islow(want.T.reshape(-1, 8, 8)
                                                 ).transpose(1, 2, 0))
    s = slice(2 * WB, 4 * WB)
    chunk, none = cuda_solver.solve_rebalance(
        torch.from_numpy(coef)[:, s], torch.from_numpy(borders)[:, s], *tabs,
        flags, reb)
    assert none is None and chunk.is_contiguous()
    assert np.array_equal(chunk.numpy(), want[:, s])


@pytest.mark.parametrize("flags,joint", [
    (JOINT_YUV | DIAGONALS, True),                  # q6 chroma: sweep
    (JOINT_YUV | LOW_QUALITY | DIAGONALS, True),    # q2 chroma: no sweep
    (LOW_QUALITY | DIAGONALS | NO_REBALANCE, False)])
def test_plain_solve_fused_vs_block_pass(flags, joint):
    """B6's plain version on given halos (and image2), the whole plane
    and a row chunk given as column-slice views."""
    qtbl, coef, _, halo, image2 = _pass_inputs(flags, joint)
    tabs = [torch.from_numpy(a) for a in make_quant_tables(qtbl)]
    reb = not flags & NO_REBALANCE
    t = lambda a: None if a is None else torch.from_numpy(a)
    got, _ = cuda_solver.solve_fused(t(coef), t(halo), t(image2), *tabs,
                                     flags, reb)
    want = _jax_pass(qtbl, coef, None, halo, image2, flags)
    assert np.array_equal(got.numpy(), want)
    s = slice(2 * WB, 4 * WB)
    chunk, _ = cuda_solver.solve_fused(
        t(coef)[:, s], t(halo)[:, s],
        None if image2 is None else t(image2)[:, s], *tabs, flags, reb)
    assert np.array_equal(chunk.numpy(), want[:, s])


# --- smooth with a callback, one pass per iteration ------------------------

@pytest.mark.parametrize("progprec", [0, 5, -1])
def test_gray_q3_trace(progprec):
    trace, _ = compare(gray(), quality_to_flags(3), 3, progprec)
    mx = {0: 20, 5: 5, -1: 12}[progprec]      # 4 block rows x 3 iterations
    assert trace and all(m == mx for _, m in trace)


@pytest.mark.parametrize("quality", [6, 2])
def test_c420_trace(quality):
    """q6: B5 on the luma, B6 (JOINT, sweep) on the chroma, with the
    plane-form downsample and upsample at factors 2; q2: B6 (LQ) on the
    luma, B6 (JOINT, no sweep) on the chroma."""
    _, got = compare(c420(), quality_to_flags(quality), 3)
    assert got.upsampled is not None


def test_gray_q0_trace():
    compare(gray(), quality_to_flags(0), 3)


def test_cancel_at_first_callback():
    """The luma keeps its first iteration; the chroma is dequantized
    only; stop is set and no upsampled planes come out."""
    img = c420()
    trace, got = compare(img, quality_to_flags(6), 3, cancel_at=1)
    assert len(trace) == 1 and got.stop == 1 and got.upsampled is None
    for ci in (1, 2):
        c = img.components[ci]
        dq = (c.coefs.astype(np.int32)
              * c.quantval.astype(np.int32)).astype(np.int16)
        assert np.array_equal(got.coefs[ci], dq)


@pytest.mark.parametrize("quality", [4, 5])
def test_skipped_component_share(quality):
    """A luma table of all 1 (val <= 1): the component is skipped (at q4)
    or only refreshed for the colour path (at q5), and its share still
    counts toward the later components' cur values."""
    img = c420()
    img.components[0].quantval = np.ones(64, np.uint16)
    trace, _ = compare(img, quality_to_flags(quality), 3)
    assert trace[0][0] > 0


def test_bad_second_component():
    """The dequantization guard trips on the second component: it falls
    back to its dequantized coefficients, the third is dequantized
    only, stop is set."""
    _, got = compare(chip_smoke.crafted_image("bad_second_comp"),
                     quality_to_flags(3), 3)
    assert got.stop == 1


def test_progress_oom_and_default_device(monkeypatch):
    """With a callback too, a device allocation failure in a pass
    degrades to plain host dequantization, and without a card the
    default device raises."""
    img = c420()
    calls = []
    opts = QsOptions.from_quality(3, 3, progress=recorder(calls))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            jpegqs_tpu_torch.smooth(img, opts)

    def oom(*a, **k):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory.")

    monkeypatch.setattr(cuda_solver, "solve_rebalance", oom)
    res = jpegqs_tpu_torch.smooth(img, opts, "cpu")
    assert calls == [] and res.stop == 0 and res.upsampled is None
    for comp, got in zip(img.components, res.coefs):
        want = (comp.coefs.astype(np.int32)
                * comp.quantval.astype(np.int32)).astype(np.int16)
        assert np.array_equal(got, want)


@pytest.mark.parametrize("make", [c420, c444], ids=["c420", "c444"])
def test_q6_n0_no_progress(make):
    """niter 0 at q6: prog_max is 0, the callback never fires; 4:2:0
    still upsamples, 4:4:4 drops its chroma components."""
    trace, _ = compare(make(), quality_to_flags(6), 0)
    assert trace == []
