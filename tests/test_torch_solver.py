"""The port's solver kernels (plain PyTorch versions on the CPU) vs the
JAX package's Pallas kernels and the NumPy spec.

B1 (``idct_pix``) and B2 (``solve_rebalance_pix``) take CPU tensors to
their plain versions; they are compared bit for bit with
``pallas_solver.idct_pix_tiles`` in interpret mode, with the JAX
package's XLA planar path at edge shapes, and against
``specref.solve_blocks`` + ``rebalance_blocks`` (as test_pallas._case).
The B2-vs-Pallas comparison sits in tests/test_torch_pallas.py: one
interpret-mode pass costs about a minute on the CPU.
The CUDA kernels themselves are held against the plain versions on the
card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from jpegqs_tpu import specref as jax_specref
from jpegqs_tpu.ops import pallas_solver as ps
from jpegqs_tpu.ops import planar as jax_planar
from jpegqs_tpu.ops.quant import make_quant_tables as jax_quant_tables
from jpegqs_tpu_torch.options import DIAGONALS
from jpegqs_tpu_torch.ops import cuda_solver, planar
from jpegqs_tpu_torch.ops.quant import make_quant_tables

torch.set_num_threads(1)


def _inputs(hb, wb, seed):
    """Coefficients near lattice points (the reachable state) and pixels,
    as tests/test_pallas.py:_pix_case builds them."""
    B = hb * wb
    rng = np.random.default_rng(seed)
    qtbl = rng.integers(1, 120, 64).astype(np.uint16)
    coef = np.clip(rng.integers(-40, 41, (64, B))
                   * qtbl.astype(np.int32)[:, None], -32768, 32767
                   ).astype(np.int32)
    pix = rng.integers(0, 256, (8, 8, B)).astype(np.int32)
    return qtbl, coef, pix.reshape(64, B)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_idct_pix_vs_pallas():
    qtbl, coef, _ = _inputs(12, 25, seed=21)
    B = coef.shape[1]
    div, x1, qshr = (jnp.asarray(a) for a in jax_quant_tables(qtbl))
    want = ps.untile_blocks(ps.idct_pix_tiles(
        ps.tile_blocks(jnp.asarray(coef)), div, x1, qshr, interpret=True), B)
    got = cuda_solver.idct_pix(_t(coef))
    assert got.dtype == torch.int32 and got.shape == (64, B)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("hb,wb,flags,reb", [
    (9, 13, 0, False), (9, 1, 0, False), (1, 1, 0, True),
    (1, 13, DIAGONALS, True), (9, 1, DIAGONALS, False)])
def test_solve_rebalance_pix_vs_jax_planar(hb, wb, flags, reb):
    """One resident pass vs the JAX package's XLA path (the planar
    border gather, sweep, rebalance and IDCT that tests/test_pallas.py
    pins to the Pallas kernel), edge shapes included; the Pallas kernel
    itself is compared in tests/test_torch_pallas.py."""
    B = hb * wb
    qtbl, coef, pix = _inputs(hb, wb, seed=hb * 100 + wb)
    div, x1, qshr = (jnp.asarray(a) for a in jax_quant_tables(qtbl))
    borders = jax_planar.borders_from_blocks(
        jnp.asarray(pix).reshape(8, 8, B), hb, wb)
    want = jax_planar.solve_blocks_p(
        jnp.asarray(coef), borders, div, x1, qshr,
        jax_specref.make_solver_tables(flags), hb, wb)
    if reb:
        want = jax_planar.rebalance_blocks_p(want, div, x1, qshr)
    want_pix = jax_planar.idct_islow_p(want.reshape(8, 8, B))
    tabs = [_t(a) for a in make_quant_tables(qtbl)]
    got_c, got_p = cuda_solver.solve_rebalance_pix(
        _t(coef), _t(pix), *tabs, flags, reb, hb, wb, want_pix=True)
    assert np.array_equal(got_c.numpy(), np.asarray(want))
    assert np.array_equal(got_p.numpy(), np.asarray(want_pix).reshape(64, B))
    _, none = cuda_solver.solve_rebalance_pix(
        _t(coef), _t(pix), *tabs, flags, reb, hb, wb, want_pix=False)
    assert none is None


@pytest.mark.parametrize("flags,reb", [(DIAGONALS, True),
                                       (DIAGONALS, False), (0, True)])
def test_solver_vs_spec(flags, reb):
    """The sweep (+ rebalance) vs the NumPy spec on materialized
    borders, 700 blocks (test_pallas._case's inputs)."""
    rng = np.random.default_rng(3)
    B = 700
    qtbl = rng.integers(1, 120, 64).astype(np.uint16)
    qv = jax_specref.make_quantval192(qtbl)
    coef = np.clip(rng.integers(-40, 41, (B, 64))
                   * qtbl.astype(np.int32)[None, :], -32768, 32767
                   ).astype(np.int32)
    borders = rng.integers(0, 256, (B, 4, 8)).astype(np.int32)
    want = jax_specref.solve_blocks(coef, borders, qv, flags,
                                    jax_specref.make_solver_tables(flags))
    if reb:
        want = jax_specref.rebalance_blocks(want, qv)
    div, x1, qshr = (_t(a) for a in make_quant_tables(qtbl))
    tab = cuda_solver.solver_tables(flags, "cpu")
    got = planar.solve_blocks_p(_t(coef.T), tuple(
        _t(borders[:, j].T) for j in range(4)), div, x1, qshr, tab)
    if reb:
        got = planar.rebalance_blocks_p(got, div, x1, qshr)
    assert np.array_equal(got.numpy().T, want)


def test_left_fold_is_sequential():
    """The a2/a3 fold equals numpy's one-rounding-per-add float32 left
    fold bit for bit (a reordered or pairwise sum does not)."""
    rng = np.random.default_rng(11)
    terms = (rng.standard_normal((242, 2, 3, 200))
             * 10.0 ** rng.integers(-3, 8, (242, 2, 3, 200))
             ).astype(np.float32)
    want = np.zeros(terms.shape[1:], np.float32)
    for j in range(terms.shape[0]):
        want = want + terms[j]
    got = planar.left_fold(_t(terms)).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_rebalance_vs_spec_lattice():
    """int64 rebalance == specref on coefficients around lattice points
    (tests/test_engine.py:test_rebalance_pair_math_vs_spec's inputs)."""
    rng = np.random.default_rng(42)
    for trial in range(5):
        qtbl = rng.integers(1, 255, 64).astype(np.uint16)
        qv = jax_specref.make_quantval192(qtbl)
        q = qtbl.astype(np.int32)
        lattice = rng.integers(-8, 9, (256, 64)).astype(np.int32) * q
        jitter = rng.integers(-1, 2, (256, 64)).astype(np.int32) * (q // 2)
        coef = np.clip(lattice + jitter, -32768, 32767).astype(np.int32)
        want = jax_specref.rebalance_blocks(coef, qv)
        div, x1, qshr = (_t(a) for a in make_quant_tables(qtbl))
        got = planar.rebalance_blocks_p(_t(coef.T), div, x1, qshr)
        assert np.array_equal(got.numpy().T, want), f"trial {trial}"


def test_wrapper_rejects_mixed_devices():
    qtbl, coef, pix = _inputs(2, 3, seed=1)
    tabs = [_t(a) for a in make_quant_tables(qtbl)]
    meta = torch.empty((64, 6), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        cuda_solver.solve_rebalance_pix(meta, _t(pix), *tabs, 0, True, 2, 3)
