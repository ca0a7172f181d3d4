"""The PyTorch port's host tables and element ops vs the JAX package.

Same inputs (numpy, seeded) through jpegqs_tpu and jpegqs_tpu_torch on
the CPU; every comparison is exact (tolerance 0: the contract is
bit-identity).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from jpegqs_tpu import engine as jax_engine
from jpegqs_tpu import specref as jax_specref
from jpegqs_tpu.ops import planar as jax_planar
from jpegqs_tpu.ops import quant as jax_quant
from jpegqs_tpu_torch import engine, specref
from jpegqs_tpu_torch.ops import dct, quant

torch.set_num_threads(1)


def _qtables():
    rng = np.random.default_rng(5)
    tables = [rng.integers(1, 255, 64), rng.integers(1, 0x800, 64),
              rng.integers(0, 0x10000, 64), np.ones(64), np.zeros(64)]
    t = rng.integers(1, 100, 64)
    t[[0, 7, 33]] = [0, 0x7FF, 0xFFFF]
    tables.append(t)
    return [np.asarray(x, np.uint16) for x in tables]


def test_zigzag_tables_match():
    assert np.array_equal(specref.NATURAL_ORDER, jax_specref.NATURAL_ORDER)
    assert np.array_equal(specref.ZIGZAG_REFRESH,
                          jax_specref.ZIGZAG_REFRESH)


@pytest.mark.parametrize("flags", [0, 1])
def test_solver_tables_byte_identical(flags):
    got = specref.make_solver_tables(flags)
    want = jax_specref.make_solver_tables(flags)
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("ti", range(6))
def test_quant_tables_byte_identical(ti):
    qtbl = _qtables()[ti]
    for got, want in zip(quant.make_quant_tables(qtbl),
                         jax_quant.make_quant_tables(qtbl)):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def _float_probe():
    rng = np.random.default_rng(9)
    x = np.concatenate([
        rng.uniform(-1e4, 1e4, 4096), rng.uniform(-3, 3, 4096),
        np.arange(-8, 8.5, 0.5),
        [0.49999997, -0.49999997, 0.5, -0.5, 1.5, -2.5, 8388607.5,
         -8388607.5, 1e30, -1e30, 0.0, -0.0]]).astype(np.float32)
    return x


def test_roundf_matches():
    x = _float_probe()
    got = quant.roundf(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_quant.roundf(jnp.asarray(x)))
    assert got.view(np.int32).tolist() == want.view(np.int32).tolist()


def test_c_f32_to_i32_matches():
    special = np.array([0.0, -0.0, 1.9, -1.9, 2147483520.0, -2147483648.0,
                        2147483648.0, -2147483904.0, np.inf, -np.inf,
                        np.nan, 1e38, -1e38], dtype=np.float32)
    x = np.concatenate([special, _float_probe()])
    got = quant.c_f32_to_i32(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_quant.c_f32_to_i32(jnp.asarray(x)))
    assert got.dtype == np.int32 and np.array_equal(got, want)
    assert got[:13].tolist() == [0, 0, 1, -1, 2147483520, -2147483648] + \
        [-2147483648] * 7


@pytest.mark.parametrize("ti", range(6))
def test_orig_coef_and_interval_clamp_match(ti):
    rng = np.random.default_rng(ti)
    qtbl = _qtables()[ti]
    div, x1, qshr = quant.make_quant_tables(qtbl)
    coef = rng.integers(-40000, 40000, (64, 300)).astype(np.int32)
    add = rng.integers(-40000, 40000, (64, 300)).astype(np.int32)
    t = [torch.from_numpy(a)[:, None] for a in (div, x1, qshr)]
    j = [jnp.asarray(a)[:, None] for a in (div, x1, qshr)]
    a0 = quant.get_orig_coef(torch.from_numpy(coef), *t)
    want_a0 = jax_quant.get_orig_coef(jnp.asarray(coef), *j)
    assert np.array_equal(a0.numpy(), np.asarray(want_a0))
    got = quant.interval_clamp(torch.from_numpy(add), a0, t[0])
    want = jax_quant.interval_clamp(jnp.asarray(add), want_a0, j[0])
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("lo,hi", [(-2048, 2048), (-32768, 32768)])
def test_idct_islow_matches(lo, hi):
    rng = np.random.default_rng(hi)
    coef = rng.integers(lo, hi, (8, 8, 500)).astype(np.int32)
    got = dct.idct_islow(torch.from_numpy(coef)).numpy()
    want = np.asarray(jax_planar.idct_islow_p(jnp.asarray(coef)))
    assert np.array_equal(got, want)


def test_int16_wrap_past_int16():
    """Dequantized products past int16 wrap like C's JCOEF storage
    (the tests/test_robustness.py crafted inputs: 900*64, 1000*64)."""
    x = np.array([57600, 64000, -57600, 32767, 32768, -32769, 65535,
                  2147450880, -2147450880, 0], np.int32)
    got = engine.int16_wrap(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_engine._int16_wrap(jnp.asarray(x)))
    assert np.array_equal(got, want)


def test_wrap_i32():
    x = np.array([0, (1 << 31) - 1, 1 << 31, -(1 << 31) - 1, 1 << 40,
                  -5 + (1 << 32)], np.int64)
    got = quant.wrap_i32(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, x.astype(np.int32))
