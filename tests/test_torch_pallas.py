"""The port's plain solver pass (B2, ``solve_rebalance_pix`` on CPU
tensors) vs the JAX package's Pallas kernel in interpret mode.

One interpret-mode call costs about a minute on the CPU, so it carries
two images at once: a 9x13 and a 1x13 plane (hb=1: every block is a top
and a bottom block) back to back on the block axis, with per-image
edge masks -- the batched layout tests/test_pallas.py pins.  The kernel
program depends on wb and the flags only, so it is the same program as
test_pallas.test_pix_mode_plain's.
"""

import numpy as np
import torch
import jax.numpy as jnp

from jpegqs_tpu.ops import pallas_solver as ps
from jpegqs_tpu.ops.quant import make_quant_tables as jax_quant_tables
from jpegqs_tpu_torch.ops import cuda_solver
from jpegqs_tpu_torch.ops.quant import make_quant_tables

torch.set_num_threads(1)


def test_solve_rebalance_pix_vs_pallas():
    wb, hbs = 13, (9, 1)
    sizes = [hb * wb for hb in hbs]
    B = sum(sizes)
    rng = np.random.default_rng(21)
    qtbl = rng.integers(1, 120, 64).astype(np.uint16)
    coef = np.clip(rng.integers(-40, 41, (64, B))
                   * qtbl.astype(np.int32)[:, None], -32768, 32767
                   ).astype(np.int32)
    pix = rng.integers(0, 256, (64, B)).astype(np.int32)
    masks = np.zeros(ps.TILE_BLOCKS, np.int32)
    masks[:B] = np.concatenate(
        [ps._edge_masks_np(hb, wb).reshape(-1)[:hb * wb] for hb in hbs])
    div, x1, qshr = (jnp.asarray(a) for a in jax_quant_tables(qtbl))
    want_c, want_p = ps.solve_rebalance_pix(
        ps.tile_blocks(jnp.asarray(coef)), ps.tile_blocks(jnp.asarray(pix)),
        jnp.asarray(masks.reshape(1, 8, 128)), div, x1, qshr, 0, True, wb,
        interpret=True)
    want_c = np.asarray(ps.untile_blocks(want_c, B))
    want_p = np.asarray(ps.untile_blocks(want_p, B))
    tabs = [torch.from_numpy(a) for a in make_quant_tables(qtbl)]
    b0 = 0
    for hb, n in zip(hbs, sizes):
        sl = slice(b0, b0 + n)
        got_c, got_p = cuda_solver.solve_rebalance_pix(
            torch.from_numpy(np.ascontiguousarray(coef[:, sl])),
            torch.from_numpy(np.ascontiguousarray(pix[:, sl])), *tabs, 0,
            True, hb, wb)
        assert np.array_equal(got_c.numpy(), want_c[:, sl]), f"hb={hb}"
        assert np.array_equal(got_p.numpy(), want_p[:, sl]), f"hb={hb}"
        assert (got_c.numpy() != coef[:, sl]).any()
        b0 += n
