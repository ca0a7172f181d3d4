"""The port's fused pass (plain versions of kernels B3/B4 on the CPU) and
its colour glue vs the JAX package and the NumPy spec.

``cuda_solver.solve_fused_pix`` given CPU tensors runs the plain
version; it is held against ``specref.quantsmooth_block_pass`` on one
full block pass, built as tests/test_pallas.py:_fused_case builds its
cases.  The halos, the block-wise and plane-wise downsample and
upsample and the float FDCT are compared with ``jpegqs_tpu.ops``.
Every comparison is exact (tolerance 0).  The CUDA kernels themselves
are held against these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from jpegqs_tpu import specref as jax_specref
from jpegqs_tpu.ops import planar as jax_planar
from jpegqs_tpu.ops import plane as jax_plane
from jpegqs_tpu.ops import upsample as jax_upsample
from jpegqs_tpu_torch.options import (DIAGONALS, JOINT_YUV, LOW_QUALITY,
                                      NO_REBALANCE)
from jpegqs_tpu_torch.ops import cuda_solver, dct, planar, plane, upsample
from jpegqs_tpu_torch.ops.quant import make_quant_tables

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))        # a writable copy


def _np_plane(blocks, hb, wb):
    """[B, 8, 8] pixel blocks -> the padded (+1 px, edge) plane."""
    p = blocks.reshape(hb, wb, 8, 8).transpose(0, 2, 1, 3).reshape(
        hb * 8, wb * 8)
    return np.pad(p, 1, mode="edge")


@pytest.mark.parametrize("flags,joint,hb,wb,seed", [
    (JOINT_YUV | DIAGONALS, True, 6, 7, 5),
    (JOINT_YUV, True, 1, 9, 15),
    (JOINT_YUV | LOW_QUALITY | DIAGONALS, True, 5, 9, 6),
    (JOINT_YUV | LOW_QUALITY | DIAGONALS, True, 9, 1, 16),
    (LOW_QUALITY | DIAGONALS, False, 7, 8, 7),
    (LOW_QUALITY | DIAGONALS, False, 1, 1, 17),
    (LOW_QUALITY | DIAGONALS | NO_REBALANCE, False, 4, 6, 8),
    (LOW_QUALITY | DIAGONALS | NO_REBALANCE, False, 1, 9, 18)])
def test_fused_pass_vs_spec(flags, joint, hb, wb, seed):
    """One B3/B4 pass (plain version) vs specref.quantsmooth_block_pass:
    the incoming pixels are the IDCT of the incoming coefficients, as in
    a pass of the engine; image2 is random (test_pallas._fused_case)."""
    B = hb * wb
    rng = np.random.default_rng(seed)
    qtbl = rng.integers(1, 120, 64).astype(np.uint16)
    qv = jax_specref.make_quantval192(qtbl)
    coef = np.clip(rng.integers(-40, 41, (B, 64))
                   * qtbl.astype(np.int32)[None, :], -32768, 32767
                   ).astype(np.int32)
    pix = jax_specref.idct_islow(coef.reshape(B, 8, 8))
    padded2 = i2halo = None
    if joint:
        ds = rng.integers(0, 256, (B, 8, 8)).astype(np.int32)
        padded2 = _np_plane(ds, hb, wb)
        i2halo = planar.blocks_halo10(
            _t(ds.reshape(B, 64).T).reshape(8, 8, B), hb, wb).reshape(100, B)
    want = jax_specref.quantsmooth_block_pass(
        coef, _np_plane(pix, hb, wb), padded2, qv, flags,
        jax_specref.make_solver_tables(flags), True)
    tabs = [_t(a) for a in make_quant_tables(qtbl)]
    got, got_pix = cuda_solver.solve_fused_pix(
        _t(coef.T), _t(pix.reshape(B, 64).T), i2halo, *tabs, flags,
        not flags & NO_REBALANCE, hb, wb)
    assert np.array_equal(got.numpy().T, want), (
        f"{(got.numpy().T != want).sum()} diffs")
    assert np.array_equal(got_pix.numpy().T.reshape(B, 8, 8),
                          jax_specref.idct_islow(want.reshape(B, 8, 8)))


def test_fused_pass_rejects_no_preamble():
    coef = torch.zeros((64, 4), dtype=torch.int32)
    tabs = [_t(a) for a in make_quant_tables(np.ones(64, np.uint16))]
    with pytest.raises(ValueError, match="LOW_QUALITY"):
        cuda_solver.solve_fused_pix(coef, coef, None, *tabs, DIAGONALS,
                                    True, 2, 2)


@pytest.mark.parametrize("hb,wb", [(1, 1), (1, 9), (6, 1), (6, 7)])
def test_blocks_halo10_matches(hb, wb):
    rng = np.random.default_rng(hb * 10 + wb)
    pix = rng.integers(0, 256, (8, 8, hb * wb)).astype(np.int32)
    want = np.asarray(jax_planar.blocks_halo10(jnp.asarray(pix), hb, wb))
    got = planar.blocks_halo10(_t(pix), hb, wb).numpy()
    assert np.array_equal(got, want)
    # two images back to back: each keeps its own edges
    two = planar.blocks_halo10(_t(np.concatenate([pix, pix[..., ::-1]],
                                                 axis=2)), hb, wb).numpy()
    assert np.array_equal(two[..., :hb * wb], want)


@pytest.mark.parametrize("hb_l,wb_l,ws,hs", [
    (6, 8, 2, 2), (7, 9, 2, 2), (5, 7, 2, 1), (6, 5, 1, 2), (4, 4, 1, 1)])
def test_downsample_blocks_matches(hb_l, wb_l, ws, hs):
    rng = np.random.default_rng(hb_l * wb_l)
    hb_c, wb_c = -(-hb_l // hs), -(-wb_l // ws)
    pix = rng.integers(0, 256, (8, 8, hb_l * wb_l)).astype(np.int32)
    want = jax_planar.downsample_blocks(jnp.asarray(pix), hb_l, wb_l, hb_c,
                                        wb_c, ws, hs)
    got = planar.downsample_blocks(_t(pix), hb_l, wb_l, hb_c, wb_c, ws, hs)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("img_h,img_w,ws,hs", [
    (48, 64, 2, 2), (49, 42, 2, 2), (48, 56, 2, 1), (56, 48, 1, 2),
    (40, 48, 1, 1)])
def test_upsample_chroma_blocks_matches(img_h, img_w, ws, hs):
    rng = np.random.default_rng(img_h + img_w)
    hb_l, wb_l = -(-img_h // 8), -(-img_w // 8)
    hb_c, wb_c = -(-img_h // (8 * hs)), -(-img_w // (8 * ws))
    chroma, ds = (rng.integers(0, 256, (8, 8, hb_c * wb_c)).astype(np.int32)
                  for _ in range(2))
    luma = rng.integers(0, 256, (8, 8, hb_l * wb_l)).astype(np.int32)
    ch_halo = jax_planar.blocks_halo10(jnp.asarray(chroma), hb_c, wb_c)
    i2_halo = jax_planar.blocks_halo10(jnp.asarray(ds), hb_c, wb_c)
    want = jax_planar.upsample_chroma_blocks(
        ch_halo, i2_halo, jnp.asarray(luma), img_w, img_h, ws, hs, hb_l,
        wb_l, hb_c, wb_c)
    got = planar.upsample_chroma_blocks(
        _t(np.asarray(ch_halo)), _t(np.asarray(i2_halo)), _t(luma), img_w,
        img_h, ws, hs, hb_l, wb_l, hb_c, wb_c)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("img_h,img_w,ws,hs", [(48, 72, 4, 1),
                                               (48, 64, 4, 2)])
def test_plane_path_matches(img_h, img_w, ws, hs):
    """downsample_plane and upsample_chroma (sampling factors above 2)
    vs jpegqs_tpu.ops.plane / .upsample, with the plane conversions."""
    rng = np.random.default_rng(img_w * hs)
    hb_l, wb_l = -(-img_h // 8), -(-img_w // 8)
    hb_c, wb_c = -(-img_h // (8 * hs)), -(-img_w // (8 * ws))
    luma = rng.integers(0, 256, (8, 8, hb_l * wb_l)).astype(np.int32)
    chroma = rng.integers(0, 256, (8, 8, hb_c * wb_c)).astype(np.int32)
    luma_p = np.asarray(jax_planar.pix_to_plane(jnp.asarray(luma), hb_l,
                                                wb_l))
    chroma_p = np.asarray(jax_planar.pix_to_plane(jnp.asarray(chroma), hb_c,
                                                  wb_c))
    assert np.array_equal(planar.pix_to_plane(_t(luma), hb_l, wb_l).numpy(),
                          luma_p)
    want_ds = np.asarray(jax_plane.downsample_plane(
        jnp.asarray(luma_p), hb_l, wb_l, hb_c, wb_c, ws, hs))
    got_ds = plane.downsample_plane(_t(luma_p), hb_l, wb_l, hb_c, wb_c, ws,
                                    hs).numpy()
    assert np.array_equal(got_ds, want_ds)
    assert np.array_equal(
        planar.padded_plane_to_halo10(_t(want_ds), hb_c, wb_c).numpy(),
        np.asarray(jax_planar.padded_plane_to_halo10(jnp.asarray(want_ds),
                                                     hb_c, wb_c)))
    want = np.asarray(jax_upsample.upsample_chroma(
        jnp.asarray(chroma_p), jnp.asarray(want_ds), jnp.asarray(luma_p),
        img_w, img_h, ws, hs, hb_l, wb_l))
    got = upsample.upsample_chroma(_t(chroma_p), _t(want_ds), _t(luma_p),
                                   img_w, img_h, ws, hs, hb_l, wb_l).numpy()
    assert np.array_equal(got, want)


def test_fdct_float_vs_spec():
    rng = np.random.default_rng(4)
    fb = rng.uniform(-128, 128, (300, 8, 8)).astype(np.float32)
    fb[:20] = np.round(fb[:20])              # the engine feeds integers
    want = jax_specref.fdct_float(fb)
    got = dct.fdct_float(_t(fb.transpose(1, 2, 0))).numpy().transpose(2, 0, 1)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_low_quality_range_and_shrink_vs_jax():
    rng = np.random.default_rng(9)
    B = 200
    qtbl = rng.integers(1, 120, 64).astype(np.uint16)
    div = make_quant_tables(qtbl)[0]
    coef = (rng.integers(-6, 7, (64, B)) * div[:, None]).astype(np.int32)
    coef[:, :3] = 0                                   # sum |AC| == 0
    want_r = jax_planar.low_quality_range_p(jnp.asarray(coef),
                                            jnp.asarray(div))
    got_r = planar.low_quality_range_p(_t(coef), _t(div))
    assert np.array_equal(got_r.numpy(), np.asarray(want_r))
    halo = rng.integers(0, 256, (10, 10, B)).astype(np.int32)
    want = jax_planar.low_quality_fblocks(jnp.asarray(halo), want_r)
    got = planar.low_quality_fblocks(_t(halo), got_r)
    assert np.array_equal(got.numpy().view(np.int32),
                          np.asarray(want).view(np.int32))


def test_lq_diagonal_weight_bits():
    """The LQ shrink's diagonal weight is the fp32 product
    2 * sqrt(fp32(0.5)), bits 0x3FB504F3 -- the constant the CUDA
    kernel carries as a bit pattern (csrc/solver.cu solve_lq_kernel)."""
    assert np.float32(planar.LQ_C1).view(np.uint32) == 0x3FB504F3
    c1 = np.float32(np.float32(2.0) * np.sqrt(np.float32(0.5)))
    assert np.float32(planar.LQ_C1) == c1
