"""The premises of the Hopper design of the sweep kernels (B2, B3 in
jpegqs_tpu_torch/csrc/solver.cu), each held against the plain version on
the CPU: numpy and torch only, no JAX.

- (a) a sweep that does not fold the two classes of all-zero weights (the
  horizontal diffs when i & 7 == 0, the vertical ones when i <= 7), as the
  kernels' sweep does, gives planar.solve_blocks_p's coefficients;
- (b) so does a sweep that folds each refresh group's steps in reverse
  order from the group-start pixels: the steps of a group are
  independent, which a kernel may use to split a group between lanes;
- (c) the pixel planes after the islow IDCT and the image2 halos
  (downsample_blocks + blocks_halo10 at 4:2:0, 4:2:2 and 4:4:4) lie in
  0..255, so B3 may stage them as 16-bit values;
- (d) the kernels' padded solver tables hold the plain table in their
  first NT columns and zeros after, in rows of a multiple of four;
- (e) B5's lane body (csrc/solver.cu solve_borders_lanes_kernel) runs
  the steps of a refresh group side by side, one lane each: its group
  table and step order are the plain version's groups, a group's steps
  change distinct coefficients, and (b) shows that steps folded from the
  group-start pixels in any order give the plain result;
- (f) a B5 launch takes the lane body up to
  REBALANCE_LANES_CTAS_PER_SM CTAs of 128 blocks an SM, B2's body above.
"""

import os
import re

import numpy as np
import pytest
import torch

from jpegqs_tpu_torch import DIAGONALS
from jpegqs_tpu_torch.ops import cuda_solver, planar
from jpegqs_tpu_torch.ops.dct import idct_islow
from jpegqs_tpu_torch.ops.quant import (c_f32_to_i32, get_orig_coef,
                                        interval_clamp, make_quant_tables,
                                        roundf, wrap_i32)

B = 24
TABLES = ("random", "ones", "max")
FLAGS = (0, DIAGONALS)


def _inputs(table, seed):
    """Coefficients on the lattice (the reachable state), random border
    lines and the quant tables of a random (1..255), all-1 or all-255
    table."""
    rng = np.random.default_rng(seed)
    q = {"random": rng.integers(1, 256, 64), "ones": np.ones(64),
         "max": np.full(64, 255)}[table].astype(np.uint16)
    div, x1, qshr = (torch.from_numpy(t) for t in make_quant_tables(q))
    coef = np.clip(rng.integers(-40, 41, (64, B))
                   * q.astype(np.int32)[:, None], -32768, 32767)
    borders = rng.integers(0, 256, (4, 8, B)).astype(np.int32)
    return (torch.from_numpy(coef.astype(np.int32)),
            tuple(torch.from_numpy(borders)), div, x1, qshr)


def _step_terms(i, nt, skip_zero_classes):
    """The terms step i folds, in the scalar order."""
    terms = []
    if i & 7 or not skip_zero_classes:
        terms += range(0, 56)                 # horizontal
    terms += range(56, 88)                    # border
    if i > 7 or not skip_zero_classes:
        terms += range(88, 144)               # vertical
    terms += range(144, nt)                   # diagonal
    return terms


def sweep_by_steps(coef, borders, div, x1, qshr, tab, skip_zero_classes,
                   reverse_groups):
    """The k = 63..1 sweep step by step, as the kernels run it: the pixels
    refreshed at each group start, each step's a2/a3 strict left folds
    over its terms, its delta applied to its own coefficient at once."""
    nt = tab.shape[1]
    coef = coef.clone()
    for group in planar.GROUPS:
        d = planar.block_diffs_p(idct_islow(coef.reshape(8, 8, B)), borders,
                                 nt)                          # f32[nt, B]
        for i in (group[::-1] if reverse_groups else group):
            rng = (div[i] * 2).to(torch.float32)
            a2 = torch.zeros(B, dtype=torch.float32)
            a3 = torch.zeros(B, dtype=torch.float32)
            for j in _step_terms(i, nt, skip_zero_classes):
                t = torch.clamp_min(rng - d[j].abs(), 0)
                t = t * t
                u = d[j] * t
                w = tab[i, j] * t
                a2 = a2 + u * w
                a3 = a3 + w * w
            delta = c_f32_to_i32(roundf(a2 / a3))
            a0 = get_orig_coef(coef[i], div[i], x1[i], qshr[i])
            add = interval_clamp(wrap_i32(coef[i].long() - delta.long()), a0,
                                 div[i])
            coef[i] = torch.where(delta != 0, add, coef[i])
    return coef


@pytest.mark.parametrize("table", TABLES)
@pytest.mark.parametrize("flags", FLAGS)
def test_skipping_zero_classes_matches_plain(table, flags):
    coef, borders, div, x1, qshr = _inputs(table, 11 + flags)
    tab = cuda_solver.solver_tables(flags, "cpu")
    want = planar.solve_blocks_p(coef, borders, div, x1, qshr, tab)
    got = sweep_by_steps(coef, borders, div, x1, qshr, tab,
                         skip_zero_classes=True, reverse_groups=False)
    assert torch.equal(got, want)
    # the sweep moved something, unless an all-1 table pins every
    # coefficient to its lattice point (an interval of one value)
    assert torch.equal(want, coef) == (table == "ones")


@pytest.mark.parametrize("table", TABLES)
@pytest.mark.parametrize("flags", FLAGS)
def test_reversed_groups_match_plain(table, flags):
    coef, borders, div, x1, qshr = _inputs(table, 23 + flags)
    tab = cuda_solver.solver_tables(flags, "cpu")
    want = planar.solve_blocks_p(coef, borders, div, x1, qshr, tab)
    got = sweep_by_steps(coef, borders, div, x1, qshr, tab,
                         skip_zero_classes=True, reverse_groups=True)
    assert torch.equal(got, want)


@pytest.mark.parametrize("sampling", [(2, 2), (2, 1), (1, 1)])
@pytest.mark.parametrize("hb_l,wb_l", [(6, 8), (5, 7)])
def test_staged_values_fit_16_bits(sampling, hb_l, wb_l):
    """Extreme coefficients still give pixels and image2 halos in 0..255."""
    ws, hs = sampling
    rng = np.random.default_rng(hb_l * 10 + ws * 2 + hs)
    coef = torch.from_numpy(rng.integers(-32768, 32768,
                                         (64, hb_l * wb_l)).astype(np.int32))
    pix = idct_islow(coef.reshape(8, 8, -1))
    assert pix.dtype == torch.int32
    assert int(pix.min()) >= 0 and int(pix.max()) <= 255
    assert int(pix.min()) == 0 and int(pix.max()) == 255   # both clamps hit
    hb_c, wb_c = -(-hb_l // hs), -(-wb_l // ws)
    image2 = planar.blocks_halo10(planar.downsample_blocks(
        pix, hb_l, wb_l, hb_c, wb_c, ws, hs), hb_c, wb_c)
    assert tuple(image2.shape) == (10, 10, hb_c * wb_c)
    assert int(image2.min()) >= 0 and int(image2.max()) <= 255
    halo = planar.blocks_halo10(pix, hb_l, wb_l)
    assert int(halo.min()) >= 0 and int(halo.max()) <= 255


@pytest.mark.parametrize("flags", FLAGS)
def test_kernel_tables_padding(flags):
    plain = cuda_solver.solver_tables(flags, "cpu")
    padded = cuda_solver.kernel_tables(flags, "cpu")
    nt = cuda_solver.nt_for(flags)
    assert tuple(plain.shape) == (64, nt)
    assert padded.shape[0] == 64 and padded.shape[1] % 4 == 0
    assert nt <= padded.shape[1] < nt + 4
    assert torch.equal(padded[:, :nt], plain)
    assert not padded[:, nt:].any()


def _solver_cu_array(name):
    """The integers of ``__constant__ int name[...] = {...}`` in
    csrc/solver.cu."""
    path = os.path.join(os.path.dirname(cuda_solver.__file__), "..", "csrc",
                        "solver.cu")
    src = open(path).read()
    body = re.search(r"int %s\[\d+\] = \{([^}]*)\}" % name, src).group(1)
    return [int(x) for x in body.replace("\n", " ").split(",")]


def test_lane_body_groups():
    iseq, refresh = _solver_cu_array("c_iseq"), _solver_cu_array("c_refresh")
    starts = _solver_cu_array("c_group")
    assert starts == [k for k in range(63) if refresh[k]] + [63]
    groups = [tuple(iseq[k0:k1]) for k0, k1 in zip(starts, starts[1:])]
    assert groups == [tuple(g) for g in planar.GROUPS]
    assert all(1 <= len(g) <= 8 and len(set(g)) == len(g) for g in groups)


@pytest.mark.parametrize("sms", [132, 114, 7])
def test_lane_body_by_size(sms):
    per_sm = cuda_solver.REBALANCE_LANES_CTAS_PER_SM
    n_max = int(per_sm * sms) * 128
    for n in (1, 128, n_max - 127, n_max):
        assert cuda_solver.use_lane_body(n, sms), n
    for n in (n_max + 1, n_max + 128, 10 * n_max + 1):
        assert not cuda_solver.use_lane_body(n, sms), n
