"""The CUDA kernels vs their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card (a CUDA kernel has no CPU mode):
they carry the ``cuda`` marker and skip without one.  The file imports
no JAX, so it also runs on a machine with only PyTorch; there, skip the
repository conftest (which sets JAX up):

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from jpegqs_tpu_torch import DIAGONALS, JOINT_YUV, LOW_QUALITY
from jpegqs_tpu_torch.ops import cuda_solver, planar
from jpegqs_tpu_torch.ops.quant import make_quant_tables


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(hb, wb, seed, device):
    """Coefficients near lattice points (the reachable state), random
    pixels and the quant tables, on ``device``."""
    B = hb * wb
    rng = np.random.default_rng(seed)
    qtbl = rng.integers(1, 120, 64).astype(np.uint16)
    coef = np.clip(rng.integers(-40, 41, (64, B))
                   * qtbl.astype(np.int32)[:, None], -32768, 32767)
    pix = rng.integers(0, 256, (64, B))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(
        a, dtype=np.int32)).to(device)
    return t(coef), t(pix), [t(a) for a in make_quant_tables(qtbl)]


@pytest.mark.cuda
@pytest.mark.parametrize("hb,wb", [(1, 13), (9, 1), (1, 1), (9, 13)])
@pytest.mark.parametrize("flags", [0, DIAGONALS])
def test_kernels_vs_plain_on_card(cuda, hb, wb, flags):
    coef, pix, tabs = _inputs(hb, wb, hb * 100 + wb, cuda)
    assert torch.equal(cuda_solver.idct_pix(coef).cpu(),
                       cuda_solver.idct_pix(coef.cpu()))
    tab = cuda_solver.solver_tables(flags, cuda)
    for reb in (True, False):
        got = cuda_solver.solve_rebalance_pix(coef, pix, *tabs, flags, reb,
                                              hb, wb)
        want = planar.solve_rebalance_pix(coef, pix, *tabs, tab, reb, hb, wb)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("hb,wb,n", [(1, 13, 1), (9, 1, 1), (1, 1, 1),
                                     (9, 13, 1), (4, 5, 2)])
@pytest.mark.parametrize("flags,joint", [
    (JOINT_YUV | DIAGONALS, True), (JOINT_YUV, True),
    (JOINT_YUV | LOW_QUALITY | DIAGONALS, True),
    (LOW_QUALITY | DIAGONALS, False)])
def test_fused_kernels_vs_plain_on_card(cuda, hb, wb, n, flags, joint):
    """B3 (JOINT_YUV preamble, with the sweep at NT 242/144 or without)
    and B4 (LOW_QUALITY) vs the plain version, n images back to back
    (the plain version runs each image on its own)."""
    coef, pix, tabs = _inputs(hb, wb * n, hb * 100 + wb + flags, cuda)
    B = hb * wb
    rng = np.random.default_rng(flags)
    image2 = (torch.from_numpy(rng.integers(0, 256, (100, B * n)).astype(
        np.int32)).to(cuda) if joint else None)
    tab = (None if flags & LOW_QUALITY
           else cuda_solver.solver_tables(flags, cuda))
    for reb in (True, False):
        for want_pix in (True, False):
            got = cuda_solver.solve_fused_pix(coef, pix, image2, *tabs, flags,
                                              reb, hb, wb, want_pix)
            for k in range(n):
                s = slice(k * B, (k + 1) * B)
                want = planar.solve_fused_pix(
                    coef[:, s].contiguous(), pix[:, s].contiguous(),
                    None if image2 is None else image2[:, s].contiguous(),
                    *tabs, tab, flags, reb, hb, wb, want_pix)
                assert torch.equal(got[0][:, s], want[0])
                if want_pix:
                    assert torch.equal(got[1][:, s], want[1])
                else:
                    assert got[1] is None and want[1] is None


@pytest.mark.cuda
def test_launch_counts(cuda):
    coef, pix, tabs = _inputs(4, 5, 0, cuda)
    image2 = torch.zeros((100, 20), dtype=torch.int32, device=cuda)
    cuda_solver.reset_launches()
    cuda_solver.idct_pix(coef)
    cuda_solver.solve_rebalance_pix(coef, pix, *tabs, 0, True, 4, 5,
                                    want_pix=False)
    cuda_solver.solve_fused_pix(coef, pix, image2, *tabs, JOINT_YUV, True, 4,
                                5)
    cuda_solver.solve_fused_pix(coef, pix, None, *tabs, LOW_QUALITY, True, 4,
                                5)
    cuda_solver.idct_pix(coef.cpu())                 # plain: not counted
    assert cuda_solver.LAUNCHES == {
        "idct_pix": 1, "solve_rebalance_pix": 1,
        "solve_fused_pix_joint": 1, "solve_fused_pix_lq": 1}


@pytest.mark.cuda
def test_canaries_on_card(cuda):
    rng = np.random.default_rng(1)
    a, b = (rng.uniform(1, 2, 4096).astype(np.float32) for _ in range(2))
    t = lambda x: torch.from_numpy(x).to(cuda)
    out = cuda_solver.canary_muladd(t(a), t(b), t(-(a * b)))
    assert int(torch.count_nonzero(out)) == 0
    terms = rng.uniform(-1e3, 1e3, (242, 4096)).astype(np.float32)
    want = np.zeros(4096, np.float32)
    for j in range(242):
        want = want + terms[j]
    got = cuda_solver.canary_fold(t(terms)).cpu().numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
