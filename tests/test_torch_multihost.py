"""The port's multi-process engine (parallel/multihost.py) vs jpegqs_tpu,
on the CPU.

- Real two-process jobs: the launcher's ``--local 2`` fan-out, two gloo
  ranks of two CPU shards each, torch only, every subprocess with a
  timeout; held in this process against
  ``jpegqs_tpu.engine._smooth_fused`` on the same input: a gray JPEG at
  q3 (a 4 x 1 row grid across the ranks) through the launcher itself
  (``python -m jpegqs_tpu_torch.parallel.run_multihost``), a colour strip
  at q6 (a 1 x 4 column grid: the column ghosts cross the ranks, the
  upsampled planes too) through ``tools/multihost_worker.py``, which
  also saves the planes, and smooth_batch_distributed on each rank's own
  synthetic frames (the worker too);
- the backend and device choice of a rank for a job across hosts;
- in this process, a one-rank gloo group over 8 CPU shards (as
  tests/test_multihost.py runs the JAX job on its 8 virtual devices): the
  crafted-file stop across components, the row x column fallback of a
  two-block-row image, and unequal Cb / Cr quant tables; the grid
  factorization against the JAX package's.

Every comparison is exact (tolerance 0).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from util import REPO, coef_arrays, make_jpeg
from jpegqs_tpu import engine as jax_engine
from jpegqs_tpu.host import jpegio as jax_jpegio
from jpegqs_tpu.host.jpegio import ComponentData, JpegImage
from jpegqs_tpu.options import QsOptions as JaxOptions
from jpegqs_tpu.parallel import multihost as jax_multihost
from jpegqs_tpu_torch import QsOptions
from jpegqs_tpu_torch.host.jpegio import image_from_arrays
from jpegqs_tpu_torch.parallel import multihost

torch.set_num_threads(1)

LAUNCHER = [sys.executable, "-m", "jpegqs_tpu_torch.parallel.run_multihost"]
WORKER = [sys.executable, os.path.join(REPO, "tools", "multihost_worker.py")]
LOCAL = ["--local", "2", "--shards-per-rank", "2", "--device", "cpu",
         "--timeout", "200"]


def _launch(args, cmd=WORKER):
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "1"
    r = subprocess.run(cmd + LOCAL + args, cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stderr.count("joined, backend gloo") == 2, r.stderr[-3000:]
    return r


def _assert_same(want, got):
    assert got.stop == want.stop
    for ci, (a, b) in enumerate(zip(want.coefs, got.coefs)):
        assert np.array_equal(np.asarray(a), np.asarray(b)), f"comp {ci}"
    assert (got.upsampled is None) == (want.upsampled is None)
    for a, b in zip(want.upsampled or (), got.upsampled or ()):
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("color,quality,hw", [(False, 3, (128, 96)),
                                              (True, 6, (16, 512))])
def test_two_process_matches_single(tmp_path, color, quality, hw):
    """The gray JPEG through the launcher, which writes the output JPEG
    and says its stop; the colour one through the worker, whose saved
    planes also hold the chroma planes that upsampling replaces in the
    output."""
    data = make_jpeg(*hw, "photo", seed=31, color=color, quality=70)
    inp, out = tmp_path / "in.jpg", tmp_path / "out.jpg"
    inp.write_bytes(data)
    want = jax_engine._smooth_fused(jax_jpegio.read_coefficients(data),
                                    JaxOptions.from_quality(quality, 2))
    save = tmp_path / "planes.npz"
    if color:
        _launch(["-q", str(quality), "-n", "2", "--save", str(save),
                 str(inp), str(out)])
    else:
        r = _launch(["-q", str(quality), "-n", "2", str(inp), str(out)],
                    LAUNCHER)
        assert f"2 ranks x 2 shards, backend gloo, stop {want.stop})" \
            in r.stderr, r.stderr[-3000:]
    got = coef_arrays(out.read_bytes())
    for ci, (coefs, _q) in enumerate(got):
        ref = (want.upsampled[ci - 1] if want.upsampled is not None
               and ci >= 1 else want.coefs[ci])
        assert np.array_equal(coefs, ref), f"comp {ci}"
    if color:
        planes = np.load(save)
        assert int(planes["stop"]) == want.stop
        for ci, c in enumerate(want.coefs):
            assert np.array_equal(planes[f"coef{ci}"], c)
        assert ("up1" in planes) == (want.upsampled is not None)


def _to_jax_image(img):
    out = JpegImage(width=img.width, height=img.height,
                    jpeg_color_space=img.jpeg_color_space,
                    progressive=img.progressive,
                    max_h_samp_factor=img.max_h_samp_factor,
                    max_v_samp_factor=img.max_v_samp_factor)
    for c in img.components:
        out.components.append(ComponentData(
            component_id=c.component_id, h_samp_factor=c.h_samp_factor,
            v_samp_factor=c.v_samp_factor, quant_tbl_no=c.quant_tbl_no,
            width_in_blocks=c.width_in_blocks,
            height_in_blocks=c.height_in_blocks,
            quantval=c.quantval.copy(), coefs=c.coefs.copy()))
    return out


def test_two_process_batch(tmp_path):
    """smooth_batch_distributed: each rank smooths its own two frames
    (seeds rank * 2 + i), row-sharded over its two shards, with no
    gather; each frame equals jpegqs_tpu's single-device engine."""
    from jpegqs_tpu_torch import synth
    base = tmp_path / "batch"
    _launch(["--synth", "40,24,0,5", "--batch", "2", "-q", "3", "-n", "2",
             "--save", str(base)])
    opts = JaxOptions.from_quality(3, 2)
    for rank in range(2):
        got = np.load(f"{base}.rank{rank}.npz")["coefs"]
        assert got.shape == (2, 5, 3, 64)
        for i in range(2):
            img = synth.make_image(40, 24, color=False, seed=5 + rank * 2 + i)
            want = jax_engine._smooth_fused(_to_jax_image(img), opts)
            assert np.array_equal(got[i], want.coefs[0]), (rank, i)


def test_backend_and_device_across_hosts(monkeypatch):
    """Two hosts of 8 cards, a rank a card (world 16): every rank picks
    NCCL from the ranks on its own host, and its card from its local
    rank; a host with more ranks than cards picks gloo.  An address that
    is not loopback needs the local rank and count."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    for rank in (0, 7, 8, 15):
        dev = multihost.rank_device(rank % 8)
        assert dev == torch.device("cuda", rank % 8)
        assert multihost.pick_backend(dev, 8) == "nccl"
    assert multihost.pick_backend("cuda:0", 16) == "gloo"
    assert multihost.pick_backend("cpu", 1) == "gloo"
    assert multihost.rank_device(3, "cpu") == torch.device("cpu")
    assert multihost._loopback("tcp://127.0.0.1:29500")
    assert multihost._loopback("tcp://localhost:29500")
    assert not multihost._loopback("tcp://host0:29500")
    with pytest.raises(ValueError, match="local_rank"):
        multihost.initialize("host0:29500", 16, 9)


# ---------------------------------------------------------------------------
# One process, one rank: the JAX package's single-process multihost tests
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_rank():
    import torch.distributed as dist
    from jpegqs_tpu_torch.parallel.run_multihost import free_port
    multihost.initialize(f"127.0.0.1:{free_port()}", 1, 0, device="cpu")
    yield ["cpu"] * 8
    dist.destroy_process_group()


def test_full_grid_matches_jax():
    for hbs, wbs, ndev, wbl in (([2, 1, 1], [64, 32, 32], 8, None),
                                ([2, 1, 1], [64, 32, 32], 8, 64),
                                ([12], [16], 4, None), ([3], [2], 8, None),
                                ([1], [3], 6, 3), ([5, 3], [7, 4], 6, 7)):
        assert multihost._full_grid(hbs, wbs, ndev, wbl) == \
            jax_multihost._full_grid(hbs, wbs, ndev, wbl)


def test_distributed_stop_propagation(one_rank):
    """The crafted two-component (non-YCbCr) file: the tripping component
    keeps its clamped fallback, the later one is plainly dequantized and
    stop is set, as jpegqs_tpu's engine does."""
    rng = np.random.default_rng(41)
    qtbl = np.full(64, 64, np.uint16)
    coefs = rng.integers(-5, 6, (2, 8, 8, 64)).astype(np.int16)
    coefs[0, 0, 0, 3] = 1000
    img = JpegImage(width=64, height=64, jpeg_color_space=2,
                    progressive=False, max_h_samp_factor=1,
                    max_v_samp_factor=1)
    for ci in range(2):
        img.components.append(ComponentData(
            component_id=ci, h_samp_factor=1, v_samp_factor=1,
            quant_tbl_no=0, width_in_blocks=8, height_in_blocks=8,
            quantval=qtbl, coefs=coefs[ci].copy()))
    want = jax_engine._smooth_fused(img, JaxOptions.from_quality(3, 2))
    got = multihost.smooth_image_distributed(
        image_from_arrays(img), QsOptions.from_quality(3, 2), one_rank)
    assert got.stop == want.stop == 1
    _assert_same(want, got)


def test_distributed_grid_fallback(one_rank):
    """Two block rows cannot spread over 8 shards: the job takes the 2 x 4
    grid (smooth_jpeg_distributed, from the JPEG bytes)."""
    data = make_jpeg(16, 512, "photo", seed=33, quality=70)
    want = jax_engine._smooth_fused(jax_jpegio.read_coefficients(data),
                                    JaxOptions.from_quality(3, 2))
    got, img = multihost.smooth_jpeg_distributed(
        data, QsOptions.from_quality(3, 2), one_rank)
    assert multihost._full_grid([2], [64], 8) == (2, 4)
    _assert_same(want, got)


def test_distributed_ycbcr_unequal_chroma_tables(one_rank):
    """Distinct Cb / Cr quant tables: each chroma pass takes its own
    tables (JOINT_YUV | DIAGONALS, 4:2:0 on an 8 x 1 row grid)."""
    rng = np.random.default_rng(42)
    img = JpegImage(width=128, height=128, jpeg_color_space=3,
                    progressive=False, max_h_samp_factor=2,
                    max_v_samp_factor=2)
    for ci, (hb, wb, hs, vs) in enumerate(((16, 16, 2, 2), (8, 8, 1, 1),
                                           (8, 8, 1, 1))):
        img.components.append(ComponentData(
            component_id=ci, h_samp_factor=hs, v_samp_factor=vs,
            quant_tbl_no=min(ci, 1), width_in_blocks=wb, height_in_blocks=hb,
            quantval=np.full(64, 10 + 3 * ci, np.uint16),
            coefs=rng.integers(-5, 6, (hb, wb, 64)).astype(np.int16)))
    want = jax_engine._smooth_fused(img, JaxOptions(flags=2 | 1, niter=2))
    got = multihost.smooth_image_distributed(
        image_from_arrays(img), QsOptions(flags=2 | 1, niter=2), one_rank)
    _assert_same(want, got)
