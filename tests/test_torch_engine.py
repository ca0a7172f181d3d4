"""The PyTorch port's engine (plain path, device="cpu") vs jpegqs_tpu.

Same decoded JPEGs (tests/util.make_jpeg at tests/test_engine.py's
shapes, so the JAX programs are the ones that file compiles) through
``jpegqs_tpu.engine.smooth`` and ``jpegqs_tpu_torch.smooth``; the
output planes and the stop flag must be identical (tolerance 0).
"""

import numpy as np
import pytest
import torch

from jpegqs_tpu import engine as jax_engine
from jpegqs_tpu import specref as jax_specref
from jpegqs_tpu.host import jpegio as jax_jpegio
from jpegqs_tpu.options import QsOptions as JaxOptions
import jpegqs_tpu_torch
from jpegqs_tpu_torch import QsOptions, cli, engine
from jpegqs_tpu_torch.host.jpegio import image_from_arrays
from jpegqs_tpu_torch.ops import _build, cuda_solver
from util import make_jpeg

torch.set_num_threads(1)


def _gray():
    return make_jpeg(64, 64, "photo", seed=1, quality=70)


def _c420():
    return make_jpeg(64, 48, "photo", seed=3, color=True, quality=70,
                     subsamp=1)


def _assert_same(want, got):
    assert got.stop == want.stop
    assert len(got.coefs) == len(want.coefs)
    for ci, (a, b) in enumerate(zip(want.coefs, got.coefs)):
        assert b.dtype == np.int16 and b.shape == a.shape, f"comp {ci}"
        assert np.array_equal(a, b), (
            f"comp {ci}: {(a != b).sum()} mismatches, first at "
            f"{tuple(np.argwhere(a != b)[0])}")


@pytest.mark.parametrize("kind,quality,niter", [
    ("gray", 3, 0), ("gray", 3, 1), ("gray", 3, 3), ("gray", 4, 3),
    ("c420", 3, 3), ("c420", 4, 1)])
def test_smooth_matches_jax(kind, quality, niter):
    img = jax_jpegio.read_coefficients(_gray() if kind == "gray"
                                       else _c420())
    want = jax_engine.smooth(img, JaxOptions.from_quality(quality, niter))
    got = jpegqs_tpu_torch.smooth(image_from_arrays(img),
                                  QsOptions.from_quality(quality, niter),
                                  device="cpu")
    _assert_same(want, got)


def test_gray_q6_reduces_to_diagonals():
    """On a gray image JOINT_YUV/UPSAMPLE_UV have nothing to act on: q6
    runs the DIAGONALS solver, exactly as prepare_fused decides."""
    img = jax_jpegio.read_coefficients(_gray())
    want = jax_engine.smooth(img, JaxOptions.from_quality(6, 3))
    got = jpegqs_tpu_torch.smooth(image_from_arrays(img),
                                  QsOptions.from_quality(6, 3), device="cpu")
    _assert_same(want, got)
    q4 = jpegqs_tpu_torch.smooth(image_from_arrays(img),
                                 QsOptions.from_quality(4, 3), device="cpu")
    _assert_same(q4, got)


# --- crafted/damaged inputs: tests/test_robustness.py's, vs the spec ------

def _image(qtbl, coefs, ncomp=1):
    img = jax_jpegio.JpegImage(
        width=coefs.shape[-2] * 8, height=coefs.shape[-3] * 8,
        jpeg_color_space=1 if ncomp == 1 else 3, progressive=False,
        max_h_samp_factor=1, max_v_samp_factor=1)
    for ci in range(ncomp):
        c = coefs[ci] if coefs.ndim == 4 else coefs
        img.components.append(jax_jpegio.ComponentData(
            component_id=ci, h_samp_factor=1, v_samp_factor=1,
            quant_tbl_no=0, width_in_blocks=c.shape[1],
            height_in_blocks=c.shape[0],
            quantval=np.asarray(qtbl, np.uint16), coefs=c.copy()))
    return img


def _robust_cases():
    rng = np.random.default_rng(1)
    q = rng.integers(1, 100, 64).astype(np.uint16)
    q[5] = 0x900
    yield "huge_quantizer", _image(q, rng.integers(
        -10, 11, (6, 8, 64)).astype(np.int16))
    rng = np.random.default_rng(2)
    c = rng.integers(-5, 6, (6, 8, 64)).astype(np.int16)
    c[2, 3, 10] = 900                     # 900*64 wraps past int16
    yield "coef_overflow", _image(np.full(64, 64, np.uint16), c)
    rng = np.random.default_rng(3)
    q = rng.integers(1, 60, 64).astype(np.uint16)
    q[7] = 0
    yield "zero_quantizer", _image(q, rng.integers(
        -20, 21, (6, 8, 64)).astype(np.int16))
    rng = np.random.default_rng(4)
    yield "all_quant_one", _image(np.ones(64, np.uint16), rng.integers(
        -200, 201, (6, 8, 64)).astype(np.int16))
    rng = np.random.default_rng(5)
    c = rng.integers(-5, 6, (3, 6, 8, 64)).astype(np.int16)
    c[1, 0, 0, 3] = 1000
    yield "bad_second_component", _image(np.full(64, 64, np.uint16), c, 3)


@pytest.mark.parametrize("name", [n for n, _ in _robust_cases()])
def test_crafted_inputs_match_spec(name):
    img = dict(_robust_cases())[name]
    opts = JaxOptions.from_quality(3, 3)
    want = jax_specref.do_quantsmooth(img, opts)
    got = jpegqs_tpu_torch.smooth(image_from_arrays(img),
                                  QsOptions.from_quality(3, 3), device="cpu")
    _assert_same(want, got)
    if name == "all_quant_one":           # the val <= 1 skip
        assert np.array_equal(got.coefs[0], img.components[0].coefs)


_OOM_ERRORS = {
    "cuda": torch.cuda.OutOfMemoryError("CUDA out of memory."),
    "cpu_allocator": RuntimeError(
        "[enforce fail at alloc_cpu.cpp:127] data. DefaultCPUAllocator: "
        "can't allocate memory: you tried to allocate 140737488355328 "
        "bytes. Error code 12 (Cannot allocate memory)"),
    "jax": RuntimeError("RESOURCE_EXHAUSTED: Out of memory while trying to "
                        "allocate 1073741824 bytes."),
}


@pytest.mark.parametrize("error", list(_OOM_ERRORS))
def test_oom_degrades_to_dequant(monkeypatch, error):
    """An allocation failure -- the card's, the CPU allocator's plain
    RuntimeError, or a JAX-style RESOURCE_EXHAUSTED -- degrades to plain
    host dequantization (quantsmooth.h:2551-2566) on device="cpu"; other
    errors, a kernel's build or launch failure among them, propagate."""
    img = image_from_arrays(jax_jpegio.read_coefficients(_c420()))

    def oom(*a, **k):
        raise _OOM_ERRORS[error]

    monkeypatch.setattr(cuda_solver, "idct_pix", oom)
    res = jpegqs_tpu_torch.smooth(img, QsOptions.from_quality(3, 3), "cpu")
    assert res.stop == 0
    for ci, comp in enumerate(img.components):
        want = (comp.coefs.astype(np.int32)
                * comp.quantval.astype(np.int32).reshape(1, 1, 64)
                ).astype(np.int16)
        assert np.array_equal(res.coefs[ci], want), f"comp {ci}"

    for other in (RuntimeError("something else entirely"),
                  _build.KernelError("idct_pix: CUDA error 2 at launch"),
                  _build.KernelError("nvcc failed (1):\nout of memory")):
        def fail(*a, **k):
            raise other

        monkeypatch.setattr(cuda_solver, "idct_pix", fail)
        with pytest.raises(RuntimeError) as raised:
            jpegqs_tpu_torch.smooth(img, QsOptions.from_quality(3, 3), "cpu")
        assert raised.value is other


def test_smooth_jpeg_bytes_matches_jax():
    data = _c420()
    want = jax_engine.smooth_jpeg_bytes(data, JaxOptions.from_quality(3, 3))
    got = jpegqs_tpu_torch.smooth_jpeg_bytes(
        data, QsOptions.from_quality(3, 3), device="cpu")
    assert got == want


def test_cli_matches_jax(tmp_path):
    data = _gray()
    src, dst = tmp_path / "in.jpg", tmp_path / "out.jpg"
    src.write_bytes(data)
    rc = cli.main(["-q", "3", "-n", "3", "-i", "0", "--backend", "cpu",
                   str(src), str(dst)])
    assert rc == 0
    want = jax_engine.smooth_jpeg_bytes(data, JaxOptions.from_quality(3, 3))
    assert dst.read_bytes() == want
    assert cli.main(["-q", "3", str(src)]) == 1             # usage
    assert cli.main(["--backend", "cpu", "-i", "0",
                     str(tmp_path / "missing.jpg"), str(dst)]) == 1
    # --batch writes each input's output under its basename
    assert cli.main(["--batch", "-i", "0", "--backend", "cpu", str(src),
                     str(tmp_path / "outdir")]) == 0
    assert (tmp_path / "outdir" / "in.jpg").read_bytes() == want


def test_unported_paths_raise():
    """Every quality level runs (q0 on gray, q5 on 4:2:0 here; the JAX
    comparisons are in tests/test_torch_color.py), and so does a progress
    callback (tests/test_torch_progress.py): one that never cancels
    leaves the planes as without it.  --batch runs too
    (test_cli_matches_jax; tests/test_torch_batch.py)."""
    gray = image_from_arrays(jax_jpegio.read_coefficients(_gray()))
    color = image_from_arrays(jax_jpegio.read_coefficients(_c420()))
    for img, q in ((gray, 0), (color, 5)):
        res = jpegqs_tpu_torch.smooth(img, QsOptions.from_quality(q, 3),
                                      "cpu")
        assert res.stop == 0 and len(res.coefs) == len(img.components)
        assert any(not np.array_equal(a, c.coefs)
                   for a, c in zip(res.coefs, img.components))
    calls = []
    plain = jpegqs_tpu_torch.smooth(gray, QsOptions.from_quality(3, 3),
                                    "cpu")
    res = jpegqs_tpu_torch.smooth(gray, QsOptions.from_quality(
        3, 3, progress=lambda *a: calls.append(a[1:]) and 0), "cpu")
    assert calls and calls[-1] == (20, 20)
    _assert_same(plain, res)


def test_default_device_is_the_card():
    """Without a card, the default device raises instead of falling back
    to the CPU (skip where a card is present)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    gray = image_from_arrays(jax_jpegio.read_coefficients(_gray()))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        jpegqs_tpu_torch.smooth(gray, QsOptions.from_quality(3, 3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.resolve_device()
    assert engine.resolve_device("cpu") == torch.device("cpu")


def test_profiling_utilities(tmp_path):
    """utils.profiling: PhaseTimer sums each phase's host time and
    reports its MP/s and blocks/s; device_trace on the CPU writes a
    Chrome trace of the region (the smooth's ops in it), as the CLI's
    --trace does."""
    import io
    import json
    from jpegqs_tpu_torch.utils.profiling import PhaseTimer, device_trace
    gray = image_from_arrays(jax_jpegio.read_coefficients(_gray()))
    opts = QsOptions.from_quality(3, 1)
    timer = PhaseTimer()
    for _ in range(2):
        with timer.phase("smooth"):
            jpegqs_tpu_torch.smooth(gray, opts, "cpu")
    with timer.phase("idle"):
        pass
    assert set(timer.phases) == {"smooth", "idle"}
    assert timer.phases["smooth"] > timer.phases["idle"] >= 0
    out = io.StringIO()
    timer.report(megapixels=0.5, blocks=4096, file=out)
    lines = out.getvalue().splitlines()
    assert lines[0].split()[0] == "smooth" and "MP/s" in lines[0] \
        and "blocks/s" in lines[0] and lines[-1].split()[0] == "total"
    with device_trace(tmp_path / "t", device="cpu") as prof:
        res = jpegqs_tpu_torch.smooth(gray, opts, "cpu")
    assert res.stop == 0 and prof.key_averages()
    events = json.loads((tmp_path / "t" / "trace.json").read_text())
    names = {e.get("name") for e in events["traceEvents"]}
    assert any(n and n.startswith("aten::") for n in names)
    src = tmp_path / "in.jpg"
    src.write_bytes(_gray())
    assert cli.main(["-i", "0", "--backend", "cpu", "--trace",
                     str(tmp_path / "cli"), str(src),
                     str(tmp_path / "out.jpg")]) == 0
    assert (tmp_path / "cli" / "smooth_trace.json").stat().st_size > 0
