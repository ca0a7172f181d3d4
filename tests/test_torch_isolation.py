"""The port stands alone: no JAX, nothing of jpegqs_tpu.

A fresh interpreter imports every module of jpegqs_tpu_torch and
chip_smoke and runs the engine, the batch engine, the decode path, the
2-D shard grid, the batch forms (dryrun_multichip), a one-rank
torch.distributed job, the profiling utilities, a case of
tools/fuzz_port.py's card path and examples/example_torch.py's import
on the CPU; neither ``jax`` nor ``jpegqs_tpu`` may appear in
sys.modules.  No module of the
package names either in an import statement.
Also checks chip_smoke's golden digests (the SHA-256 of jpegqs_tpu's
output planes and of its decoded pixels, which the card must reproduce)
against the JAX package, and that chip_smoke fails without a card or
without the repository.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
import jpegqs_tpu_torch
from jpegqs_tpu_torch import engine
from jpegqs_tpu import engine as jax_engine
from jpegqs_tpu.host import jpegio as jax_jpegio
from jpegqs_tpu.options import QsOptions as JaxOptions

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import sys
import numpy as np
import chip_smoke
import jpegqs_tpu_torch
from jpegqs_tpu_torch import batch, cli, engine, options, specref, synth
from jpegqs_tpu_torch.host import jpegio
from jpegqs_tpu_torch.ops import (_build, colorout, cuda_solver, dct, joint,
                                  planar, plane, quant, upsample)
from jpegqs_tpu_torch.parallel import multihost, run_multihost, sharded
from jpegqs_tpu_torch.utils import profiling
for i in (2, 13):       # gray q3 n3; 4:2:0 q6 n3 (JOINT_YUV, UPSAMPLE_UV)
    case = chip_smoke.GOLDEN_CASES[i]
    res = jpegqs_tpu_torch.smooth(chip_smoke.golden_image(case),
                                  chip_smoke.golden_opts(case), device="cpu")
    assert chip_smoke.digest(res.coefs, res.stop, res.upsampled) == \
        chip_smoke.GOLDEN[case[0]]
    if case[0] in chip_smoke.DECODE_GOLDEN:
        img = chip_smoke.golden_image(case)
        px = engine._decode_native(img, res, "cpu")
        assert chip_smoke.pixel_digest(px) == \
            chip_smoke.DECODE_GOLDEN[case[0]]
imgs = [chip_smoke.golden_image(chip_smoke.GOLDEN_CASES[2])] * 2
out = batch.smooth_image_batch(imgs, chip_smoke.golden_opts(
    chip_smoke.GOLDEN_CASES[2]), device="cpu")
assert chip_smoke.digest(out[1].coefs, out[1].stop) == \
    chip_smoke.GOLDEN[chip_smoke.GOLDEN_CASES[2][0]]
assert "OK" in sharded.dryrun_multichip(2, "cpu")
import tempfile
with tempfile.TemporaryDirectory() as d:
    with profiling.device_trace(d, device="cpu"):
        pass
multihost.initialize(f"127.0.0.1:{run_multihost.free_port()}", 1, 0,
                     device="cpu")
case = chip_smoke.GOLDEN_CASES[2]
res = multihost.smooth_image_distributed(
    chip_smoke.golden_image(case), chip_smoke.golden_opts(case), ["cpu"] * 2)
assert chip_smoke.digest(res.coefs, res.stop, res.upsampled) == \
    chip_smoke.GOLDEN[case[0]]
# the fuzz tool's card path (its oracle is the port's own CPU run) and
# the library example
import importlib.util
def load(name, rel):
    spec = importlib.util.spec_from_file_location(name, rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
fuzz_port = load("fuzz_port", "tools/fuzz_port.py")
case = dict(fuzz_port.sample_case(1, 0), h=32, w=48, color="ycc",
            sampling=[2, 2], damage=None, quality=6, niter=1, flags=None,
            grid=[1, 2], batch=2, decode=True)
ran = fuzz_port.run_case(case, "cpu", fuzz_port.PortCpuOracle())
assert ran.get("grid") and ran.get("batch") and ran.get("decode"), ran
example = load("example_torch", "examples/example_torch.py")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "jpegqs_tpu"))
print("FOREIGN", bad)
"""


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["OMP_NUM_THREADS"] = "1"
    return env


def test_port_imports_no_jax():
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                       capture_output=True, text=True, env=_env(),
                       timeout=300)
    assert r.returncode == 0, r.stderr
    assert "FOREIGN []" in r.stdout, r.stdout


def test_no_module_imports_jax():
    """No module of the package, and not chip_smoke.py or the worker it
    starts ranks of, names jax or jpegqs_tpu in an import statement (the
    probe above shows what runs; this covers every module, whatever
    runs)."""
    import ast
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "tools", "multihost_worker.py"),
             os.path.join(REPO, "examples", "example_torch.py")]
    for d, _, names in os.walk(os.path.join(REPO, "jpegqs_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in ("jax", "jaxlib",
                                               "jpegqs_tpu"), (path, m)


def _to_jax_image(img):
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


@pytest.mark.parametrize("case", chip_smoke.GOLDEN_CASES,
                         ids=[c[0] for c in chip_smoke.GOLDEN_CASES])
def test_golden_digests_are_the_jax_package_output(case):
    img = chip_smoke.golden_image(case)
    opts = chip_smoke.golden_opts(case)
    want = jax_engine.smooth(_to_jax_image(img), JaxOptions(
        flags=opts.flags, niter=opts.niter))
    assert chip_smoke.digest(want.coefs, want.stop, want.upsampled) == \
        chip_smoke.GOLDEN[case[0]]
    got = jpegqs_tpu_torch.smooth(img, opts, device="cpu")
    assert (got.upsampled is None) == (want.upsampled is None)
    assert chip_smoke.digest(got.coefs, got.stop, got.upsampled) == \
        chip_smoke.GOLDEN[case[0]]
    if case[3] and case[1][0] == "synth":   # niter > 0 moves coefficients
        assert any(not np.array_equal(a, c.coefs)
                   for a, c in zip(got.coefs, img.components))


_DECODE_CASES = [c for c in chip_smoke.GOLDEN_CASES
                 if c[0] in chip_smoke.DECODE_GOLDEN]


@pytest.mark.parametrize("case", _DECODE_CASES,
                         ids=[c[0] for c in _DECODE_CASES])
def test_decode_golden_digests_are_the_jax_package_output(case):
    """chip_smoke's DECODE_GOLDEN: the SHA-256 of jpegqs_tpu's decoded
    pixels of the case's smoothed planes; the port's CPU path gives the
    same pixels."""
    img = chip_smoke.golden_image(case)
    opts = chip_smoke.golden_opts(case)
    jimg = _to_jax_image(img)
    res = jax_engine.smooth(jimg, JaxOptions(flags=opts.flags,
                                             niter=opts.niter))
    want = jax_engine._decode_native(jimg, res)
    assert chip_smoke.pixel_digest(want) == chip_smoke.DECODE_GOLDEN[case[0]]
    got = engine._decode_native(img, jpegqs_tpu_torch.smooth(
        img, opts, device="cpu"), "cpu")
    assert np.array_equal(got, want)


def test_chip_smoke_fails_without_card_or_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                       capture_output=True, text=True, env=_env(),
                       timeout=300)
    assert r.returncode != 0 and '"ok"' not in r.stdout
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, env=_env(),
                       timeout=300)
    assert r.returncode != 0 and '"ok"' not in r.stdout
