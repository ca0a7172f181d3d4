"""The port's differential fuzz, tools/fuzz_port.py, at a small size.

The fuzz itself is a tool, not a test (tens of seconds a case against
jpegqs_tpu); these check its parts: the case sampler, the golden file
(reproduced by the port's CPU path, two entries recomputed by
jpegqs_tpu), one case through every path against jpegqs_tpu, that a
mismatch is caught and printed with its repro line, and that card mode
neither runs without a card nor imports JAX.  Also the port's library
example, examples/example_torch.py.
"""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from jpegqs_tpu_torch import QsOptions, decode_smoothed, engine, synth
from jpegqs_tpu_torch.host import jpegio

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


fuzz_port = _load("fuzz_port", "tools/fuzz_port.py")


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["OMP_NUM_THREADS"] = "1"
    return env


def test_sample_case_deterministic_and_covering():
    """A case depends on (seed, index) alone; 500 synth draws reach every
    quality level, sampling factor, colour kind and damage kind."""
    for source in ("synth", "jpeg"):
        assert fuzz_port.sample_case(3, 17, source) == \
            fuzz_port.sample_case(3, 17, source)
        assert fuzz_port.sample_case(3, 17, source) != \
            fuzz_port.sample_case(3, 18, source)
    cases = [fuzz_port.sample_case(7, i) for i in range(500)]
    assert {c["quality"] for c in cases} == set(range(7))
    assert {tuple(c["sampling"]) for c in cases
            if c["color"] == "ycc"} == set(fuzz_port.SAMPLINGS)
    assert {c["color"] for c in cases} == {"gray", "ycc", "rgb", "cmyk"}
    assert {c["damage"] for c in cases} == {None, *synth.DAMAGES}
    assert any(c["flags"] is not None for c in cases)
    assert all(8 <= c["h"] <= 229 and 8 <= c["w"] <= 229 for c in cases)
    # the paths' schedule: a cancel every 5th case, a batch every 4th,
    # a decode every 3rd
    assert [bool(c["progress"]["cancel_at"]) for c in cases[:10]] == \
        [False] * 4 + [True] + [False] * 4 + [True]
    assert [c["batch"] > 0 for c in cases[:8]] == [False] * 3 + [True] + \
        [False] * 3 + [True]
    assert [c["decode"] for c in cases[:6]] == [False, False, True] * 2


def test_damage_kinds():
    img = synth.make_image(24, 40, color=True, seed=1, quality=50)
    tripped = synth.damage(synth.make_image(24, 40, color=True, seed=1,
                                            quality=50), "coef", 1, 4)
    c = tripped.components[1]
    assert (np.abs(c.coefs.astype(np.int32) * int(c.quantval.max()))
            > 32767).sum() == 1
    assert not np.array_equal(c.coefs, img.components[1].coefs)
    crafted = synth.damage(img, "qtable", 0, 4)
    assert int(crafted.components[0].quantval.max()) >= 0x800
    ones = synth.damage(synth.make_planes_image(16, 16, 4), "ones", 3)
    assert (ones.components[3].quantval == 1).all()
    assert len(ones.components) == 4 and not ones.is_ycbcr


def test_golden_file_reproduced_by_the_port_on_the_cpu():
    """Every entry of tools/fuzz_port_golden.json: the port's CPU path
    gives jpegqs_tpu's digest (the card replays the same file)."""
    entries = fuzz_port.load_golden()
    assert len(entries) == fuzz_port.GOLDEN_CASES
    assert [e["case"] for e in entries] == fuzz_port.golden_cases()
    assert sum("pixel_digest" in e for e in entries) >= 5
    assert fuzz_port.replay_golden("cpu", progress=False) == len(entries)


def _clean(case):
    return case["damage"] is None and case["flags"] is None \
        and case["niter"] > 0


def _golden_pick(kind):
    """The smallest clean gray entry, or the smallest clean 4:2:0 q6
    one."""
    entries = [e for e in fuzz_port.load_golden() if _clean(e["case"])
               and (e["case"]["color"] == "gray" if kind == "gray" else
                    e["case"]["color"] == "ycc"
                    and e["case"]["sampling"] == [2, 2]
                    and e["case"]["quality"] == 6)]
    return min(entries, key=lambda e: e["case"]["h"] * e["case"]["w"])


@pytest.mark.parametrize("kind", ["gray", "c420_q6"])
def test_golden_entries_are_the_jax_package_output(kind):
    entry = _golden_pick(kind)
    case = entry["case"]
    res = fuzz_port.JaxOracle().smooth(fuzz_port.build_image(case),
                                       fuzz_port.case_opts(case))
    assert fuzz_port.digest(res.coefs, res.stop, res.upsampled) == \
        entry["digest"]


_EVERY_PATH = {
    "source": "synth", "h": 24, "w": 40, "kind": "photo", "seed": 7,
    "color": "gray", "sampling": [1, 1], "damage": None, "damage_comp": 0,
    "srcq": 50, "quality": 3, "niter": 2, "flags": None,
    "progress": {"precise": True, "progprec": -1, "cancel_at": 3},
    "grid": [2, 2], "batch": 2, "decode": True, "transcode": False}


def test_run_case_every_path_against_jax():
    """One synth case -- the gray golden entry above, whose fused program
    jpegqs_tpu has then compiled already -- through every path in CPU
    mode, against jpegqs_tpu: a 2 x 2 grid, a progress run cancelled at
    its third callback, a batch of 2 (and a plane batch), a decode."""
    case = dict(_golden_pick("gray")["case"], grid=[2, 2], batch=2,
                decode=True, transcode=False,
                progress={"precise": True, "progprec": -1, "cancel_at": 3})
    ran = fuzz_port.run_case(case, "cpu", fuzz_port.JaxOracle())
    assert ran == {"skipped": None, "fused": 1, "progress": 1,
                   "cancelled": 1, "c2": 0, "grid": 1, "batch": 1,
                   "plane_batch": 1, "decode": 1}


def test_fused_path_differs_from_progress_as_jpegqs_tpu_does():
    """The card mode's find (``--seed 12 --case 156``; ROADMAP C2): with
    no iteration, UPSAMPLE_UV on a 4:4:0 image and a luma that trips the
    dequantization guard, jpegqs_tpu's fused path dequantizes the chroma
    components and its progress path, as the reference (specref), leaves
    them as they were.  The port's two paths are each bit-identical to
    jpegqs_tpu's, so they differ the same way, and the fuzz holds the
    progress path against the fused one everywhere else."""
    from jpegqs_tpu import specref
    case = dict(_EVERY_PATH, h=16, w=24, color="ycc", sampling=[1, 2],
                damage="coef", quality=2, niter=0, kind="flat")
    img, opts = fuzz_port.build_image(case), fuzz_port.case_opts(case)
    assert fuzz_port.fused_differs_from_progress(img, opts)
    jax = fuzz_port.JaxOracle()
    fused = engine.smooth(img, opts, "cpu")
    fuzz_port.check_result("fused", fused, jax.smooth(img, opts))
    progress = engine.smooth(img, QsOptions(
        flags=opts.flags, niter=0, progress=fuzz_port.recorder()[1]), "cpu")
    fuzz_port.check_result("progress", progress, specref.do_quantsmooth(
        jax.image(img), jax.opts(opts)))
    assert fused.stop == progress.stop == 1
    assert np.array_equal(fused.coefs[0], progress.coefs[0])
    for ci in (1, 2):
        c = img.components[ci]
        assert np.array_equal(progress.coefs[ci], c.coefs)
        assert np.array_equal(fused.coefs[ci], (
            c.coefs.astype(np.int32) * c.quantval.astype(np.int32)
        ).astype(np.int16))
    # one iteration more and both paths dequantize them
    opts1 = fuzz_port.case_opts(dict(case, niter=1))
    assert not fuzz_port.fused_differs_from_progress(img, opts1)
    # the rule is exact: on drawn niter-0 colour cases, damaged or not,
    # the port's two paths differ where it says and nowhere else
    hits = 0
    for i in range(24):
        rng = np.random.default_rng(i)
        c = dict(fuzz_port.sample_case(97, i, "synth", 32), niter=0,
                 color="ycc", damage=[None, "coef", "qtable"][i % 3],
                 damage_comp=0 if i % 2 else int(rng.integers(3)),
                 flags=[None, 4, 6, 12][int(rng.integers(4))],
                 quality=int(rng.choice([1, 2, 5, 6])),
                 sampling=list(fuzz_port.SAMPLINGS[int(rng.integers(6))]))
        img, opts = fuzz_port.build_image(c), fuzz_port.case_opts(c)
        want = fuzz_port.fused_differs_from_progress(img, opts)
        try:
            fuzz_port.check_result("c2", engine.smooth(img, QsOptions(
                flags=opts.flags, niter=0,
                progress=fuzz_port.recorder()[1]), "cpu"),
                engine.smooth(img, opts, "cpu"))
            differs = False
        except fuzz_port.Mismatch:
            differs = True
        assert differs == want, c
        hits += want
    assert hits >= 3


def test_mismatch_is_caught_with_its_repro(monkeypatch, capsys):
    class Off(fuzz_port.PortCpuOracle):
        def smooth(self, img, opts):
            res = super().smooth(img, opts)
            res.coefs[0] = res.coefs[0].copy()
            res.coefs[0][1, 2, 3] += 1
            return res

    case = dict(_EVERY_PATH, batch=0, decode=False, grid=[1, 1])
    with pytest.raises(fuzz_port.Mismatch) as raised:
        fuzz_port.run_case(case, "cpu", Off())
    assert raised.value.path == "fused"
    assert raised.value.what == "component 0"
    assert raised.value.detail["index"] == (1, 2, 3)
    assert raised.value.detail["count"] == 1

    def broken(case, device, oracle):
        raise fuzz_port.Mismatch("grid 2x2", "component 1",
                                 {"index": (0, 0, 5), "count": 3})

    monkeypatch.setattr(fuzz_port, "run_case", broken)
    assert fuzz_port.main(["--device", "cpu", "--seed", "5", "--cases",
                           "3"]) == 1
    out = capsys.readouterr().out
    assert "python tools/fuzz_port.py --device cpu --seed 5 --case 0" in out
    assert "MISMATCH path grid 2x2, component 1" in out
    assert "BIT-EXACT" not in out


def test_card_mode_without_card_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, "tools/fuzz_port.py", "--seed", "3",
                        "--case", "1"], cwd=REPO, capture_output=True,
                       text=True, env=_env(), timeout=300)
    assert r.returncode != 0 and "BIT-EXACT" not in r.stdout
    assert "no CUDA device" in r.stderr


_HELP_PROBE = r"""
import runpy, sys
sys.argv = ["tools/fuzz_port.py", "--device", "cuda", "--help"]
try:
    runpy.run_path("tools/fuzz_port.py", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "jpegqs_tpu"))
print("FOREIGN", bad)
"""


def test_card_mode_help_imports_no_jax():
    r = subprocess.run([sys.executable, "-c", _HELP_PROBE], cwd=REPO,
                       capture_output=True, text=True, env=_env(),
                       timeout=300)
    assert r.returncode == 0, r.stderr
    assert "--write-golden" in r.stdout
    assert "FOREIGN []" in r.stdout, r.stdout


def _read_bmp(path):
    data = open(path, "rb").read()
    w = int.from_bytes(data[18:22], "little", signed=True)
    h = int.from_bytes(data[22:26], "little", signed=True)
    row = (w * 3 + 3) & ~3
    rows = np.frombuffer(data[54:54 + row * h], np.uint8).reshape(h, row)
    return rows[::-1, :w * 3].reshape(h, w, 3)[:, :, ::-1]


def test_example_torch_writes_the_decoded_pixels(tmp_path, capsys):
    """examples/example_torch.py --backend cpu: a BMP of the port's
    decode_smoothed pixels (test_torch_decode ties them to jpegqs_tpu),
    and a progress line."""
    example = _load("example_torch", "examples/example_torch.py")
    data = jpegio.encode_pixels(synth.synth_image(32, 32, 3, True),
                                quality=60)
    src, dst = tmp_path / "in.jpg", tmp_path / "out.bmp"
    src.write_bytes(data)
    assert example.main(["--backend", "cpu", str(src), str(dst), "4",
                         "2"]) == 0
    out = capsys.readouterr().out
    assert "progress: 100%" in out and "wrote" in out
    want = decode_smoothed(data, QsOptions.from_quality(4, 2), device="cpu")
    assert want.shape == (32, 32, 3)
    assert np.array_equal(_read_bmp(dst), want)
    assert example.main(["--backend", "tpu", str(src), str(dst)]) == 1
