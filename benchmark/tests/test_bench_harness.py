"""The harness on the CPU: files found by name, the frozen roofline
arithmetic, the trace's reduction and the metric readers, the isolation
of the benchmark from JAX, and run.py's refusals."""

import ast
import json
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest

from benchmark.harness import cell, roofline, spec, trace
from benchmark.reference import tables

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_every_cell_finds_its_files():
    names = set()
    for wl in BENCH["workloads"]:
        cfg = spec.config(BENCH, wl["config"])
        assert cfg["name"] == wl["config"]
        assert {"quality", "niter"} <= cfg.keys()
        t = spec.traffic(wl["traffic"])
        assert t["batch_images"] <= t["pool_images"]
        names.add(wl["name"])
    for section in ("end_to_end", "per_layer"):
        for m in BENCH[section]:
            assert callable(spec.metric_reader(m["name"]))
            assert set(m.get("workloads", names)) <= names
    assert [c["file"] for c in BENCH["configs"]] == [
        f"benchmark/configs/{c['name']}.json" for c in BENCH["configs"]]


@pytest.mark.parametrize("wl", CELLS)
def test_metrics_of_a_cell(wl):
    """Each cell reports both end-to-end metrics, the roofline of all
    kernels and the idle share; each per-layer metric it reports moves
    one of them; a metric with a ``workloads`` key is only in the cells
    it lists, one without it in every cell."""
    e2e = [m["name"] for m in spec.metrics_of(BENCH, wl, "end_to_end")]
    assert e2e == ["card_compute_mp_s", "setup_s"]
    layer = spec.metrics_of(BENCH, wl, "per_layer")
    names = [m["name"] for m in layer]
    assert "kernels_roofline" in names and "device.idle_pct" in names
    assert {m["moves"] for m in layer} <= set(e2e)
    assert spec.metrics_of({"per_layer": [{"name": "x", "workloads": [
        "other"]}]}, wl, "per_layer") == []
    assert spec.metrics_of({"per_layer": [{"name": "x"}]}, wl,
                           "per_layer") == [{"name": "x"}]


def _photo(w, h, sampling):
    """Geometry only: what roofline.image_work reads."""
    fh, fv = sampling
    ceil = lambda a, b: -(-a // b)
    comps = [types.SimpleNamespace(h_samp=fh, v_samp=fv, hb=ceil(h, 8),
                                   wb=ceil(w, 8))]
    comps += [types.SimpleNamespace(h_samp=1, v_samp=1,
                                    hb=ceil(h, 8 * fv), wb=ceil(w, 8 * fh))
              for _ in range(2)]
    return types.SimpleNamespace(width=w, height=h, ycbcr=True, comps=comps)


def test_roofline_hand_counts():
    """One pass of a 12 MP 4:2:0 photo (187,500 luma and 2 x 47,000
    chroma blocks) against the counts of the program's kernel table:
    7,648 non-zero sweep terms a block at flags 0 (B2's bound 0.3853 ms
    on the luma plane), 13,308 with DIAGONALS (0.6704 ms), and the
    JOINT preamble's 1,664 operations (B3 at q6: 0.1704 ms on a chroma
    plane)."""
    assert roofline.sweep_terms(0) == 7648
    assert roofline.sweep_terms(tables.DIAGONALS) == 13308
    assert roofline.JOINT_PREAMBLE_OPS == 1664
    assert roofline.LQ_PREAMBLE_OPS == 6914
    photo = _photo(4000, 3000, (2, 2))
    luma, chroma = 187_500, 47_000
    assert (photo.comps[0].hb * photo.comps[0].wb,
            photo.comps[1].hb * photo.comps[1].wb) == (luma, chroma)
    ms = lambda ops: ops / roofline.PEAK_FP32_OPS_PER_S * 1e3

    ops3, bytes3 = roofline.image_work(photo, tables.quality_to_flags(3), 1)
    assert ops3 == (luma + 2 * chroma) * 7648 * 9
    assert bytes3 == (luma + 2 * chroma) * 64 * 2 * 2
    assert round(ms(luma * 7648 * 9), 4) == 0.3853
    assert roofline.least_seconds(ops3, bytes3) == pytest.approx(
        ms(ops3) / 1e3)

    ops6, bytes6 = roofline.image_work(photo, tables.quality_to_flags(6), 1)
    assert ops6 == luma * 13308 * 9 + 2 * chroma * (1664 + 13308 * 9)
    assert bytes6 == bytes3 + 2 * luma * 64 * 2
    assert round(ms(luma * 13308 * 9), 4) == 0.6704
    assert round(ms(chroma * (1664 + 13308 * 9)), 4) == 0.1704
    # three passes are three times one
    assert roofline.image_work(photo, tables.quality_to_flags(6), 3)[0] \
        == 3 * ops6


def test_roofline_low_quality():
    """At q2 the luma takes the LOW_QUALITY preamble and the chroma the
    JOINT one, neither a sweep; at q0 every plane the LQ preamble."""
    photo = _photo(64, 48, (2, 2))
    nl, nc = 8 * 6, 4 * 3
    assert roofline.image_work(photo, tables.quality_to_flags(2), 1)[0] \
        == nl * 6914 + 2 * nc * 1664
    assert roofline.image_work(photo, tables.quality_to_flags(0), 1)[0] \
        == (nl + 2 * nc) * 6914


def test_b2_work_hand_counts():
    """B2's own share: at q3 the sweep of all three planes (7,648 terms a
    block, the kernel table's NT 144 bound 0.3853 ms on the luma plane);
    at q6 the luma alone, the chroma going to B3 (13,308 terms, 0.6704
    ms); at q0 nothing, B4 solving every plane."""
    photo = _photo(4000, 3000, (2, 2))
    luma, chroma = 187_500, 47_000
    ms = lambda ops: ops / roofline.PEAK_FP32_OPS_PER_S * 1e3
    assert round(ms(luma * 7648 * 9), 4) == 0.3853
    ops3, bytes3 = roofline.b2_work(photo, tables.quality_to_flags(3), 3)
    assert ops3 == 3 * (luma + 2 * chroma) * 7648 * 9
    assert bytes3 == (luma + 2 * chroma) * 64 * 2 * 2
    # the least time is the operations', as image_work's is at q3
    assert roofline.least_seconds(ops3, bytes3) == pytest.approx(
        ms(ops3) / 1e3)
    assert (ops3, bytes3) == roofline.image_work(
        photo, tables.quality_to_flags(3), 3)
    ops6, bytes6 = roofline.b2_work(photo, tables.quality_to_flags(6), 1)
    assert (ops6, bytes6) == (luma * 13308 * 9, luma * 64 * 2 * 2)
    assert round(ms(ops6), 4) == 0.6704
    assert roofline.b2_work(photo, tables.quality_to_flags(0), 3) == (0, 0)
    # gray, or colour whose chroma is not at 1x1: B2 solves every plane
    gray = types.SimpleNamespace(width=64, height=48, ycbcr=False,
                                 comps=photo.comps[:1])
    assert roofline.b2_work(gray, tables.quality_to_flags(6), 2)[0] == \
        2 * luma * 13308 * 9
    odd = types.SimpleNamespace(width=64, height=48, ycbcr=True, comps=[
        photo.comps[0], photo.comps[1],
        types.SimpleNamespace(h_samp=2, v_samp=1, hb=10, wb=10)])
    assert roofline.b2_work(odd, tables.quality_to_flags(6), 1)[0] == \
        (luma + chroma + 100) * 13308 * 9


def test_solver_tables_frozen_copy():
    """The benchmark's own solver tables equal the program's."""
    from jpegqs_tpu_torch.specref import make_solver_tables
    for flags in (0, tables.DIAGONALS):
        ours = tables.solver_tables(flags)
        assert np.array_equal(ours, make_solver_tables(flags)[:, :ours.shape[1]])


def test_trace_reduction():
    ms = 1_000_000
    ops = [("void at::native::elementwise_kernel<int>", "aten", 0, 2 * ms),
           ("solve_borders_kernel<144, false>", "kernel", 1 * ms, 5 * ms),
           ("Memcpy DtoH (Device -> Pinned)", "copy", 7 * ms, 8 * ms)]
    assert [trace.op_kind(o[0]) for o in ops] == ["aten", "kernel", "copy"]
    assert trace.op_kind("Memcpy DtoD (Device -> Device)") == "device"
    assert trace.op_kind("Memset (Device)") == "device"
    assert trace.op_kind("void cub::DeviceScanKernel<x>") == "aten"
    iv = [(o[2], o[3]) for o in ops]
    assert trace.union_s(iv, 0, 10 * ms) == pytest.approx(0.006)
    assert trace.union_s(iv, 3 * ms, 7_500_000) == pytest.approx(0.0025)
    spans = {"bench.dispatch": [(0, 1 * ms)],
             "bench.assemble": [(5 * ms, 6 * ms), (8 * ms, 10 * ms)]}
    gaps = dict(trace.idle_gaps(iv, spans, 0, 10 * ms))
    assert gaps == pytest.approx({"assemble": 0.003, "between calls": 0.001})
    top = trace.top_ops(ops + ops[1:2])
    assert [t[0] for t in top] == [ops[1][0], ops[0][0], ops[2][0]]
    assert [t[1] for t in top] == pytest.approx([0.008, 0.002, 0.001])


def test_readers():
    ms = 1_000_000
    r = trace.Reading(batches=2, images=4, least_s=0.002, window_s=0.01,
                      busy_s=0.006)
    r.spans = {"dispatch": [0.001, 0.003], "assemble": [0.01, 0.02]}
    r.device_ops = [("at::a", "aten", 0, 2 * ms), ("at::b", "aten", 2 * ms,
                                                     3 * ms),
                    ("k", "kernel", 3 * ms, 8 * ms),
                    ("Memcpy HtoD", "copy", 8 * ms, 9 * ms)]
    from benchmark.harness.drive import Batch, LoopRecord
    loop = LoopRecord(t0=0.0, t_end=1.0)
    loop.done = [Batch(0, [0, 1], 0.0, 0.0, 0.0, 0.25)]
    ctx = cell.RunContext(loop=loop, image_mp=12.0, setup_s=9.5, reading=r)
    want = {
        "batch.throughput_mp_s": 24.0, "batch.dispatch_ms": 2.0, "host.assemble_ms": 15.0,
        "glue.device_ms": 1.5, "glue.launches": 1.0,
        "kernels.device_ms": 2.5, "kernels_roofline": 25.0,
        "device.idle_pct": 40.0}
    got = {name: spec.metric_reader(name)(ctx) for name in want}
    assert got == pytest.approx(want)
    # every reader of BENCHMARK.json reads this context: a number or None
    for m in BENCH["per_layer"]:
        v = spec.metric_reader(m["name"])(ctx)
        assert v is None or isinstance(v, float), m["name"]
    # a reading with nothing on the card: the device metrics stay out
    empty = cell.RunContext(None, 12.0, 1.0, trace.Reading(batches=2))
    for name in ("glue.device_ms", "glue.launches", "kernels.device_ms",
                 "kernels_roofline", "device.idle_pct"):
        assert spec.metric_reader(name)(empty) is None


def test_the_b2_roofline_reader():
    """B2's least time over the device time of its own launches alone:
    B1, B3, ATen's kernels and the copies beside them are not B2's."""
    read = spec.metric_reader("kernels.b2_roofline")
    assert read(cell.RunContext(None, 12.0, 1.0)) is None
    ms = 1_000_000
    r = trace.Reading(batches=1, images=2, least_s=0.004, b2_least_s=0.003)
    r.device_ops = [
        ("Memcpy HtoD (Pinned -> Device)", "copy", 0, 1 * ms),
        ("void at::native::elementwise_kernel<128, 2>", "aten", 1 * ms,
         2 * ms),
        ("void (anonymous namespace)::idct_pix_kernel(float const*)",
         "kernel", 2 * ms, 3 * ms),
        ("void (anonymous namespace)::solve_borders_kernel<144, false>"
         "(PassArgs)", "kernel", 3 * ms, 7 * ms),
        ("void (anonymous namespace)::solve_joint_kernel<242, false>"
         "(PassArgs)", "kernel", 7 * ms, 9 * ms),
        ("void (anonymous namespace)::solve_borders_kernel<144, false>"
         "(PassArgs)", "kernel", 9 * ms, 11 * ms),
        ("Memcpy DtoH (Device -> Pinned)", "copy", 11 * ms, 13 * ms)]
    ctx = cell.RunContext(None, 12.0, 1.0, r)
    assert read(ctx) == pytest.approx(100.0 * 0.003 / 0.006)
    # the share of all kernels is another number
    assert spec.metric_reader("kernels_roofline")(ctx) == pytest.approx(
        100.0 * 0.004 / 0.010)
    # no B2 work (LOW_QUALITY), or no B2 launch read: nothing
    r.b2_least_s = 0.0
    assert read(ctx) is None
    r.b2_least_s = 0.003
    r.device_ops = [o for o in r.device_ops if "solve_borders" not in o[0]]
    assert read(ctx) is None


def test_a_traced_reading_counts_b2s_work():
    """A traced run hands the readers the least time of every dispatched
    batch's work, and beside it that of B2's own share."""
    from benchmark.harness.drive import Batch, LoopRecord

    class HostOnly:
        traced, on_card, prof = True, False, None

    pool = [_photo(64, 48, (2, 2)), _photo(40, 32, (2, 2))]
    rec = LoopRecord(t0=0.0, t_end=1.0)
    rec.done = [Batch(0, [0, 1], 0.0, 0.0, 0.0, 1.0)]
    rec.drained = [Batch(1, [1, 1], 0.0, 0.0, 1.0, 1.5)]
    for q in (3, 6, 0):
        flags = tables.quality_to_flags(q)
        r = cell._reading(rec, HostOnly(), pool, {"quality": q, "niter": 3})
        least = lambda work: roofline.least_seconds(*map(sum, zip(*(
            work(pool[i], flags, 3) for i in (0, 1, 1, 1)))))
        assert r.least_s == least(roofline.image_work)
        assert r.b2_least_s == least(roofline.b2_work)
        assert (r.b2_least_s > 0) == (q != 0)
        assert r.b2_least_s <= r.least_s


def test_end_to_end_readers():
    from benchmark.harness.drive import Batch, LoopRecord
    rec = LoopRecord(t0=10.0, t_end=12.0)
    rec.done = [Batch(k, [0, 1], 10.0 + 0.1 * k, 0.0, 0.0,
                      10.5 + 0.1 * k + (0.5 if k == 19 else 0.0))
                for k in range(20)]
    # 22 batches of 2 images dispatched, 20 of them in the window; the
    # card busy 0.5 s for them all, 0.4 s of it without host copies
    r = trace.Reading(batches=22, images=44, busy_s=0.5, compute_s=0.4,
                      window_s=2.5)
    ctx = cell.RunContext(rec, 12.0, 7.25, r)
    read = lambda n: spec.metric_reader(n)(ctx)
    assert read("card_compute_mp_s") == pytest.approx(44 * 12.0 / 0.4)
    assert read("setup_s") == 7.25
    # with nothing read on a card the card's rate stays out
    assert spec.metric_reader("card_compute_mp_s")(
        cell.RunContext(rec, 12.0, 7.25)) is None
    assert spec.metric_reader("card_compute_mp_s")(
        cell.RunContext(rec, 12.0, 7.25, trace.Reading(batches=22))) is None
    # the host's rate, per layer, and the printed diagnostics
    assert read("batch.throughput_mp_s") == pytest.approx(20 * 2 * 12.0 / 2)
    p95 = np.percentile([500.0] * 19 + [1000.0], 95)
    pace = cell._pace(rec, 12.0)
    assert f"batch latency p95 {p95:.3f} ms" in pace
    assert f"throughput {20 * 2 * 12.0 / 2:.4f} MP/s" in pace


def test_forbidden_modules_compares_whole_names():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
             "jpegqs_tpu", "jpegqs_tpu.engine", "jpegqs_tpu_torch",
             "jpegqs_tpu_torch.engine", "jaxtyping", "flaxen", "numpy"]
    assert cell.forbidden_modules(names) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
         "jpegqs_tpu", "jpegqs_tpu.engine"])


def _imports(path):
    """(top-level names imported, relative import levels) of a file."""
    tree = ast.parse(open(path).read())
    names, levels = set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                levels.add(node.level)
            else:
                names.add(node.module.split(".")[0])
    return names, levels


def test_no_file_of_the_benchmark_imports_jax():
    for dirpath, _, files in os.walk(spec.BENCH_DIR):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            names, levels = _imports(path)
            assert not names & set(cell.FORBIDDEN), path
            if os.sep + "reference" in dirpath:
                # the reference imports nothing of the program, nor of the
                # harness beside it
                assert "jpegqs_tpu_torch" not in names, path
                assert "benchmark" not in names and levels <= {1}, path


def _run(args, cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_run_fails_without_a_card():
    r = _run(["benchmark/run.py", "--workload", CELLS[0],
              "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace",
              "0"], spec.ROOT)
    assert r.returncode != 0 and r.stdout == ""
    assert "CUDA device" in r.stderr


def test_run_fails_without_the_program(tmp_path):
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    for p in BENCH["paths"]:
        shutil.copytree(os.path.join(spec.ROOT, p), tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    r = _run(["benchmark/run.py", "--workload", CELLS[0],
              "--seed", "3", "--seconds", "1", "--trace", "0"],
             str(tmp_path), {"PYTHONPATH": ""})
    assert r.returncode != 0 and r.stdout == ""
    assert "jpegqs_tpu_torch" in r.stderr


def test_a_cpu_run_loads_no_jax():
    """A fresh interpreter drives a small cell through the harness on the
    CPU, reference and trace included: no JAX, no JAX package."""
    code = (
        "import sys, time, json\n"
        "from benchmark.harness import cell, spec\n"
        "b = spec.load_benchmark()\n"
        f"wl = spec.workload(b, {CELLS[0]!r})\n"
        "out = cell.run_cell(b, wl, 11, 0.0, True, 'cpu', "
        "time.perf_counter(), overrides=dict(image_wh='24x16', "
        "pool_images=2, batch_images=2, window=1, check_batches=1), "
        "log=lambda m: None)\n"
        "print(json.dumps([out['correct'], cell.forbidden_modules()]))\n")
    r = _run(["-c", code], spec.ROOT)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout.strip().splitlines()[-1]) == [True, []]


def test_an_untraced_reading_on_a_card():
    """Without host spans the card's record from its first operation to
    its last is the window's: busy in the union of every operation, its
    own work in the union of those that are not host copies."""
    from benchmark.harness.drive import Batch, LoopRecord
    ms = 1_000_000

    class CardOnly:
        traced, on_card, prof = False, True, object()

        def events(self):
            return ([("Memcpy HtoD (Pinned -> Device)", "copy", 0, 2 * ms),
                     ("at::add", "aten", 2 * ms, 5 * ms),
                     ("solve_joint_kernel<242, false>", "kernel", 4 * ms,
                      8 * ms),
                     ("Memcpy DtoH (Device -> Pinned)", "copy", 8 * ms,
                      10 * ms)],
                    {n: [] for n in trace.HOST_SPANS})

    rec = LoopRecord(t0=0.0, t_end=1.0)
    rec.done = [Batch(0, [0, 1], 0.0, 0.0, 0.0, 1.0)]
    rec.drained = [Batch(1, [1, 0], 0.0, 0.0, 1.0, 1.5)]
    r = cell._reading(rec, CardOnly(), pool=None, cfg=None)
    assert (r.batches, r.images) == (2, 4)
    assert r.busy_s == pytest.approx(0.010)
    assert r.compute_s == pytest.approx(0.006)
    assert r.breakdown is None
    ctx = cell.RunContext(rec, 12.0, 1.0, r)
    assert spec.metric_reader("card_compute_mp_s")(ctx) == pytest.approx(
        4 * 12.0 / 0.006)
