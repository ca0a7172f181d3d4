"""The `correct` check on the CPU at a size a test run holds: a sound run
of each cell comes out correct; the control (the reference in bfloat16
in the program's place) and each fault the cells can have, planted in
the program underneath a run, come out not correct.  The look for a card
is skipped: the harness drives the program's plain path on the CPU.
The cells run on one card, so they have no exchange between chips to
leave out."""

import time

import pytest

from jpegqs_tpu_torch import batch, engine
from jpegqs_tpu_torch.ops import cuda_solver

from benchmark import control
from benchmark.harness import cell, spec

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
SMALL = {"image_wh": "40x32", "pool_images": 4, "batch_images": 2,
         "window": 2, "check_batches": 1}


def _run(name, seed=2 ** 31 + 3, traced=False):
    return cell.run_cell(BENCH, spec.workload(BENCH, name), seed, 0.0,
                         traced, "cpu", time.perf_counter(),
                         overrides=SMALL, log=lambda m: None)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    out = _run(name)
    assert out["correct"] and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert out["checks"]["images_compared"]["value"] >= 2
    # on the CPU no card is traced: the metrics by the host's clock alone
    assert set(out["metrics"]) == {m["name"] for m in BENCH["end_to_end"]
                                   if m["source"] == "host_clock"}


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_reports_the_host_spans(name):
    out = _run(name, traced=True)
    assert out["correct"]
    # on the CPU the profiler sees no card: only the host's readings, the
    # cell's per-layer metrics read by the host's clock or from a span
    assert set(out["metrics"]) == {
        m["name"] for m in spec.metrics_of(BENCH, name, "per_layer")
        if m["source"] in ("host_clock", "program_span")}
    assert "busy_s" in out["device"] and "window_s" in out["device"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    checks, correct = control.control_checks(
        BENCH, spec.workload(BENCH, name), 2 ** 31 + 21, "cpu",
        dict(SMALL, check_batches=2))
    assert not correct
    assert checks["coef_mismatch"]["value"] > 0
    assert checks["images_compared"]["value"] == 4


def _unchanged(coef, pix, *args, want_pix=True, **kw):
    """A pass that returns its state unchanged."""
    return coef, (pix if want_pix else None)


def _half_batch(real):
    """The batch engine leaves out the second half of a batch and hands
    back the first half's results in its place."""
    def dispatch(imgs, opts, dev):
        half = max(len(imgs) // 2, 1)
        asm = real(imgs[:half], opts, dev)

        def assemble():
            res = asm()
            return (res * len(imgs))[:len(imgs)]
        return assemble
    return dispatch


def _altered(real):
    """One coefficient of each batch's first result altered on its way to
    the host."""
    def download(tensors):
        fetch = real(tensors)

        def altered():
            arrays = fetch()
            arrays[0].flat[1] += 1
            return arrays
        return altered
    return download


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_a_fault_underneath_is_not_correct(monkeypatch, name, fault):
    if fault == "unchanged":
        monkeypatch.setattr(cuda_solver, "solve_rebalance_pix", _unchanged)
        monkeypatch.setattr(cuda_solver, "solve_fused_pix", _unchanged)
    elif fault == "half_batch":
        monkeypatch.setattr(batch, "dispatch_image_batch",
                            _half_batch(batch.dispatch_image_batch))
    else:
        monkeypatch.setattr(engine, "download", _altered(engine.download))
    out = _run(name)
    assert not out["correct"] and out["failed"] > 0
    assert out["checks"]["coef_mismatch"]["value"] > 0


def test_an_error_in_the_window_is_not_correct(monkeypatch):
    def broken(imgs, opts, dev):
        raise RuntimeError("planted")
    out = _run(CELLS[0])
    assert out["correct"]
    monkeypatch.setattr(batch, "dispatch_image_batch", broken)
    out = _run(CELLS[0])
    assert not out["correct"] and out["checks"]["errors"]["value"] == 1
    assert out["metrics"] == {}
