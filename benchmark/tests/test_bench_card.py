"""On the card: each cell once, short, through run.py, as a check
runs it; the result's line has every key and comes out correct.  Skips
without a card.

    python -m pytest benchmark/tests/test_bench_card.py -m cuda
"""

import json
import subprocess
import sys

import pytest
import torch

from benchmark.harness import spec

BENCH = spec.load_benchmark()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("traced", [0, 1])
def test_a_short_run_on_the_card(card, name, traced):
    r = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", name, "--seed",
         str(2 ** 31 + 101 + traced), "--seconds", "3", "--trace",
         str(traced)], cwd=spec.ROOT, capture_output=True, text=True,
        timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"] and list(out)[-1] == "checks"
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    section = "per_layer" if traced else "end_to_end"
    want = {m["name"] for m in spec.metrics_of(BENCH, name, section)}
    assert set(out["metrics"]) == want
    if traced:
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
        assert out["breakdown"]["device_ops"]
