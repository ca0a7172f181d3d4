"""BENCHMARK.json and the files it names, found by name."""

from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _named(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def workload(bench: dict, name: str) -> dict:
    return _named(bench["workloads"], name, "workload")


def config(bench: dict, name: str, root: str = ROOT) -> dict:
    """The configuration's file, as run."""
    entry = _named(bench["configs"], name, "config")
    with open(os.path.join(root, entry["file"])) as f:
        return json.load(f)


def traffic(name: str) -> dict:
    """The traffic mix's parameters, ``benchmark/traffic/<name>.json``."""
    with open(os.path.join(BENCH_DIR, "traffic", name + ".json")) as f:
        return json.load(f)


def metrics_of(bench: dict, workload_name: str, section: str) -> list:
    """The metrics of ``section`` (end_to_end or per_layer) that a cell
    reports: those without a ``workloads`` key and those that list it."""
    return [m for m in bench[section]
            if workload_name in m.get("workloads", [workload_name])]


def metric_reader(name: str):
    """``read(reading) -> number or None`` of a per-layer metric, from
    ``benchmark/metrics/<name>.py``."""
    path = os.path.join(BENCH_DIR, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
