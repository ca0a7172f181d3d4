"""The benchmark's harness: one cell of BENCHMARK.json run once.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is a file of its own, found by its name:
``benchmark/configs/<config>.json``, ``benchmark/traffic/<traffic>.json``
and ``benchmark/metrics/<metric>.py``.  Nothing here imports JAX or the
JAX package; the program under test is ``jpegqs_tpu_torch``.
"""
