"""Tracing and profiling helpers: the port of
``jpegqs_tpu/utils/profiling.py``.

The reference has a single wall-clock timer around the smoothing phase
(quantsmooth.h:72-86, 2820-2825).  Here: a phase timer with MP/s and
blocks/s rates, and a ``torch.profiler`` trace of a region for the real
per-kernel timeline (a Chrome trace: chrome://tracing or Perfetto).
"""

from __future__ import annotations

import contextlib
import os
import sys
import time


class PhaseTimer:
    """Accumulates host wall time per named phase; reports MP/s rates.
    Work queued on a card is counted only if the phase waits for it."""

    def __init__(self):
        self.phases = {}

    @contextlib.contextmanager
    def phase(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = (self.phases.get(name, 0.0)
                                 + time.perf_counter() - t0)

    def report(self, megapixels=None, blocks=None, file=sys.stderr):
        total = sum(self.phases.values())
        for name, dt in sorted(self.phases.items(), key=lambda kv: -kv[1]):
            line = f"  {name:<24s} {dt * 1e3:9.2f} ms"
            if megapixels:
                line += f"  {megapixels / dt:9.1f} MP/s"
            if blocks:
                line += f"  {blocks / dt:12.0f} blocks/s"
            print(line, file=file)
        print(f"  {'total':<24s} {total * 1e3:9.2f} ms", file=file)


@contextlib.contextmanager
def device_trace(log_dir, device="cuda", name="trace.json"):
    """torch.profiler trace around a region, written as a Chrome trace to
    ``log_dir/name``: host activity, and on the card (``device`` CUDA) its
    kernels and copies, the region's work waited for at its end.  Yields
    the profiler (``key_averages()`` for sums by kernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    on_card = str(device).startswith("cuda")
    acts = [ProfilerActivity.CPU]
    if on_card:
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
        if on_card:
            torch.cuda.synchronize()
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, name))
