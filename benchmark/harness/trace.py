"""The traced run's reading: the device's operations from torch.profiler,
the harness's own host spans, and what the metric readers are given.

Device operations are the profiler's events on the card: kernels, and
the memcpy and memset operations (named "Memcpy ..." and "Memset ...").  A kernel is ATen's (the program's eager glue)
when its name is one of PyTorch's own (``at::`` and its CUDA helpers,
CUB); every other kernel is one of the program's hand-written kernels.
Copies between host and card are neither.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

ATEN_MARKERS = ("at::", "at_cuda_detail", "cub::", "c10::")
HOST_SPANS = ("bench.dispatch", "bench.assemble")


def op_kind(name: str) -> str:
    """"copy" (between host and card), "device" (a copy or fill within
    the card), "aten" (one of PyTorch's kernels) or "kernel" (one of the
    program's)."""
    if name.startswith("Memcpy") or name.startswith("Memset"):
        return "copy" if "HtoD" in name or "DtoH" in name else "device"
    return "aten" if any(m in name for m in ATEN_MARKERS) else "kernel"


@dataclass
class Reading:
    """What a metric reads.  Host spans in seconds by the harness's clock;
    device operations as (name, kind, start_ns, end_ns) on the profiler's
    clock; ``busy_s`` the seconds with any operation on the card,
    ``compute_s`` those with one that is not a copy between host and
    card; ``least_s`` the roofline's least time of the traced batches'
    work, ``b2_least_s`` that of B2's own share of it."""
    batches: int = 0
    images: int = 0
    spans: dict = field(default_factory=dict)
    device_ops: list = field(default_factory=list)
    window_s: float = 0.0
    busy_s: float = 0.0
    compute_s: float = 0.0
    least_s: float = 0.0
    b2_least_s: float = 0.0
    breakdown: dict = None

    def device_s(self, kind: str) -> float:
        return sum(e - s for _, k, s, e in self.device_ops if k == kind) / 1e9

    def count(self, kind: str) -> int:
        return sum(1 for _, k, _s, _e in self.device_ops if k == kind)


class Tracer:
    """torch.profiler over the window.  A traced run records the host and
    the card, with a profiler range around each call of the harness into
    the program (``span``); an untraced run on a card records the card's
    activity alone, which the end-to-end ``card_compute_mp_s`` reads."""

    def __init__(self, traced: bool, on_card: bool):
        self.traced = traced
        self.on_card = on_card
        self.prof = None

    def span(self, name):
        if not self.traced:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(name)

    @contextlib.contextmanager
    def trace(self):
        if not (self.traced or self.on_card):
            yield
            return
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] if self.traced else []
        if self.on_card:
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            yield
        self.prof = prof

    def events(self):
        """(device operations [(name, kind, start_ns, end_ns)], host spans
        {name: [(start_ns, end_ns)]}) from the profiler's raw events.  A
        device event named like a host span is that range's shadow on the
        card's timeline, not an operation."""
        ops, spans = [], {n: [] for n in HOST_SPANS}
        for ev in self.prof.profiler.kineto_results.events():
            name = ev.name()
            on_card = "CUDA" in str(ev.device_type())
            if name in spans:
                if not on_card:
                    spans[name].append((ev.start_ns(), ev.end_ns()))
            elif on_card:
                ops.append((name, op_kind(name), ev.start_ns(),
                            ev.end_ns()))
        ops.sort(key=lambda o: o[2])
        return ops, spans


def union_s(intervals, lo, hi) -> float:
    """Seconds of [lo, hi] covered by sorted (start, end) ns intervals."""
    busy, cur_s, cur_e = 0, None, None
    for s, e in intervals:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e9


def idle_gaps(intervals, spans, lo, hi):
    """Idle time of the card in [lo, hi], by what the harness's host was
    doing then: inside a dispatch, inside an assemble, or between them.
    Returns [[activity, seconds], ...], the most first."""
    gaps, edge = [], lo
    for s, e in intervals:
        if s > edge:
            gaps.append((edge, min(s, hi)))
        edge = max(edge, e)
        if edge >= hi:
            break
    if edge < hi:
        gaps.append((edge, hi))
    host = sorted((s, e, name.split(".")[-1])
                  for name, ivs in spans.items() for s, e in ivs)
    by = {}
    i = 0
    for gs, ge in gaps:
        covered = 0
        while i < len(host) and host[i][1] <= gs:
            i += 1
        j = i
        while j < len(host) and host[j][0] < ge:
            o = min(ge, host[j][1]) - max(gs, host[j][0])
            if o > 0:
                by[host[j][2]] = by.get(host[j][2], 0) + o
                covered += o
            j += 1
        by["between calls"] = by.get("between calls", 0) + (ge - gs - covered)
    return sorted(([k, v / 1e9] for k, v in by.items()),
                  key=lambda kv: -kv[1])


def top_ops(ops, n=10):
    """The device operations that took most time, by name."""
    by = {}
    for name, _, s, e in ops:
        key = name if len(name) <= 120 else name[:117] + "..."
        by[key] = by.get(key, 0) + (e - s)
    rows = sorted(by.items(), key=lambda kv: -kv[1])[:n]
    return [[k, v / 1e9] for k, v in rows]
