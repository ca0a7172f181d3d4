"""Launches of PyTorch's own (ATen) kernels per batch of the traced
window (profiler)."""


def read(ctx):
    r = ctx.reading
    if r is None or not r.batches or not r.count("aten"):
        return None
    return r.count("aten") / r.batches
