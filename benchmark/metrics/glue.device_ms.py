"""Device time of PyTorch's own (ATen) kernels, the program's eager
glue, per batch of the traced window, in ms (profiler)."""


def read(ctx):
    r = ctx.reading
    if r is None or not r.batches or not r.count("aten"):
        return None
    return r.device_s("aten") / r.batches * 1e3
