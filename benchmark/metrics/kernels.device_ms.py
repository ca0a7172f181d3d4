"""Device time of the program's own kernels (every kernel that is not
ATen's) per batch of the traced window, in ms (profiler)."""


def read(ctx):
    r = ctx.reading
    if r is None or not r.batches or not r.count("kernel"):
        return None
    return r.device_s("kernel") / r.batches * 1e3
