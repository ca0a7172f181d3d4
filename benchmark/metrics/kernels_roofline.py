"""The least time of the traced batches' smoothing work (harness/
roofline.py) as a share of the device time of all kernels of the traced
window, ATen's included, in %."""


def read(ctx):
    r = ctx.reading
    if r is None:
        return None
    spent = r.device_s("kernel") + r.device_s("aten")
    return 100.0 * r.least_s / spent if spent > 0 else None
