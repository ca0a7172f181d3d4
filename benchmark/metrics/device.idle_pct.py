"""Share of the traced window (first dispatch to last assemble) with
neither a kernel nor a copy on the card, in % (profiler)."""


def read(ctx):
    r = ctx.reading
    if r is None or r.window_s <= 0 or r.busy_s <= 0:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)
