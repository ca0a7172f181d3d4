"""B2's least time as a share of its device time, in %: the roofline's
least time of B2's own work in the traced batches (harness/roofline.py
``b2_work``: the sweep of every component that B2 solves) over the
device time of the traced window's ``solve_borders_kernel`` operations.
Nothing to read where B2 has no work (LOW_QUALITY) or did not run."""

B2 = "solve_borders_kernel<"


def read(ctx):
    r = ctx.reading
    if r is None or r.b2_least_s <= 0:
        return None
    spent = sum(e - s for name, kind, s, e in r.device_ops
                if kind == "kernel" and B2 in name) / 1e9
    return 100.0 * r.b2_least_s / spent if spent > 0 else None
