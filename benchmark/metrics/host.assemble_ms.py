"""Host time of each ``assemble()`` (the wait for the batch's copies,
the copies into fresh host arrays, the results built), mean over the
traced window's batches, in ms.  A span in the harness."""


def read(ctx):
    d = ctx.reading.spans.get("assemble") if ctx.reading else None
    return sum(d) / len(d) * 1e3 if d else None
