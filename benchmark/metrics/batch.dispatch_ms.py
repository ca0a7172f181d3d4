"""Host time of each dispatch call into the program (the batch engine's
``dispatch_image_batch``: staging, upload, every launch queued), mean
over the traced window's batches, in ms.  A span in the harness."""


def read(ctx):
    d = ctx.reading.spans.get("dispatch") if ctx.reading else None
    return sum(d) / len(d) * 1e3 if d else None
