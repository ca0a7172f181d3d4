"""Seconds from the process's start to the window's: imports, the
kernel library built or loaded, the inputs made, the warm-up batches."""


def read(ctx):
    return ctx.setup_s
