"""Megapixels of the images whose results reached the host in the
window, over the window's seconds (first dispatch to last completion),
by the host's clock: the batch pipeline's rate, which the host sets
today."""


def read(ctx):
    loop = ctx.loop
    if not loop.done or loop.t_end <= loop.t0:
        return None
    images = sum(len(b.images) for b in loop.done)
    return images * ctx.image_mp / (loop.t_end - loop.t0)
