"""Megapixels of every image that the window dispatched, over the seconds
in which a kernel, a copy within the card or a fill ran on the card for
them (the profiler's device activity, recorded in every run on a card;
copies between host and card left out): the rate of the card's own work,
whatever pace the host sets and whatever its copy engines take."""


def read(ctx):
    r = ctx.reading
    if r is None or r.compute_s <= 0 or not r.images:
        return None
    return r.images * ctx.image_mp / r.compute_s
