"""K5's share of its roofline in the traced window: the least time its
work could take (``kernels/k5.py``) over the profiled time of its
kernels."""


def read(ctx):
    return ctx.roofline("k5")
