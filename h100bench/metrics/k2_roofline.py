"""K2's share of its roofline in the traced window: the least time its
work could take (``kernels/k2.py``) over the profiled time of its
kernels."""


def read(ctx):
    return ctx.roofline("k2")
