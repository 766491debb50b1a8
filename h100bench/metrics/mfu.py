"""The whole step's share of the card's bf16 dense peak (989 TFLOP/s):
the traced window's model FLOPs (2 x the parameters each decoded or
prefilled token uses, attention over its context, each tower pass) over
the window's length times the peak."""


def read(ctx):
    return ctx.mfu()
