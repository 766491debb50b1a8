"""Share of the traced window in which no device operation ran (the
profiler's busy union)."""


def read(ctx):
    if ctx.summary is None:
        return None
    return 100.0 * ctx.summary.idle_share
