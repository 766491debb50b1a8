"""Milliseconds a decode step: the traced window over the engine's
``counters["decode_steps"]`` in it."""


def read(ctx):
    steps = ctx.trace_counters.get("decode_steps")
    if ctx.summary is None or not steps:
        return None
    return 1e3 * ctx.summary.window_s / steps
