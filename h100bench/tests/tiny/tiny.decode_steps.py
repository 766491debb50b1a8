"""Decode steps in the traced window (the engine's counter): a per-layer
metric that the tests add as a new file."""


def read(ctx):
    return ctx.trace_counters.get("decode_steps")
