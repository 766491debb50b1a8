"""Waits of the host for the card per decode block in the traced window:
the engine's ``counters["host_syncs"]`` over its
``counters["decode_dispatches"]``."""


def read(ctx):
    syncs = ctx.trace_counters.get("host_syncs")
    blocks = ctx.trace_counters.get("decode_dispatches")
    if ctx.summary is None or syncs is None or not blocks:
        return None
    return syncs / blocks
