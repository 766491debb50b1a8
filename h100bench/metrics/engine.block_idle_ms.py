"""Milliseconds the card idles in a decode block's host work, per
``engine.step`` span of the traced window that dispatched a block: idle
under the program's ``engine.step`` spans (dispatch, uploads, the wait
for the block's tokens and their delivery)."""
from h100bench.program_spans import idle_ns, named, window_spans


def read(ctx):
    steps = named(window_spans(ctx), "engine.step")
    blocks = sum("kv_pages" in s.attrs for s in steps)
    if not blocks:
        return None
    return idle_ns(ctx, steps).get("engine.step", 0) / 1e6 / blocks
