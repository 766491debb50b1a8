"""Milliseconds the card idles during a hand-over's host work, per
``engine.start`` span of the traced window: idle under the program's
``engine.start`` spans but outside the ``engine.prefill`` inside them
(slot, page and table work, and the prompt's uploads)."""
from h100bench.program_spans import idle_ns, named, window_spans


def read(ctx):
    spans = window_spans(ctx)
    starts = named(spans, "engine.start")
    if not starts:
        return None
    idle = idle_ns(ctx, starts + named(spans, "engine.prefill"))
    return (idle.get("engine.start", 0) - idle.get("engine.prefill", 0)) \
        / 1e6 / len(starts)
