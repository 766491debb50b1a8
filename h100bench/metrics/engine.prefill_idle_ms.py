"""Milliseconds the card idles during a hand-over's prefill, per
``engine.start`` span of the traced window: idle under the program's
``engine.prefill`` spans (the prefill's launches and the first token's
draw)."""
from h100bench.program_spans import idle_ns, named, window_spans


def read(ctx):
    spans = window_spans(ctx)
    starts = named(spans, "engine.start")
    if not starts:
        return None
    idle = idle_ns(ctx, named(spans, "engine.prefill"))
    return idle.get("engine.prefill", 0) / 1e6 / len(starts)
