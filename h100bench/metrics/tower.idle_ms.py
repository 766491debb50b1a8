"""Milliseconds the card idles in the tower's passes, per image of the
traced window: idle under the program's ``tower`` spans (the pixels'
upload, the tower and the connector) over the images they encoded."""
from h100bench.program_spans import idle_ns, named, window_spans


def read(ctx):
    towers = named(window_spans(ctx), "tower")
    images = sum(s.attrs.get("images", 0) for s in towers)
    if not images:
        return None
    return idle_ns(ctx, towers).get("tower", 0) / 1e6 / images
