"""The program's own spans in a traced window, and the card's idle time
under them.

The port's recorder (``detikzify_torch.utils.profiling``) keeps spans only
while a profiler runs: in a ``--trace 1`` run, the traced sub-window.
Idle under a span is the part of its interval that lies under no device
event of the window: ``trace.py``'s idle gaps, attributed to the spans by
``trace.Spans.attribute``, as the harness's own spans are. A program
without the recorder gives no spans, and its readers ``None``.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

from .trace import Spans, clip, gaps, merge


def recorded() -> list:
    """The recorder's spans, or [] where the program has none."""
    try:
        from detikzify_torch.utils import profiling
    except ImportError:
        return []
    spans = getattr(profiling, "spans", None)
    return [] if spans is None else list(spans())


def named(spans: Sequence, name: str) -> list:
    return [s for s in spans if s.name == name]


def window_spans(ctx) -> List:
    """The program's spans of a traced window; [] with no trace."""
    return [] if ctx.summary is None else recorded()


def idle_ns(ctx, spans: Sequence) -> Dict[str, int]:
    """Idle nanoseconds under ``spans``, by span name. A nested span's idle
    counts under its own name and under its parent's. The program records
    spans only while the profiler runs, so they lie inside the window."""
    if not spans:
        return {}
    lo = min(s.start_ns for s in spans)
    hi = max(s.end_ns for s in spans)
    busy = merge(clip([(a, b) for _, a, b in ctx.summary.events], lo, hi))
    host = Spans()
    host.items = [(s.start_ns, s.end_ns, s.name) for s in spans]
    return host.attribute(gaps(busy, lo, hi))
