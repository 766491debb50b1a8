"""The device trace of a traced window, and the harness's host spans.

``Window`` runs ``torch.profiler`` over the device's activity alone (host
events are not recorded: reading them costs seconds and stalls the run)
and reduces it to: the busy union of every device event (kernels, copies,
sets) inside the window, the summed time of the events whose names match
each kernel class's patterns, the device operations that took most time,
and the idle time named by the host spans that overlapped it. Host spans
are the harness's own (``Spans``), around its calls into the program,
on the wall clock the profiler's events use.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple


class Spans:
    """Named host intervals on ``time.time_ns()``."""

    def __init__(self):
        self.items: List[Tuple[int, int, str]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.items.append((t0, time.time_ns(), name))

    def wrap(self, obj, method: str, name: str) -> None:
        """Record a span around every call of ``obj.method``."""
        fn = getattr(obj, method)

        def call(*args, **kw):
            with self.span(name):
                return fn(*args, **kw)
        setattr(obj, method, call)

    def attribute(self, idle) -> Dict[str, int]:
        """Nanoseconds of each idle interval by the host span that
        overlapped it (the harness's spans run one after another on one
        thread); time under no span is ``harness``."""
        spans = sorted(self.items)
        out: Dict[str, int] = defaultdict(int)
        i = 0
        for a, b in idle:
            while i < len(spans) and spans[i][1] <= a:
                i += 1
            covered, j = 0, i
            while j < len(spans) and spans[j][0] < b:
                lo, hi = max(a, spans[j][0]), min(b, spans[j][1])
                if hi > lo:
                    out[spans[j][2]] += hi - lo
                    covered += hi - lo
                j += 1
            if b - a > covered:
                out["harness"] += b - a - covered
        return dict(out)


def merge(intervals: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Union of [start, end) intervals, sorted and disjoint."""
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(intervals, lo: int, hi: int) -> List[Tuple[int, int]]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if min(b, hi) > max(a, lo)]


def gaps(busy: Sequence[Tuple[int, int]], lo: int, hi: int
         ) -> List[Tuple[int, int]]:
    """The idle intervals of [lo, hi) between the merged busy ones."""
    out, t = [], lo
    for a, b in busy:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def matches(name: str, patterns: Sequence[str]) -> bool:
    return any(p in name for p in patterns)


class Summary:
    """A traced window reduced to what the per-layer metrics read."""

    def __init__(self, events: Sequence[Tuple[str, int, int]], lo: int,
                 hi: int, spans: Spans):
        # every event was recorded between the profiler's start and stop;
        # if their clock is not the host's wall clock, the first event
        # starts the window
        if events and (min(a for _, a, _ in events) < lo - 10**6
                       or max(b for _, _, b in events) > hi + 10**6):
            shift = lo - min(a for _, a, _ in events)
            events = [(n, a + shift, b + shift) for n, a, b in events]
        inside = [(n, a, b) for n, a, b in events if b > lo and a < hi]
        self.window_s = (hi - lo) / 1e9
        busy = merge(clip([(a, b) for _, a, b in inside], lo, hi))
        self.busy_s = sum(b - a for a, b in busy) / 1e9
        self.events = inside
        by_name: Dict[str, int] = defaultdict(int)
        for n, a, b in inside:
            by_name[n] += min(b, hi) - max(a, lo)
        self.by_name = dict(by_name)
        self.idle_by_span = spans.attribute(gaps(busy, lo, hi))

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def kernel_s(self, patterns: Sequence[str]) -> float:
        """Summed device time of the events a kernel class names."""
        return sum(t for n, t in self.by_name.items()
                   if matches(n, patterns)) / 1e9

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:top]
        idle = sorted(self.idle_by_span.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:120], t / 1e9] for n, t in ops],
                "idle_gaps": [[n, t / 1e9] for n, t in idle]}


class Window:
    """``start()`` and ``stop()`` the profiler at block boundaries (the
    caller synchronises the device first); ``summary()`` afterwards."""

    def __init__(self, torch, spans: Spans):
        self.torch = torch
        self.spans = spans
        self.prof = None
        self.lo = self.hi = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.lo = time.time_ns()

    def stop(self) -> None:
        self.torch.cuda.synchronize()
        self.hi = time.time_ns()
        self.prof.__exit__(None, None, None)

    def summary(self) -> Optional[Summary]:
        if self.prof is None or self.hi is None:
            return None
        events = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type().name != "CUDA" or e.duration_ns() <= 0:
                continue
            if e.is_user_annotation():
                continue
            events.append((e.name(), e.start_ns(),
                           e.start_ns() + e.duration_ns()))
        return Summary(events, self.lo, self.hi, self.spans)
