"""Profiling / tracing hooks (counterpart of
``detikzify_tpu/utils/profiling.py``): make the prefill, decode, compile
and score phases observable.

``trace(...)`` wraps ``torch.profiler`` so a TensorBoard-compatible trace
(host ops, and the card's kernels when CUDA is available) lands on disk;
``span(name, **attrs)`` names a region: it shows in such a trace's
timeline, and while any torch profiler runs the process's recorder keeps
it (name, start and end, the span it nests in, attributes) for
``spans()``. With no profiler running a span costs one attribute read and
records nothing. ``Timer`` aggregates host-side phase timings.

Span times are ``time.time_ns()``: the wall clock on which the profiler
stamps the card's activity, so a span and the kernels it launched lie on
one time line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional

import torch.autograd.profiler as _autograd_profiler
from torch.autograd.profiler import record_function


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Capture a profile: ``with trace('/tmp/profile'): ...`` writes one
    ``*.pt.trace.json`` into ``logdir`` when the block ends."""
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


@dataclasses.dataclass(frozen=True)
class Span:
    """One recorded region: ``parent`` is the ``id`` of the span it was
    opened inside on the same thread (None at the top)."""
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    attrs: dict


class Recorder:
    """A bounded list of finished spans; past ``CAPACITY`` new ones are
    counted in ``dropped`` instead of kept."""

    CAPACITY = 1 << 16

    def __init__(self):
        self.dropped = 0
        self._items: List[Span] = []
        self._lock = threading.Lock()
        self._ids = itertools.count()
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def add(self, item: Span) -> None:
        with self._lock:
            if len(self._items) < self.CAPACITY:
                self._items.append(item)
            else:
                self.dropped += 1

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._items)

    def clear(self) -> None:
        with self._lock:
            self._items.clear()
            self.dropped = 0


class _Open:
    """The context of a span being recorded; ``set`` adds attributes known
    only inside the region."""
    __slots__ = ("recorder", "name", "attrs", "id", "parent", "start_ns",
                 "_rf")

    def __init__(self, recorder: Recorder, name: str, attrs: dict):
        self.recorder, self.name, self.attrs = recorder, name, attrs

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> "_Open":
        stack = self.recorder._stack()
        self.parent = stack[-1] if stack else None
        self.id = next(self.recorder._ids)
        stack.append(self.id)
        self._rf = record_function(self.name)
        self._rf.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        end = time.time_ns()
        self._rf.__exit__(*exc)
        self.recorder._stack().pop()
        self.recorder.add(Span(self.name, self.start_ns, end, self.id,
                               self.parent, self.attrs))


class _NoSpan:
    """What ``span`` returns while no profiler runs: shared, and a no-op."""
    __slots__ = ()

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def set(self, **attrs) -> None:
        return None


NO_SPAN = _NoSpan()
RECORDER = Recorder()


def span(name: str, **attrs):
    """A named region, ``with span("engine.step", k=16) as s: ...;
    s.set(captured=True)``: recorded, and shown in a trace's timeline,
    only while a torch profiler runs (the flag ``record_function``'s own
    callers check)."""
    if not _autograd_profiler._is_profiler_enabled:
        return NO_SPAN
    return _Open(RECORDER, name, attrs)


def spans() -> List[Span]:
    """The spans recorded since the last ``clear()``, in the order they
    ended."""
    return RECORDER.spans()


def clear() -> None:
    RECORDER.clear()


class Timer:
    """Accumulating phase timer: ``with timer('prefill'): ...``."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, phase: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[phase] += time.perf_counter() - t0
            self.counts[phase] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {k: {"total_s": self.totals[k], "count": self.counts[k],
                    "mean_ms": 1e3 * self.totals[k] / max(self.counts[k], 1)}
                for k in self.totals}
