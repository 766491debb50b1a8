"""Profiling / tracing hooks (counterpart of
``detikzify_tpu/utils/profiling.py``): make the prefill, decode, compile
and score phases observable.

``trace(...)`` wraps ``torch.profiler`` so a TensorBoard-compatible trace
(host ops, and the card's kernels when CUDA is available) lands on disk;
``annotate(...)`` names a region inside it; ``Timer`` aggregates host-side
phase timings (the generator's ``stats`` dict uses the same convention).
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator


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


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region inside a trace (shows up in the profiler timeline)."""
    from torch.profiler import record_function

    with record_function(name):
        yield


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
