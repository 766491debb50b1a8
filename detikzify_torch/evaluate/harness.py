"""Evaluation harness: the reference's ``examples/eval.py`` protocol as a
library (counterpart of ``detikzify_tpu/evaluate/harness.py``).

Implements (reference file:line cites):
  * per-item generation protocol -- MCTS until the first compilable output
    (fast mode) or score-improvement until a minimum timeout (model mode),
    keeping the best-scored program (eval.py:95-106,119);
  * MeanTokenEfficiency = len(best)/sum(len(sampled)), winsorized 5%
    (eval.py:147-151);
  * MeanSamplingThroughput = programs per item within budget, winsorized
    (eval.py:153-154);
  * prediction caching so interrupted runs resume (eval.py:121-136);
  * distributed sharding: striped chunks per process + interleaved gather
    (eval.py:80-93,125-133), the processes being those of the default
    ``torch.distributed`` group (one process without one).
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import numpy as np

from .dist import process_index_count


def winsorize(values: Sequence[float], limit: float = 0.05) -> np.ndarray:
    """Clamp the top/bottom ``limit`` quantiles (reference winsorizes 5%)."""
    arr = np.asarray(list(values), np.float64)
    if arr.size == 0:
        return arr
    lo, hi = np.quantile(arr, [limit, 1 - limit])
    return np.clip(arr, lo, hi)


def mean_token_efficiency(per_item_lengths: Sequence[Sequence[int]],
                          limit: float = 0.05) -> float:
    """Per item: len(best program)/sum(len(all sampled programs)); the best
    program is by protocol the last one sampled (eval.py:119,147-151)."""
    ratios = []
    for lengths in per_item_lengths:
        if lengths and sum(lengths) > 0:
            ratios.append(lengths[-1] / sum(lengths))
    return float(np.mean(winsorize(ratios, limit))) if ratios else 0.0


def mean_sampling_throughput(per_item_counts: Sequence[int],
                             limit: float = 0.05) -> float:
    return float(np.mean(winsorize(list(map(float, per_item_counts)),
                                   limit))) if per_item_counts else 0.0


def p50_time_to_first_compile(per_item_seconds: Sequence[float]) -> float:
    """Median wall-clock until the first compilable output (BASELINE.md
    north-star metric #3)."""
    if not per_item_seconds:
        return float("nan")
    return float(np.median(np.asarray(list(per_item_seconds), np.float64)))


@dataclass
class ItemResult:
    best_code: str
    best_score: float
    num_programs: int
    program_lengths: List[int] = field(default_factory=list)
    seconds: float = 0.0
    compiled: bool = False


def generate_until_compilable(
    pipeline,
    image,
    *,
    timeout: Optional[float] = None,
    max_expansions: Optional[int] = None,
    score_improve: bool = False,
    min_seconds: float = 0.0,
    token_len: Optional[Callable[[str], int]] = None,
    parallelism: int = 1,
) -> ItemResult:
    """The reference per-item protocol: run MCTS until the first compilable
    output (fast) or keep improving the score for >= min_seconds (model
    mode); the last (= best-scored) program is kept (eval.py:95-106).

    ``parallelism > 1`` overlaps MCTS expansions on the engine's decode
    slots -- same protocol, ~linear cut in wall-clock to first compile."""
    token_len = token_len or (lambda code: len(
        pipeline.processor.tokenizer.encode(code,
                                            add_special_tokens=False)))
    t0 = time.time()
    best_code, best_score = "", -float("inf")
    lengths: List[int] = []
    count = 0
    for score, doc in pipeline.simulate(image=image, timeout=timeout,
                                        expansions=max_expansions,
                                        parallelism=parallelism):
        count += 1
        lengths.append(token_len(doc.code))
        if score >= best_score:
            best_code, best_score = doc.code, score
        compiled = doc.is_rasterizable
        elapsed = time.time() - t0
        if compiled and not score_improve:
            break
        if score_improve and compiled and elapsed >= min_seconds:
            break
    return ItemResult(best_code=best_code, best_score=float(best_score),
                      num_programs=count, program_lengths=lengths,
                      seconds=time.time() - t0,
                      compiled=best_score > -float("inf") and bool(best_code))


def redacted_render(doc, rot13: bool = False, size: int = 420):
    """Rasterize a compiled document with its text redacted (or rot13'd) --
    the leakage-controlled eval variant (reference examples/eval.py:156-193,
    util/image.py:62-71). Requires a PDF output and pymupdf; hermetic
    backends may instead provide ``render_redacted`` (FakeBackend does),
    else returns None."""
    if doc.output.pdf is None:
        fn = getattr(getattr(doc, "backend", None), "render_redacted", None)
        if fn is not None and doc.output.image is not None:
            return fn(doc.code, rot13=rot13, size=size)
        return None
    try:
        import fitz
    except ImportError:
        return None
    from PIL import Image

    from ..utils.image import expand, redact

    pdf = fitz.open(stream=doc.output.pdf, filetype="pdf")
    redact(pdf, rot13=rot13)
    page = pdf[-1]
    pix = page.get_pixmap(dpi=200)
    img = Image.frombytes("RGB", (pix.width, pix.height), pix.samples)
    return expand(img, size, do_trim=True)


class PredictionCache:
    """JSONL prediction cache so crashed eval runs resume (eval.py:121-136)."""

    def __init__(self, path: str):
        import threading

        self.path = path
        self._data = {}
        self._lock = threading.Lock()   # replica threads put() concurrently
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    row = json.loads(line)
                    self._data[row["key"]] = row

    def get(self, key: str):
        return self._data.get(key)

    def put(self, key: str, value: dict) -> None:
        row = {"key": key, **value}
        with self._lock:
            self._data[key] = row
            with open(self.path, "a") as f:
                f.write(json.dumps(row) + "\n")


def shard_indices(n_items: int, process_index: Optional[int] = None,
                  process_count: Optional[int] = None) -> List[int]:
    """Striped assignment: item i -> process (i % P) (eval.py:80-83)."""
    if process_index is None:
        process_index, process_count = process_index_count()
    return list(range(process_index, n_items, process_count))


def gather_interleaved(local_results: List, n_items: int,
                       process_index: Optional[int] = None,
                       process_count: Optional[int] = None) -> List:
    """All-gather striped per-process results back into item order
    (reference uses dist.all_gather_object + interleave, eval.py:125-133).
    ``local_results`` are (item_index, row) pairs; the return value is rows
    sorted by item index -- in single-process runs too, so callers can mix
    cache hits and computed items in any order. Across processes each
    process's pairs travel as one JSON payload through
    ``torch.distributed.all_gather_object`` (rows come back as JSON values,
    as the JAX gather's do), of any size."""
    process_count = process_count or process_index_count()[1]
    if process_count == 1:
        merged = dict(local_results)
        return [merged[i] for i in range(n_items) if i in merged]
    import torch.distributed as dist

    payload = json.dumps([(i, r) for i, r in local_results])
    gathered: List = [None] * process_count
    dist.all_gather_object(gathered, payload)
    merged: dict = {}
    for part in gathered:
        for i, r in json.loads(part):
            merged[i] = r
    return [merged[i] for i in range(n_items) if i in merged]
