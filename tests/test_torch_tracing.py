"""The port's span recorder and its host-sync counter
(``detikzify_torch/utils/profiling.py``, ``engine/decode.py``) on a tiny
engine on the CPU, the benchmark's readers of them
(``h100bench/metrics/``) on hand-built traced windows, and one check on a
card that a span and the kernels it launched lie on one clock.

This file imports neither JAX nor the JAX package: on a card run it with
``python -m pytest tests/test_torch_tracing.py -m gpu --noconftest``.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from detikzify_torch.config import tiny_test_config  # noqa: E402
from detikzify_torch.engine import DecodeEngine  # noqa: E402
from detikzify_torch.models import convert  # noqa: E402
from detikzify_torch.ops.sampling import SamplingParams  # noqa: E402
from detikzify_torch.utils import profiling  # noqa: E402
from h100bench.harness import Context  # noqa: E402
from h100bench.manifest import Manifest  # noqa: E402
from h100bench.trace import Spans, Summary  # noqa: E402
from h100bench.work import Log  # noqa: E402

MS = 1_000_000


@pytest.fixture(scope="module")
def model():
    cfg = tiny_test_config(vocab_size=512)
    params = convert.init_random(cfg, device="cpu", dtype=torch.float32,
                                 seed=0)
    return cfg, params


def _engine(model, **kw):
    cfg, params = model
    return DecodeEngine(params, cfg, num_slots=3, max_len=128, page_size=16,
                        decode_block=4, cache_dtype=torch.float32,
                        sampling=SamplingParams(temperature=0.0),
                        device="cpu", **kw)


def _prompt(cfg):
    return [cfg.image_token_id] * cfg.image_seq_len + [cfg.bos_token_id]


def _pixels(cfg, n=1):
    size = cfg.vision.image_size
    return np.zeros((n, size, size, 3), np.float32)


def _hand_over(eng, cfg):
    """One request: the tower, a lazy start, steps to its end, release."""
    embeds = eng.encode_image(_pixels(cfg))
    ro = eng.start(_prompt(cfg), image_embeds=embeds, max_new_tokens=6,
                   lazy=True)
    while not ro.finished:
        eng.step()
    eng.release(ro)
    return ro


def test_no_profiler_records_nothing(model):
    cfg = model[0]
    eng = _engine(model)
    profiling.clear()
    _hand_over(eng, cfg)
    ros = eng.start_many([_prompt(cfg)] * 2, max_new_tokens=3)
    eng.run()
    for ro in ros:
        eng.release(ro)
    assert profiling.spans() == []
    assert profiling.span("engine.step", k=4) is profiling.NO_SPAN


def test_spans_nest_and_share_the_request_id(model):
    """Under a CPU profiler: ``engine.prefill`` inside its
    ``engine.start``, both with the rollout's ``rid``; one ``tower`` span
    an encode; every ``engine.step`` says whether it captured a graph
    (never on the CPU), and those that dispatched carry the block's
    ``kv_pages`` and ``active`` slots; a ``start_many`` group is one
    ``engine.start`` with its rollouts' ids."""
    cfg = model[0]
    eng = _engine(model)
    profiling.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            ro = _hand_over(eng, cfg)
            group = eng.start_many([_prompt(cfg)] * 2, max_new_tokens=3)
            eng.run()
            eng.flush_steps()
        got = profiling.spans()
    finally:
        profiling.clear()
    by_id = {s.id: s for s in got}
    starts = [s for s in got if s.name == "engine.start"]
    prefills = [s for s in got if s.name == "engine.prefill"]
    steps = [s for s in got if s.name == "engine.step"]
    towers = [s for s in got if s.name == "tower"]
    assert len(starts) == len(prefills) == 2 and len(towers) == 1
    assert towers[0].attrs == {"images": 1} and towers[0].parent is None
    one, burst = starts
    assert one.attrs == {"rid": ro.rid, "slot": ro.slot,
                         "rows": len(_prompt(cfg))}
    assert burst.attrs["rids"] == [r.rid for r in group]
    assert burst.attrs["slots"] == [r.slot for r in group]
    for p, start in zip(prefills, starts):
        assert by_id[p.parent] is start
        assert start.start_ns <= p.start_ns <= p.end_ns <= start.end_ns
    assert prefills[0].attrs["rid"] == ro.rid
    assert prefills[1].attrs["rids"] == [r.rid for r in group]
    assert len({ro.rid, *(r.rid for r in group)}) == 3
    assert steps and all(s.attrs["captured"] is False for s in steps)
    blocks = [s for s in steps if "kv_pages" in s.attrs]
    assert len(blocks) == eng.counters["decode_dispatches"]
    assert all(s.attrs["k"] == 4 and s.attrs["active"] >= 1
               for s in blocks)
    assert steps[-1].attrs == {"k": 0, "captured": False}   # the flush


@pytest.mark.parametrize("kw,want", [
    # the tower's pixels; nine uploads of a start; a block's two uploads,
    # its first-token fetch and its tokens' fetch
    ({}, (1, 9, 4)),
    # speculative: the start's history and hint rows too
    ({"speculate": 3, "spec_min_rate": 0.0}, (1, 11, 4)),
    # pipelined: pinned uploads wait for nothing; the first step only
    # fetches the first tokens
    ({"pipelined": True}, (1, 0, 1)),
], ids=["eager", "speculative", "pipelined"])
def test_host_syncs_count_the_documented_sites(model, kw, want):
    cfg = model[0]
    eng = _engine(model, **kw)
    got = []
    embeds = eng.encode_image(_pixels(cfg))
    got.append(eng.counters["host_syncs"])
    eng.start(_prompt(cfg), image_embeds=embeds, max_new_tokens=8,
              lazy=True)
    got.append(eng.counters["host_syncs"] - sum(got))
    eng.step()
    got.append(eng.counters["host_syncs"] - sum(got))
    assert tuple(got) == want


# a hand-built traced window of 100 ms: the card busy in [0, 10), [30, 40)
# and [60, 100) ms, and the program's spans (ms) over it
BUSY = [(0, 10), (30, 40), (60, 100)]
SPANS = [  # name, start, end, id, parent, attrs
    ("tower", 5, 15, 0, None, {"images": 2}),            # idle 5
    ("engine.start", 20, 35, 1, None, {"rid": 7}),       # idle 10
    ("engine.prefill", 25, 33, 2, 1, {"rid": 7}),        # idle 5
    ("engine.start", 41, 50, 3, None, {"rid": 8}),       # idle 9
    ("engine.prefill", 44, 48, 4, 3, {"rid": 8}),        # idle 4
    ("engine.step", 50, 58, 5, None, {"kv_pages": 2}),   # idle 8
    ("engine.step", 58, 65, 6, None, {"kv_pages": 2}),   # idle 2
    ("engine.step", 65, 70, 7, None, {"k": 0}),          # no block, busy
]


def _ctx(busy, counters=None, traced=True):
    events = [("kernel", a * MS, b * MS) for a, b in busy]
    summary = Summary(events, 0, 100 * MS, Spans()) if traced else None
    return Context({}, {}, summary, Log(), counters or {}, {},
                   ROOT / "h100bench")


def _spans(rows):
    return [profiling.Span(n, a * MS, b * MS, i, p, dict(at))
            for n, a, b, i, p, at in rows]


@pytest.mark.parametrize("metric,want", [
    ("engine.handover_idle_ms.sample", ((10 + 9) - (5 + 4)) / 2),
    ("engine.prefill_idle_ms.sample", (5 + 4) / 2),
    ("engine.block_idle_ms.sample", (8 + 2 + 0) / 2),
    ("tower.idle_ms.sample", 5 / 2),
])
def test_span_readers_on_a_hand_built_window(monkeypatch, metric, want):
    """Idle under the spans (the gap in [15, 20) ms lies under none);
    a prefill counts once, inside its start."""
    monkeypatch.setattr(profiling, "spans", lambda: _spans(SPANS))
    reader = Manifest(ROOT).reader(metric)
    assert reader.read(_ctx(BUSY)) == pytest.approx(want)


@pytest.mark.parametrize("metric", [
    "engine.handover_idle_ms.sample", "engine.prefill_idle_ms.sample",
    "engine.block_idle_ms.sample", "tower.idle_ms.sample",
    "engine.syncs_per_block.sample"])
def test_readers_give_none_where_the_window_has_nothing(monkeypatch,
                                                        metric):
    """No spans and no counters; then spans but no trace (the CPU's
    runs)."""
    reader = Manifest(ROOT).reader(metric)
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert reader.read(_ctx(BUSY)) is None
    monkeypatch.setattr(profiling, "spans", lambda: _spans(SPANS))
    counters = {"host_syncs": 30, "decode_dispatches": 4}
    assert reader.read(_ctx(BUSY, counters, traced=False)) is None


def test_syncs_per_block_reader():
    reader = Manifest(ROOT).reader("engine.syncs_per_block.sample")
    assert reader.read(_ctx(BUSY, {"host_syncs": 30,
                                         "decode_dispatches": 4})) == 7.5
    assert reader.read(_ctx(BUSY, {"host_syncs": 30,
                                         "decode_dispatches": 0})) is None
    assert reader.read(_ctx(BUSY, {"decode_dispatches": 4})) is None


@pytest.mark.gpu
def test_span_holds_its_kernel_on_the_profiler_clock():
    """Under the benchmark's profiler settings (the card's activity
    alone), a span around a product and a synchronise holds the product's
    profiled interval within 50 us at each end."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.randn(4096, 4096, device="cuda")
    for _ in range(2):         # the second profile is the one checked
        torch.cuda.synchronize()
        profiling.clear()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            with profiling.span("clock"):
                x @ x
                torch.cuda.synchronize()
    spans = [s for s in profiling.spans() if s.name == "clock"]
    profiling.clear()
    kernels = [(e.start_ns(), e.start_ns() + e.duration_ns())
               for e in prof.profiler.kineto_results.events()
               if e.device_type().name == "CUDA" and e.duration_ns() > 0
               and not e.is_user_annotation()]
    assert len(spans) == 1 and kernels
    a, b = max(kernels, key=lambda ab: ab[1] - ab[0])
    slack = 50_000
    assert spans[0].start_ns - slack <= a < b <= spans[0].end_ns + slack, (
        a - spans[0].start_ns, spans[0].end_ns - b)
