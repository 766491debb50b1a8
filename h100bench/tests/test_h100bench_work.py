"""The yardstick's arithmetic on shapes checked by hand: the kernels'
work, model FLOPs, the trace's busy union, idle gaps and roofline
shares."""
from __future__ import annotations

import json

import pytest

from conftest import TINY
from h100bench import trace, work
from h100bench.work import Log


@pytest.fixture(scope="module")
def cfg():
    with open(TINY / "tiny-int8.json") as f:
        return json.load(f)


def test_prefill_keys():
    assert work.prefill_keys(0, 3) == 1 + 2 + 3
    assert work.prefill_keys(4, 6) == 5 + 6


def test_k5_work_one_step(cfg):
    # tiny: d 64, 4 heads of 16 (MHA), ffn 128, 2 layers
    log = Log(slots=2, steps=1)
    ops, nbytes = work.kernel_class("k5").work(log, cfg)
    shapes = [(64 + 2 * 64, 64), (64, 64), (256, 64), (64, 128)]
    assert ops == 2 * sum(2 * 2 * n * k for n, k in shapes)
    assert nbytes == 2 * sum(n * k + 4 * n + 2 * 2 * (n + k)
                             for n, k in shapes)
    assert work.kernel_class("k5").work(log, dict(cfg, weights="bf16")) \
        is None


def test_k2_work_counts_context_rows(cfg):
    log = Log(decode_contexts=[10, 11])
    ops, nbytes = work.kernel_class("k2").work(log, cfg)
    rows = 21
    assert nbytes == rows * 2 * 2 * 4 * 16 * 2 + 2 * 2 * 2 * 4 * 16 * 2
    assert ops == 4 * rows * 2 * 4 * 16
    assert work.kernel_class("k2").work(Log(), cfg) is None


def test_k1_work_tower_and_prefill(cfg):
    # tiny tower: 42 px / 14 = 9 patches, 4 heads of 12, feature layer 0
    log = Log(prompt_images=1)
    ops, nbytes = work.kernel_class("k1").work(log, cfg)
    assert ops == 4 * 9 * 9 * 48 * 1 and nbytes == 4 * 9 * 48 * 2
    log = Log(prefills=[(0, 2)])
    ops, nbytes = work.kernel_class("k1").work(log, cfg)
    assert ops == 4 * 3 * 64 * 2
    assert nbytes == (2 * 2 * 64 + 2 * 2 * 64) * 2 * 2


def test_model_flops_one_decoded_token(cfg):
    log = Log(decode_contexts=[5])
    per_layer = sum(n * k for _, n, k in work.decoder_projections(cfg))
    want = 2 * per_layer * 2 + 2 * 512 * 64 + 4 * 64 * 2 * 5
    assert work.model_flops(log, cfg) == pytest.approx(want)


def test_merge_and_gaps():
    busy = trace.merge([(5, 7), (0, 2), (1, 3), (7, 8)])
    assert busy == [(0, 3), (5, 8)]
    assert trace.gaps(busy, 0, 10) == [(3, 5), (8, 10)]
    assert trace.clip([(0, 4), (6, 12)], 2, 10) == [(2, 4), (6, 10)]


def test_summary_busy_idle_and_breakdown():
    spans = trace.Spans()
    spans.items = [(0, 100, "engine.step"), (100, 200, "processor")]
    events = [("int8_gemv_kernel<a>", 0, 40), ("paged_split_kernel", 30, 60),
              ("paged_merge_kernel", 60, 70), ("gemm", 150, 160)]
    s = trace.Summary(events, 0, 200, spans)
    assert s.window_s == pytest.approx(200e-9)
    assert s.busy_s == pytest.approx(80e-9)
    assert s.idle_share == pytest.approx(0.6)
    assert s.kernel_s(("paged_split_kernel", "paged_merge_kernel")) \
        == pytest.approx(40e-9)
    b = s.breakdown()
    assert set(b) == {"device_ops", "idle_gaps"}
    assert b["device_ops"][0] == ["int8_gemv_kernel<a>", 40e-9]
    # idle: 70-150 (engine.step to 100, then processor), 160-200
    assert dict(b["idle_gaps"]) == pytest.approx(
        {"engine.step": 30e-9, "processor": 90e-9})


def test_roofline_share_is_least_time_over_kernel_time(cfg):
    log = Log(decode_contexts=[100])
    ops, nbytes = work.kernel_class("k2").work(log, cfg)
    pk = work.peaks()
    least = max(ops / pk["bf16_flops"], nbytes / pk["hbm_bytes_per_s"])
    assert work.roofline_share("k2", log, cfg, 2 * least) \
        == pytest.approx(50.0)
    assert work.roofline_share("k2", Log(), cfg, 1.0) is None
    assert work.roofline_share("k2", log, cfg, 0.0) is None
