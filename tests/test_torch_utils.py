"""The port's device and profiling utilities (``detikzify_torch/utils/
{device,profiling}.py``) against the JAX package's, on the CPU."""
import itertools
import json
import time

import torch

from detikzify_tpu.utils import profiling as jprofiling
from detikzify_torch.utils import device, profiling


def test_infer_device_and_count_without_a_card():
    if torch.cuda.is_available():
        assert device.infer_device() == "gpu"
        assert device.device_count() == torch.cuda.device_count() >= 1
    else:
        assert device.infer_device() == "cpu"
        assert device.device_count() == 0


def test_trace_writes_a_cpu_trace_with_the_annotation(tmp_path):
    """``trace`` leaves one TensorBoard trace in ``logdir`` whose events
    hold the ``annotate`` span and the ops run inside it."""
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("prefill"):
            (x @ x).sum()
    files = list(tmp_path.rglob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    spans = [e for e in events if e.get("name") == "prefill"]
    assert spans and spans[0].get("cat") == "user_annotation"
    assert any(e.get("name") == "aten::mm" for e in events)


def test_timer_summary_matches_jax(monkeypatch):
    """The same phases on one clock give the JAX ``Timer``'s summary."""

    def run(timer_cls):
        clock = itertools.count(0.0, 0.25)
        monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
        t = timer_cls()
        for phase in ("prefill", "decode", "decode", "score", "decode"):
            with t(phase):
                pass
        try:
            with t("compile"):
                raise ValueError
        except ValueError:
            pass
        return t.summary()

    got, want = run(profiling.Timer), run(jprofiling.Timer)
    assert got == want
    assert got["decode"] == {"total_s": 0.75, "count": 3, "mean_ms": 250.0}
    assert got["compile"]["count"] == 1
