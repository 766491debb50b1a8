"""Whole runs of tiny cells on the CPU (the harness's look for a card
skipped): cells added as new files run, the result line has the
contract's keys, the comparison passes and its control fails, and a run
whose timed path is broken underneath reads ``correct`` false."""
from __future__ import annotations

import subprocess
import sys

import pytest
import torch

from conftest import BENCH, ROOT
from h100bench import harness

KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def _run(root, cell, seed=2**31 + 77, trace=False, control=False):
    torch.manual_seed(0)
    return harness.run_cell(root, cell, seed, 2.0, trace, device="cpu",
                            bench=root / "h100bench", control=control)


CELLS = ["tiny-sample-int8", "tiny-sample-bf16"]


@pytest.mark.parametrize("cell", CELLS)
def test_added_cell_runs_and_passes(tiny_root, cell):
    result, checks, extra = _run(tiny_root, cell)
    assert set(result) == KEYS
    assert result["correct"], checks
    assert result["attempted"] > 0 and result["failed"] == 0
    assert "setup_s" in result["metrics"]
    assert all(set(v) == {"value", "unit"} for v in result["metrics"].values())
    assert extra["window_captures"] == 0


def test_the_added_files_left_the_committed_ones_alone(tiny_root):
    for path in BENCH.rglob("*"):
        if path.is_file() and "tests" not in path.parts \
                and "__pycache__" not in path.parts:
            copy = tiny_root / "h100bench" / path.relative_to(BENCH)
            assert copy.read_bytes() == path.read_bytes(), path


def test_traced_run_reports_per_layer_metrics_only(tiny_root):
    """The metric added as a file reads; those of the device trace leave
    themselves out (no trace on the CPU)."""
    result, _, _ = _run(tiny_root, "tiny-sample-int8", trace=True)
    assert set(result) == KEYS      # no device trace on the CPU: no breakdown
    names = set(result["metrics"])
    assert names == {"tiny.decode_steps"}
    assert result["metrics"]["tiny.decode_steps"]["value"] > 0


def test_added_kernel_class_counts_work(tiny_root):
    from h100bench.work import Log, kernel_class, roofline_share
    from conftest import NEW_KERNEL
    from h100bench.manifest import Manifest

    bench = tiny_root / "h100bench"
    cfg = Manifest(tiny_root, bench).config("tiny-int8")
    log = Log(slots=4, steps=10)
    assert kernel_class(NEW_KERNEL, bench).work(log, cfg)[0] > 0
    assert 0 < roofline_share(NEW_KERNEL, log, cfg, 1.0, bench) < 100


@pytest.mark.parametrize("cell,name", [("tiny-sample-int8", "control"),
                                       ("tiny-sample-int8", "fault"),
                                       ("tiny-sample-bf16", "fault")])
def test_control_and_fault_fail_the_limits(tiny_root, cell, name):
    """The reference in the program's place at the precision below the
    configuration's (``control``), or sampling with top-p left out
    (``fault``), reads above a limit that the program keeps. (A tiny
    bf16 model's logits lie too far apart for int8 weights to move its
    greedy choice; ``test_h100bench_control.py`` reads that control at
    the cell's own size, on the card.)"""
    result, checks, extra = _run(tiny_root, cell, control=True)
    assert result["correct"], checks
    failed = [n for n, c in checks.items()
              if extra.get(f"{name}.{n}") is not None
              and extra[f"{name}.{n}"] > c["limit"]]
    assert failed, (checks, extra)


def test_altered_token_reads_incorrect(tiny_root, monkeypatch):
    """A token altered where the engine produces it."""
    from detikzify_torch.engine import decode

    accept = decode.DecodeEngine._accept_token

    def altered(self, ro, tok):
        accept(self, ro, (tok + 1) % (self.cfg.text.vocab_size - 3))
    monkeypatch.setattr(decode.DecodeEngine, "_accept_token", altered)
    result, checks, _ = _run(tiny_root, "tiny-sample-int8")
    assert not result["correct"], checks


def test_sampling_without_top_p_reads_incorrect(tiny_root, monkeypatch):
    """Sampled tokens drawn with top-p left out where the engine samples
    them: the greedy tokens stay right, the nucleus check fails."""
    from detikzify_torch.ops import sampling

    warp = sampling._warp
    monkeypatch.setattr(sampling, "_warp", lambda lg, t, p, k, c: warp(
        lg, t, torch.ones_like(p), k, c))
    result, checks, _ = _run(tiny_root, "tiny-sample-int8")
    assert checks["token_gap"]["value"] <= checks["token_gap"]["limit"]
    assert not result["correct"], checks


def test_no_card_no_result():
    out = subprocess.run([sys.executable, str(BENCH / "run.py"),
                          "--workload", "ds7b-sample", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=300)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    """A checkout holding only BENCHMARK.json and the benchmark's files."""
    import shutil

    shutil.copytree(BENCH, tmp_path / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "h100bench/run.py", "--workload",
                          "ds7b-sample", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
