"""Fixtures of the benchmark's CPU tests: a checkout in a temporary
directory whose ``BENCHMARK.json`` adds tiny cells (``tests/tiny/``) to
the committed ones, as a later change would add a cell: new files and
new entries, no existing file edited."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
TINY = BENCH / "tests" / "tiny"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: tiny cells: name -> (config, traffic, like), ``like`` the committed
#: cell whose metrics it reports
CELLS = {"tiny-sample-int8": ("tiny-int8", "tiny-sample", "ds7b-sample"),
         "tiny-sample-bf16": ("tiny-bf16", "tiny-sample", "ds7b-sample")}
#: a per-layer metric and a kernel class added as new files
NEW_METRIC = {"name": "tiny.decode_steps", "unit": "steps",
              "better": "higher", "source": "program_counter",
              "layer": "engine", "moves": "tokens_per_s",
              "workloads": list(CELLS)}
NEW_KERNEL = "k_tiny"


def add_tiny_cells(root: Path) -> Path:
    """Copy the benchmark under ``root`` and add the tiny cells, a
    per-layer metric and a kernel class as new files and manifest
    entries; returns the copy's benchmark folder."""
    bench = root / "h100bench"
    shutil.copytree(BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(TINY / "tiny-sample.json", bench / "traffic" / "tiny-sample.json")
    for name in ("tiny-int8", "tiny-bf16"):
        shutil.copy(TINY / f"{name}.json", bench / "configs" / f"{name}.json")
    shutil.copy(TINY / f"{NEW_METRIC['name']}.py",
                bench / "metrics" / f"{NEW_METRIC['name']}.py")
    shutil.copy(TINY / f"{NEW_KERNEL}.py", bench / "kernels" / f"{NEW_KERNEL}.py")
    with open(ROOT / "BENCHMARK.json") as f:
        bm = json.load(f)
    for name in ("tiny-int8", "tiny-bf16"):
        bm["configs"].append({"name": name, "source": "tests",
                              "file": f"h100bench/configs/{name}.json",
                              "reduced": [], "why": "CPU tests"})
    for cell, (config, mix, like) in CELLS.items():
        bm["workloads"].append({"name": cell, "config": config,
                                "traffic": mix, "chips": 1,
                                "why": "CPU tests"})
        shutil.copy(TINY / f"limits-{cell}.json",
                    bench / "limits" / f"{cell}.json")
        for m in bm["end_to_end"] + bm["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(cell)
    bm["per_layer"].append(NEW_METRIC)
    with open(root / "BENCHMARK.json", "w") as f:
        json.dump(bm, f, indent=1)
    return bench


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("checkout")
    add_tiny_cells(root)
    return root
