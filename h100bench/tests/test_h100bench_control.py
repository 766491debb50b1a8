"""The comparison's control and fault at each committed cell's own size,
on the card: the program reads inside every limit and the reference in
its place at the precision below the configuration's (``control``), or
sampling with top-p left out (``fault``), reads above one. Each run
takes a cell's full set-up and window, so the test runs one seed a cell;
``calibrate.py`` reads more."""
from __future__ import annotations

import json

import pytest

from conftest import ROOT


@pytest.fixture(scope="module")
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a cell runs at its published size")


def _cells():
    with open(ROOT / "BENCHMARK.json") as f:
        bm = json.load(f)
    return [w["name"] for w in bm["workloads"]], bm["run_seconds"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", _cells()[0])
def test_control_and_fault_fail_at_the_cells_size(card, cell):
    from h100bench import harness

    result, checks, extra = harness.run_cell(ROOT, cell, 2**31 + 101,
                                             _cells()[1], False,
                                             control=True)
    assert result["correct"], checks
    for name in ("control", "fault"):
        assert any(extra.get(f"{name}.{n}") is not None
                   and extra[f"{name}.{n}"] > c["limit"]
                   for n, c in checks.items()), (name, checks, extra)
