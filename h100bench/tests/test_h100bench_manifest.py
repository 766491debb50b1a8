"""BENCHMARK.json keeps the contract's shape, and every name it holds
finds its file."""
from __future__ import annotations

import json
import re

import pytest

from conftest import BENCH, ROOT
from h100bench.manifest import Manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bm():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_top_level_keys(bm):
    assert set(bm) == {"command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"}
    assert bm["paths"] == ["h100bench"]
    assert 1 <= bm["run_seconds"] <= 51
    assert all("/" not in w or w.startswith("h100bench/")
               for w in bm["command"][1:])
    assert (ROOT / "BENCHMARK.json").stat().st_size < 64 * 1024


def test_names_units_and_entry_keys(bm):
    for c in bm["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("h100bench/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in bm["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in bm["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bm["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in bm["end_to_end"] + bm["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    names = [m["name"] for m in bm["end_to_end"] + bm["per_layer"]]
    assert len(names) == len(set(names))


def test_every_cell_reports_what_it_must(bm):
    man = Manifest(ROOT)
    for w in bm["workloads"]:
        e2e = {m["name"] for m in man.metrics(w["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        layer = man.metrics(w["name"], "per_layer")
        assert layer, w["name"]
        for m in layer:
            assert m["moves"] in e2e, (w["name"], m["name"])
        assert any(m["name"] == "setup_s" and m["bound"] == 0.25
                   for m in bm["end_to_end"])


def test_names_find_their_files(bm):
    man = Manifest(ROOT)
    for c in bm["configs"]:
        cfg = man.config(c["name"])
        assert cfg["weights"] in ("int8", "bf16")
    for w in bm["workloads"]:
        mix = man.traffic(w["traffic"])
        assert (BENCH / "drivers" / f"{mix['kind']}.py").exists()
        assert man.limits(w["name"])
    for m in bm["per_layer"]:
        assert callable(man.reader(m["name"]).read)


@pytest.mark.parametrize("kernel", ["k1", "k2", "k5"])
def test_kernel_classes_are_files(kernel):
    from h100bench.work import kernel_class, peaks

    kc = kernel_class(kernel)
    assert kc.PATTERNS and kc.BOUND in peaks()


def test_a_split_metric_finds_the_reader_of_its_quantity():
    man = Manifest(ROOT)
    assert man.reader("mfu.sample").__file__.endswith("metrics/mfu.py")
    assert man.reader("device.idle_share.serve").__file__.endswith(
        "metrics/device.idle_share.py")
    with pytest.raises(KeyError):
        man.reader("no_such_metric.sample")
