"""``BENCHMARK.json`` and the files it names, found by name:

* configuration ``<c>``: the ``file`` its entry names;
* traffic mix ``<t>``: ``traffic/<t>.json``;
* the limits of cell ``<w>``: ``limits/<w>.json``;
* per-layer metric ``<m>``: ``metrics/<m>.py`` (``read(ctx)``), or,
  where there is none, the file of its longest dotted prefix: one reader
  serves a quantity split by cell (``mfu.sample``, ``mfu.serve``:
  ``metrics/mfu.py``);
* kernel class ``<k>``: ``kernels/<k>.py``;
* driver of a mix's ``kind``: ``drivers/<kind>.py``.
"""
from __future__ import annotations

import importlib
import json
from pathlib import Path
from typing import List

from .work import load_module

BENCH = Path(__file__).resolve().parent


class Manifest:
    def __init__(self, root: Path, bench: Path = BENCH):
        self.root = Path(root)
        self.bench = Path(bench)
        with open(self.root / "BENCHMARK.json") as f:
            self.data = json.load(f)

    def _one(self, key: str, name: str) -> dict:
        for entry in self.data[key]:
            if entry["name"] == name:
                return entry
        raise KeyError(f"no {key} entry named {name!r} in BENCHMARK.json")

    def workload(self, name: str) -> dict:
        return self._one("workloads", name)

    def config(self, name: str) -> dict:
        entry = self._one("configs", name)
        with open(self.root / entry["file"]) as f:
            cfg = json.load(f)
        cfg["name"] = name
        return cfg

    def traffic(self, name: str) -> dict:
        with open(self.bench / "traffic" / f"{name}.json") as f:
            return json.load(f)

    def limits(self, workload: str) -> dict:
        with open(self.bench / "limits" / f"{workload}.json") as f:
            return json.load(f)

    def driver(self, kind: str):
        return importlib.import_module(f"h100bench.drivers.{kind}")

    def metrics(self, workload: str, section: str) -> List[dict]:
        """The ``section`` metrics this cell reports: those that list it,
        and those with no list."""
        return [m for m in self.data[section]
                if workload in m.get("workloads", [workload])]

    def reader(self, metric: str):
        name = metric
        while not (self.bench / "metrics" / f"{name}.py").exists():
            if "." not in name:
                raise KeyError(f"no reader for metric {metric!r}")
            name = name.rpartition(".")[0]
        return load_module(self.bench / "metrics" / f"{name}.py")
