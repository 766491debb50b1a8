"""One run of one cell: set-up, the measured window, the comparison with
the reference, the result line.

The result's last line on standard output is one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``, and last ``checks``: each number
compared beside its limit (also the last lines on standard error).
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np

from . import check
from .manifest import BENCH, Manifest
from .work import Log, kernel_class, model_flops, peaks, roofline_share

FORBIDDEN = ("jax", "jaxlib", "flax", "detikzify_tpu")
#: greedy requests, and sampled ones, that the comparison judges: the
#: longest of each kind among them
SAMPLE = 4


@dataclasses.dataclass
class Context:
    """What a per-layer metric reader reads."""
    cfg: dict
    mix: dict
    summary: object                  # trace.Summary or None
    log: Log
    trace_counters: dict
    window_counters: dict
    bench: Path

    def roofline(self, kernel: str) -> Optional[float]:
        if self.summary is None:
            return None
        kc = kernel_class(kernel, self.bench)
        return roofline_share(kernel, self.log, self.cfg,
                              self.summary.kernel_s(kc.PATTERNS), self.bench)

    def mfu(self) -> Optional[float]:
        if self.summary is None:
            return None
        flops = model_flops(self.log, self.cfg)
        return 100.0 * flops / (self.summary.window_s * peaks()["bf16_flops"])


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", t_start: float = None,
             bench: Path = BENCH, control: bool = False):
    """Returns (result dict, checks dict). ``device="cpu"`` skips nothing
    but the card: the tests' path."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    man = Manifest(root, bench)
    cell = man.workload(workload)
    cfg = man.config(cell["config"])
    mix = man.traffic(cell["traffic"])
    limits = man.limits(workload)
    on_card = device != "cpu"
    if on_card:
        from detikzify_torch.ops.cuda import build_all

        build_all()
        torch.cuda.reset_peak_memory_stats()
    run = man.driver(mix["kind"]).Run(cfg, mix, seed, seconds, trace, device)
    t_setup = time.perf_counter()
    run.setup()
    setup_s = time.perf_counter() - t_start
    stages = dict(run.stages, before_setup_s=t_setup - t_start)
    measured = run.window()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    summary = run.summary()
    ctx = Context(cfg, mix, summary, run.log, run.trace_counters,
                  run.window_counters, bench)
    evidence = run.evidence(np.random.default_rng([abs(int(seed)), 3]),
                            SAMPLE)
    run.close()
    del run
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers = check.compare(cfg, mix, seed, evidence, torch.device(device),
                            control=control)
    checks = {}
    for name, limit in limits.items():
        checks[name] = {"value": numbers.get(name), "limit": limit}
    correct = all(c["value"] is not None and c["value"] <= c["limit"]
                  for c in checks.values())

    if trace:
        metrics = {}
        for m in man.metrics(workload, "per_layer"):
            value = man.reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(measured["metrics"], setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in man.metrics(workload, "end_to_end")}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell["chips"] if on_card else 0,
           "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": measured["attempted"],
              "failed": measured["failed"], "metrics": metrics,
              "device": dev}
    if trace and summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        result["breakdown"] = summary.breakdown()
    extra = {k: v for k, v in numbers.items() if k not in checks}
    extra.update({k: v for k, v in measured.items()
                  if k not in ("metrics", "attempted", "failed")})
    extra["stages"] = stages
    if trace:
        extra["e2e_in_traced_run"] = measured["metrics"]
    return result, checks, extra


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"nvidia-smi: {err}"
    return out.stdout.strip().splitlines()[0] if out.stdout else out.stderr


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    man = Manifest(BENCH.parent)
    chips = man.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"h100bench: the cell needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, checks, extra = run_cell(BENCH.parent, args.workload, args.seed,
                                     args.seconds, bool(args.trace),
                                     t_start=t_start)
    found = forbidden_modules()
    if found:
        print(f"h100bench: the run loaded {found}", file=sys.stderr)
        return 3
    result["checks"] = checks
    extra["card"] = card()
    print(json.dumps({"extra": extra}), file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
