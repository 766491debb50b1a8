#!/usr/bin/env python3
"""Readings for the limits of ``correct``: not run by the benchmark.

    python3 h100bench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --seconds <s>

runs the cell once per seed in one process (set-up, window, comparison)
and prints a JSON line per seed with the program's numbers and the
control's: the reference in the program's place at the precision below
the configuration's (``control`` in its file), on the same prompts,
tokens and candidates.
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from h100bench.harness import run_cell  # noqa: E402


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        result, checks, extra = run_cell(ROOT, args.workload, seed,
                                         args.seconds, False,
                                         device=args.device, control=True)
        print(json.dumps({"seed": seed, "checks": checks, "extra": extra,
                          "metrics": result["metrics"],
                          "device": result["device"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
