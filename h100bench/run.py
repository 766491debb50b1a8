#!/usr/bin/env python3
"""Run one cell of the port's H100 benchmark once.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout: ``BENCHMARK.json`` names the cells. Needs a
CUDA card (exits 2 without one); prints one JSON result line last.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# a library that would load JAX by itself is kept from doing so
for var in ("USE_FLAX", "USE_JAX", "USE_TF"):
    os.environ[var] = "0"
sys.path.insert(0, str(ROOT))

from h100bench.harness import main  # noqa: E402

if __name__ == "__main__":
    code = main(sys.argv[1:], T_START)
    sys.stdout.flush()
    sys.stderr.flush()
    # no interpreter teardown: the compile pool's threads and the CUDA
    # context end with the process
    os._exit(code)
