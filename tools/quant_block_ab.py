#!/usr/bin/env python3
"""Time ``ops.quant.quantize_kernel`` by block size, in turns.

    python3 tools/quant_block_ab.py [--preset detikzify-v2-8b] [--device cpu]

For every projection shape that ``quantize_params`` quantizes in the
preset (found on a ``meta`` model), random bf16 weights from a seed are
quantized with each block size of ``--blocks`` (elements per pass; 0 means
the whole weight in one pass), in the order A B C ... C B A, and every
block size must give the same q and scale bits as the whole pass. Prints
the device (and the card as nvidia-smi names it, for ``cuda``), then one
JSON line per shape (seconds per call for each block, the mean of its two
turns) and one line with the model's total: each shape's time times its
count in the model, which is what a quantized load of the preset spends
quantizing. Exits non-zero if two block sizes disagree.
"""
from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def shapes(preset: str):
    """{(out, in): count} of the preset's quantized projections."""
    from detikzify_torch.config import get_config
    from detikzify_torch.models.detikzify import Params
    from detikzify_torch.ops.quant import QUANT_KEYS, _targets

    params = Params(get_config(preset), device="meta")
    return collections.Counter(
        (lin.out_features, lin.in_features)
        for _, _, lin in _targets(params, QUANT_KEYS))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="detikzify-v2-8b")
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    ap.add_argument("--blocks", default="262144,1048576,4194304,0",
                    help="elements per pass, comma separated; 0 = whole")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from detikzify_torch.ops.quant import quantize_kernel

    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("no card", file=sys.stderr)
            return 1
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    blocks = [int(b) for b in args.blocks.split(",")]
    order = blocks + blocks[::-1]
    print(json.dumps({"device": str(dev), "threads": torch.get_num_threads(),
                      "preset": args.preset, "blocks": blocks}))
    gen = torch.Generator().manual_seed(args.seed)
    total = collections.defaultdict(float)
    ok = True
    for (n, k), count in sorted(shapes(args.preset).items()):
        w = torch.randn((n, k), generator=gen).to(torch.bfloat16).to(dev)
        want = quantize_kernel(w, w.numel())
        times = collections.defaultdict(list)
        same = True
        for b in order:
            sync()
            t0 = time.perf_counter()
            q, scale = quantize_kernel(w, b or w.numel())
            sync()
            times[b].append(time.perf_counter() - t0)
            same &= torch.equal(q, want[0]) and torch.equal(scale, want[1])
            del q, scale
        ok &= same
        mean = {b: sum(t) / len(t) for b, t in times.items()}
        for b in blocks:
            total[b] += count * mean[b]
        print(json.dumps({"shape": [n, k], "count": count, "same_bits": same,
                          "s": {str(b): mean[b] for b in blocks},
                          "turns_s": {str(b): times[b] for b in blocks}}))
        del w, want
    print(json.dumps({"model_total_s": {str(b): total[b] for b in blocks},
                      "same_bits": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
