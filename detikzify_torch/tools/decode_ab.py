"""Eager decoding on two checkouts of this package, on one card.

    python -m detikzify_torch.tools.decode_ab --old build/parent

The engine's default (eager) stepping, which ``sample()``, ``simulate()``
and ``serve`` drive, timed old / new / new / old, each run a process of its
own that imports the package from its checkout (``--new`` defaults to this
one). Each run builds its checkout's kernels, draws random v2-8b weights at
full width (``--layers`` cuts the depth), quantizes them int8 and fuses the
projections, then times eight greedy slots of ``--new-tokens`` tokens after
300 image tokens, decode block 16: plain and ``speculate=4`` (ungated),
three timed runs of each after one untimed run. The end-of-sequence token
is the banned image token, so every slot decodes all its tokens. The time
counts from the start (the prefill included) to the last token on the
host. Prints one JSON line a run, then the card's name and power limit,
then a summary: each mode's median tokens/s per checkout (over its six
runs), new over old, and how many (new, old) pairs of runs new won.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SLOTS, BLOCK, SPECULATE, RUNS = 8, 16, 4, 3


def _worker(root: str, layers: int, new_tokens: int, seed: int) -> dict:
    sys.path.insert(0, root)
    import torch

    import detikzify_torch
    from detikzify_torch.config import get_config
    from detikzify_torch.engine import DecodeEngine
    from detikzify_torch.models import convert
    from detikzify_torch.ops import build_all
    from detikzify_torch.ops.quant import fuse_projections, quantize_params
    from detikzify_torch.ops.sampling import SamplingParams

    if not Path(detikzify_torch.__file__).resolve().is_relative_to(
            Path(root).resolve()):
        raise SystemExit(f"imported {detikzify_torch.__file__}, not {root}")
    build_all()
    cfg = get_config("detikzify-v2-8b")
    if layers:
        cfg = dataclasses.replace(cfg, text=dataclasses.replace(
            cfg.text, num_hidden_layers=layers))
    params = convert.init_random(cfg, device="cuda", seed=seed)
    fuse_projections(quantize_params(params))
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    emb = (torch.randn(SLOTS, cfg.image_seq_len, cfg.text.hidden_size,
                       generator=gen, device="cuda") * 0.02
           ).to(torch.bfloat16)
    prompts = [[cfg.image_token_id] * cfg.image_seq_len + [cfg.bos_token_id]
               for _ in range(SLOTS)]
    out = {"root": root, "layers": cfg.text.num_hidden_layers,
           "new_tokens": new_tokens}
    for mode, spec in (("plain", 0), ("speculative", SPECULATE)):
        eng = DecodeEngine(params, cfg, num_slots=SLOTS, max_len=2048,
                           decode_block=BLOCK, speculate=spec,
                           spec_min_rate=0.0,
                           eos_token_id=cfg.image_token_id,
                           sampling=SamplingParams(temperature=0.0),
                           device="cuda", seed=seed)
        runs = []
        for _ in range(1 + RUNS):       # the first is not timed
            ros = eng.start_many(prompts, image_embeds=emb,
                                 max_new_tokens=new_tokens)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            while not all(ro.finished for ro in ros):
                eng.step()
            wall = time.perf_counter() - t0
            runs.append(sum(ro.new_tokens for ro in ros) / wall)
            for ro in ros:
                eng.release(ro)
        out[mode + "_tokens_per_s"] = runs[1:]
        del eng
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", required=True, help="the other checkout")
    ap.add_argument("--new", default=str(ROOT))
    ap.add_argument("--layers", type=int, default=0,
                    help="decoder layers (0: all of v2-8b's)")
    ap.add_argument("--new-tokens", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(_worker(args.worker, args.layers, args.new_tokens,
                                 args.seed)), flush=True)
        return 0
    roots = {"old": str(Path(args.old).resolve()),
             "new": str(Path(args.new).resolve())}
    results = {"old": [], "new": []}
    for which in ("old", "new", "new", "old"):
        root = roots[which]
        env = dict(os.environ, PYTHONPATH=root)
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--old",
             roots["old"], "--worker", root, "--layers", str(args.layers),
             "--new-tokens", str(args.new_tokens), "--seed",
             str(args.seed)], cwd=root, env=env, capture_output=True,
            text=True)
        if proc.returncode:
            sys.stderr.write(proc.stderr[-4000:])
            return proc.returncode
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        line["checkout"] = which
        print(json.dumps(line), flush=True)
        results[which].append(line)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    summary = {"nvidia_smi": smi}
    for mode in ("plain", "speculative"):
        key = mode + "_tokens_per_s"
        runs = {w: sorted(x for r in rs for x in r[key])
                for w, rs in results.items()}
        med = {w: statistics.median(v) for w, v in runs.items()}
        summary[mode] = {**{w + "_median": v for w, v in med.items()},
                         "new_over_old": med["new"] / med["old"],
                         "new_beats_old": sum(n > o for n in runs["new"]
                                              for o in runs["old"]),
                         "pairs": len(runs["new"]) * len(runs["old"])}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
