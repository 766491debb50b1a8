"""FSDP against plain data parallel over N processes, one device each.

    python -m detikzify_torch.tools.fsdp_memory --procs 4 [--device cpu]

Each rank joins a group on ``tcp://127.0.0.1`` (nccl on the cards, gloo on
the CPU), draws the same random weights (``--preset``, default DS-1.3b, in
bf16; ``tiny-test`` in fp32 on the CPU) and places them over a ``(data=N,
model=1)`` mesh, first with ``fsdp=False`` and then with ``fsdp=True``. Each
mode runs ``--steps`` train steps as the ``train`` phase of
``chip_smoke.py`` runs them (remat, 8-bit moments, ``grad_accum`` 2) on a
global batch of 2N rows of ``--seq`` tokens, two rows a rank. Rank 0
prints one JSON line: each mode's losses, the seconds of each step after
the first, and for every rank the device memory held after a step (the
weights or their slices and the moments) and the peak during the steps.
On the CPU the memory is not measured.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

import numpy as np
import torch


def _batch(cfg, rows: int, seq: int, seed: int):
    rng = np.random.default_rng(seed)
    ids = np.full((rows, seq), cfg.image_token_id, np.int64)
    ids[:, cfg.image_seq_len] = cfg.bos_token_id
    ids[:, cfg.image_seq_len + 1:] = rng.integers(
        5, cfg.text.vocab_size - 8, (rows, seq - cfg.image_seq_len - 1))
    labels = np.where(ids == cfg.image_token_id, -100, ids)
    pixels = rng.standard_normal(
        (rows, cfg.vision.image_size, cfg.vision.image_size, 3)
    ).astype(np.float32)
    return {"input_ids": ids, "labels": labels, "pixel_values": pixels}


def _rank(rank: int, world: int, init: str, args) -> None:
    import torch.distributed as dist

    from ..config import get_config
    from ..models import convert
    from ..parallel.mesh import local_rows, make_mesh, place_params
    from ..train.step import (init_state, make_optimizer, make_train_step,
                              trainable_mask)

    on_card = args.device == "cuda"
    if on_card:
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    else:
        torch.set_num_threads(1)
        device = torch.device("cpu")
    dist.init_process_group("nccl" if on_card else "gloo", init_method=init,
                            rank=rank, world_size=world)
    try:
        mesh = make_mesh(device=device)
        cfg = get_config(args.preset)
        seq = min(args.seq, cfg.text.max_position_embeddings)
        grad_accum = 2
        batch = _batch(cfg, world * grad_accum, seq, args.seed)
        mine = {k: torch.from_numpy(local_rows(v, mesh)).to(device)
                for k, v in batch.items()}
        if on_card:
            mine["pixel_values"] = mine["pixel_values"].to(torch.bfloat16)
        out = {}
        for fsdp in (False, True):
            params = convert.init_random(
                cfg, device=device, seed=args.seed,
                dtype=torch.bfloat16 if on_card else torch.float32)
            params = place_params(params, mesh, fsdp=fsdp)
            optimizer = make_optimizer(
                1e-5, total_steps=10, moment_dtype="quant8",
                trainable=trainable_mask(params, "all"))
            state = init_state(params, optimizer)
            step = make_train_step(cfg, optimizer, grad_accum=grad_accum,
                                   remat=True)
            if on_card:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            losses, seconds = [], []
            for _ in range(args.steps):
                t0 = time.perf_counter()
                state, metrics = step(state, mine)
                losses.append(float(metrics["loss"]))
                seconds.append(time.perf_counter() - t0)
            mode = {"losses": losses, "step_s": seconds[1:]}
            if on_card:
                mem = torch.tensor([torch.cuda.memory_allocated(),
                                    torch.cuda.max_memory_allocated()],
                                   dtype=torch.float64, device=device)
                every = [torch.empty_like(mem) for _ in range(world)]
                dist.all_gather(every, mem)
                mode["held_gb"] = [float(m[0]) / 1e9 for m in every]
                mode["peak_gb"] = [float(m[1]) / 1e9 for m in every]
            out["fsdp" if fsdp else "data_parallel"] = mode
            del params, optimizer, state, step, metrics
            gc.collect()
            if on_card:
                torch.cuda.empty_cache()
        if rank == 0:
            dp, fs = out["data_parallel"]["losses"], out["fsdp"]["losses"]
            print(json.dumps({
                "preset": args.preset, "ranks": world, "device": args.device,
                "rows_per_rank": 2, "grad_accum": grad_accum,
                "seq": seq, "moments": "quant8", "remat": True, **out,
                "loss_rel_diff": [abs(a - b) / abs(b) for a, b in
                                  zip(fs, dp)]}), flush=True)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--procs", type=int, default=4)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--preset", default=None,
                    help="default: detikzify-ds-1.3b (tiny-test on the CPU)")
    ap.add_argument("--seq", type=int, default=640)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.preset is None:
        args.preset = ("detikzify-ds-1.3b" if args.device == "cuda"
                       else "tiny-test")
    if args.device == "cuda" and torch.cuda.device_count() < args.procs:
        print(f"fsdp_memory: {args.procs} processes need as many cards",
              file=sys.stderr)
        return 1
    import torch.multiprocessing as mp

    from ..parallel.dryrun import _free_port

    os.environ.setdefault("OMP_NUM_THREADS", "1")
    mp.start_processes(_rank, args=(args.procs,
                                    f"tcp://127.0.0.1:{_free_port()}", args),
                       nprocs=args.procs, join=True, start_method="spawn")
    return 0


if __name__ == "__main__":
    sys.exit(main())
