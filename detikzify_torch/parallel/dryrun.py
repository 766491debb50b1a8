"""Entry points for a quick check of the port (counterpart of the
repository's ``__graft_entry__.py``): one device's forward at a real
configuration, and a dry run of the mesh over several processes.

    python -m detikzify_torch.parallel.dryrun [N]

runs ``dryrun_multi_device(N)`` (default 2) on the CPU: a training step
over a ``(data, model)`` mesh of N gloo processes (``model = 2`` when N is
even, as the JAX dry run takes it), then the JAX dry run's three
tensor-parallel inference legs over a ``(data=1, model=2)`` mesh of two
gloo processes (``tp_decode``, ``tp_burst``, ``tp_spec``: each rank's
greedy streams equal the unsharded engine's), then two replicas.
"""
from __future__ import annotations

import os
import socket
import sys
from typing import Callable, Tuple

import numpy as np
import torch


def _zero_params(cfg, device, dtype):
    """The model's structure with every weight zero (no random draw)."""
    from ..models.detikzify import Params

    params = Params(cfg, device=device, dtype=dtype)
    with torch.no_grad():
        for t in params.parameters():
            t.zero_()
    return params


def entry(device="cuda") -> Tuple[Callable, tuple]:
    """The image + prompt forward of a tracked configuration (DS-1.3b,
    ``BASELINE.md`` config #2) on zero bf16 weights: returns ``(fn,
    args)``; ``fn(*args)`` gives the logits ``[1, S, V]``."""
    from ..config import get_config
    from ..models import detikzify

    cfg = get_config("detikzify-ds-1.3b")
    params = _zero_params(cfg, device, torch.bfloat16)
    seq = cfg.image_seq_len + 64
    ids = np.full((1, seq), cfg.image_token_id, np.int64)
    ids[0, cfg.image_seq_len] = cfg.bos_token_id
    ids[0, cfg.image_seq_len + 1:] = 1
    pixels = torch.zeros((1, cfg.vision.image_size, cfg.vision.image_size,
                          3), dtype=torch.bfloat16, device=device)

    @torch.inference_mode()
    def fn(params, input_ids, pixel_values):
        logits, _ = detikzify.forward(params, cfg, input_ids, pixel_values)
        return logits

    return fn, (params, torch.from_numpy(ids).to(device), pixels)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _train_rank(rank: int, world: int, init: str) -> None:
    """One rank of the dry run: a ``grad_accum=2`` FSDP step of
    ``tiny-test`` over a ``(data=world/m, model=m)`` mesh, ``m = 2`` when
    ``world`` is even."""
    import torch.distributed as dist

    from ..config import tiny_test_config
    from ..models import convert
    from ..train.step import (init_state, make_optimizer, make_train_step,
                              trainable_mask)
    from .mesh import local_rows, make_mesh, place_params

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh(model=2 if world % 2 == 0 else 1, device="cpu")
        cfg = tiny_test_config(vocab_size=512)
        params = convert.init_random(cfg, device="cpu", dtype=torch.float32)
        params = place_params(params, mesh, fsdp=True)
        optimizer = make_optimizer(1e-4, total_steps=10,
                                   trainable=trainable_mask(params, "all"))
        state = init_state(params, optimizer)
        step = make_train_step(cfg, optimizer, grad_accum=2)

        batch_size = 2 * mesh.shape["data"]   # grad_accum * data-parallel
        seq = cfg.image_seq_len + 13
        ids = np.full((batch_size, seq), cfg.image_token_id, np.int64)
        ids[:, cfg.image_seq_len] = cfg.bos_token_id
        ids[:, cfg.image_seq_len + 1:] = 7
        labels = np.where(ids == cfg.image_token_id, -100, ids)
        pixels = np.zeros((batch_size, cfg.vision.image_size,
                           cfg.vision.image_size, 3), np.float32)
        batch = {k: torch.from_numpy(local_rows(v, mesh)) for k, v in
                 (("input_ids", ids), ("labels", labels),
                  ("pixel_values", pixels))}
        state, metrics = step(state, batch)
        loss = float(metrics["loss"])
        assert np.isfinite(loss), loss
        if rank == 0:
            print(f"dryrun_multi_device({world}): ok, loss={loss:.4f}, "
                  f"mesh={mesh.shape}", flush=True)
    finally:
        dist.destroy_process_group()


PROMPT = (5, 6, 7)            # after BOS: the JAX dry run's prompt


def tp_decode(params, cfg, device="cpu"):
    """The JAX dry run's first leg: greedy decode of the prompt, its prefix
    stored and restored for a second rollout -> (both streams)."""
    from ..engine import DecodeEngine
    from ..ops.sampling import SamplingParams

    prompt = [cfg.bos_token_id, *PROMPT]
    eng = DecodeEngine(params, cfg, num_slots=2, max_len=64,
                       cache_dtype=torch.float32, device=device,
                       sampling=SamplingParams(temperature=0.0))
    ro = eng.start(list(prompt), max_new_tokens=10)
    eng.run()
    toks = list(ro.token_ids)
    eng.store_prefix("node", ro, length=len(prompt) + 3)
    eng.release(ro)
    _, sp = eng.best_prefix(toks[:len(prompt) + 3])
    r2 = eng.start(toks[:len(prompt) + 3], max_new_tokens=4, prefix=sp)
    eng.run()
    assert eng.counters["prefix_starts"] >= 1
    return toks, list(r2.token_ids)


def tp_burst(params, cfg, device="cpu"):
    """The second leg: a ``start_many`` burst of three rows with mixed
    prefixes (one restored, two fresh) -> their streams."""
    from ..engine import DecodeEngine
    from ..ops.sampling import SamplingParams

    prompt = [cfg.bos_token_id, *PROMPT]
    eng = DecodeEngine(params, cfg, num_slots=4, max_len=64,
                       cache_dtype=torch.float32, device=device,
                       sampling=SamplingParams(temperature=0.0))
    ro = eng.start(list(prompt), max_new_tokens=8)
    eng.run()
    toks = list(ro.token_ids)
    eng.store_prefix("n0", ro, length=len(prompt) + 4)
    eng.release(ro)
    _, sp = eng.best_prefix(toks[:len(prompt) + 4])
    ros = eng.start_many(
        [toks[:len(prompt) + 4], list(prompt), toks[:len(prompt) + 2]],
        max_new_tokens=5, prefixes=[sp, None, None])
    eng.run()
    out = [list(r.token_ids) for r in ros]
    assert eng.counters["prefix_starts"] >= 1
    for r in ros:
        eng.release(r)
    return out


def tp_spec(params, cfg, device="cpu"):
    """The third leg: the speculative engine (2 drafts, no gating, blocks
    of 4) with a hinted and an unhinted row -> their streams."""
    from ..engine import DecodeEngine
    from ..ops.sampling import SamplingParams

    prompt = [cfg.bos_token_id, *PROMPT]
    eng = DecodeEngine(params, cfg, num_slots=2, max_len=64,
                       cache_dtype=torch.float32, speculate=2,
                       spec_min_rate=0.0, decode_block=4, device=device,
                       sampling=SamplingParams(temperature=0.0))
    r1 = eng.start(list(prompt), max_new_tokens=10, lazy=True)
    r2 = eng.start(list(prompt) + [9], max_new_tokens=10, lazy=True,
                   hint=[5, 6, 7, 8])
    eng.run()
    out = [list(r1.token_ids), list(r2.token_ids)]
    assert eng.counters["spec_steps"] > 0
    eng.release(r1)
    eng.release(r2)
    return out


TP_LEGS = (("decode", tp_decode), ("burst", tp_burst), ("spec", tp_spec))


def _tp_rank(rank: int, world: int, init: str, n_devices: int) -> None:
    """One rank of the dry run's tensor-parallel legs: ``tiny-test`` over a
    ``(data=1, model=world)`` mesh against the unsharded engine."""
    import torch.distributed as dist

    from ..config import tiny_test_config
    from ..models import convert
    from .mesh import make_mesh, place_params

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        cfg = tiny_test_config(vocab_size=512)
        base = convert.init_random(cfg, device="cpu", dtype=torch.float32)
        tp = place_params(
            convert.init_random(cfg, device="cpu", dtype=torch.float32),
            make_mesh(data=1, model=world, device="cpu"), identical=True)
        lines = {
            "decode": lambda o: (f"TP decode token-match ok "
                                 f"({len(o[0]) - len(PROMPT) - 1} new "
                                 f"tokens, prefix restore ok)"),
            "burst": lambda o: ("TP burst start_many token-match ok "
                                "(mixed prefixes, 3 rows)"),
            "spec": lambda o: ("TP speculative decode token-match ok "
                               "(hinted + unhinted rows)")}
        for name, leg in TP_LEGS:
            want, got = leg(base, cfg), leg(tp, cfg)
            assert got == want, \
                f"TP {name} diverges from unsharded: {got} vs {want}"
            if rank == 0:
                print(f"dryrun_multi_device({n_devices}): "
                      f"{lines[name](want)}", flush=True)
    finally:
        dist.destroy_process_group()


def dryrun_multi_device(n_devices: int) -> None:
    """Run one FSDP training step over ``n_devices`` gloo CPU processes
    (tensor-parallel over pairs when ``n_devices`` is even), the three
    tensor-parallel engine legs over two, then a ``ReplicaPool`` gathering
    4 items over two CPU replicas."""
    import torch.multiprocessing as mp

    init = f"tcp://127.0.0.1:{_free_port()}"
    mp.start_processes(_train_rank, args=(n_devices, init),
                       nprocs=n_devices, join=True, start_method="spawn")
    if n_devices % 2 == 0:
        init = f"tcp://127.0.0.1:{_free_port()}"
        mp.start_processes(_tp_rank, args=(2, init, n_devices), nprocs=2,
                           join=True, start_method="spawn")

    from PIL import Image

    from ..config import tiny_test_config
    from ..infer import FakeBackend, set_backend
    from ..models import convert
    from ..processing import ByteTokenizer, DetikzifyProcessor
    from .replicas import ReplicaPool

    cfg = tiny_test_config(vocab_size=512)
    params = convert.init_random(cfg, device="cpu", dtype=torch.float32)
    set_backend(FakeBackend())
    try:
        tok = ByteTokenizer(vocab_size=cfg.text.vocab_size,
                            image_token_id=cfg.image_token_id,
                            bos_token_id=cfg.bos_token_id,
                            eos_token_id=cfg.eos_token_id,
                            model_max_length=64)
        pool = ReplicaPool(params, cfg, DetikzifyProcessor(tok, cfg),
                           devices=["cpu", "cpu"], num_slots=2, max_len=64,
                           temperature=0.0)
        docs = pool.map_sample(
            [Image.new("RGB", (32, 32), "white") for _ in range(4)],
            max_new_tokens=6)
        assert len(docs) == 4 and all(
            isinstance(d.code, str) for d in docs), docs
        assert len(pool.pipelines) == 2
    finally:
        set_backend(None)
    print(f"dryrun_multi_device({n_devices}): replica-parallel 2-engine "
          f"gather ok (4 items over 2 devices)", flush=True)


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    dryrun_multi_device(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
