"""Single-host replica-parallel inference: one model replica per device
(counterpart of ``detikzify_tpu/parallel/replicas.py``).

The reference's multi-GPU eval protocol places ONE model replica per rank
and stripes the test set across ranks (reference ``examples/eval.py:
110-133``, torchrun). Here one process drives every local card: the
weights are placed on each device (``device_put``), each device hosts an
independent ``DecodeEngine`` (its own page pool and sampling generator),
and one host thread per replica drives the search and compile logic. Each
worker thread runs under ``torch.cuda.device(dev)`` and
``torch.inference_mode()``: PyTorch keeps the current device (and with it
the stream a kernel wrapper launches on) and the grad mode per thread.
Kernel launches and device waits release the GIL, so R cards decode
concurrently. Combined with per-process sharding
(``evaluate.harness.shard_indices``) across processes, rollout throughput
scales with the cards.

Two replicas may share one device (``devices=["cuda:0", "cuda:0"]``, or
``["cpu", "cpu"]`` in tests): ``device_put`` gives back the same weights,
as ``jax.device_put`` does, so they share the weight tensors and own
separate engines and page pools; their kernels serialise on the device's
default stream. Nothing per replica writes the shared weights.
"""
from __future__ import annotations

import copy
import queue
import threading
from typing import Callable, List, Optional, Sequence

import torch
from torch import nn

from ..config import DetikzifyConfig
from ..engine import DecodeEngine
from ..ops.cuda import device_scope
from ..ops.sampling import SamplingParams
from ..utils.device import device_count, infer_device


def _canonical(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def device_put(module: nn.Module, device) -> nn.Module:
    """``module`` on ``device``: the module itself when every tensor of it
    is already there (``jax.device_put`` returns the same arrays); else a
    copy whose parameters and buffers are moved one by one, the original
    left as it was (``nn.Module.to`` would move it in place)."""
    dev = _canonical(device)
    tensors = list(module.parameters()) + list(module.buffers())
    if all(_canonical(t.device) == dev for t in tensors):
        return module
    memo = {}
    for t in tensors:
        moved = t.detach().to(dev)
        if isinstance(t, nn.Parameter):
            moved = nn.Parameter(moved, requires_grad=t.requires_grad)
        memo[id(t)] = moved
    return copy.deepcopy(module, memo)


class ReplicaPool:
    """R independent pipelines, one per device, with work-stealing map."""

    def __init__(
        self,
        params,
        cfg: DetikzifyConfig,
        processor,
        *,
        devices: Optional[Sequence] = None,
        metric="fast",
        adapter=None,
        num_slots: int = 8,
        max_len: Optional[int] = None,
        temperature: float = 0.8,
        top_p: float = 0.95,
        top_k: int = 0,
        compile_timeout: float = 60.0,
        compile_workers: int = 4,
        speculate: int = 0,
    ):
        """``devices=None`` places one replica on each CUDA device
        (``jax.local_devices()``); it raises without a card. Pass
        ``devices=["cpu", ...]`` to run the plain versions."""
        from ..infer.pipeline import DetikzifyPipeline

        if devices is None:
            if infer_device() != "gpu":
                raise RuntimeError("ReplicaPool: no CUDA device; pass "
                                   "devices=['cpu', ...] to run the plain "
                                   "versions")
            devices = [torch.device(f"cuda:{i}")
                       for i in range(device_count())]
        self.devices = [_canonical(d) for d in devices]
        assert self.devices, "no devices"
        self.pipelines: List[DetikzifyPipeline] = []
        for i, dev in enumerate(self.devices):
            p_i = device_put(params, dev)
            with device_scope(dev):
                # seed=i decorrelates sampling across replicas
                engine = DecodeEngine(
                    p_i, cfg, num_slots=num_slots,
                    max_len=max_len or min(processor.model_max_length,
                                           cfg.model_max_length),
                    sampling=SamplingParams(temperature=temperature,
                                            top_p=top_p, top_k=top_k),
                    speculate=speculate, device=dev, seed=i)
                self.pipelines.append(DetikzifyPipeline(
                    p_i, cfg, processor, engine=engine, metric=metric,
                    adapter=adapter, compile_timeout=compile_timeout,
                    compile_workers=compile_workers, device=dev))

    def __len__(self) -> int:
        return len(self.pipelines)

    def run(self, fn: Callable, items: Sequence) -> List:
        """``results[i] = fn(pipeline, items[i])`` with each replica's
        pipeline owned exclusively by one worker thread; items are pulled
        from a shared queue (work stealing -- MCTS item times vary a lot).
        An item whose ``fn`` raises gets the exception object as its
        result; other items are unaffected."""
        results: List = [None] * len(items)
        todo: "queue.Queue[int]" = queue.Queue()
        for i in range(len(items)):
            todo.put(i)

        def worker(pipe):
            with device_scope(pipe.engine.device), torch.inference_mode():
                while True:
                    try:
                        i = todo.get_nowait()
                    except queue.Empty:
                        return
                    try:
                        results[i] = fn(pipe, items[i])
                    except Exception as e:  # noqa: BLE001 -- isolate items
                        results[i] = e
                    except BaseException as e:
                        # record so no None row reaches callers, then stop
                        # this worker (KeyboardInterrupt etc. must not be
                        # swallowed into per-item results silently)
                        results[i] = e
                        raise

        threads = [threading.Thread(target=worker, args=(p,), daemon=True)
                   for p in self.pipelines[:max(1, len(items))]]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return results

    def map_sample(self, images: Sequence, **kw) -> List:
        """One-shot ``pipeline.sample`` per image across replicas."""
        return self.run(lambda pipe, img: pipe.sample(image=img, **kw),
                        images)

    def map_until_compilable(self, images: Sequence, **kw) -> List:
        """Reference eval protocol per item (``examples/eval.py:95-106``)
        across replicas; kwargs forward to ``generate_until_compilable``."""
        from ..evaluate.harness import generate_until_compilable

        return self.run(
            lambda pipe, img: generate_until_compilable(pipe, img, **kw),
            images)

    def close(self) -> None:
        """Stop each replica's compile workers."""
        for pipe in self.pipelines:
            pipe.close()
