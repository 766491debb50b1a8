"""Distributed metric-state reduction (counterpart of
``detikzify_tpu/evaluate/dist.py``) on ``torch.distributed``.

Metric states are plain (sum, count) host scalars; across processes they
reduce with one ``all_reduce`` of a float64 tensor, on the card for an
NCCL group and on the host for a gloo one. Without an initialised process
group (one process) they pass through, as the JAX functions do at
``process_count() == 1``.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist


def process_index_count() -> Tuple[int, int]:
    """(rank, world size) of the default process group, (0, 1) without
    one: the counterparts of ``jax.process_index()`` /
    ``jax.process_count()``."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _group_device() -> torch.device:
    """Where a collective's tensors must live: NCCL reduces CUDA tensors."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def allreduce_sum(*values: float) -> Tuple[float, ...]:
    """Sum each value across all processes (no-op single-process)."""
    if process_index_count()[1] == 1:
        return values
    t = torch.tensor(values, dtype=torch.float64, device=_group_device())
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return tuple(float(x) for x in t.cpu())


def sync_metric(metric) -> float:
    """Reduce a (sum, count)-style metric's state across processes and
    return the global mean. Works with ImageSim/ClipScore-shaped metrics
    (``_sum``/``_n``) without mutating local state."""
    total, count = allreduce_sum(float(metric._sum), float(metric._n))
    if count == 0:
        raise RuntimeError("no updates across any process")
    return total / count
