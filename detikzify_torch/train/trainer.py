"""Training loop: the step + epochs + fractional-epoch saves + auto-resume
(counterpart of ``detikzify_tpu/train/trainer.py``).

The HF-Trainer responsibilities the reference relies on
(``train/train.py:105-147``) live here: the step runs over a
``("data", "model")`` mesh (``parallel.mesh``: the processes of the
``torch.distributed`` group, one device each, or one device where there is
no group), data loading and augmentation stay on the host (numpy), each
rank takes its rows of the global batch to its device from pinned memory
without blocking the host, checkpoints are ``train.checkpoint``'s, and
"SplitEpochSaveCallback(0.25)" becomes ``save_epoch_fraction=0.25``.
``TrainConfig.fsdp`` stores the weights and moments sharded over the data
axis; ``model_axis`` > 1 splits each layer over that many ranks (tensor
parallelism, ``parallel.tp``), FSDP then sharding each rank's part over
the data axis.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..config import DetikzifyConfig
from ..parallel.mesh import local_rows, make_mesh, place_params
from ..processing import DetikzifyProcessor
from . import data as data_mod
from .checkpoint import Checkpointer, get_last_checkpoint
from .step import init_state, make_optimizer, make_train_step, trainable_mask


@dataclasses.dataclass
class TrainConfig:
    output_dir: str
    learning_rate: float = 5e-5
    epochs: int = 5
    micro_batch_size: int = 1
    grad_accum: int = 128
    warmup_ratio: float = 0.03
    weight_decay: float = 0.0
    max_length: int = 1024
    sketch_ratio: float = 0.5
    save_epoch_fraction: float = 0.25       # SplitEpochSaveCallback(0.25)
    logging_steps: int = 10
    seed: int = 0
    trainable: str = "all"                  # or "projector"
    gradient_checkpointing: bool = False
    fsdp: bool = True
    model_axis: int = 1


def to_device(batch: dict, device) -> dict:
    """numpy batch -> tensors on ``device``; to a card through pinned host
    memory, without blocking the host."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


class Trainer:
    def __init__(
        self,
        params,
        cfg: DetikzifyConfig,
        processor: DetikzifyProcessor,
        dataset,
        train_cfg: TrainConfig,
        *,
        mesh=None,
        device=None,
        log_fn: Callable[[str], None] = print,
    ):
        """``mesh`` (default ``make_mesh(model=model_axis)``): over a
        ``torch.distributed`` group the weights are placed on it and the
        global batch must divide by its data axis; without a group the
        step runs on ``device`` (default: where ``params`` are)."""
        self.cfg = cfg
        self.processor = processor
        self.dataset = dataset
        self.tc = train_cfg
        self.log = log_fn
        self.mesh = mesh or make_mesh(model=train_cfg.model_axis,
                                      device=device)
        if self.mesh.distributed:
            self.device = self.mesh.device
        else:
            self.device = torch.device(device) if device is not None \
                else next(params.parameters()).device

        global_bs = train_cfg.micro_batch_size * train_cfg.grad_accum
        data_size = self.mesh.shape["data"]
        if global_bs % data_size != 0:
            raise ValueError(
                f"global batch {global_bs} (micro {train_cfg.micro_batch_size}"
                f" x accum {train_cfg.grad_accum}) must be divisible by the "
                f"mesh data axis ({data_size})")
        steps_per_epoch = max(
            len(dataset) // (train_cfg.micro_batch_size
                             * train_cfg.grad_accum), 1)
        self.steps_per_epoch = steps_per_epoch
        self.total_steps = steps_per_epoch * train_cfg.epochs

        if self.mesh.distributed or self.mesh.shape["model"] > 1:
            params = place_params(params, self.mesh, fsdp=train_cfg.fsdp)
        else:
            params = params.to(self.device)
        self.optimizer = make_optimizer(
            train_cfg.learning_rate,
            total_steps=self.total_steps,
            warmup_ratio=train_cfg.warmup_ratio,
            weight_decay=train_cfg.weight_decay,
            trainable=trainable_mask(params, train_cfg.trainable))
        self.state = init_state(params, self.optimizer)
        self._step_fn = make_train_step(
            cfg, self.optimizer, grad_accum=train_cfg.grad_accum,
            remat=train_cfg.gradient_checkpointing)
        self.ckpt = Checkpointer(train_cfg.output_dir)
        self._save_every = max(
            int(steps_per_epoch * train_cfg.save_epoch_fraction), 1)

    # ------------------------------------------------------------------

    def _resume(self) -> int:
        last = get_last_checkpoint(self.tc.output_dir)
        if last is None:
            return 0
        restored, meta = self.ckpt.restore_latest(self.state)
        if restored is not None:
            self.state = restored
            self.log(f"resumed from {last} (step {meta['step']})")
            return int(meta["step"])
        return 0

    def train(self, resume: bool = True, max_steps: Optional[int] = None):
        """Train to the end of the last epoch (or ``max_steps`` in all,
        resumed steps included), saving every ``save_epoch_fraction`` of an
        epoch and at the end."""
        start_step = self._resume() if resume else 0
        step = start_step
        global_bs = self.tc.micro_batch_size * self.tc.grad_accum
        t0 = time.time()
        start_epoch = start_step // self.steps_per_epoch
        epoch = start_epoch
        for epoch in range(start_epoch, self.tc.epochs):
            # mid-epoch resume: skip the batches already trained (the
            # per-epoch shuffle is seeded, so the order is reproducible)
            skip = (start_step % self.steps_per_epoch
                    if epoch == start_epoch else 0)
            for batch_idx, batch in enumerate(data_mod.batches(
                    self.dataset, self.processor, global_bs,
                    max_length=self.tc.max_length,
                    shuffle_seed=self.tc.seed, epoch=epoch)):
                if batch_idx < skip:
                    continue
                if max_steps is not None and step >= max_steps:
                    break
                if self.mesh.distributed:
                    batch = {k: local_rows(v, self.mesh)
                             for k, v in batch.items()}
                self.state, metrics = self._step_fn(
                    self.state, to_device(batch, self.device))
                step += 1
                if step % self.tc.logging_steps == 0:
                    loss = float(metrics["loss"])
                    self.log(f"epoch {epoch} step {step}/"
                             f"{self.total_steps} loss {loss:.4f} "
                             f"({(time.time() - t0):.1f}s)")
                if step % self._save_every == 0:
                    self.ckpt.save(step, self.state, {"epoch": epoch})
            if max_steps is not None and step >= max_steps:
                break
        self.ckpt.save(step, self.state,
                       {"epoch": min(epoch, self.tc.epochs - 1)})
        self.ckpt.wait()
        placement = getattr(self.state.params, "placement", None)
        if placement is not None:
            # whole over the data axis; over a model axis each rank keeps
            # its part (``convert.params_to_numpy`` gives the whole leaves)
            placement.gather()
        return self.state
