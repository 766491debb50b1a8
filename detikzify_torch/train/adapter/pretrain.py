"""TikZero adapter pretraining: cross-modal knowledge distillation
(counterpart of ``detikzify_tpu/train/adapter/pretrain.py``).

Reference ``detikzify/train/adapter/pretrain.py:34-337``: the *teacher* is
the frozen vision encoder seeing the real figure; the *student* is the same
encoder seeing a degraded/blank/edited image while cross-attending the
caption through the adapter. Only the adapter trains. Loss terms (reference
``AdapterTrainer.compute_loss``, :109-149): pooled output, mean-patch,
per-patch (elementwise) and per-layer (depth-weighted) embedding
similarity; ``EmbeddingSimilarityLoss`` (:34-64) supports cosine or L2,
elementwise or relational (Gram-matrix) form.

Data partition (reference ``AdapterDataset``, :193-253): each example is
degraded by one of {sketchify, full-erase, cutout/mixup/cutmix}.
Hyperparameters: bs 512 (grad accum), lr 1e-4, 3 epochs (:264-268).

The adapter trains in place: ``pretrain_adapter`` switches its leaves'
``requires_grad`` on for the run and off at the end; the tower and the
caption model stay frozen and get no optimizer state. The losses are
taken in fp32 whatever the towers' dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from ...config import AdapterConfig, DetikzifyConfig
from ...data.augment import (EditCutMix, EditCutOut, EditMixUp, FullErase,
                             SketchAugment)
from ...models import siglip
from ...models.adapter import make_inputs
from ...models.embedding import AdapterBundle
from ...processing import preprocess_image
from ..checkpoint import Checkpointer
from ..step import AdamW, make_optimizer
from ..trainer import to_device


def embedding_similarity_loss(student: torch.Tensor, teacher: torch.Tensor,
                              kind: str = "cosine",
                              relational: bool = False) -> torch.Tensor:
    """Reference ``EmbeddingSimilarityLoss`` (pretrain.py:34-64)."""
    student, teacher = student.float(), teacher.float()
    if relational:
        # Gram-style: match pairwise patch relations instead of embeddings
        def gram(x):
            xn = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True)
                      + 1e-8)
            return torch.einsum("...nd,...md->...nm", xn, xn)

        student, teacher = gram(student), gram(teacher)
    teacher = teacher.detach()
    if kind == "cosine":
        sim = ((student * teacher).sum(-1)
               / (torch.linalg.vector_norm(student, dim=-1)
                  * torch.linalg.vector_norm(teacher, dim=-1) + 1e-8))
        return (1.0 - sim).mean()
    if kind == "l2":
        return (student - teacher).square().mean()
    raise ValueError(kind)


@dataclasses.dataclass
class DistillLossConfig:
    kind: str = "cosine"
    relational: bool = False
    w_pool: float = 1.0
    w_avg: float = 1.0
    w_patch: float = 1.0
    w_layer: float = 1.0


class DistillState(NamedTuple):
    adapter_params: nn.Module     # the Adapter, updated in place by a step
    opt_state: dict
    step: int


def make_distill_step(cfg: DetikzifyConfig, vision_params: nn.Module,
                      optimizer: AdamW, loss_cfg: DistillLossConfig,
                      acfg: Optional[AdapterConfig] = None):
    """(state, batch) -> (state, metrics). batch tensors:
    teacher_pixels [B,H,W,C], student_pixels [B,H,W,C],
    caption_hidden [B,T,De], caption_mask [B,T]. The step differentiates
    the adapter's leaves that require a gradient (``pretrain_adapter``
    switches them all on)."""
    vcfg = cfg.vision
    acfg = acfg or cfg.adapter
    assert acfg is not None

    def loss_fn(adapter, batch):
        # the teacher is a constant of the loss, as in JAX's closure
        with torch.no_grad():
            teacher = siglip.apply(vision_params, vcfg,
                                   batch["teacher_pixels"],
                                   output_hidden_states=True)
        ai = make_inputs(adapter, acfg, batch["caption_hidden"],
                         batch["caption_mask"])
        student = siglip.apply(vision_params, vcfg, batch["student_pixels"],
                               adapter=ai, output_hidden_states=True)

        def sim(s, t):
            return embedding_similarity_loss(s, t, loss_cfg.kind,
                                             loss_cfg.relational)

        terms: Dict[str, torch.Tensor] = {}
        terms["pool"] = sim(student["pooler_output"],
                            teacher["pooler_output"])
        terms["avg"] = sim(student["last_hidden_state"].float().mean(1),
                           teacher["last_hidden_state"].float().mean(1))
        terms["patch"] = sim(student["last_hidden_state"],
                             teacher["last_hidden_state"])
        # depth-weighted per-layer distillation (later layers weigh more)
        sh, th = student["hidden_states"], teacher["hidden_states"]
        n_layers = len(sh)
        weights = torch.arange(1, n_layers + 1, dtype=torch.float32,
                               device=sh[0].device)
        weights = weights / weights.sum()
        per_layer = torch.stack([sim(s, t) for s, t in zip(sh, th)])
        terms["layer"] = (per_layer * weights).sum()

        loss = (loss_cfg.w_pool * terms["pool"]
                + loss_cfg.w_avg * terms["avg"]
                + loss_cfg.w_patch * terms["patch"]
                + loss_cfg.w_layer * terms["layer"])
        return loss, terms, per_layer

    def step(state: DistillState, batch):
        adapter = state.adapter_params
        trained = [p for p in adapter.parameters() if p.requires_grad]
        if not trained:
            raise ValueError("no adapter leaf requires a gradient")
        loss, terms, per_layer = loss_fn(adapter, batch)
        grads = torch.autograd.grad(loss, trained, allow_unused=True)
        # a leaf the loss does not reach (dummy_input) has a zero gradient
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, trained)]
        opt_state = optimizer.update(adapter, dict(zip(trained, grads)),
                                     state.opt_state)
        metrics = {"loss": loss.detach(), "per_layer": per_layer.detach(),
                   **{k: v.detach() for k, v in terms.items()}}
        return DistillState(adapter, opt_state, state.step + 1), metrics

    return step


class AdapterDataset:
    """Multimodal degradation partition (reference :193-253): sketchify /
    full-erase / {cutout, mixup, cutmix} chosen per example, with the JAX
    package's draws in its order, so a seed picks the same mode, edit and
    partner."""

    def __init__(self, items: List[dict], seed: int = 0):
        self.items = items
        self.rng = np.random.default_rng(seed)
        self.sketch = SketchAugment(seed=seed)
        self.erase = FullErase()
        self.edits = [EditCutOut(seed=seed), EditMixUp(seed=seed),
                      EditCutMix(seed=seed)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx: int) -> dict:
        item = dict(self.items[idx])
        mode = self.rng.integers(3)
        img = item["image"]
        if mode == 0:
            student = self.sketch(img)
        elif mode == 1:
            student = self.erase(img)
        else:
            edit = self.edits[int(self.rng.integers(3))]
            other = self.items[int(self.rng.integers(len(self.items)))]
            student = edit(img) if isinstance(edit, EditCutOut) \
                else edit(img, other["image"])
        item["student_image"] = student
        return item


def pretrain_adapter(
    output_dir: str,
    bundle: AdapterBundle,
    cfg: DetikzifyConfig,
    vision_params: nn.Module,
    dataset: List[dict],                 # [{image, text(caption)}, ...]
    *,
    batch_size: int = 512,
    micro_batch_size: int = 8,
    learning_rate: float = 1e-4,
    epochs: int = 3,
    loss_cfg: Optional[DistillLossConfig] = None,
    seed: int = 0,
    log_fn=print,
):
    """Train the adapter by distillation; returns the trained adapter
    (``bundle.adapter_params``, trained in place). The step runs where the
    tower lives. As in the JAX loop, each micro-batch is one optimizer
    update (``accum`` is computed and not used) and the schedule's length
    counts batches of ``batch_size``."""
    loss_cfg = loss_cfg or DistillLossConfig()
    data = AdapterDataset(dataset, seed=seed)
    accum = max(batch_size // micro_batch_size, 1)  # noqa: F841 (as JAX)
    steps_per_epoch = max(len(data) // batch_size, 1)
    total_steps = steps_per_epoch * epochs

    adapter = bundle.adapter_params
    adapter.requires_grad_(True)
    try:
        optimizer = make_optimizer(learning_rate, total_steps=total_steps)
        state = DistillState(adapter, optimizer.init(adapter), 0)
        step_fn = make_distill_step(cfg, vision_params, optimizer, loss_cfg)
        ckpt = Checkpointer(output_dir)
        device = next(vision_params.parameters()).device

        size = cfg.vision.image_size
        rng = np.random.default_rng(seed)
        step = 0
        for epoch in range(epochs):
            order = rng.permutation(len(data))
            for i in range(0, len(order) - micro_batch_size + 1,
                           micro_batch_size):
                items = [data[int(j)] for j in order[i:i + micro_batch_size]]
                hidden, mask = bundle.embed_captions(
                    [it["text"] for it in items])
                batch = to_device({
                    "teacher_pixels": np.stack(
                        [preprocess_image(it["image"], size)
                         for it in items]),
                    "student_pixels": np.stack(
                        [preprocess_image(it["student_image"], size)
                         for it in items]),
                }, device)
                batch["caption_hidden"] = hidden
                batch["caption_mask"] = mask
                state, metrics = step_fn(state, batch)
                step += 1
                if step % 10 == 0:
                    log_fn(f"adapter-pretrain epoch {epoch} step {step} "
                           f"loss {float(metrics['loss']):.4f}")
            ckpt.save(step, state.adapter_params, {"epoch": epoch})
    finally:
        adapter.requires_grad_(False)
    bundle.adapter_params = state.adapter_params
    return state.adapter_params
