"""TikZero+ end-to-end fine-tuning: train the LLM with the adapter attached
(counterpart of ``detikzify_tpu/train/adapter/train.py``).

Reference ``detikzify/train/adapter/train.py:22-193``: the text decoder
fine-tunes on caption-conditioned TikZ generation while the vision tower,
adapter, and caption-embedding model stay frozen (:117-124). In
``caption_condition`` mode the LLM prompt is ``caption <bos> code`` and the
loss is masked until after the bos separator (:51-61); otherwise only image
and pad tokens are masked.

``train_adapter_llm`` trains a copy of the caller's text tower (the JAX
arrays it starts from are immutable): the caller's ``Params`` stay as they
were given. The JAX loop pins ``attn_impl="xla"``; the port has no
attention switch, so its forward runs K1 on the card as every path does.
"""
from __future__ import annotations

import copy
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from ...config import DetikzifyConfig
from ...models import detikzify
from ...models.adapter import dummy_pixels, make_inputs
from ...models.detikzify import Params
from ...models.embedding import AdapterBundle
from ...processing import preprocess_image
from ...processing_adapter import AdapterProcessor
from ..checkpoint import Checkpointer
from ..data import IGNORE_INDEX
from ..step import AdamW, make_optimizer
from ..trainer import to_device

__all__ = ["tokenize_adapter_batch", "make_adapter_train_step",
           "train_adapter_llm"]


def tokenize_adapter_batch(
    processor: AdapterProcessor,
    captions: List[str],
    codes: List[str],
    images: Optional[List] = None,
    *,
    caption_condition: bool = False,
    max_length: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Build (input_ids, labels, adapter_*) with reference label masking."""
    base = processor.processor
    tok = base.tokenizer
    bos = tok.bos_token_id
    if caption_condition:
        # prompt = image tokens + caption <bos> code <eos>; bos is the
        # caption/code separator and loss starts after it (reference
        # train/adapter/train.py:36,51-61 -- bos_token.join + after_bos mask)
        joined = []
        for cap, code in zip(captions, codes):
            cap_ids = tok.encode(cap, add_special_tokens=False)
            code_ids = tok.encode(code, add_special_tokens=False)
            joined.append((cap_ids, code_ids))
        width = max(len(c) + len(d) + 2 for c, d in joined)
        if max_length:
            width = min(width, max_length)
        seq = base.image_seq_len
        pad = getattr(tok, "pad_token_id", 0) or 0
        total = seq + width
        ids = np.full((len(joined), total), pad, np.int32)
        labels = np.full_like(ids, IGNORE_INDEX)
        mask = np.zeros_like(ids, bool)
        for i, (cap_ids, code_ids) in enumerate(joined):
            row = ([base.image_token_id] * seq + cap_ids + [bos]
                   + code_ids + [tok.eos_token_id])[:total]
            ids[i, :len(row)] = row
            mask[i, :len(row)] = True
            # loss starts after the separator bos
            sep = seq + len(cap_ids)       # index of separator bos
            start = min(sep + 1, len(row))
            end = len(row)
            labels[i, start:end] = row[start:end]
        out = {"input_ids": ids, "labels": labels, "attention_mask": mask}
    else:
        enc = base(images=images, text=list(codes),
                   add_eos_token=True, truncation=True)
        ids = enc.input_ids
        labels = ids.copy()
        labels[ids == base.image_token_id] = IGNORE_INDEX
        labels[~enc.attention_mask] = IGNORE_INDEX
        out = {"input_ids": ids.astype(np.int32),
               "labels": labels.astype(np.int32),
               "attention_mask": enc.attention_mask}

    cap_out = processor(images=None, text=list(captions))
    out["adapter_input_ids"] = cap_out.adapter_input_ids
    out["adapter_attention_mask"] = cap_out.adapter_attention_mask
    if images is not None:
        out["pixel_values"] = np.stack([
            preprocess_image(img, base.cfg.vision.image_size)
            for img in images])
    return out


class AdapterLLMState(NamedTuple):
    text_params: nn.Module        # the trained text tower, updated in place
    opt_state: dict
    step: int


def make_adapter_train_step(cfg: DetikzifyConfig, frozen: Params,
                            bundle: AdapterBundle, optimizer: AdamW):
    """Step training ONLY the text tower (the state's ``text_params``, whose
    leaves that require a gradient are differentiated); vision, connector,
    adapter and caption model are frozen (reference :117-124). batch
    tensors: input_ids, labels, attention_mask, pixel_values,
    caption_hidden, caption_mask."""
    acfg = bundle.adapter_cfg

    def loss_fn(text_params, batch):
        params = Params.of(frozen.vision, frozen.connector, text_params)
        ai = make_inputs(bundle.adapter_params, acfg,
                         batch["caption_hidden"], batch["caption_mask"])
        image_embeds = None
        if batch.get("pixel_values") is not None:
            # the frozen tower and connector build no graph
            with torch.no_grad():
                image_embeds = detikzify.encode_image(
                    params, cfg, batch["pixel_values"], adapter=ai)
        _, loss = detikzify.forward(
            params, cfg, batch["input_ids"],
            attention_mask=batch.get("attention_mask"),
            labels=batch["labels"], image_embeds=image_embeds)
        return loss

    def step(state: AdapterLLMState, batch):
        text = state.text_params
        trained = [p for p in text.parameters() if p.requires_grad]
        if not trained:
            raise ValueError("no text leaf requires a gradient")
        loss = loss_fn(text, batch)
        grads = torch.autograd.grad(loss, trained, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, trained)]
        opt_state = optimizer.update(text, dict(zip(trained, grads)),
                                     state.opt_state)
        return (AdapterLLMState(text, opt_state, state.step + 1),
                {"loss": loss.detach()})

    return step


def train_adapter_llm(
    output_dir: str,
    params: Params,
    cfg: DetikzifyConfig,
    processor: AdapterProcessor,
    bundle: AdapterBundle,
    dataset: List[dict],                 # [{image?, caption, code}, ...]
    *,
    caption_condition: bool = False,
    batch_size: int = 128,
    micro_batch_size: int = 4,
    learning_rate: float = 5e-5,
    epochs: int = 1,
    seed: int = 0,
    log_fn=print,
) -> Params:
    """Fine-tune the text tower with the adapter attached; returns new
    ``Params`` holding the caller's vision and connector and the trained
    text tower (a copy: ``params`` is not changed). The step runs where
    ``params`` live."""
    steps_per_epoch = max(len(dataset) // micro_batch_size, 1)
    total = steps_per_epoch * epochs
    optimizer = make_optimizer(learning_rate, total_steps=total)
    text = copy.deepcopy(params.text).requires_grad_(True)
    state = AdapterLLMState(text, optimizer.init(text), 0)
    step_fn = make_adapter_train_step(cfg, params, bundle, optimizer)
    ckpt = Checkpointer(output_dir)
    device = params.device
    rng = np.random.default_rng(seed)
    step = 0
    for epoch in range(epochs):
        order = rng.permutation(len(dataset))
        for i in range(0, len(order) - micro_batch_size + 1,
                       micro_batch_size):
            items = [dataset[int(j)] for j in order[i:i + micro_batch_size]]
            batch = tokenize_adapter_batch(
                processor,
                captions=[it["caption"] for it in items],
                codes=[it["code"] for it in items],
                images=[it["image"] for it in items]
                if "image" in items[0] else None,
                caption_condition=caption_condition)
            hidden, mask = bundle.embed_captions(
                [it["caption"] for it in items])
            batch.pop("adapter_input_ids", None)
            batch.pop("adapter_attention_mask", None)
            batch = to_device(batch, device)
            batch["caption_hidden"] = hidden
            batch["caption_mask"] = mask
            if "pixel_values" not in batch:
                # text-only: the adapter's (frozen) learnable blank image
                batch["pixel_values"] = dummy_pixels(
                    bundle.adapter_params, len(items)).detach()
            state, metrics = step_fn(state, batch)
            step += 1
            if step % 10 == 0:
                log_fn(f"tikzero+ epoch {epoch} step {step} "
                       f"loss {float(metrics['loss']):.4f}")
        ckpt.save(step, state.text_params, {"epoch": epoch})
    # detach adapter before returning base params (reference :188-191)
    text.requires_grad_(False)
    return Params.of(params.vision, params.connector, state.text_params)
