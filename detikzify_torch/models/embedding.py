"""Frozen caption-embedding model for the TikZero adapter (counterpart of
``detikzify_tpu/models/embedding.py``).

The adapter cross-attends caption embeddings from a frozen
``meta-llama/Llama-3.2-1B`` (reference ``model/adapter/__init__.py:10``,
``modeling_adapter.py:398-537``). Here the caption model is the port's own
LLaMA decoder run WITHOUT its LM head: ``llama.forward``, causal, with the
caption's padding mask as K1's key mask and positions ``cumsum(mask) - 1``
(captions are padded on the right). Any ``(llama.Llama, TextConfig)`` pair
works: the tests use a tiny random one, ``load.load_adapter`` imports a
checkpoint through ``import_hf.import_text``.

The caption model is frozen everywhere: ``embed_captions`` and
``adapter_inputs`` run under ``torch.no_grad()``, so they build no graph.
Not under ``torch.inference_mode()``: its outputs are inference tensors,
which autograd refuses to save for a backward, and adapter distillation
(``train.adapter.pretrain``) and TikZero+ (``train.adapter.train``) feed
them into a computation that trains (the adapter's connector, K1's key
mask).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import AdapterConfig, TextConfig
from . import llama
from .adapter import Adapter, make_inputs
from .siglip import AdapterInputs


def pad_right(tokenizer, texts, max_length: int):
    """Tokenize ``texts`` (a string or a list) with the tokenizer's special
    tokens, cut each to ``max_length`` and pad on the right -> (ids int32
    [B, T], mask bool [B, T])."""
    if isinstance(texts, str):
        texts = [texts]
    rows = [tokenizer.encode(t, add_special_tokens=True)[:max_length]
            for t in texts]
    width = max(len(r) for r in rows)
    pad = getattr(tokenizer, "pad_token_id", 0) or 0
    ids = np.full((len(rows), width), pad, np.int32)
    mask = np.zeros((len(rows), width), bool)
    for i, r in enumerate(rows):
        ids[i, :len(r)] = r
        mask[i, :len(r)] = True
    return ids, mask


@dataclasses.dataclass
class AdapterBundle:
    """Everything the text-conditioned path needs, in one handle. The
    caption model runs where ``embed_params`` live."""

    adapter_params: Adapter       # init_random_adapter / import_adapter
    adapter_cfg: AdapterConfig
    embed_params: llama.Llama     # frozen LLaMA decoder (no LM head needed)
    embed_cfg: TextConfig
    tokenizer: object             # caption tokenizer (pad right, max 512)
    max_length: int = 512

    def tokenize(self, texts) -> tuple:
        return pad_right(self.tokenizer, texts, self.max_length)

    @torch.no_grad()
    def embed_captions(self, texts) -> tuple:
        """texts -> (caption hidden states [B, T, De], mask [B, T] bool),
        on the caption model's device."""
        ids, mask = self.tokenize(texts)
        dev = self.embed_params.embed_tokens.device
        ids = torch.from_numpy(ids).to(dev)
        mask = torch.from_numpy(mask).to(dev)
        embeds = llama.embed(self.embed_params, ids)
        hidden = llama.forward(self.embed_params, self.embed_cfg, embeds,
                               attention_mask=mask)
        return hidden, mask

    @torch.no_grad()
    def adapter_inputs(self, texts) -> AdapterInputs:
        hidden, mask = self.embed_captions(texts)
        return make_inputs(self.adapter_params, self.adapter_cfg, hidden,
                           mask)
