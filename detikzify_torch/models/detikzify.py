"""Composite DeTikZify model: SigLIP vision + connector + LLaMA decoder
(counterpart of ``detikzify_tpu/models/detikzify.py``; v2 and v1
families; ``adapter=`` conditions the vision tower on a caption through
the TikZero adapter).

  * ``connector``      -- 3->1 patch concatenation + projection;
  * ``merge_inputs``   -- image embeddings into the ``<image>`` token slots
                          (a masked gather, with ``image_offsets`` for
                          prefill blocks that are the tail of a prompt);
  * ``forward``        -- logits and the masked shifted-CE loss;
  * ``prefill`` / ``decode_step`` / ``decode_verify_step`` -- prefill,
    decode and the speculative verify forward over a contiguous
    ``llama.KVCache``;
  * ``encode_image`` / ``prefill_paged`` / ``decode_step_paged`` /
    ``decode_verify_step_paged_zerocopy`` -- the decode engine's entry
    points over its page pool.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import DetikzifyConfig
from . import llama, siglip
from .layers import layer_norm, linear


class Connector(nn.Module):
    def __init__(self, cfg: DetikzifyConfig, *, device=None, dtype=None):
        super().__init__()
        self.proj = nn.Linear(cfg.projection_in, cfg.text.hidden_size,
                              bias=cfg.projector_bias, device=device,
                              dtype=dtype)


class Params(nn.Module):
    """The model's weights: ``vision``, ``connector``, ``text`` (the field
    names of the JAX ``Params``)."""

    def __init__(self, cfg: DetikzifyConfig, *, vision_head: bool = True,
                 device="cuda", dtype=torch.bfloat16):
        """Allocates the weights on ``device`` WITHOUT initialising them:
        build through ``convert.init_random`` or ``convert.params_from_numpy``.
        No parameter requires a gradient: training switches on the leaves
        it trains (``train.step.trainable_mask``)."""
        super().__init__()
        kw = dict(device="meta", dtype=dtype)
        self.vision = siglip.SiglipVision(cfg.vision, head=vision_head, **kw)
        self.connector = Connector(cfg, **kw)
        self.text = llama.Llama(cfg.text, **kw)
        self.to_empty(device=device)
        self.requires_grad_(False)

    @classmethod
    def of(cls, vision: nn.Module, connector: nn.Module,
           text: nn.Module) -> "Params":
        """``Params`` over existing parts, sharing their tensors (the JAX
        ``Params(vision=..., connector=..., text=...)``)."""
        params = cls.__new__(cls)
        nn.Module.__init__(params)
        params.vision, params.connector, params.text = vision, connector, text
        return params

    @property
    def device(self) -> torch.device:
        return self.text.embed_tokens.device

    @property
    def dtype(self) -> torch.dtype:
        return self.text.embed_tokens.dtype


def connector(params: Params, image_hidden: torch.Tensor,
              concat_factor: int) -> torch.Tensor:
    """[B, N, Dv] -> [B, N/cf, Dv*cf] -> [B, N/cf, Dt]."""
    b, n, d = image_hidden.shape
    x = image_hidden.reshape(b, n // concat_factor, d * concat_factor)
    return linear(params.connector.proj, x)


def vision_features(params: Params, cfg: DetikzifyConfig,
                    pixel_values: torch.Tensor, *,
                    adapter: Optional[siglip.AdapterInputs] = None,
                    remat=False) -> torch.Tensor:
    """pixel_values [B,H,W,C] -> pre-connector features
    [B, image_seq_len*cf, Dv]. v2: the final post-norm hidden state. v1
    (``cfg.feature_layer`` set): the output of an intermediate block
    through the final norm (timm ``get_intermediate_layers(norm=True)``,
    reference ``model/v1/modeling_detikzify.py:132-137``), front-truncated
    when the patch count is not divisible by concat_factor; the blocks
    after the tapped one are not run."""
    if cfg.feature_layer is not None:
        feats = siglip.hidden_state(params.vision, cfg.vision, pixel_values,
                                    cfg.feature_layer, adapter=adapter,
                                    remat=remat)
        feats = layer_norm(params.vision.post_ln, feats,
                           cfg.vision.layer_norm_eps)
        return feats[:, -cfg.image_seq_len * cfg.concat_factor:]
    return siglip.apply(params.vision, cfg.vision, pixel_values,
                        adapter=adapter, remat=remat)["last_hidden_state"]


def encode_image(params: Params, cfg: DetikzifyConfig,
                 pixel_values: torch.Tensor, *,
                 adapter: Optional[siglip.AdapterInputs] = None,
                 remat=False) -> torch.Tensor:
    """pixel_values [B,H,W,C] -> projected image tokens
    [B, image_seq_len, Dt] (vision tower + connector)."""
    feats = vision_features(params, cfg, pixel_values, adapter=adapter,
                            remat=remat)
    return connector(params, feats, cfg.concat_factor)


def merge_inputs(cfg: DetikzifyConfig, input_ids: torch.Tensor,
                 inputs_embeds: torch.Tensor, image_embeds: torch.Tensor,
                 image_offsets: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Scatter image embeddings into the <image> token positions: the k-th
    ``<image>`` token of a row takes ``image_embeds[row, k + offset]``."""
    is_image = input_ids == cfg.image_token_id                   # [B, S]
    k = is_image.to(torch.int64).cumsum(-1) - 1
    if image_offsets is not None:
        k = k + image_offsets.to(torch.int64)[:, None]
    k = k.clamp(0, image_embeds.shape[1] - 1)
    idx = k[..., None].expand(*k.shape, image_embeds.shape[-1])
    gathered = torch.gather(image_embeds, 1, idx)                # [B, S, D]
    return torch.where(is_image[..., None],
                       gathered.to(inputs_embeds.dtype), inputs_embeds)


def forward(params: Params, cfg: DetikzifyConfig, input_ids: torch.Tensor,
            pixel_values: Optional[torch.Tensor] = None, *,
            attention_mask: Optional[torch.Tensor] = None,
            labels: Optional[torch.Tensor] = None,
            image_embeds: Optional[torch.Tensor] = None, remat=False):
    """Full forward. Returns (logits [B,S,V] fp32, loss or None).
    ``remat`` (False | True | "dots") recomputes each layer of both towers
    in the backward (``layers.apply_remat``)."""
    embeds = llama.embed(params.text, input_ids)
    if image_embeds is None and pixel_values is not None:
        image_embeds = encode_image(params, cfg, pixel_values, remat=remat)
    if image_embeds is not None:
        embeds = merge_inputs(cfg, input_ids, embeds, image_embeds)
    hidden = llama.forward(params.text, cfg.text, embeds,
                           attention_mask=attention_mask, remat=remat)
    logits = llama.unembed(params.text, hidden)

    loss = None
    if labels is not None:
        # attention-mask-aware shift (reference modeling_detikzify.py:357-376)
        shift_logits = logits[:, :-1]
        shift_labels = labels[:, 1:]
        valid = shift_labels != -100
        if attention_mask is not None:
            valid = valid & attention_mask[:, 1:]
        safe = torch.where(valid, shift_labels, torch.zeros_like(shift_labels))
        logp = torch.log_softmax(shift_logits, dim=-1)
        token_lp = torch.gather(logp, -1, safe[..., None].long())[..., 0]
        loss = -torch.where(valid, token_lp, torch.zeros_like(token_lp)
                            ).sum() / valid.sum().clamp(min=1)
    return logits, loss


def _last_valid(hidden: torch.Tensor, seq_len: torch.Tensor) -> torch.Tensor:
    idx = (seq_len.to(torch.int64) - 1).clamp(min=0)
    return hidden[torch.arange(hidden.shape[0], device=hidden.device), idx]


def prefill(params: Params, cfg: DetikzifyConfig,
            input_ids: torch.Tensor,                # [B, S] (padded block)
            image_embeds: Optional[torch.Tensor],   # [B, image_seq_len, Dt]
            start: torch.Tensor,                    # [B] write offsets
            seq_len: torch.Tensor,                  # [B] valid lengths
            cache: llama.KVCache,
            *, image_offsets: Optional[torch.Tensor] = None):
    """Prefill a token block into a contiguous cache; returns
    (last-valid-token logits [B, V] fp32, cache)."""
    embeds = llama.embed(params.text, input_ids)
    if image_embeds is not None:
        embeds = merge_inputs(cfg, input_ids, embeds, image_embeds,
                              image_offsets)
    hidden, cache = llama.prefill(params.text, cfg.text, embeds, start,
                                  seq_len, cache)
    return llama.unembed(params.text, _last_valid(hidden, seq_len)), cache


def decode_step(params: Params, cfg: DetikzifyConfig,
                token_ids: torch.Tensor,      # [B]
                positions: torch.Tensor,      # [B]
                cache: llama.KVCache,
                kv_limit: Optional[int] = None):
    """One decode step over a contiguous cache; returns (logits [B, V]
    fp32, cache)."""
    embeds = llama.embed(params.text, token_ids)
    hidden, cache = llama.decode_step(params.text, cfg.text, embeds,
                                      positions, cache, kv_limit=kv_limit)
    return llama.unembed(params.text, hidden), cache


def decode_verify_step(params: Params, cfg: DetikzifyConfig,
                       token_block: torch.Tensor,   # [B, K+1]: [last, drafts]
                       start: torch.Tensor,         # [B] row of column 0
                       cache: llama.KVCache):
    """Speculative verify forward over a contiguous cache: K+1 tokens per
    slot in one offset prefill, logits at EVERY position ([B, K+1, V]
    fp32); ``logits[:, i]`` is the distribution of the token following
    input i. Rows beyond the eventually accepted count stay invisible to
    later steps, whose attention is bounded by per-slot positions."""
    b, k1 = token_block.shape
    embeds = llama.embed(params.text, token_block)
    hidden, cache = llama.prefill(
        params.text, cfg.text, embeds, start,
        torch.full((b,), k1, dtype=torch.int32, device=token_block.device),
        cache)
    return llama.unembed(params.text, hidden), cache


def prefill_paged(params: Params, cfg: DetikzifyConfig,
                  input_ids: torch.Tensor,          # [B, S] (padded block)
                  image_embeds: Optional[torch.Tensor],
                  start: torch.Tensor,              # [B] write offsets
                  seq_len: torch.Tensor,            # [B] valid lengths
                  pool: llama.PagedKV,
                  read_tab: torch.Tensor,           # [B, PB] prefix pages
                  write_tab: torch.Tensor,          # [B, m_cap] slot tables
                  cow_begin: torch.Tensor,          # [B] write-back base
                  *, image_offsets: Optional[torch.Tensor] = None,
                  trash_row=None, trash_page=None):
    """Paged prefill; returns (last-valid-token logits [B, V], pool)."""
    embeds = llama.embed(params.text, input_ids)
    if image_embeds is not None:
        embeds = merge_inputs(cfg, input_ids, embeds, image_embeds,
                              image_offsets)
    hidden, pool = llama.prefill_paged(
        params.text, cfg.text, embeds, start, seq_len, pool, read_tab,
        write_tab, cow_begin, trash_row=trash_row, trash_page=trash_page)
    return llama.unembed(params.text, _last_valid(hidden, seq_len)), pool


def decode_step_paged(params: Params, cfg: DetikzifyConfig,
                      token_ids: torch.Tensor,      # [B]
                      positions: torch.Tensor,      # [B]
                      pool: llama.PagedKV,
                      tab: torch.Tensor,            # [B, m_cap]
                      kv_pages=None, trash_row=None, trash_page=None):
    """One zero-copy paged decode step; returns (logits [B, V] fp32, pool)."""
    embeds = llama.embed(params.text, token_ids)
    hidden, pool = llama.decode_step_paged(
        params.text, cfg.text, embeds, positions, pool, tab,
        kv_pages=kv_pages, trash_row=trash_row, trash_page=trash_page)
    return llama.unembed(params.text, hidden), pool


def decode_verify_step_paged_zerocopy(
        params: Params, cfg: DetikzifyConfig,
        token_block: torch.Tensor,    # [B, K+1]
        start: torch.Tensor,          # [B] pool row of token_block[:, 0]
        pool: llama.PagedKV,
        tab: torch.Tensor,            # [B, m_cap]
        *, dead=None, kv_pages=None, trash_row=None, trash_page=None):
    """Zero-copy speculative verify: K+1 logits per slot ([B, K+1, V] fp32)
    with the block's K/V written through the page table and attention read
    by the verify-window kernel K4."""
    embeds = llama.embed(params.text, token_block)
    hidden, pool = llama.verify_step_paged_zerocopy(
        params.text, cfg.text, embeds, start, pool, tab, dead=dead,
        kv_pages=kv_pages, trash_row=trash_row, trash_page=trash_page)
    return llama.unembed(params.text, hidden), pool
