"""SigLIP-style ViT vision encoder (counterpart of
``detikzify_tpu/models/siglip.py``), with the TikZero adapter's gated
cross-attention wired in explicitly (``AdapterInputs``) where the reference
uses forward pre-hooks.

Images are NHWC at the public surface, as in the JAX package. The patch
embedding is an unfold + matmul whose per-patch order is (C, ph, pw), so a
torch ``Conv2d`` weight ``[D, C, ph, pw]`` reshapes to it directly. Every
attention call (the 900-patch layers, the 1-query MAP head and the
adapter's cross-attention over a key-masked caption) goes through
``ops.flash.flash_attention``, i.e. kernel K1 on the card. So does the
SigLIP text tower (``SiglipText``, ``apply_text``) that ClipScore pairs
with a vision tower: the same encoder layers over token + position
embeddings, pooled at the last position.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from ..config import AdapterConfig, VisionConfig
from ..ops.flash import flash_attention
from .layers import (ACTIVATIONS, LayerNorm, apply_remat, layer_norm, linear,
                     run_layer)


class AdapterInputs(NamedTuple):
    """Caption-conditioning inputs for the TikZero cross-attention adapter."""

    params: nn.ModuleList         # one ``adapter.CrossAttentionBlock`` a layer
    config: AdapterConfig
    cross_states: torch.Tensor    # [B, T, D_vision]: caption embeds, connected
    cross_mask: torch.Tensor      # [B, T] bool


class Attention(nn.Module):
    def __init__(self, d: int, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.q = nn.Linear(d, d, **kw)
        self.k = nn.Linear(d, d, **kw)
        self.v = nn.Linear(d, d, **kw)
        self.o = nn.Linear(d, d, **kw)


class MLP(nn.Module):
    def __init__(self, d: int, i: int, *, device=None, dtype=None):
        super().__init__()
        self.fc1 = nn.Linear(d, i, device=device, dtype=dtype)
        self.fc2 = nn.Linear(i, d, device=device, dtype=dtype)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: VisionConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.hidden_size
        self.ln1 = LayerNorm(d, **kw)
        self.attn = Attention(d, **kw)
        self.ln2 = LayerNorm(d, **kw)
        self.mlp = MLP(d, cfg.intermediate_size, **kw)


class Embeddings(nn.Module):
    def __init__(self, cfg: VisionConfig, *, device=None, dtype=None):
        super().__init__()
        patch_dim = cfg.patch_size * cfg.patch_size * cfg.num_channels
        self.patch = nn.Linear(patch_dim, cfg.hidden_size, device=device,
                               dtype=dtype)
        self.position = nn.Parameter(torch.zeros(
            cfg.num_patches, cfg.hidden_size, device=device, dtype=dtype))


class MAPHead(nn.Module):
    """SigLIP multihead attention-pooling head: one learned probe query."""

    def __init__(self, cfg: VisionConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.hidden_size
        self.probe = nn.Parameter(torch.zeros(1, 1, d, **kw))
        self.attn = Attention(d, **kw)
        self.ln = LayerNorm(d, **kw)
        self.mlp = MLP(d, cfg.intermediate_size, **kw)


class SiglipVision(nn.Module):
    def __init__(self, cfg: VisionConfig, *, head: bool = True, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.embeddings = Embeddings(cfg, **kw)
        self.layers = nn.ModuleList(EncoderLayer(cfg, **kw)
                                    for _ in range(cfg.num_hidden_layers))
        self.post_ln = LayerNorm(cfg.hidden_size, **kw)
        self.head = MAPHead(cfg, **kw) if head else None


class TextEmbeddings(nn.Module):
    def __init__(self, vocab_size: int, max_positions: int, d: int, *,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.token = nn.Parameter(torch.zeros(vocab_size, d, **kw))
        self.position = nn.Parameter(torch.zeros(max_positions, d, **kw))


class SiglipText(nn.Module):
    """SigLIP text tower (JAX ``siglip.init_text``): the vision tower's
    encoder layers over token + position embeddings, a final norm and a
    dense head."""

    def __init__(self, cfg: VisionConfig, vocab_size: int = 32000,
                 max_positions: int = 64, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.hidden_size
        self.embeddings = TextEmbeddings(vocab_size, max_positions, d, **kw)
        self.layers = nn.ModuleList(EncoderLayer(cfg, **kw)
                                    for _ in range(cfg.num_hidden_layers))
        self.final_ln = LayerNorm(d, **kw)
        self.head = nn.Linear(d, d, **kw)


def patchify(pixel_values: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, (H/p)*(W/p), p*p*C], per-patch order (C, ph, pw).
    Rows and columns past the last whole patch are dropped, as a torch
    ``Conv2d`` of stride p drops them: the v1 tower takes 384 px at patch
    14, 27 x 27 patches and 6 pixels left over (the JAX package's
    ``patchify`` raises there)."""
    b, h, w, c = pixel_values.shape
    gh, gw = h // patch, w // patch
    x = pixel_values[:, :gh * patch, :gw * patch]
    x = x.reshape(b, gh, patch, gw, patch, c)
    x = x.permute(0, 1, 3, 5, 2, 4)             # [B, gh, gw, C, ph, pw]
    return x.reshape(b, gh * gw, c * patch * patch)


def _mha(p: Attention, x_q: torch.Tensor, x_kv: torch.Tensor,
         num_heads: int, *, kv_mask=None) -> torch.Tensor:
    b, s, d = x_q.shape
    hd = d // num_heads
    t = x_kv.shape[1]
    q = linear(p.q, x_q).reshape(b, s, num_heads, hd)
    k = linear(p.k, x_kv).reshape(b, t, num_heads, hd)
    v = linear(p.v, x_kv).reshape(b, t, num_heads, hd)
    out = flash_attention(q, k, v, kv_mask=kv_mask)
    return linear(p.o, out.reshape(b, s, d))


def _cross_attn_layer(ap, x: torch.Tensor, adapter: AdapterInputs,
                      eps: float) -> torch.Tensor:
    """One gated cross-attention block (reference ``CrossAttentionLayer``,
    ``modeling_adapter.py:309-352``): per-head q/k layer norms, K1 over the
    key-masked caption, sigmoid gates."""
    nh = adapter.config.num_attention_heads
    b, s, d = x.shape
    hd = d // nh
    cross = adapter.cross_states

    h = layer_norm(ap.ln1, x, eps)
    q = linear(ap.attn.q, h).reshape(b, s, nh, hd)
    k = linear(ap.attn.k, cross).reshape(b, -1, nh, hd)
    v = linear(ap.attn.v, cross).reshape(b, -1, nh, hd)
    q = layer_norm(ap.attn.q_norm, q, eps)
    k = layer_norm(ap.attn.k_norm, k, eps)
    out = flash_attention(q, k, v, kv_mask=adapter.cross_mask)
    out = linear(ap.attn.o, out.reshape(b, s, d))
    x = x + torch.sigmoid(ap.attn_gate) * out

    h = layer_norm(ap.ln2, x, eps)
    h = linear(ap.mlp.fc2, ACTIVATIONS["gelu_pytorch_tanh"](
        linear(ap.mlp.fc1, h)))
    return x + torch.sigmoid(ap.mlp_gate) * h


def _blocks(params: SiglipVision, cfg: VisionConfig,
            pixel_values: torch.Tensor, num_layers: Optional[int] = None,
            keep: bool = False, adapter: Optional[AdapterInputs] = None,
            remat=False):
    """Patch embedding and the first ``num_layers`` encoder blocks (all by
    default) -> (the last block's output, every block's output when
    ``keep``, else []). With ``adapter``, its cross-attention block runs
    before each active layer (``(idx + 1) % cross_attn_every_n_layers ==
    0``, the reference's pre-hook placement); the other layers skip it.
    ``remat`` recomputes each block (with its cross-attention) in the
    backward (``layers.apply_remat``)."""
    act = ACTIVATIONS[cfg.hidden_act]
    eps = cfg.layer_norm_eps
    nh = cfg.num_attention_heads
    dtype = params.embeddings.patch.weight.dtype
    every = (adapter.config.cross_attn_every_n_layers
             if adapter is not None else 0)

    def block(x, idx, lp):
        if every and (idx + 1) % every == 0:
            x = _cross_attn_layer(adapter.params[idx], x, adapter, eps)
        return _encoder_layer(lp, x, act, eps, nh)

    block = apply_remat(block, remat)
    x = linear(params.embeddings.patch,
               patchify(pixel_values.to(dtype), cfg.patch_size))
    x = x + params.embeddings.position
    states = []
    for idx, lp in enumerate(params.layers[:num_layers]):
        x = run_layer(block, lp, x, idx, lp)
        if keep:
            states.append(x)
    return x, states


def _encoder_layer(lp: EncoderLayer, x: torch.Tensor, act, eps: float,
                   nh: int) -> torch.Tensor:
    h = layer_norm(lp.ln1, x, eps)
    x = x + _mha(lp.attn, h, h, nh)
    h = layer_norm(lp.ln2, x, eps)
    return x + linear(lp.mlp.fc2, act(linear(lp.mlp.fc1, h)))


def hidden_state(params: SiglipVision, cfg: VisionConfig,
                 pixel_values: torch.Tensor, layer: int,
                 adapter: Optional[AdapterInputs] = None,
                 remat=False) -> torch.Tensor:
    """``apply(..., output_hidden_states=True)["hidden_states"][layer]``
    (Python indexing, negative values included), computing the blocks up
    to ``layer`` and no further."""
    n = len(params.layers)
    if not -n <= layer < n:
        raise IndexError(f"layer {layer} of a {n}-layer tower")
    return _blocks(params, cfg, pixel_values, layer % n + 1,
                   adapter=adapter, remat=remat)[0]


def apply(params: SiglipVision, cfg: VisionConfig,
          pixel_values: torch.Tensor, *,
          adapter: Optional[AdapterInputs] = None,
          output_hidden_states: bool = False, remat=False) -> dict:
    """pixel_values [B, H, W, C] (SigLIP-normalized) ->
    {'last_hidden_state': [B, N, D], 'pooler_output': [B, D]}, plus
    'hidden_states' (each block's output, before the final norm, one per
    layer) when asked. ``adapter`` conditions the tower on a caption;
    ``remat`` (False | True | "dots") recomputes each block in the
    backward."""
    act = ACTIVATIONS[cfg.hidden_act]
    eps = cfg.layer_norm_eps
    nh = cfg.num_attention_heads
    x, states = _blocks(params, cfg, pixel_values,
                        keep=output_hidden_states, adapter=adapter,
                        remat=remat)
    x = layer_norm(params.post_ln, x, eps)

    hp: Optional[MAPHead] = params.head
    if hp is not None:
        probe = hp.probe.expand(x.shape[0], 1, x.shape[-1]).to(x.dtype)
        pooled = _mha(hp.attn, probe, x, nh)
        h = layer_norm(hp.ln, pooled, eps)
        h = linear(hp.mlp.fc2, act(linear(hp.mlp.fc1, h)))
        pooled = (pooled + h)[:, 0]
    else:
        pooled = x.mean(dim=1)
    out = {"last_hidden_state": x, "pooler_output": pooled}
    if output_hidden_states:
        out["hidden_states"] = states
    return out


def apply_text(params: SiglipText, cfg: VisionConfig,
               input_ids: torch.Tensor) -> dict:
    """input_ids [B, T] -> {'last_hidden_state', 'pooler_output'}.

    Pooling follows SigLIP: the LAST position's hidden state through the
    head (the tokenizer pads every caption to a fixed length). Attention is
    K1 over all T positions, with no key mask, as in the JAX tower."""
    act = ACTIVATIONS[cfg.hidden_act]
    eps = cfg.layer_norm_eps
    nh = cfg.num_attention_heads
    emb = params.embeddings
    ids = input_ids.to(emb.token.device).long()
    x = emb.token[ids] + emb.position[:ids.shape[1]]
    for lp in params.layers:
        x = _encoder_layer(lp, x, act, eps, nh)
    x = layer_norm(params.final_ln, x, eps)
    pooled = linear(params.head, x[:, -1])
    return {"last_hidden_state": x, "pooler_output": pooled}
