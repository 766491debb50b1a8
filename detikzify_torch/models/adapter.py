"""TikZero cross-attention adapter (counterpart of
``detikzify_tpu/models/adapter.py``; reference
``detikzify/model/adapter/modeling_adapter.py:355-394``).

The adapter is (a) one gated cross-attention block per vision layer, run
before the layer where ``(idx + 1) % cross_attn_every_n_layers == 0``
(``siglip.apply`` skips the others; an imported checkpoint fills them with
zeros), (b) a ``connector`` projecting the frozen caption model's hidden
states (Llama-3.2-1B's 2048) into the vision width, and (c) a learnable
``dummy_input`` image ``[H, W, C]`` for generation from a caption alone.
The blocks' q/k/v/o and MLP products and the connector are ``nn.Linear``
(cuBLAS on the card); their attention is kernel K1 with a key mask.

An ``Adapter`` is built frozen (no leaf requires a gradient). Adapter
distillation (``train.adapter.pretrain.pretrain_adapter``) is the one
place that trains it: it switches every leaf on for its run and off again
at the end; TikZero+ and inference keep it frozen.
"""
from __future__ import annotations

import torch
from torch import nn

from ..config import AdapterConfig, VisionConfig
from .layers import LayerNorm, linear
from .siglip import MLP, AdapterInputs


class CrossAttention(nn.Module):
    def __init__(self, d: int, head_dim: int, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.q = nn.Linear(d, d, **kw)
        self.k = nn.Linear(d, d, **kw)
        self.v = nn.Linear(d, d, **kw)
        self.o = nn.Linear(d, d, **kw)
        self.q_norm = LayerNorm(head_dim, **kw)
        self.k_norm = LayerNorm(head_dim, **kw)


class CrossAttentionBlock(nn.Module):
    """The JAX block's tree: ``ln1``, ``attn``, ``ln2``, ``mlp`` and the
    sigmoid gates ``attn_gate``, ``mlp_gate`` (zero at init, reference
    ``modeling_adapter.py:320-321``)."""

    def __init__(self, vcfg: VisionConfig, acfg: AdapterConfig, *,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = vcfg.hidden_size
        self.ln1 = LayerNorm(d, **kw)
        self.attn = CrossAttention(d, d // acfg.num_attention_heads, **kw)
        self.ln2 = LayerNorm(d, **kw)
        self.mlp = MLP(d, vcfg.intermediate_size, **kw)
        self.attn_gate = nn.Parameter(torch.zeros(1, **kw))
        self.mlp_gate = nn.Parameter(torch.zeros(1, **kw))


class Adapter(nn.Module):
    """The adapter's weights: ``layers`` (one block per vision layer),
    ``connector`` and ``dummy_input``, the names of the JAX tree."""

    def __init__(self, vcfg: VisionConfig, acfg: AdapterConfig, *,
                 device="cuda", dtype=torch.bfloat16):
        """Allocates on ``device`` WITHOUT initialising: build through
        ``convert.init_random_adapter``, ``convert.adapter_from_numpy`` or
        ``import_hf.import_adapter``. Frozen: distillation switches the
        leaves on (``train.adapter.pretrain``)."""
        super().__init__()
        kw = dict(device="meta", dtype=dtype)
        self.layers = nn.ModuleList(
            CrossAttentionBlock(vcfg, acfg, **kw)
            for _ in range(vcfg.num_hidden_layers))
        self.connector = nn.Linear(acfg.embedding_hidden_size,
                                   vcfg.hidden_size, **kw)
        self.dummy_input = nn.Parameter(torch.ones(
            vcfg.image_size, vcfg.image_size, vcfg.num_channels, **kw))
        self.to_empty(device=device)
        self.requires_grad_(False)

    @property
    def device(self) -> torch.device:
        return self.dummy_input.device


def make_inputs(adapter: Adapter, acfg: AdapterConfig,
                caption_embeds: torch.Tensor,     # [B, T, De]
                caption_mask) -> AdapterInputs:
    """Project caption embeddings into the vision width and bundle them for
    ``siglip.apply``. The mask becomes a contiguous bool tensor on the
    adapter's device, as K1 takes it."""
    w = adapter.connector.weight
    cross = linear(adapter.connector, caption_embeds.to(w.device, w.dtype))
    mask = torch.as_tensor(caption_mask, device=w.device).to(
        torch.bool).contiguous()
    return AdapterInputs(params=adapter.layers, config=acfg,
                         cross_states=cross, cross_mask=mask)


def dummy_pixels(adapter: Adapter, batch: int) -> torch.Tensor:
    """The learnable blank image clamped to [-1, 1] (reference :500-501),
    broadcast to ``[batch, H, W, C]``."""
    img = adapter.dummy_input.clamp(-1.0, 1.0)
    return img[None].expand(batch, *img.shape)
