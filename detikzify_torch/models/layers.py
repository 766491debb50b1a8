"""Shared neural-net primitives (counterpart of ``detikzify_tpu/models/layers.py``).

Dense layers are ``torch.nn.Linear`` (weights ``[out, in]``, the transpose
of the JAX ``[in, out]`` kernels) or, once quantized, ``ops.quant.
QuantLinear`` (int8 ``[out, in]`` + fp32 per-channel scale). Norms compute
in fp32 and cast back to the input dtype, as the JAX functions do. RoPE is
the non-interleaved
"rotate_half" form with optional llama3 frequency scaling. ``apply_remat``
wraps a layer's body in ``torch.utils.checkpoint`` for training.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.quant import QuantLinear
from ..ops.quant_matmul import int8_matmul

#: the outputs ``remat="dots"`` keeps: the products without batch dims (the
#: projections), as JAX's ``dots_with_no_batch_dims_saveable``; attention's
#: batched products and K1 are recomputed
_SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_projections(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def apply_remat(block, remat):
    """Wrap a layer's body per the remat policy (``detikzify_tpu/models/
    layers.py::apply_remat``): ``True`` keeps only the layer's inputs and
    recomputes its forward in the backward (``torch.utils.checkpoint``);
    ``"dots"`` also keeps the projections' outputs (``aten.mm`` /
    ``aten.addmm``), so the backward recomputes only the cheap ops and
    attention; ``False`` returns ``block`` itself."""
    if not remat:
        return block
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)

    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_projections)

    def wrapped(*args):
        return checkpoint(block, *args, use_reentrant=False, **kw)
    return wrapped


def run_layer(block, lp: nn.Module, x: torch.Tensor, *args):
    """``block(x, *args)``, the layer whose weights are ``lp``. A layer
    stored sharded over a mesh's data axis (``parallel.mesh``: its
    ``fsdp_unit``) is gathered around its forward and backward."""
    unit = getattr(lp, "fsdp_unit", None)
    return block(x, *args) if unit is None else unit.run(block, x, *args)


class LayerNorm(nn.Module):
    """Parameters of a layer norm (``scale``, ``bias``), applied by
    ``layer_norm``."""

    def __init__(self, dim: int, *, device=None, dtype=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(dim, device=device, dtype=dtype))


class RMSNorm(nn.Module):
    """Parameters of an RMS norm (``scale``), applied by ``rms_norm``."""

    def __init__(self, dim: int, *, device=None, dtype=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))


def linear(p: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Dense layer ``x W^T + b`` (the JAX ``einsum('...i,io->...o')``); an
    int8 ``QuantLinear`` goes through ``int8_matmul`` (kernel K5 for
    decode-regime products on the card), then adds its bias."""
    if isinstance(p, QuantLinear):
        y = int8_matmul(x, p.q, p.scale)
        return y if p.bias is None else y + p.bias
    return F.linear(x, p.weight, p.bias)


def layer_norm(p: LayerNorm, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * p.scale.float() + p.bias.float()).to(x.dtype)


def rms_norm(p: RMSNorm, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (y * p.scale.float()).to(x.dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """PyTorch 'gelu_pytorch_tanh' / gelu(approximate='tanh')."""
    return F.gelu(x, approximate="tanh")


ACTIVATIONS = {
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "gelu_pytorch_tanh": gelu_tanh,
    "silu": F.silu,
    "relu": F.relu,
}


# ---------------------------------------------------------------------------
# Rotary position embeddings (LLaMA-style, non-interleaved "rotate_half").
# ---------------------------------------------------------------------------

def rope_inv_freq(head_dim: int, theta: float, rope_scaling=None,
                  device=None) -> torch.Tensor:
    """Per-frequency inverse wavelengths, with optional llama3 NTK scaling."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2,
                                             dtype=torch.float32,
                                             device=device) / head_dim))
    if rope_scaling and rope_scaling.get("rope_type") == "llama3":
        factor = rope_scaling["factor"]
        lo = rope_scaling["low_freq_factor"]
        hi = rope_scaling["high_freq_factor"]
        orig = rope_scaling["original_max_position_embeddings"]
        wavelen = 2.0 * math.pi / inv_freq
        low_wl, high_wl = orig / lo, orig / hi
        smooth = (orig / wavelen - lo) / (hi - lo)
        inv_freq = torch.where(
            wavelen > low_wl, inv_freq / factor,
            torch.where(wavelen < high_wl, inv_freq,
                        (1 - smooth) * inv_freq / factor + smooth * inv_freq))
    return inv_freq


def rope_cos_sin(positions: torch.Tensor, inv_freq: torch.Tensor):
    """positions [...] int -> (cos, sin) each [..., head_dim] fp32."""
    angles = positions[..., None].float() * inv_freq
    angles = torch.cat([angles, angles], dim=-1)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x [..., n_heads, head_dim]; cos/sin broadcastable [..., head_dim]."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    rotated = torch.cat([-x2, x1], dim=-1)
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    return (x.float() * cos + rotated.float() * sin).to(x.dtype)
