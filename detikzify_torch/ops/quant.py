"""Int8 weight-only quantization (counterpart of
``detikzify_tpu/ops/quant.py``).

A quantized projection is a :class:`QuantLinear`: ``q`` int8 ``[out, in]``
(``nn.Linear.weight``'s layout, so one output channel's weights are
contiguous, which is what kernel K5 streams) and ``scale`` fp32 ``[out]``,
symmetric per output channel, plus the layer's bias if it has one.
``quantize_params`` swaps ``QuantLinear`` in for the ``nn.Linear`` modules
under the JAX package's ``_QUANT_KEYS`` paths, in place; ``models.layers.
linear`` dispatches on it. ``fuse_projections`` packs the text tower's
q/k/v into one ``qkv`` projection and gate/up into one ``gateup`` (rows and
per-channel scales concatenate, so int8 fuses losslessly); the layer bodies
consume either layout.
"""
from __future__ import annotations

from typing import Iterable, Optional, Sequence, Tuple

import torch
from torch import nn

QUANT_KEYS = ("attn/q", "attn/k", "attn/v", "attn/o",
              "mlp/gate", "mlp/up", "mlp/down", "mlp/fc1", "mlp/fc2",
              "lm_head")

#: fused projection -> the projections it packs, in row order
FUSED = {"qkv": ("q", "k", "v"), "gateup": ("gate", "up")}


class QuantLinear(nn.Module):
    """Int8 weight-only dense layer. ``scale`` stays fp32 whatever dtype
    the model is cast to; ``q`` is an integer buffer and is never cast."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = False, *, device=None, dtype=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.register_buffer("q", torch.zeros(
            (out_features, in_features), dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.ones(
            (out_features,), dtype=torch.float32, device=device))
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device,
                                              dtype=dtype),
                                  requires_grad=False) if bias else None)

    @classmethod
    def like(cls, lin: nn.Linear) -> "QuantLinear":
        """An unfilled QuantLinear of ``lin``'s shape, device and dtype."""
        return cls(lin.in_features, lin.out_features, lin.bias is not None,
                   device=lin.weight.device, dtype=lin.weight.dtype)

    @classmethod
    @torch.no_grad()
    def from_linear(cls, lin: nn.Linear) -> "QuantLinear":
        out = cls.like(lin)
        out.q, out.scale = quantize_kernel(lin.weight)
        if lin.bias is not None:
            out.bias.copy_(lin.bias)
        return out

    def _apply(self, fn, recurse=True):
        scale = self.scale
        super()._apply(fn, recurse)
        moved = self.scale
        if moved.dtype != torch.float32:      # a dtype cast: keep fp32
            self.scale = scale.to(device=moved.device)
        return self


#: elements of a weight quantized per pass (4 MiB in fp32), on either
#: device. On the 8-core host of an H100 machine this quantizes v2-8b's
#: projections in 9.4 s against 19.9 s for one pass over each whole
#: weight (2^18: 17.4 s, 2^22: 9.7 s); on the card it costs launches, 0.95
#: s against 0.21 s (``tools/quant_block_ab.py``, ``PERF.md``).
BLOCK_ELEMENTS = 1 << 20


def quantize_kernel(weight: torch.Tensor,
                    block_elements: int = BLOCK_ELEMENTS
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[out, in]`` float weight -> (q int8 ``[out, in]``, scale fp32
    ``[out]``): absmax / 127 per output channel, round half to even, clip
    to +-127. The channels go in blocks of about ``block_elements``
    entries; the arithmetic is per channel, so the result does not depend
    on the block. Both divisions are IEEE fp32 divisions on either device,
    as numpy's in the JAX package's host quantization: PyTorch divides a
    CUDA tensor by a Python number through its reciprocal, so 127 is a
    tensor here."""
    n, k = weight.shape
    rows = max(1, block_elements // max(k, 1))
    q = torch.empty((n, k), dtype=torch.int8, device=weight.device)
    scale = torch.empty((n,), dtype=torch.float32, device=weight.device)
    for r in range(0, n, rows):
        wf = weight[r:r + rows].to(torch.float32, copy=True)
        absmax = wf.abs().amax(dim=1)
        s = torch.clamp(absmax / torch.full_like(absmax, 127.0), min=1e-8)
        q[r:r + rows] = wf.div_(s[:, None]).round_().clamp_(-127, 127)
        scale[r:r + rows] = s
    return q, scale


def _path(name: str) -> str:
    return "/" + name.replace(".", "/")


def _targets(params: nn.Module, keys: Sequence[str]
             ) -> Iterable[Tuple[nn.Module, str, nn.Linear]]:
    """(parent, attribute, module) for every nn.Linear under a key path."""
    found = []
    for name, mod in params.named_modules():
        if isinstance(mod, nn.Linear) and any(k in _path(name)
                                              for k in keys):
            parent, _, attr = name.rpartition(".")
            found.append((params.get_submodule(parent), attr, mod))
    return found


@torch.no_grad()
def quantize_params(params: nn.Module, keys: Sequence[str] = QUANT_KEYS
                    ) -> nn.Module:
    """Replace every ``nn.Linear`` under the listed paths (``'attn/q'``
    matches ``text.layers.3.attn.q``) by its ``QuantLinear``, in place, on
    the device it lives on. Returns ``params``."""
    for parent, attr, lin in _targets(params, keys):
        setattr(parent, attr, QuantLinear.from_linear(lin))
    return params


@torch.no_grad()
def quantize_params_host(params: nn.Module,
                         keys: Sequence[str] = QUANT_KEYS,
                         device=None) -> nn.Module:
    """Quantize on the host, one layer at a time, and place each int8
    result on ``device`` (the layer's own device when None), so full
    precision and int8 copies of a model never sit on the card together.
    In place; returns ``params``."""
    for parent, attr, lin in _targets(params, keys):
        dev = lin.weight.device if device is None else torch.device(device)
        q, scale = quantize_kernel(lin.weight.detach().to("cpu"))
        out = QuantLinear(lin.in_features, lin.out_features,
                          lin.bias is not None, device=dev,
                          dtype=lin.weight.dtype)
        out.q, out.scale = q.to(dev), scale.to(dev)
        if lin.bias is not None:
            out.bias.copy_(lin.bias.to(dev))
        setattr(parent, attr, out)
    return params


def params_nbytes(params: nn.Module) -> int:
    """Bytes held by the model's parameters and buffers."""
    return sum(t.numel() * t.element_size()
               for t in (*params.parameters(), *params.buffers()))


def _concat_linear(parts: Sequence[nn.Module]) -> Optional[nn.Module]:
    """One projection whose output rows are the parts' rows in order (plain
    or int8, not mixed: None then)."""
    bias = all(p.bias is not None for p in parts)
    k = parts[0].in_features
    n = sum(p.out_features for p in parts)
    if all(isinstance(p, QuantLinear) for p in parts):
        out = QuantLinear(k, n, bias, device=parts[0].q.device,
                          dtype=None if not bias else parts[0].bias.dtype)
        out.q = torch.cat([p.q for p in parts])
        out.scale = torch.cat([p.scale for p in parts])
    elif all(type(p) is nn.Linear for p in parts):
        w = torch.cat([p.weight for p in parts])
        out = nn.Linear(k, n, bias=bias, device="meta", dtype=w.dtype)
        out.weight = nn.Parameter(w, requires_grad=False)
        if bias:
            out.bias = nn.Parameter(torch.empty(n, dtype=w.dtype,
                                                device=w.device),
                                    requires_grad=False)
    else:
        return None
    if bias:
        out.bias.copy_(torch.cat([p.bias for p in parts]))
    return out


@torch.no_grad()
def fuse_module(module: nn.Module, fused: str) -> bool:
    """Replace ``module``'s projections ``FUSED[fused]`` by one projection
    named ``fused``; False (and no change) when they are absent or mixed."""
    names = FUSED[fused]
    if not all(hasattr(module, p) for p in names):
        return False
    cat = _concat_linear([getattr(module, p) for p in names])
    if cat is None:
        return False
    role = getattr(getattr(module, names[0]), "tp_role", None)
    if role is not None:     # a rank's slices: its columns of the fusion
        cat.tp_role = role
    for p in names:
        delattr(module, p)
    setattr(module, fused, cat)
    return True


def fuse_projections(params: nn.Module) -> nn.Module:
    """Pack q/k/v into one ``qkv`` and gate/up into one ``gateup``
    projection in every text-tower layer, in place (inference-time: 7
    decode projections per layer become 4). The vision tower keeps its
    layout. Accepts ``Params`` or the text tower; returns its argument.
    On weights placed over a model axis each rank fuses its own slices
    (``[q_r; k_r; v_r]``, ``[gate_r; up_r]``), never a cut of the whole
    fusion."""
    text = getattr(params, "text", params)
    for layer in text.layers:
        fuse_module(layer.attn, "qkv")
        fuse_module(layer.mlp, "gateup")
    return params
