"""Weight rounding, worked out again from the raw weights.

``int8``: symmetric per output channel, scale absmax / 127 (at least
1e-8), round half to even, clip to +-127, the scale in float32: the
int8 weight-only serving rule of the configuration. ``int4``: the same
with 7 levels a side. ``bf16``: the weights as drawn. Every result is
float32.
"""
from __future__ import annotations

import torch

LEVELS = {"int8": 127.0, "int4": 7.0}


def round_weight(w: torch.Tensor, precision: str) -> torch.Tensor:
    """``[out, in]`` weight -> its ``precision`` rounding, in float32."""
    wf = w.float()
    if precision == "bf16":
        return wf
    if precision in LEVELS:
        absmax = wf.abs().amax(dim=1, keepdim=True)
        levels = LEVELS[precision]
        s = torch.clamp(absmax / torch.full_like(absmax, levels), min=1e-8)
        return (wf / s).round().clamp(-levels, levels) * s
    raise ValueError(f"unknown weight precision {precision!r}")
