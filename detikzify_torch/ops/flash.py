"""Kernel K1: fused attention forward (``csrc/flash_attn.cu``).

Port of the Pallas TPU kernel ``detikzify_tpu/ops/flash.py::flash_attention``.
The CUDA kernel streams K/V tiles through shared memory with an online
softmax (see the header of ``flash_attn.cu`` for its design). The plain
version is ``ops.attention.attend_plain``: a tensor on the CPU takes it, a
CUDA tensor launches the kernel or raises. There is no backward yet.
"""
from __future__ import annotations

from typing import Optional

import torch

from .attention import attend_plain
from .cuda import KERNELS, stream_handle

KERNEL = KERNELS["flash_attention"]
#: head dims the kernel is built for: Llama-3.1 (128), SigLIP (72) and 64
HEAD_DIMS = (64, 72, 128)


def flash_attention(
    q: torch.Tensor,                      # [B, S, NH, Hd]
    k: torch.Tensor,                      # [B, T, NKV, Hd]
    v: torch.Tensor,
    *,
    causal: bool = False,
    kv_mask: Optional[torch.Tensor] = None,    # [B, T] bool
    scale: Optional[float] = None,
    q_offsets: Optional[torch.Tensor] = None,  # [B] per-batch causal offset
    kv_limits: Optional[torch.Tensor] = None,  # [B] per-batch key bound
) -> torch.Tensor:
    """softmax(q k^T * scale + masks) v with GQA; returns [B, S, NH, Hd].

    With ``q_offsets``/``kv_limits`` key t is visible to query i of batch
    row b iff ``t <= q_offsets[b] + i and t < kv_limits[b]``."""
    if kv_limits is not None and q_offsets is None:
        raise ValueError("kv_limits requires q_offsets "
                         "(pass zeros for offset-free bounds)")
    if q.device.type == "cpu":
        return attend_plain(q, k, v, causal=causal, kv_mask=kv_mask,
                            scale=scale, q_offsets=q_offsets,
                            kv_limits=kv_limits)
    b, s, nh, hd = q.shape
    if k.dim() != 4 or k.shape[0] != b or k.shape != v.shape:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    t, nkv = k.shape[1], k.shape[2]
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device or x.device.type != "cuda":
            raise ValueError(f"flash_attention: {name} on {x.device}, "
                             f"expected the CUDA device of q")
        if x.dtype != torch.bfloat16:
            raise ValueError(f"flash_attention: {name} is {x.dtype}; the "
                             "kernel takes bfloat16")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} is not contiguous "
                             "and 16-byte aligned")
    if k.shape[3] != hd or hd not in HEAD_DIMS or nh % nkv:
        raise ValueError(f"flash_attention: unsupported head layout "
                         f"NH={nh} NKV={nkv} Hd={hd} (Hd must be one of "
                         f"{HEAD_DIMS}, NH a multiple of NKV)")
    if causal and s > t:
        raise ValueError("flash_attention: causal needs S <= T")
    if kv_mask is not None:
        if (kv_mask.dtype != torch.bool or tuple(kv_mask.shape) != (b, t)
                or kv_mask.device != q.device
                or not kv_mask.is_contiguous()):
            raise ValueError("flash_attention: kv_mask must be a contiguous "
                             f"bool [{b}, {t}] tensor on {q.device}")
    per_batch = q_offsets is not None
    if per_batch:
        if kv_limits is None:
            kv_limits = torch.full((b,), t, dtype=torch.int32,
                                   device=q.device)
        for name, x in (("q_offsets", q_offsets), ("kv_limits", kv_limits)):
            if (x.dtype != torch.int32 or tuple(x.shape) != (b,)
                    or x.device != q.device or not x.is_contiguous()):
                raise ValueError(f"flash_attention: {name} must be a "
                                 f"contiguous int32 [{b}] tensor on "
                                 f"{q.device}")
    scale = (hd ** -0.5) if scale is None else float(scale)
    out = torch.empty_like(q)
    KERNEL.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if kv_mask is None else kv_mask.data_ptr(),
        q_offsets.data_ptr() if per_batch else None,
        kv_limits.data_ptr() if per_batch else None,
        b, s, t, nh, nkv, hd, scale, int(causal), int(per_batch),
        stream_handle(q.device))
    return out
