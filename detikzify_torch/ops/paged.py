"""Kernel K2: decode attention read straight from the page pool
(``csrc/paged_decode.cu``).

Port of the Pallas TPU kernel
``detikzify_tpu/ops/paged.py::decode_attend_paged_pallas``. The decode
engine's KV cache is one page POOL ``[P, page, NKV, Hd]`` per layer; slot b's
row r lives in page ``tab[b, r // page]``. The kernel reads pages through the
table (zero-copy). The plain version gathers the attended pages into a
contiguous view (``gather_pages``) and runs ``decode_attend_plain``: a tensor
on the CPU takes it, a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from .attention import decode_attend_plain
from .cuda import KERNELS, stream_handle

KERNEL = KERNELS["paged_decode"]


def gather_pages(pool: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    """pool [P, page, N, H] + tab [B, m] -> contiguous [B, m*page, N, H]."""
    b, m = tab.shape
    _, page, n, h = pool.shape
    return pool[tab.long()].reshape(b, m * page, n, h)


def decode_attend_paged_plain(q, pool_k, pool_v, tab, lengths, *,
                              scale: Optional[float] = None) -> torch.Tensor:
    return decode_attend_plain(q, gather_pages(pool_k, tab),
                               gather_pages(pool_v, tab), lengths,
                               scale=scale)


def decode_attend_paged(
    q: torch.Tensor,          # [B, NH, Hd]
    pool_k: torch.Tensor,     # [P, page, NKV, Hd]
    pool_v: torch.Tensor,
    tab: torch.Tensor,        # [B, m] int32 page ids (may be a column slice)
    lengths: torch.Tensor,    # [B] int32 valid rows per slot (<= m*page)
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """One query row per slot against its pages; returns [B, NH, Hd]."""
    if q.device.type == "cpu":
        return decode_attend_paged_plain(q, pool_k, pool_v, tab, lengths,
                                         scale=scale)
    b, nh, hd = q.shape
    if pool_k.dim() != 4 or pool_k.shape != pool_v.shape:
        raise ValueError(f"paged_decode: pools {tuple(pool_k.shape)} / "
                         f"{tuple(pool_v.shape)} must match")
    _, page, nkv, phd = pool_k.shape
    for name, x in (("q", q), ("pool_k", pool_k), ("pool_v", pool_v)):
        if x.device != q.device or x.device.type != "cuda":
            raise ValueError(f"paged_decode: {name} on {x.device}, expected "
                             "the CUDA device of q")
        if x.dtype != torch.bfloat16:
            raise ValueError(f"paged_decode: {name} is {x.dtype}; the kernel "
                             "takes bfloat16")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"paged_decode: {name} is not contiguous and "
                             "16-byte aligned")
    if phd != hd or hd not in (64, 128):
        raise ValueError(f"paged_decode: head_dim {hd} (pool {phd}); the "
                         "kernel takes 64 or 128")
    if nh % nkv or nh // nkv > 8:
        raise ValueError(f"paged_decode: NH={nh}, NKV={nkv}; needs NH a "
                         "multiple of NKV with at most 8 query rows per "
                         "KV head")
    if page % 64:
        raise ValueError(f"paged_decode: page size {page} is not a "
                         "multiple of 64")
    if (tab.dim() != 2 or tab.shape[0] != b or tab.dtype != torch.int32
            or tab.device != q.device or tab.stride(1) != 1
            or tab.shape[1] < 1):
        raise ValueError("paged_decode: tab must be an int32 [B, m] tensor "
                         f"with unit column stride on {q.device}")
    if (tuple(lengths.shape) != (b,) or lengths.dtype != torch.int32
            or lengths.device != q.device or not lengths.is_contiguous()):
        raise ValueError(f"paged_decode: lengths must be a contiguous int32 "
                         f"[{b}] tensor on {q.device}")
    scale = (hd ** -0.5) if scale is None else float(scale)
    out = torch.empty_like(q)
    KERNEL.launch(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), tab.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), b, nh, nkv, hd, page,
        tab.shape[1], tab.stride(0), scale, stream_handle(q.device))
    return out
