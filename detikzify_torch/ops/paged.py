"""Kernels K2 and K4: attention read straight from the page pool
(``csrc/paged_decode.cu``, ``csrc/paged_verify.cu``).

Ports of the Pallas TPU kernels in ``detikzify_tpu/ops/paged.py``. The
decode engine's KV cache is one page POOL ``[P, page, NKV, Hd]`` per layer;
slot b's row r lives in page ``tab[b, r // page]``. Both kernels read pages
through the table (zero-copy):

  * K2 ``decode_attend_paged`` (``decode_attend_paged_pallas``): one query
    row per slot; plain version: gather the attended pages into a contiguous
    view (``gather_pages``) and run ``decode_attend_plain``;
  * K4 ``decode_verify_attend_paged`` (``decode_verify_attend_paged_pallas``):
    the speculative verify window, K+1 query rows per slot with per-row
    causal limits; plain version: the JAX gather + masked einsum path.

A tensor on the CPU takes the plain version, a CUDA tensor launches the
kernel or raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from .attention import NEG_INF, decode_attend_plain
from .cuda import KERNELS, stream_handle

KERNEL = KERNELS["paged_decode"]
VERIFY_KERNEL = KERNELS["paged_verify"]
#: verify-window rows per slot, and query rows per (slot, KV head), that K4
#: is built for
MAX_K1, MAX_VERIFY_ROWS = 8, 64


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


def _check_pool(name: str, q: torch.Tensor, pool_k: torch.Tensor,
                pool_v: torch.Tensor, tab: torch.Tensor, hd: int) -> tuple:
    """Argument checks shared by K2 and K4: bf16 CUDA tensors, contiguous
    16-byte aligned q and pools, head_dim 64 or 128, page a multiple of 64,
    an int32 [B, m] table with unit column stride. Returns (page, NKV)."""
    b = q.shape[0]
    if pool_k.dim() != 4 or pool_k.shape != pool_v.shape:
        raise ValueError(f"{name}: pools {tuple(pool_k.shape)} / "
                         f"{tuple(pool_v.shape)} must match")
    _, page, nkv, phd = pool_k.shape
    for arg, x in (("q", q), ("pool_k", pool_k), ("pool_v", pool_v)):
        if x.device != q.device or x.device.type != "cuda":
            raise ValueError(f"{name}: {arg} on {x.device}, expected the "
                             "CUDA device of q")
        if x.dtype != torch.bfloat16:
            raise ValueError(f"{name}: {arg} is {x.dtype}; the kernel takes "
                             "bfloat16")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} is not contiguous and 16-byte "
                             "aligned")
    if phd != hd or hd not in (64, 128):
        raise ValueError(f"{name}: head_dim {hd} (pool {phd}); the kernel "
                         "takes 64 or 128")
    if page % 64:
        raise ValueError(f"{name}: page size {page} is not a multiple of 64")
    if (tab.dim() != 2 or tab.shape[0] != b or tab.dtype != torch.int32
            or tab.device != q.device or tab.stride(1) != 1
            or tab.shape[1] < 1):
        raise ValueError(f"{name}: tab must be an int32 [B, m] tensor with "
                         f"unit column stride on {q.device}")
    return page, nkv


def _check_rows(name: str, x: torch.Tensor, b: int, device) -> None:
    if (tuple(x.shape) != (b,) or x.dtype != torch.int32
            or x.device != device or not x.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous int32 [{b}] tensor "
                         f"on {device}")


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
    page, nkv = _check_pool("paged_decode", q, pool_k, pool_v, tab, hd)
    if nh % nkv or nh // nkv > 8:
        raise ValueError(f"paged_decode: NH={nh}, NKV={nkv}; needs NH a "
                         "multiple of NKV with at most 8 query rows per "
                         "KV head")
    _check_rows("paged_decode: lengths", lengths, b, q.device)
    scale = (hd ** -0.5) if scale is None else float(scale)
    out = torch.empty_like(q)
    KERNEL.launch(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), tab.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), b, nh, nkv, hd, page,
        tab.shape[1], tab.stride(0), scale, stream_handle(q.device))
    return out


def decode_verify_attend_paged_plain(q, pool_k, pool_v, tab, starts, *,
                                     scale: Optional[float] = None
                                     ) -> torch.Tensor:
    """The JAX gather + masked XLA path: gather the m attended pages, row j
    of slot b sees gathered rows ``[0, starts[b] + j + 1)`` (so at most the
    m * page gathered rows), softmax and PV in fp32."""
    b, k1, nh, hd = q.shape
    groups = nh // pool_k.shape[2]
    scale = (hd ** -0.5) if scale is None else float(scale)
    k = gather_pages(pool_k, tab).repeat_interleave(groups, dim=2)
    v = gather_pages(pool_v, tab).repeat_interleave(groups, dim=2)
    logits = torch.einsum("bjnh,bpnh->bnjp", q.float(), k.float()) * scale
    pos = torch.arange(k.shape[1], device=q.device)[None, None, None, :]
    limit = (starts.long()[:, None]
             + torch.arange(k1, device=q.device)[None, :] + 1)[:, None, :,
                                                                None]
    logits = logits.masked_fill(pos >= limit, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bnjp,bpnh->bjnh", p, v.float())
    return out.to(q.dtype)


def decode_verify_attend_paged(
    q: torch.Tensor,          # [B, K1, NH, Hd]: [last, draft_1..draft_K]
    pool_k: torch.Tensor,     # [P, page, NKV, Hd]; rows starts..starts+K1-1
    pool_v: torch.Tensor,     #   of each slot already written
    tab: torch.Tensor,        # [B, m] int32 page ids (may be a column slice)
    starts: torch.Tensor,     # [B] int32 absolute pool row of q[:, 0]
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Speculative verify-window attention against the page pool: row j of
    slot b attends rows ``[0, starts[b] + j + 1)`` through the slot's table,
    clamped to its ``m * page`` rows. Returns [B, K1, NH, Hd]."""
    if q.device.type == "cpu":
        return decode_verify_attend_paged_plain(q, pool_k, pool_v, tab,
                                                starts, scale=scale)
    if q.dim() != 4:
        raise ValueError(f"paged_verify: q {tuple(q.shape)} is not "
                         "[B, K1, NH, Hd]")
    b, k1, nh, hd = q.shape
    page, nkv = _check_pool("paged_verify", q, pool_k, pool_v, tab, hd)
    if (nh % nkv or not 1 <= k1 <= MAX_K1
            or nh // nkv * k1 > MAX_VERIFY_ROWS):
        raise ValueError(f"paged_verify: NH={nh}, NKV={nkv}, K1={k1}; needs "
                         f"NH a multiple of NKV, K1 <= {MAX_K1} and "
                         f"(NH / NKV) * K1 <= {MAX_VERIFY_ROWS}")
    _check_rows("paged_verify: starts", starts, b, q.device)
    scale = (hd ** -0.5) if scale is None else float(scale)
    out = torch.empty_like(q)
    VERIFY_KERNEL.launch(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), tab.data_ptr(),
        starts.data_ptr(), out.data_ptr(), b, k1, nh, nkv, hd, page,
        tab.shape[1], tab.stride(0), scale, stream_handle(q.device))
    return out
