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

Both run on the split-and-merge body of ``csrc/decode_split.cuh``, which
K3 (``ops.decode_flash``) shares: each slot's keys are cut into blocks of
``SPLIT_ROWS`` whose fp32 partials a second kernel merges, in scratch that
the wrappers allocate. ``split_attend`` repeats that arithmetic in PyTorch
with a key limit per query row, and ``decode_attend_contiguous_split``
(K3), ``decode_attend_paged_split`` (K2) and
``decode_verify_attend_paged_split`` (K4) apply it for the tests.

Both kernels take bf16 pools and float32 pools (the ``*_f32`` entry
points: every product an fp32 FFMA, P kept in fp32), at head_dim 32, 64
or 128 (``SPLIT_HEAD_DIMS``). The JAX kernels read pools of any dtype;
the JAX package sends head_dim 32 to XLA, the port to the same kernels.

A tensor on the CPU takes the plain version, a CUDA tensor launches the
kernel or raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from .attention import NEG_INF, decode_attend_plain
from .cuda import (KERNELS, SPLIT_HEAD_DIMS, SPLIT_ROWS, split_scratch,
                   stream_handle)

KERNEL = KERNELS["paged_decode"]
KERNEL_F32 = KERNELS["paged_decode_f32"]
VERIFY_KERNEL = KERNELS["paged_verify"]
VERIFY_KERNEL_F32 = KERNELS["paged_verify_f32"]
#: pool dtypes K2 and K4 take
DTYPES = (torch.bfloat16, torch.float32)
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


def merge_partials(m: torch.Tensor, l: torch.Tensor,
                   acc: torch.Tensor) -> torch.Tensor:
    """Combine split-softmax partials: m, l [..., n] (a split's max and
    sum of exp(x - max); m = -inf for a split with nothing to add) and
    acc [..., n, H] (its unnormalised P V) -> [..., H], in fp32, summed in
    split order: sum_s w_s acc_s / max(sum_s w_s l_s, 1e-30) with
    w_s = exp(m_s - max_s m_s), as the merge kernels compute it."""
    dead = m == float("-inf")          # never read, as in the kernels
    w = torch.exp(m - m.amax(dim=-1, keepdim=True)).masked_fill(dead, 0.0)
    den = (w * l.masked_fill(dead, 0.0)).sum(dim=-1).clamp_min(1e-30)
    num = (w[..., None] * acc.masked_fill(dead[..., None], 0.0)).sum(dim=-2)
    return num / den[..., None]


def split_attend(q_rows: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 limits: torch.Tensor, *, split: int = SPLIT_ROWS,
                 scale: float) -> torch.Tensor:
    """The split body's arithmetic in PyTorch (for the tests): q_rows
    [B, NKV, R, Hd] against k, v [B, L, NKV, Hd], query row r of slot b
    seeing keys ``[0, limits[b, r])``. The keys are cut into splits of
    ``split`` rows; in each split a row that sees no key adds nothing
    (m = -inf), the others give (max, sum, acc) over the keys they see, in
    fp32; then ``merge_partials``. Returns [B, NKV, R, Hd] in fp32."""
    n_rows = k.shape[1]
    logits = torch.einsum("bnrh,blnh->bnrl", q_rows.float(), k.float()) * scale
    pos = torch.arange(n_rows, device=q_rows.device)
    seen = pos[None, None, :] < limits.long()[:, :, None]     # [B, R, L]
    logits = logits.masked_fill(~seen[:, None], NEG_INF)
    ms, ls, accs = [], [], []
    for r0 in range(0, n_rows, split):
        x = logits[..., r0:r0 + split]
        mx = x.amax(dim=-1)
        p = torch.exp(x - mx[..., None])
        dead = ~seen[:, None, :, r0:r0 + split].any(dim=-1)
        ms.append(mx.masked_fill(dead, float("-inf")))
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bnrl,blnh->bnrh", p,
                                 v[:, r0:r0 + split].float()))
    return merge_partials(torch.stack(ms, -1), torch.stack(ls, -1),
                          torch.stack(accs, -2))


def decode_attend_contiguous_split(q, k_cache, v_cache, lengths, *,
                                   split: int = SPLIT_ROWS,
                                   scale: Optional[float] = None
                                   ) -> torch.Tensor:
    """K3's arithmetic (and K2's on gathered pages): the G query rows of
    each KV head all see the slot's length, clamped to ``[0, L]``.
    Returns [B, NH, Hd] in q.dtype."""
    b, nh, hd = q.shape
    n_rows, nkv = k_cache.shape[1], k_cache.shape[2]
    g = nh // nkv
    scale = (hd ** -0.5) if scale is None else float(scale)
    limits = lengths.long().clamp(0, n_rows)[:, None].expand(b, g)
    out = split_attend(q.reshape(b, nkv, g, hd), k_cache, v_cache, limits,
                       split=split, scale=scale)
    return out.reshape(b, nh, hd).to(q.dtype)


def decode_attend_paged_split(q, pool_k, pool_v, tab, lengths, *,
                              split: int = SPLIT_ROWS,
                              scale: Optional[float] = None) -> torch.Tensor:
    """K2's arithmetic: ``decode_attend_contiguous_split`` on the gathered
    pages, lengths clamped to ``[0, m * page]``. Returns [B, NH, Hd]."""
    return decode_attend_contiguous_split(
        q, gather_pages(pool_k, tab), gather_pages(pool_v, tab), lengths,
        split=split, scale=scale)


def decode_verify_attend_paged_split(q, pool_k, pool_v, tab, starts, *,
                                     split: int = SPLIT_ROWS,
                                     scale: Optional[float] = None
                                     ) -> torch.Tensor:
    """K4's arithmetic: query rows r = g * K1 + j of each KV head, row j
    seeing keys ``[0, min(max(start, 0) + j + 1, m * page))``. Returns
    [B, K1, NH, Hd] in q.dtype."""
    b, k1, nh, hd = q.shape
    nkv = pool_k.shape[2]
    g = nh // nkv
    scale = (hd ** -0.5) if scale is None else float(scale)
    k = gather_pages(pool_k, tab)
    v = gather_pages(pool_v, tab)
    j = torch.arange(k1, device=q.device)
    lim = (starts.long().clamp_min(0)[:, None] + j[None] + 1).clamp_max(
        k.shape[1])                                          # [B, K1]
    limits = lim[:, None, :].expand(b, g, k1).reshape(b, g * k1)
    q_rows = q.reshape(b, k1, nkv, g, hd).permute(0, 2, 3, 1, 4).reshape(
        b, nkv, g * k1, hd)
    out = split_attend(q_rows, k, v, limits, split=split, scale=scale)
    out = out.reshape(b, nkv, g, k1, hd).permute(0, 3, 1, 2, 4)
    return out.reshape(b, k1, nh, hd).to(q.dtype)


def _check_pool(name: str, q: torch.Tensor, pool_k: torch.Tensor,
                pool_v: torch.Tensor, tab: torch.Tensor, hd: int) -> tuple:
    """Argument checks shared by K2 and K4: CUDA tensors of one dtype in
    ``DTYPES``, contiguous 16-byte aligned q and pools, head_dim in
    ``SPLIT_HEAD_DIMS``, page a multiple of 64, an int32 [B, m] table with
    unit column stride. Returns (page, NKV)."""
    b = q.shape[0]
    if pool_k.dim() != 4 or pool_k.shape != pool_v.shape:
        raise ValueError(f"{name}: pools {tuple(pool_k.shape)} / "
                         f"{tuple(pool_v.shape)} must match")
    _, page, nkv, phd = pool_k.shape
    for arg, x in (("q", q), ("pool_k", pool_k), ("pool_v", pool_v)):
        if x.device != q.device or x.device.type != "cuda":
            raise ValueError(f"{name}: {arg} on {x.device}, expected the "
                             "CUDA device of q")
        if x.dtype not in DTYPES or x.dtype != q.dtype:
            raise ValueError(f"{name}: {arg} is {x.dtype}, q {q.dtype}; the "
                             "kernel takes bfloat16 or float32, one dtype")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} is not contiguous and 16-byte "
                             "aligned")
    if phd != hd or hd not in SPLIT_HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {hd} (pool {phd}); the kernel "
                         f"takes {SPLIT_HEAD_DIMS}")
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
    m = tab.shape[1]
    scratch = split_scratch(b * nh, m * page, hd, q.device)
    out = torch.empty_like(q)
    (KERNEL_F32 if q.dtype == torch.float32 else KERNEL).launch(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), tab.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        scratch.numel(), b, nh, nkv, hd, page, m, tab.stride(0), scale,
        stream_handle(q.device))
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
    m = tab.shape[1]
    scratch = split_scratch(b * k1 * nh, m * page, hd, q.device)
    out = torch.empty_like(q)
    kernel = VERIFY_KERNEL_F32 if q.dtype == torch.float32 else VERIFY_KERNEL
    kernel.launch(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), tab.data_ptr(),
        starts.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        scratch.numel(), b, k1, nh, nkv, hd, page, m, tab.stride(0), scale,
        stream_handle(q.device))
    return out
