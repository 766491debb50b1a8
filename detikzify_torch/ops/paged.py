"""Kernels K2 and K4: attention read straight from the page pool
(``csrc/paged_decode.cu``, ``csrc/paged_verify.cu``).

Ports of the Pallas TPU kernels in ``detikzify_tpu/ops/paged.py``. The
decode engine's KV cache is one page POOL ``[P, page, NKV, Hd]`` per layer;
slot b's row r lives in page ``tab[b, r // page]``. Both kernels read pages
through the table (zero-copy):

  * K2 ``decode_attend_paged`` (``decode_attend_paged_pallas``): one query
    row per slot; plain version: gather the attended pages into a contiguous
    view (``gather_pages``) and run ``decode_attend_plain``. The kernel
    splits each slot's rows into blocks of ``SPLIT_ROWS`` and merges their
    fp32 partials; ``merge_partials`` and ``decode_attend_paged_split``
    repeat that arithmetic in PyTorch for the tests;
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
#: rows of one (slot, KV head) per K2 block, and the most blocks per slot
#: (``SPLIT``, ``MAX_SPLITS`` in decode_split.cuh)
SPLIT_ROWS, MAX_SPLITS = 128, 256
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


def decode_attend_paged_split(q, pool_k, pool_v, tab, lengths, *,
                              split: int = SPLIT_ROWS,
                              scale: Optional[float] = None) -> torch.Tensor:
    """K2's arithmetic in PyTorch (for the tests): each slot's rows, its
    length clamped to ``[0, m * page]``, cut into splits of ``split`` rows;
    a split at or past the length adds nothing (m = -inf), a live one gives
    (max, sum, acc) over its rows below the length in fp32; then
    ``merge_partials``. Returns [B, NH, Hd] in q.dtype."""
    b, nh, hd = q.shape
    nkv = pool_k.shape[2]
    g = nh // nkv
    scale = (hd ** -0.5) if scale is None else float(scale)
    k = gather_pages(pool_k, tab).float()              # [B, L, NKV, Hd]
    v = gather_pages(pool_v, tab).float()
    n_rows = k.shape[1]
    length = lengths.long().clamp(0, n_rows)
    qg = q.float().reshape(b, nkv, g, hd)
    logits = torch.einsum("bngh,blnh->bngl", qg, k) * scale
    rows = torch.arange(n_rows, device=q.device)
    logits = logits.masked_fill(~(rows[None, :] < length[:, None])[:, None,
                                                                   None],
                                NEG_INF)
    ms, ls, accs = [], [], []
    for r0 in range(0, n_rows, split):
        x = logits[..., r0:r0 + split]
        mx = x.amax(dim=-1)
        p = torch.exp(x - mx[..., None])
        dead = (length <= r0)[:, None, None]
        ms.append(mx.masked_fill(dead, float("-inf")))
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bngl,blnh->bngh", p, v[:, r0:r0 + split]))
    out = merge_partials(torch.stack(ms, -1), torch.stack(ls, -1),
                         torch.stack(accs, -2))
    return out.reshape(b, nh, hd).to(q.dtype)


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
    m = tab.shape[1]
    # fp32 partials of every split the table allows; sized from m alone, so
    # the host never reads lengths
    n_split = -(-m * page // SPLIT_ROWS)
    if n_split > MAX_SPLITS:
        raise ValueError(f"paged_decode: a table of {m} pages of {page} rows "
                         f"exceeds {MAX_SPLITS * SPLIT_ROWS} rows")
    scratch = torch.empty(b * nh * n_split * (hd + 2), dtype=torch.float32,
                          device=q.device)
    out = torch.empty_like(q)
    KERNEL.launch(
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
    out = torch.empty_like(q)
    VERIFY_KERNEL.launch(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), tab.data_ptr(),
        starts.data_ptr(), out.data_ptr(), b, k1, nh, nkv, hd, page,
        tab.shape[1], tab.stride(0), scale, stream_handle(q.device))
    return out
