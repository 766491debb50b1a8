"""Attention: the plain PyTorch versions, and the contiguous decode
dispatcher.

Counterpart of ``detikzify_tpu/ops/attention.py``:

  * ``attend_plain``        -- copy of the JAX ``attend_xla``: the plain
                               version of kernel K1 (``ops.flash``);
  * ``decode_attend_plain`` -- copy of the XLA branch of ``decode_attend``:
                               the plain version of kernel K3
                               (``ops.decode_flash``) and, with
                               ``ops.paged.gather_pages``, of kernel K2;
  * ``decode_attend``       -- the JAX dispatcher: CPU tensors take
                               ``decode_attend_plain``, CUDA tensors launch
                               K3 at every cache length.

The JAX ``attend`` dispatcher has one counterpart here, the kernel wrapper
``ops.flash.flash_attention``: CPU tensors take ``attend_plain``, CUDA
tensors launch K1.

Softmax runs in fp32 whatever the input dtype; probabilities are cast to
the value dtype before the PV product, as in the JAX package.
"""
from __future__ import annotations

from typing import Optional

import torch

from .decode_flash import decode_attend_contiguous

#: mask sentinel shared with the JAX package (``ops/pallas_common.py``):
#: large-negative but finite, so masked rows never produce inf - inf
NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, T, NKV, H] -> [B, T, NKV*n_rep, H] (GQA broadcast)."""
    if n_rep == 1:
        return x
    b, t, nkv, h = x.shape
    return x[:, :, :, None, :].expand(b, t, nkv, n_rep, h).reshape(
        b, t, nkv * n_rep, h)


def attend_plain(
    q: torch.Tensor,                      # [B, S, NH, Hd]
    k: torch.Tensor,                      # [B, T, NKV, Hd]
    v: torch.Tensor,                      # [B, T, NKV, Hd]
    *,
    causal: bool = False,
    kv_mask: Optional[torch.Tensor] = None,    # [B, T] bool, True = valid
    scale: Optional[float] = None,
    q_offsets: Optional[torch.Tensor] = None,  # [B] causal offset per batch
    kv_limits: Optional[torch.Tensor] = None,  # [B] valid-key bound per batch
) -> torch.Tensor:
    """Reference attention. Returns [B, S, NH, Hd] in q.dtype."""
    if kv_limits is not None and q_offsets is None:
        raise ValueError("kv_limits requires q_offsets "
                         "(pass zeros for offset-free bounds)")
    b, s, nh, hd = q.shape
    t, nkv = k.shape[1], k.shape[2]
    k = _repeat_kv(k, nh // nkv)
    v = _repeat_kv(v, nh // nkv)
    scale = (hd ** -0.5) if scale is None else scale

    logits = torch.einsum("bsnh,btnh->bnst", q.float(), k.float()) * scale
    if kv_mask is not None:
        logits = logits.masked_fill(~kv_mask[:, None, None, :], NEG_INF)
    if q_offsets is not None:
        # per-batch causal window: key t visible to query i iff
        # t <= q_offsets[b] + i and t < kv_limits[b] (offset prefill)
        ar_s = torch.arange(s, device=q.device)
        ar_t = torch.arange(t, device=q.device)
        qpos = q_offsets[:, None, None, None] + ar_s[None, None, :, None]
        kpos = ar_t[None, None, None, :]
        visible = kpos <= qpos
        if kv_limits is not None:
            visible = visible & (kpos < kv_limits[:, None, None, None])
        logits = logits.masked_fill(~visible, NEG_INF)
    if causal:
        # queries are the last s positions of the t-long key sequence
        qpos = torch.arange(s, device=q.device)[:, None] + (t - s)
        kpos = torch.arange(t, device=q.device)[None, :]
        logits = logits.masked_fill(~(kpos <= qpos)[None, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bnst,btnh->bsnh", probs, v.to(q.dtype))


def decode_attend_plain(
    q: torch.Tensor,          # [B, NH, Hd] -- one new token per slot
    k_cache: torch.Tensor,    # [B, L, NKV, Hd]
    v_cache: torch.Tensor,    # [B, L, NKV, Hd]
    lengths: torch.Tensor,    # [B] int -- valid rows per slot (incl. new)
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-token decode attention over a contiguous cache (the XLA
    branch of the JAX ``decode_attend``)."""
    b, nh, hd = q.shape
    nkv = k_cache.shape[2]
    scale = (hd ** -0.5) if scale is None else scale
    groups = nh // nkv

    qg = q.reshape(b, nkv, groups, hd)
    logits = torch.einsum("bngh,blnh->bngl", qg.float(),
                          k_cache.float()) * scale           # [B, NKV, G, L]
    valid = (torch.arange(k_cache.shape[1], device=q.device)[None, :]
             < lengths[:, None])                             # [B, L]
    logits = logits.masked_fill(~valid[:, None, None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bngl,blnh->bngh", probs.to(v_cache.dtype), v_cache)
    return out.reshape(b, nh, hd).to(q.dtype)


def decode_attend(
    q: torch.Tensor,          # [B, NH, Hd] -- one new token per slot
    k_cache: torch.Tensor,    # [B, L, NKV, Hd] (may be a [:, :kv_limit] view)
    v_cache: torch.Tensor,
    lengths: torch.Tensor,    # [B] int32 -- valid rows per slot (incl. new)
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-token decode attention over a contiguous KV cache: the plain
    version for CPU tensors, kernel K3 for CUDA tensors (or it raises)."""
    if q.device.type == "cpu":
        return decode_attend_plain(q, k_cache, v_cache, lengths, scale=scale)
    return decode_attend_contiguous(q, k_cache, v_cache, lengths,
                                    scale=scale)
