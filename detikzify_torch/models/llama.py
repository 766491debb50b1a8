"""LLaMA-family decoder (counterpart of ``detikzify_tpu/models/llama.py``).

Entry points:

  * ``forward``            -- full-sequence causal pass (evaluation / loss);
  * ``prefill``            -- offset prefill of a token block into a
                              contiguous ``KVCache`` (attention: the
                              per-batch window of kernel K1);
  * ``decode_step``        -- one token for every slot over a contiguous
                              ``KVCache``, attending at most ``kv_limit``
                              rows in place (kernel K3);
  * ``prefill_paged``      -- offset prefill of a token block against the
                              engine's page pool: restored prefix pages are
                              gathered into a per-layer work cache, attention
                              is the per-batch window of kernel K1, and the
                              tail plus at most one copy-on-write boundary
                              page are written back through the page table;
  * ``decode_step_paged``  -- one token for every slot, zero-copy: K/V rows
                              are written into the pool through the page
                              table and attention reads the pool through it
                              (kernel K2). This is the JAX package's
                              ``_decode_step_paged_zerocopy``;
  * ``verify_step_paged_zerocopy`` -- the speculative verify forward of
                              K+1 tokens per slot, zero-copy: rows written
                              through the page table, attention by the
                              verify-window kernel K4.

Projections may be int8 (``ops.quant.QuantLinear``, kernel K5 in the
decode regime) and q/k/v and gate/up may be fused (``fuse_projections``);
the layer bodies take either layout.

The pool is ``PagedKV [L, P, page, NKV, Hd]``; rows at or beyond the
engine's ``trash_row`` are written to the shared trash page, never through
a (possibly stale) page table -- do not simplify that routing. Where JAX
donated the cache or pool buffers, the port updates them in place. The
contiguous writes clamp their start into the cache as
``jax.lax.dynamic_update_slice`` does.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..config import TextConfig
from ..ops.attention import decode_attend
from ..ops.flash import flash_attention
from ..ops.paged import decode_attend_paged, decode_verify_attend_paged
from ..ops.quant import QuantLinear
from ..ops.quant_matmul import int8_matmul, matmul_f32
from .layers import (ACTIVATIONS, RMSNorm, apply_remat, apply_rope, linear,
                     rms_norm, rope_cos_sin, rope_inv_freq, run_layer)


class Attention(nn.Module):
    def __init__(self, cfg: TextConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d, hd = cfg.hidden_size, cfg.head_dim
        nh, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
        bias = cfg.attention_bias
        # this rank's head counts (``parallel.mesh.place_params`` lowers
        # them to its shard on a model axis)
        self.heads, self.head_dim = (nh, nkv), hd
        self.q = nn.Linear(d, nh * hd, bias=bias, **kw)
        self.k = nn.Linear(d, nkv * hd, bias=bias, **kw)
        self.v = nn.Linear(d, nkv * hd, bias=bias, **kw)
        self.o = nn.Linear(nh * hd, d, bias=False, **kw)


class MLP(nn.Module):
    def __init__(self, cfg: TextConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=dtype)
        d, i = cfg.hidden_size, cfg.intermediate_size
        self.gate = nn.Linear(d, i, **kw)
        self.up = nn.Linear(d, i, **kw)
        self.down = nn.Linear(i, d, **kw)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: TextConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.input_ln = RMSNorm(cfg.hidden_size, **kw)
        self.attn = Attention(cfg, **kw)
        self.post_ln = RMSNorm(cfg.hidden_size, **kw)
        self.mlp = MLP(cfg, **kw)


class Llama(nn.Module):
    def __init__(self, cfg: TextConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.embed_tokens = nn.Parameter(torch.zeros(
            cfg.vocab_size, cfg.hidden_size, **kw))
        self.layers = nn.ModuleList(DecoderLayer(cfg, **kw)
                                    for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, **kw)
        self.lm_head = (None if cfg.tie_word_embeddings else
                        nn.Linear(cfg.hidden_size, cfg.vocab_size,
                                  bias=False, **kw))


def embed(params: Llama, token_ids: torch.Tensor) -> torch.Tensor:
    """Token embeddings; over a model axis the table is split over hidden
    (``embed_tp``) and the rows are gathered."""
    x = params.embed_tokens[token_ids.long()]
    tp = getattr(params, "embed_tp", None)
    return x if tp is None else tp.gather(x)


def unembed(params: Llama, hidden: torch.Tensor) -> torch.Tensor:
    """Final-norm'd hidden -> fp32 logits, accumulated in fp32 and never
    rounded through bf16 (JAX ``preferred_element_type=float32``). An int8
    head is K5's product with an fp32 output. Over a model axis a head
    split over the vocabulary gathers its logits; a tied head contracts
    this rank's hidden columns with its slice of the embedding and sums
    the partial logits."""
    head = params.lm_head
    role = getattr(head, "tp_role", None)
    if head is None and getattr(params, "embed_tp", None) is not None:
        tp = params.embed_tp
        w = params.embed_tokens
        part = tp.enter(hidden)[..., tp.rank * w.shape[1]:
                                (tp.rank + 1) * w.shape[1]]
        return tp.reduce(matmul_f32(part, w))
    if role is not None:
        hidden = role.tp.enter(hidden)
    if isinstance(head, QuantLinear):
        logits = int8_matmul(hidden, head.q, head.scale,
                             out_dtype=torch.float32)
    else:
        logits = matmul_f32(hidden, head.weight if head is not None
                            else params.embed_tokens)
    return logits if role is None else role.tp.gather(logits)


def kv_heads(params: Llama) -> int:
    """The KV heads this rank's page pool holds (all of them unless the
    weights are placed over a model axis)."""
    return params.layers[0].attn.heads[1]


def _qkv(lp: DecoderLayer, x: torch.Tensor, cfg: TextConfig, cos, sin):
    """Rotated q, k and v from separate q/k/v projections or from one
    fused ``qkv`` (``ops.quant.fuse_projections``)."""
    lead = x.shape[:-1]            # [B, S] full-seq / [B] decode
    (nh, nkv), hd = lp.attn.heads, lp.attn.head_dim   # this rank's
    if hasattr(lp.attn, "qkv"):
        q, k, v = torch.split(linear(lp.attn.qkv, x),
                              [nh * hd, nkv * hd, nkv * hd], dim=-1)
    else:
        q, k, v = (linear(lp.attn.q, x), linear(lp.attn.k, x),
                   linear(lp.attn.v, x))
    q = q.reshape(*lead, nh, hd)
    k = k.reshape(*lead, nkv, hd)
    v = v.reshape(*lead, nkv, hd)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _mlp(lp: DecoderLayer, x: torch.Tensor, act) -> torch.Tensor:
    if hasattr(lp.mlp, "gateup"):
        gate, up = linear(lp.mlp.gateup, x).chunk(2, dim=-1)
    else:
        gate, up = linear(lp.mlp.gate, x), linear(lp.mlp.up, x)
    return linear(lp.mlp.down, act(gate) * up)


def _inv_freq(cfg: TextConfig, device) -> torch.Tensor:
    return rope_inv_freq(cfg.head_dim, cfg.rope_theta, cfg.rope_scaling,
                         device=device)


# ---------------------------------------------------------------------------
# full-sequence forward
# ---------------------------------------------------------------------------

def forward(params: Llama, cfg: TextConfig, inputs_embeds: torch.Tensor, *,
            positions: Optional[torch.Tensor] = None,
            attention_mask: Optional[torch.Tensor] = None,
            remat=False) -> torch.Tensor:
    """Causal full-sequence pass; returns final-norm'd hidden [B, S, D].

    ``remat`` (False | True | "dots") recomputes each layer in the backward
    (``layers.apply_remat``): activation memory of one layer, not of all."""
    b, s, _ = inputs_embeds.shape
    dev = inputs_embeds.device
    act = ACTIVATIONS[cfg.hidden_act]
    if positions is None:
        if attention_mask is not None:
            positions = (attention_mask.to(torch.int32).cumsum(-1) - 1
                         ).clamp(min=0)
        else:
            positions = torch.arange(s, device=dev)[None].expand(b, s)
    cos, sin = rope_cos_sin(positions, _inv_freq(cfg, dev))

    def block(x, lp):
        h = rms_norm(lp.input_ln, x, cfg.rms_norm_eps)
        q, k, v = _qkv(lp, h, cfg, cos, sin)
        h = flash_attention(q, k, v.contiguous(), causal=True,
                            kv_mask=attention_mask)
        x = x + linear(lp.attn.o, h.reshape(b, s, -1))
        h = rms_norm(lp.post_ln, x, cfg.rms_norm_eps)
        return x + _mlp(lp, h, act)

    block = apply_remat(block, remat)
    x = inputs_embeds
    for lp in params.layers:
        x = run_layer(block, lp, x, lp)
    return rms_norm(params.norm, x, cfg.rms_norm_eps)


# ---------------------------------------------------------------------------
# contiguous KV cache: prefill and decode
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor  # [n_layers, B, T, n_kv_heads, head_dim]
    v: torch.Tensor

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    @property
    def batch(self) -> int:
        return self.k.shape[1]


def init_cache(cfg: TextConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> KVCache:
    shape = (cfg.num_hidden_layers, batch, max_len,
             cfg.num_key_value_heads, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def _write_block(cache_x: torch.Tensor, new: torch.Tensor,
                 start: torch.Tensor) -> None:
    """cache_x [B, T, N, H] <- new [B, S, N, H] at rows start[b] .. +S, in
    place. The start is clamped into [0, T - S], as
    ``jax.lax.dynamic_update_slice`` clamps it: a block that would run past
    the cache lands on its last S rows."""
    b, s = new.shape[:2]
    s0 = start.long().clamp(0, cache_x.shape[1] - s)
    rows = s0[:, None] + torch.arange(s, device=new.device)[None, :]
    cache_x[torch.arange(b, device=new.device)[:, None], rows] = \
        new.to(cache_x.dtype)


def prefill(
    params: Llama,
    cfg: TextConfig,
    inputs_embeds: torch.Tensor,     # [B, S, D]
    start: torch.Tensor,             # [B] int32 -- write offset per slot
    seq_len: torch.Tensor,           # [B] int32 -- valid tokens in block
    cache: KVCache,
) -> Tuple[torch.Tensor, KVCache]:
    """Process a (padded) token block against ``cache[:, :, :start]`` plus
    causal attention within the block (K1's per-batch window: key t is
    visible to query i iff ``t <= start + i and t < start + seq_len``).
    Invalid tail rows (i >= seq_len) are written too and stay masked.
    Returns (hidden [B, S, D], cache updated in place)."""
    b, s, _ = inputs_embeds.shape
    dev = inputs_embeds.device
    act = ACTIVATIONS[cfg.hidden_act]
    start = start.to(torch.int32)
    positions = start[:, None] + torch.arange(s, device=dev)[None, :]
    cos, sin = rope_cos_sin(positions, _inv_freq(cfg, dev))
    q_offsets = start.contiguous()
    kv_limits = (start + seq_len.to(torch.int32)).contiguous()
    x = inputs_embeds
    for li, lp in enumerate(params.layers):
        h = rms_norm(lp.input_ln, x, cfg.rms_norm_eps)
        q, k, v = _qkv(lp, h, cfg, cos, sin)
        kc, vc = cache.k[li], cache.v[li]
        _write_block(kc, k, start)
        _write_block(vc, v, start)
        h = flash_attention(q, kc, vc, q_offsets=q_offsets,
                            kv_limits=kv_limits)
        x = x + linear(lp.attn.o, h.reshape(b, s, -1))
        h = rms_norm(lp.post_ln, x, cfg.rms_norm_eps)
        x = x + _mlp(lp, h, act)
    return rms_norm(params.norm, x, cfg.rms_norm_eps), cache


def decode_step(
    params: Llama,
    cfg: TextConfig,
    inputs_embeds: torch.Tensor,     # [B, D] -- the newest token's embedding
    positions: torch.Tensor,         # [B] int32 -- its position
    cache: KVCache,
    kv_limit: Optional[int] = None,  # attend rows [0, kv_limit) only
) -> Tuple[torch.Tensor, KVCache]:
    """One decode step for all slots; returns (hidden [B, D], cache updated
    in place). ``kv_limit`` bounds the ATTENDED rows: attention (kernel K3)
    reads the view ``kc[:, :kv_limit]`` in place with lengths clamped to
    it, while writes land in the full cache. Callers guarantee every
    attending slot's position < kv_limit."""
    act = ACTIVATIONS[cfg.hidden_act]
    dev = inputs_embeds.device
    positions = positions.to(torch.int32)
    cos, sin = rope_cos_sin(positions, _inv_freq(cfg, dev))
    lengths = positions + 1
    limit = cache.max_len
    if kv_limit is not None and kv_limit < limit:
        limit = kv_limit
        lengths = lengths.clamp(max=kv_limit)
    lengths = lengths.contiguous()
    x = inputs_embeds
    for li, lp in enumerate(params.layers):
        h = rms_norm(lp.input_ln, x, cfg.rms_norm_eps)
        q, k, v = _qkv(lp, h, cfg, cos, sin)
        kc, vc = cache.k[li], cache.v[li]
        _write_block(kc, k[:, None], positions)
        _write_block(vc, v[:, None], positions)
        h = decode_attend(q, kc[:, :limit], vc[:, :limit], lengths)
        x = x + linear(lp.attn.o, h.reshape(x.shape[0], -1))
        h = rms_norm(lp.post_ln, x, cfg.rms_norm_eps)
        x = x + _mlp(lp, h, act)
    return rms_norm(params.norm, x, cfg.rms_norm_eps), cache


# ---------------------------------------------------------------------------
# paged KV cache: shared page pool + per-slot page tables
# ---------------------------------------------------------------------------

class PagedKV(NamedTuple):
    k: torch.Tensor  # [n_layers, n_pages, page, n_kv_heads, head_dim]
    v: torch.Tensor

    @property
    def page(self) -> int:
        return self.k.shape[2]

    @property
    def n_pages(self) -> int:
        return self.k.shape[1]


def init_paged_cache(cfg: TextConfig, n_pages: int, page: int,
                     dtype=torch.bfloat16, device="cuda",
                     kv_heads: Optional[int] = None) -> PagedKV:
    """The page pool of ``kv_heads`` KV heads (the config's by default;
    a rank of a model axis holds its own, ``kv_heads(params)``)."""
    shape = (cfg.num_hidden_layers, n_pages, page,
             kv_heads or cfg.num_key_value_heads, cfg.head_dim)
    return PagedKV(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def _scatter_rows(pool_x: torch.Tensor, src: torch.Tensor,
                  rows: torch.Tensor, write_tab: torch.Tensor, page: int,
                  trash_row: Optional[int] = None,
                  trash_page: Optional[int] = None) -> None:
    """Write src [B, R, N, H] (one layer) at absolute token rows ``rows``
    [B, R] of each slot, through its ``write_tab`` [B, m_cap] page table,
    into ``pool_x`` [P, page, N, H] in place.

    Rows at or beyond ``trash_row`` (the engine's trash block) write to the
    shared ``trash_page`` instead of dereferencing the table: a RELEASED
    slot's stale table must never be written through. Without a trash
    config, rows beyond the allocation clamp to the slot's last row."""
    m_cap = write_tab.shape[1]
    entry = (rows // page).clamp(0, m_cap - 1)
    pid = torch.gather(write_tab, 1, entry)
    rid = rows % page
    if trash_row is not None:
        pid = torch.where(rows >= trash_row,
                          torch.full_like(pid, trash_page), pid)
    else:
        overflow = rows >= m_cap * page
        pid = torch.where(overflow, write_tab[:, -1:].expand_as(pid), pid)
        rid = torch.where(overflow, torch.full_like(rid, page - 1), rid)
    pool_x[pid.long(), rid.long()] = src.to(pool_x.dtype)


def prefill_paged(
    params: Llama,
    cfg: TextConfig,
    inputs_embeds: torch.Tensor,     # [B, S, D] (padded block)
    start: torch.Tensor,             # [B] int32 -- block write offset
    seq_len: torch.Tensor,           # [B] int32 -- valid tokens in block
    pool: PagedKV,
    read_tab: torch.Tensor,          # [B, PB] prefix pages (PB may be 0)
    write_tab: torch.Tensor,         # [B, m_cap] the slot's full page table
    cow_begin: torch.Tensor,         # [B] first row written back (page-
                                     # aligned boundary of the restored
                                     # prefix; == start when fresh)
    *,
    trash_row: Optional[int] = None,
    trash_page: Optional[int] = None,
) -> Tuple[torch.Tensor, PagedKV]:
    """Offset prefill against the page pool. Per layer: the restored prefix
    pages are gathered into a contiguous work cache [B, W, N, H] with
    ``W = PB*page + S + page``, the block's K/V land at rows
    ``start .. start+S``, attention is K1's per-batch window
    (``t <= start + i and t < start + seq_len``), and rows
    ``[cow_begin, cow_begin + page + S)`` go back to the pool through
    ``write_tab``: the tail plus at most one copy-on-write boundary page.
    Returns (hidden [B, S, D], pool updated in place)."""
    b, s, _ = inputs_embeds.shape
    dev = inputs_embeds.device
    act = ACTIVATIONS[cfg.hidden_act]
    page = pool.page
    pb = read_tab.shape[1]
    n, hd = pool.k.shape[-2], pool.k.shape[-1]
    w = pb * page + s + page       # pad page: the write-back never clamps

    start = start.to(torch.int32)
    seq_len = seq_len.to(torch.int32)
    positions = start[:, None] + torch.arange(s, device=dev)[None, :]
    cos, sin = rope_cos_sin(positions, _inv_freq(cfg, dev))
    kv_limits = (start + seq_len).contiguous()
    q_offsets = start.contiguous()
    bidx = torch.arange(b, device=dev)[:, None]
    block_rows = positions.long()                                # [B, S]
    rows = cow_begin.long()[:, None] + torch.arange(page + s, device=dev)
    read_ids = read_tab.long()

    x = inputs_embeds
    for li, lp in enumerate(params.layers):
        h = rms_norm(lp.input_ln, x, cfg.rms_norm_eps)
        q, k, v = _qkv(lp, h, cfg, cos, sin)
        work = []
        for pool_x, new in ((pool.k[li], k), (pool.v[li], v)):
            wx = torch.zeros((b, w, n, hd), dtype=pool_x.dtype, device=dev)
            if pb:
                wx[:, :pb * page] = pool_x[read_ids].reshape(
                    b, pb * page, n, hd)
            wx[bidx, block_rows] = new.to(wx.dtype)
            work.append(wx)
        h = flash_attention(q, work[0], work[1], q_offsets=q_offsets,
                            kv_limits=kv_limits)
        x = x + linear(lp.attn.o, h.reshape(b, s, -1))
        h = rms_norm(lp.post_ln, x, cfg.rms_norm_eps)
        x = x + _mlp(lp, h, act)
        # write-back after this layer's reads: later layers only read their
        # own layer of the pool, so this equals JAX's one scatter at the end
        for pool_x, wx in ((pool.k[li], work[0]), (pool.v[li], work[1])):
            _scatter_rows(pool_x, wx[bidx, rows], rows, write_tab, page,
                          trash_row, trash_page)
    return rms_norm(params.norm, x, cfg.rms_norm_eps), pool


def _route_pool_writes(tab: torch.Tensor, positions: torch.Tensor, page: int,
                       trash_row: Optional[int], trash_page,
                       dead: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Resolve each write position to a pool (page, row) through the slot's
    page table, DIVERTING rows at/beyond ``trash_row`` -- and ``dead``
    slots entirely -- to the shared trash page. Diverted writes must never
    go through a (possibly stale) released slot's table: do not simplify
    this routing. ``positions`` may be [B] (1-row decode) or [B, K1]
    (verify window). Only trash-page rows can ever be written twice in one
    write (several diverted rows share them)."""
    m_cap = tab.shape[1]
    pos2 = (positions if positions.dim() == 2 else positions[:, None]).long()
    entry = (pos2 // page).clamp(0, m_cap - 1)
    pid = torch.gather(tab.long(), 1, entry)
    divert = None
    if trash_row is not None:
        divert = pos2 >= trash_row
    if dead is not None:
        divert = (dead[:, None] if divert is None
                  else divert | dead[:, None])
    if divert is not None:
        target = (torch.full_like(pid, trash_page) if trash_page is not None
                  else tab[:, -1:].long().expand_as(pid))
        pid = torch.where(divert, target, pid)
    if positions.dim() == 1:
        pid = pid[:, 0]
    return pid, positions.long() % page


def _paged_block(cfg: TextConfig, act, lp: DecoderLayer, x: torch.Tensor,
                 pool_k: torch.Tensor, pool_v: torch.Tensor,
                 pid: torch.Tensor, rid: torch.Tensor, cos, sin,
                 attend) -> torch.Tensor:
    """Per-layer body shared by the zero-copy paged paths (1-row decode and
    K+1-row speculative verify): qkv + rope, the K/V rows written straight
    into this layer's pool through the pre-routed ``pid``/``rid``,
    attention ``attend(q, pool_k, pool_v)``, o-proj, SwiGLU. The two paths
    differ only in their attention window."""
    h = rms_norm(lp.input_ln, x, cfg.rms_norm_eps)
    q, k, v = _qkv(lp, h, cfg, cos, sin)
    pool_k[pid, rid] = k.to(pool_k.dtype)
    pool_v[pid, rid] = v.to(pool_v.dtype)
    h = attend(q, pool_k, pool_v)
    x = x + linear(lp.attn.o, h.reshape(*x.shape[:-1], -1))
    h = rms_norm(lp.post_ln, x, cfg.rms_norm_eps)
    return x + _mlp(lp, h, act)


def decode_step_paged(
    params: Llama,
    cfg: TextConfig,
    inputs_embeds: torch.Tensor,   # [B, D]
    positions: torch.Tensor,       # [B] int32 (engine trash-clamps done slots)
    pool: PagedKV,
    tab: torch.Tensor,             # [B, m_cap] int32 page tables
    *,
    kv_pages: Optional[int] = None,   # attend pages [0, kv_pages)
    trash_row: Optional[int] = None,
    trash_page: Optional[int] = None,
) -> Tuple[torch.Tensor, PagedKV]:
    """Zero-copy decode step: per layer, the new K/V rows are written into
    the pool through the routed (page, row), then kernel K2 reads the pool
    through ``tab[:, :kv_pages]`` up to ``min(position + 1, kv_pages*page)``
    rows. Returns (hidden [B, D], pool updated in place)."""
    act = ACTIVATIONS[cfg.hidden_act]
    page = pool.page
    m_cap = tab.shape[1]
    m = min(kv_pages or m_cap, m_cap)
    dev = inputs_embeds.device

    cos, sin = rope_cos_sin(positions, _inv_freq(cfg, dev))
    lengths = torch.clamp(positions.to(torch.int32) + 1,
                          max=m * page).contiguous()
    pid, rid = _route_pool_writes(tab, positions, page, trash_row,
                                  trash_page)
    sub = tab[:, :m]

    def attend(q, pk, pv):
        return decode_attend_paged(q, pk, pv, sub, lengths)

    x = inputs_embeds
    for li, lp in enumerate(params.layers):
        x = _paged_block(cfg, act, lp, x, pool.k[li], pool.v[li], pid, rid,
                         cos, sin, attend)
    return rms_norm(params.norm, x, cfg.rms_norm_eps), pool


def verify_step_paged_zerocopy(
    params: Llama,
    cfg: TextConfig,
    inputs_embeds: torch.Tensor,   # [B, K1, D] -- [last, draft_1..draft_K]
    start: torch.Tensor,           # [B] int32 absolute pool row of column 0
    pool: PagedKV,
    tab: torch.Tensor,             # [B, m_cap] int32 page tables
    *,
    dead: Optional[torch.Tensor] = None,   # [B] bool: writes to the trash
    kv_pages: Optional[int] = None,
    trash_row: Optional[int] = None,
    trash_page: Optional[int] = None,
) -> Tuple[torch.Tensor, PagedKV]:
    """Zero-copy speculative verify step: the K+1 block's K/V rows write
    straight into the pool through the page table, then the verify-window
    kernel K4 reads the pool with per-row causal limits (row j sees pool
    rows ``[0, start + j + 1)``). ``dead`` slots (frozen or inactive, their
    ``start`` clamped small by the caller) divert ALL their writes to the
    trash page, so a released slot's stale table is never written through.
    Returns (hidden [B, K1, D], pool updated in place)."""
    k1 = inputs_embeds.shape[1]
    act = ACTIVATIONS[cfg.hidden_act]
    page = pool.page
    m_cap = tab.shape[1]
    m = min(kv_pages or m_cap, m_cap)
    dev = inputs_embeds.device

    start = start.to(torch.int32).contiguous()
    positions = start[:, None] + torch.arange(k1, device=dev,
                                              dtype=torch.int32)[None, :]
    cos, sin = rope_cos_sin(positions, _inv_freq(cfg, dev))
    pid, rid = _route_pool_writes(
        tab, positions, page,
        trash_row if trash_row is not None else m_cap * page,
        trash_page, dead=dead)
    sub = tab[:, :m]

    def attend(q, pk, pv):
        return decode_verify_attend_paged(q, pk, pv, sub, start)

    x = inputs_embeds
    for li, lp in enumerate(params.layers):
        x = _paged_block(cfg, act, lp, x, pool.k[li], pool.v[li], pid, rid,
                         cos, sin, attend)
    return rms_norm(params.norm, x, cfg.rms_norm_eps), pool
