"""Token sampling, batched over decode slots (counterpart of
``detikzify_tpu/ops/sampling.py``).

One [B, V] pass: ban -> first-step EOS suppression -> temperature -> a
static top-``candidates`` prefilter -> top-k -> top-p within the candidate
set -> Gumbel-max draw. Gumbel noise comes from an explicit
``torch.Generator`` on the logits' device; greedy rows (temperature <= 0)
take the plain argmax and no noise. Philox and threefry give different
bits, so sampled draws match the JAX package in distribution, not token
for token; greedy draws match exactly. ``speculative_accept`` is the
distribution-preserving acceptance of speculative decoding under the same
warp.
"""
from __future__ import annotations

import re
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

_NEG_INF = -1e30

CANDIDATES = 1024  # static top-k prefilter for the top-p sort


class SamplingParams(NamedTuple):
    temperature: float = 0.8
    top_p: float = 0.95
    top_k: int = 0          # 0 = disabled
    candidates: int = CANDIDATES


def _per_row(x, b: int, dtype, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=dtype, device=device).expand(b)


def _warp(logits: torch.Tensor, temperature: torch.Tensor,
          top_p: torch.Tensor, top_k: torch.Tensor, candidates: int):
    """Temperature -> top-k -> top-p within the candidate set.
    ``logits`` [B, V] fp32 (banned tokens already masked); the sampling
    parameters are [B]. Returns (top_logits [B, cand] with filtered
    entries at -1e30, top_idx [B, cand], greedy [B] bool)."""
    v = logits.shape[-1]
    greedy = temperature <= 0.0
    scaled = logits / torch.where(greedy, torch.ones_like(temperature),
                                  temperature)[:, None]
    cand = min(candidates, v)
    # a stable descending sort breaks ties toward the lower token id, as
    # jax.lax.top_k does (torch.topk leaves the order of ties open)
    top_logits, top_idx = torch.sort(scaled, dim=-1, descending=True,
                                     stable=True)
    top_logits, top_idx = top_logits[:, :cand], top_idx[:, :cand]

    ranks = torch.arange(cand, device=logits.device)
    k_eff = torch.where(top_k <= 0, torch.full_like(top_k, cand),
                        top_k.clamp(max=cand))[:, None]
    top_logits = torch.where(ranks < k_eff, top_logits,
                             torch.full_like(top_logits, _NEG_INF))

    probs = torch.softmax(top_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # keep the smallest prefix whose mass reaches top_p (rank 0 always
    # survives). top_p >= 1 disables the filter; top_p <= 0 keeps only the
    # top token (HF TopPLogitsWarper's min_tokens_to_keep=1)
    p_eff = torch.where(top_p >= 1.0, torch.ones_like(top_p),
                        top_p.clamp(min=1e-9))[:, None]
    keep = (cum - probs) < p_eff
    top_logits = torch.where(keep, top_logits,
                             torch.full_like(top_logits, _NEG_INF))
    return top_logits, top_idx, greedy


def sample(
    logits: torch.Tensor,                    # [B, V]
    generator: Optional[torch.Generator],
    *,
    params: Optional[SamplingParams] = None,
    temperature=None,                        # float or [B]; 0 = greedy
    top_p=None,                              # float or [B]; >= 1 disables
    top_k=None,                              # int or [B]; 0 disables
    candidates: Optional[int] = None,
    banned_tokens: Tuple[int, ...] = (),
    suppress_begin_tokens: Tuple[int, ...] = (),
    is_first: Optional[torch.Tensor] = None,     # [B] bool: first step
) -> torch.Tensor:
    """Sample one token per row; returns [B] int32."""
    base = params if params is not None else SamplingParams()
    temperature = base.temperature if temperature is None else temperature
    top_p = base.top_p if top_p is None else top_p
    top_k = base.top_k if top_k is None else top_k
    candidates = base.candidates if candidates is None else candidates

    b = logits.shape[0]
    dev = logits.device
    logits = logits.float().clone()
    for tok in banned_tokens:
        logits[:, tok] = _NEG_INF
    if suppress_begin_tokens and is_first is not None:
        for tok in suppress_begin_tokens:
            logits[:, tok] = torch.where(
                is_first, torch.full_like(logits[:, tok], _NEG_INF),
                logits[:, tok])
    temperature = _per_row(temperature, b, torch.float32, dev)
    top_p = _per_row(top_p, b, torch.float32, dev)
    top_k = _per_row(top_k, b, torch.int32, dev)

    top_logits, top_idx, greedy = _warp(logits, temperature, top_p, top_k,
                                        candidates)
    # noise is drawn for every row (no host sync to test for all-greedy)
    # and zeroed on greedy rows
    gumbel = _gumbel(top_logits.shape, generator, dev)
    noisy = top_logits + torch.where(greedy[:, None],
                                     torch.zeros_like(gumbel), gumbel)
    choice = torch.argmax(noisy, dim=-1)
    return torch.gather(top_idx, 1, choice[:, None])[:, 0].to(torch.int32)


def _gumbel(shape, generator, device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    return -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))


def speculative_accept(
    logits: torch.Tensor,           # [B, K+1, V] fp32 -- verify logits
    drafts: torch.Tensor,           # [B, K] int32 drafted tokens (<0: none)
    generator: Optional[torch.Generator],
    *,
    temperature,                    # float or [B]
    top_p,
    top_k,
    candidates: int = CANDIDATES,
    banned_tokens: Tuple[int, ...] = (),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distribution-preserving acceptance of deterministic drafts (n-gram
    speculative decoding), the JAX ``speculative_accept``.

    ``logits[:, i]`` is the distribution of the token following input i of
    ``[last_token, d_1 .. d_K]``. Draft ``d_{i+1}`` is accepted with
    probability ``p_i(d_{i+1})`` under the warp ``sample`` uses; at the first
    rejection one token is drawn from ``p_i`` with the draft removed, and
    when every draft is accepted a bonus token is drawn from ``p_K``. Greedy
    rows (temperature <= 0) accept exactly the argmax chain. Random numbers,
    in this order: one uniform [B, K], one Gumbel [B, candidates].

    Returns (emitted [B, K+1] int32, counts [B] int32): row b emits
    ``emitted[b, :counts[b]]``, 1 <= counts <= K+1."""
    b, k1, v = logits.shape
    k = k1 - 1
    assert tuple(drafts.shape) == (b, k)
    dev = logits.device
    drafts = drafts.long()
    logits = logits.float().clone()
    for tok in banned_tokens:
        logits[:, :, tok] = _NEG_INF
    temperature = _per_row(temperature, b, torch.float32, dev)
    top_p = _per_row(top_p, b, torch.float32, dev)
    top_k = _per_row(top_k, b, torch.int32, dev)
    top_logits, top_idx, greedy = _warp(
        logits.reshape(b * k1, v), temperature.repeat_interleave(k1),
        top_p.repeat_interleave(k1), top_k.repeat_interleave(k1), candidates)
    top_logits = top_logits.reshape(b, k1, -1)
    top_idx = top_idx.reshape(b, k1, -1)
    greedy = greedy.reshape(b, k1)[:, 0]
    probs = torch.softmax(top_logits, dim=-1)                    # [B,K1,C]

    # p_i(d_{i+1}) under the warped distribution; 0 when the draft is
    # outside the candidate set, filtered or invalid (< 0)
    is_draft = top_idx[:, :k] == drafts[:, :, None]              # [B,K,C]
    p_draft = torch.where(is_draft, probs[:, :k],
                          torch.zeros_like(probs[:, :k])).sum(-1)
    # greedy rows: accept iff the draft IS the argmax (warped top choice)
    argmax_tok = top_idx[..., 0]                                 # [B,K1]
    p_draft = torch.where(greedy[:, None],
                          (drafts == argmax_tok[:, :k]).float(), p_draft)

    u = torch.rand((b, k), generator=generator, device=dev,
                   dtype=torch.float32)
    acc = u < p_draft
    m = torch.cumprod(acc.long(), dim=-1).sum(-1)                # [B] 0..K

    # final token: residual of p_m with the rejected draft removed when
    # m < K, plain p_K (bonus) when every draft was accepted
    rows = torch.arange(b, device=dev)
    final_logits = top_logits[rows, m]                           # [B,C]
    final_idx = top_idx[rows, m]
    if k > 0:
        rej_draft = drafts.gather(1, m.clamp(max=k - 1)[:, None])[:, 0]
    else:
        rej_draft = torch.full((b,), -1, dtype=torch.long, device=dev)
    drop = (m < k)[:, None] & (final_idx == rej_draft[:, None])
    final_logits = final_logits.masked_fill(drop, _NEG_INF)
    gumbel = _gumbel(final_logits.shape, generator, dev)
    noisy = final_logits + torch.where(greedy[:, None],
                                       torch.zeros_like(gumbel), gumbel)
    choice = torch.argmax(noisy, dim=-1)
    final_tok = final_idx.gather(1, choice[:, None])[:, 0]

    pos = torch.arange(k1, device=dev)[None, :]
    padded = torch.cat([drafts, torch.zeros((b, 1), dtype=torch.long,
                                            device=dev)], dim=1)
    emitted = torch.where(pos < m[:, None], padded,
                          torch.where(pos == m[:, None], final_tok[:, None],
                                      torch.zeros_like(padded)))
    return emitted.to(torch.int32), (m + 1).to(torch.int32)


def make_newline_table(tokenizer, vocab_size: int):
    """Per-token newline counts + whether the token's text ends a line.

    For every vocab id, how many '\\n' its decoded text contributes and
    whether that text ends with '\\n' (a prefix ending on this token is a
    complete line). The generator uses it to cut rollouts at line
    boundaries without re-decoding. Returns (counts [V] int32, ends_nl [V]
    bool) as numpy arrays."""
    counts = np.zeros((vocab_size,), np.int32)
    ends = np.zeros((vocab_size,), bool)
    specials = set(getattr(tokenizer, "all_special_ids", []) or [])
    for tok in range(vocab_size):
        if tok in specials:
            continue
        try:
            text = tokenizer.decode([tok])
        except Exception:
            continue
        # normalize \r\n and bare \r like the reference (generate.py:240)
        text = re.sub(r"\r\n|\r", "\n", text)
        n = text.count("\n")
        if n:
            counts[tok] = n
            ends[tok] = text.endswith("\n")
    return counts, ends
