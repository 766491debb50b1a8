"""The comparison that decides ``correct``.

The reference runs each sampled request's prompt with its served tokens
once. At each served position it reads:

* greedy requests: how far the served token's logit lies below the
  reference's best (the tokens the engine never emits there, the image
  token everywhere and, where eos ends a request, eos first, left out on
  both sides).
  ``token_gap`` is the widest gap over the sample; ``token_gap_mean``
  the mean gap over every served token (nought where the served token is
  the reference's best); ``token_gap_contested`` the mean gap over the
  contested positions, those whose best two logits in the reference lie
  within ``CONTESTED`` of each other. A rounding that moves the logits
  by e flips a contested position with a chance that grows as e, by a
  gap that grows as e: that mean grows as e squared, and does not move
  with how many positions a seed's weights leave contested, as the
  mean over every token does;
* sampled requests: whether the served token lies in the reference's
  nucleus, the tokens the mix's sampler may draw there (the same tokens
  left out, then temperature, the top ``candidates`` logits, top-k, and
  the smallest prefix whose share of the candidates' mass reaches
  ``top_p``). ``nucleus_miss`` is the share of served tokens outside it.

A cell's limits file says which numbers are compared.

With ``control``, two more readings, each of the reference put in the
program's place: ``control.token_gap``, ``control.token_gap_mean`` and
``control.token_gap_contested``, at the precision below the
configuration's (``control`` in its file), those of the token it puts
first at each greedy position; ``fault.nucleus_miss``, with top-p left
out of its sampler, that of a token it draws at each sampled position.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .reference import images as ref_images
from .reference import model as ref

#: rows of a sequence whose nucleus is worked out at once
CHUNK = 256
#: logits: a position whose best two lie closer than this is contested
CONTESTED = 0.1


def _banned(cfg: dict, mix: dict, j: int) -> List[int]:
    """The tokens the engine never emits at served position ``j``: the
    image token, and eos first where eos ends a request (the engine
    suppresses its end token at a request's first step)."""
    first = j == 0 and mix.get("eos_ends_request", True)
    return [cfg["image_token_id"]] + ([cfg["eos_token_id"]] if first
                                      else [])


def _masked(rows: torch.Tensor, cfg: dict, mix: dict,
            first: int) -> torch.Tensor:
    """Rows of positions ``first``, ``first`` + 1, ... with the tokens
    the engine never emits there at -inf."""
    rows = rows.clone()
    rows[:, cfg["image_token_id"]] = float("-inf")
    if first == 0:
        rows[0, _banned(cfg, mix, 0)] = float("-inf")
    return rows


def _images(cfg: dict, figures, device) -> List[torch.Tensor]:
    size = cfg["vision"]["image_size"]
    return [torch.from_numpy(ref_images.pixels(f, size)).to(device)
            for f in figures]


@torch.no_grad()
def logits(cfg: dict, seed: int, precision: str, sequences: List[dict],
           device) -> List[torch.Tensor]:
    """Rows predicting each sequence's served tokens, [n_served, V]."""
    if not sequences:
        return []
    w = ref.Weights(cfg, seed, precision, device)
    with ref.fp32_exact():
        tokens = ref.vision(w, _images(cfg, [s["figure"] for s in sequences],
                                       device))
        rows = ref.decoder_logits(w, [s["token_ids"] for s in sequences],
                                  tokens, [s["prompt_len"] for s in sequences])
    return [r[:len(s["token_ids"]) - s["prompt_len"]].cpu()
            for r, s in zip(rows, sequences)]


def token_gaps(cfg: dict, mix: dict, sequences: List[dict], ref_rows,
               chosen_rows=None):
    """(gap below the reference's best of each served token, or with
    ``chosen_rows`` of the token those rows put first; the margin between
    the reference's best two there), each [n_served]."""
    gaps, margins = [], []
    for s, rows, ch in zip(sequences, ref_rows,
                           chosen_rows or [None] * len(sequences)):
        served = s["token_ids"][s["prompt_len"]:]
        for j, tok in enumerate(served):
            banned = _banned(cfg, mix, j)
            r = rows[j].clone()
            r[banned] = float("-inf")
            if ch is not None:
                c = ch[j].clone()
                c[banned] = float("-inf")
                tok = int(torch.argmax(c))
            top2 = torch.topk(r, 2).values
            gaps.append(float(top2[0] - r[tok]))
            margins.append(float(top2[0] - top2[1]))
    return np.asarray(gaps), np.asarray(margins)


def _gap_numbers(gaps: np.ndarray, margins: np.ndarray, prefix: str = ""):
    contested = margins < CONTESTED
    return {f"{prefix}token_gap": gaps.max(),
            f"{prefix}token_gap_mean": gaps.mean(),
            f"{prefix}token_gap_contested": (gaps[contested].mean()
                                             if contested.any() else 0.0)}


def _nucleus(rows: torch.Tensor, mix: dict, top_p: float):
    """(candidate ids [n, C], their logits after temperature and top-k
    [n, C], kept [n, C]): the mix's sampler over fp32 rows whose banned
    tokens are at -inf."""
    scaled = rows / mix["temperature"]
    cand = min(mix["candidates"], rows.shape[-1])
    top, idx = torch.sort(scaled, dim=-1, descending=True, stable=True)
    top, idx = top[:, :cand], idx[:, :cand]
    if mix["top_k"] > 0:
        top[:, mix["top_k"]:] = float("-inf")
    probs = torch.softmax(top, dim=-1)
    keep = (torch.cumsum(probs, dim=-1) - probs) < top_p
    keep &= top > float("-inf")
    return idx, top, keep


def nucleus_misses(cfg: dict, mix: dict, sequences: List[dict], ref_rows,
                   device, fault_seed: Optional[int] = None) -> np.ndarray:
    """1 for each served token outside the reference's nucleus, else 0;
    with ``fault_seed``, for a token drawn (Gumbel-max, a generator from
    that seed) from the reference's candidates with top-p left out."""
    gen = None
    if fault_seed is not None:
        gen = torch.Generator(device=device)
        gen.manual_seed(abs(int(fault_seed)) % 2**63)
    out = []
    for s, rows in zip(sequences, ref_rows):
        served = torch.as_tensor(s["token_ids"][s["prompt_len"]:],
                                 device=device)
        for a in range(0, len(served), CHUNK):
            r = _masked(rows[a:a + CHUNK].to(device), cfg, mix, a)
            idx, top, keep = _nucleus(r, mix, mix["top_p"])
            if gen is None:
                tok = served[a:a + CHUNK]
            else:
                u = torch.rand(top.shape, generator=gen, device=device)
                noisy = top - torch.log(-torch.log(u.clamp_min(1e-20)))
                tok = idx.gather(1, noisy.argmax(1, keepdim=True))[:, 0]
            inside = ((idx == tok[:, None]) & keep).any(dim=1)
            out.append((~inside).cpu().numpy().astype(np.float64))
    return np.concatenate(out) if out else np.zeros(0)


def compare(cfg: dict, mix: dict, seed: int, evidence: dict, device,
            control: bool = False) -> Dict[str, Optional[float]]:
    """The cell's numbers for the program (and with ``control``, the
    control's and the fault's)."""
    precision = cfg["weights"]
    out: Dict[str, Optional[float]] = {}
    seqs = evidence["sequences"]
    if seqs:
        rows = logits(cfg, seed, precision, seqs, device)
        gaps, margins = token_gaps(cfg, mix, seqs, rows)
        out.update(_gap_numbers(gaps, margins))
        out["served_tokens"] = len(gaps)
        out["contested_tokens"] = int((margins < CONTESTED).sum())
        if control:
            low, _ = token_gaps(cfg, mix, seqs, rows,
                                logits(cfg, seed, cfg["control"], seqs,
                                       device))
            out.update(_gap_numbers(low, margins, "control."))
        del rows
    sampled = evidence.get("sampled", [])
    if sampled:
        rows = logits(cfg, seed, precision, sampled, device)
        miss = nucleus_misses(cfg, mix, sampled, rows, device)
        out["nucleus_miss"], out["sampled_tokens"] = miss.mean(), len(miss)
        if control:
            out["fault.nucleus_miss"] = nucleus_misses(
                cfg, mix, sampled, rows, device, fault_seed=seed).mean()
    return {k: None if v is None else float(v) for k, v in out.items()}
