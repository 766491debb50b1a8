"""TexEditDistance: Extended Edit Distance with TeX tokenization (host copy
of ``detikzify_tpu/evaluate/eed.py``).

Reference ``detikzify/evaluate/eed.py:11-69`` wraps torchmetrics'
ExtendedEditDistance (Stanchev, Wang & Ney 2019) with a LaTeX lexer.
Re-implemented here from the paper: Levenshtein over TeX tokens with a
cheap-deletion bias and a "jump" operation (allowed at blank boundaries),
plus a coverage penalty for the jumps actually taken on the optimal path:

    EED = min(1, (e + rho * v) / (|ref| + rho * v))

with the published constants alpha=2.0 (jump), deletion=0.2, insertion=1.0,
substitution=1.0, rho=0.3. Matching torchmetrics semantics, the DP runs at
CHARACTER level over the space-joined TeX-token string (jumps allowed at
the interior spaces), so absolute values are comparable with
reference/published numbers. Lower is better; 0 for identical programs.
"""
from __future__ import annotations

from typing import List, Sequence

from .crystalbleu import tex_tokenize

ALPHA = 2.0      # jump cost
DELETION = 0.2
INSERTION = 1.0
SUBSTITUTION = 1.0
RHO = 0.3        # coverage penalty weight

_BLANK = " "


def extended_edit_distance(hyp: Sequence, ref: Sequence) -> float:
    """EED between token sequences (dispatches to the native C++ DP when
    available -- O(n*m) in pure Python is the eval suite's hottest loop)."""
    from ..native import eed_distance_ids

    vocab = {}
    for tok in list(hyp) + list(ref):
        if tok not in vocab:
            vocab[tok] = len(vocab)
    # interior blanks (char-level mode) must map to the kernel's blank id
    # so jumps are allowed at them
    blank_id = vocab.get(_BLANK, len(vocab))
    native = eed_distance_ids([vocab[t] for t in hyp],
                              [vocab[t] for t in ref], blank_id)
    if native is not None:
        return native
    return _extended_edit_distance_py(hyp, ref)


def _extended_edit_distance_py(hyp: Sequence, ref: Sequence) -> float:
    """Pure-Python reference implementation (kept in lockstep with the
    C++ kernel by tests)."""
    hyp = [_BLANK] + list(hyp) + [_BLANK]
    ref = [_BLANK] + list(ref) + [_BLANK]
    n_h, n_r = len(hyp), len(ref)

    SUB, INS, DEL, JMP = 0, 1, 2, 3
    inf = float("inf")
    # dist[j][i]: cost consuming ref[:j] ending at hyp position i
    dist = [[inf] * (n_h + 1) for _ in range(n_r + 1)]
    op = [[SUB] * (n_h + 1) for _ in range(n_r + 1)]
    jump_src = [[0] * (n_h + 1) for _ in range(n_r + 1)]
    for i in range(n_h + 1):
        dist[0][i] = i * DELETION
        op[0][i] = DEL
    for j in range(1, n_r + 1):
        dist[j][0] = dist[j - 1][0] + INSERTION
        op[j][0] = INS
        for i in range(1, n_h + 1):
            sub = dist[j - 1][i - 1] + (
                0.0 if hyp[i - 1] == ref[j - 1] else SUBSTITUTION)
            ins = dist[j - 1][i] + INSERTION
            dele = dist[j][i - 1] + DELETION
            best = min(sub, ins, dele)
            dist[j][i] = best
            op[j][i] = SUB if best == sub else (INS if best == ins else DEL)
        # jump: teleport to any blank-adjacent hyp position
        row_best = min(range(n_h + 1), key=lambda i: dist[j][i])
        base = dist[j][row_best]
        for i in range(n_h + 1):
            if i <= n_h and (i == 0 or hyp[i - 1] == _BLANK):
                if base + ALPHA < dist[j][i]:
                    dist[j][i] = base + ALPHA
                    op[j][i] = JMP
                    jump_src[j][i] = row_best

    e = dist[n_r][n_h]
    # backtrace: coverage = jumps actually used (each revisits a segment)
    j, i, jumps = n_r, n_h, 0
    while j > 0 or i > 0:
        o = op[j][i]
        if o == JMP:
            jumps += 1
            i = jump_src[j][i]
        elif o == SUB and j > 0 and i > 0:
            j, i = j - 1, i - 1
        elif o == INS and j > 0:
            j = j - 1
        else:
            i = i - 1
    coverage = float(jumps)
    denom = n_r + RHO * coverage
    return min(1.0, (e + RHO * coverage) / max(denom, 1e-9))


class TexEditDistance:
    """update/compute/reset over (hypotheses, list-of-references)."""

    higher_is_better = False

    def __init__(self):
        self._scores: List[float] = []

    def update(self, hypotheses: Sequence[str],
               references: Sequence[Sequence[str]]) -> None:
        for hyp, refs in zip(hypotheses, references):
            # char-level over the space-joined token string, matching
            # torchmetrics' tokenize -> " ".join -> per-character DP
            # (reference evaluate/eed.py:26-41)
            h = list(" ".join(tex_tokenize(hyp)))
            self._scores.append(
                min(extended_edit_distance(
                    h, list(" ".join(tex_tokenize(r))))
                    for r in refs))

    def compute(self) -> float:
        if not self._scores:
            raise RuntimeError("no updates")
        return sum(self._scores) / len(self._scores)

    def reset(self) -> None:
        self._scores = []
