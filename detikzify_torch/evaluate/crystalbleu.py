"""CrystalBLEU: BLEU that ignores the corpus's trivially-shared n-grams
(host copy of ``detikzify_tpu/evaluate/crystalbleu.py``).

Reference ``detikzify/evaluate/crystalbleu.py:37-107`` (built on the
``crystalbleu`` package), re-implemented from the paper's definition
(Eghbali & Pradel 2022): compute the k most frequent n-grams of the
reference corpus ("trivially shared"), then corpus-BLEU where those n-grams
are removed from both candidate and reference counts. TeX-aware
tokenization via Pygments' TexLexer (a regex where Pygments is missing);
the shared-ngram set is cached keyed by the corpus md5 (reference
:55-81). The corpus pass counts n-grams in the native library
(``detikzify_torch.native``) where it is built, else in Python. Pure
host-side CPU metric.
"""
from __future__ import annotations

import hashlib
import math
import os
import pickle
import tempfile
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

TRIVIALLY_SHARED_K = 500   # reference crystalbleu.py:40
MAX_N = 4


_MOSES = None


def _split_text(text: str) -> List[str]:
    """Split a plain-text run into words/punctuation (Moses if available,
    mirroring the reference's TexLexer+Moses pipeline; regex otherwise)."""
    global _MOSES
    if _MOSES is None:
        try:
            from sacremoses import MosesTokenizer

            _MOSES = MosesTokenizer(lang="en")
        except ImportError:
            _MOSES = False
    if _MOSES:
        return _MOSES.tokenize(text, escape=False)
    import re

    return re.findall(r"\w+|[^\w\s]", text)


def tex_tokenize(code: str) -> List[str]:
    """Tokenize LaTeX/TikZ: Pygments TexLexer for commands, Moses for text
    runs (reference crystalbleu.py:83-91)."""
    try:
        from pygments.lexers.markup import TexLexer

        out: List[str] = []
        for _, tok in TexLexer().get_tokens(code):
            if not tok.strip():
                continue
            if tok.startswith("\\"):
                out.append(tok)
            else:
                out.extend(_split_text(tok))
        return out
    except ImportError:   # regex fallback
        import re

        return re.findall(r"\\[a-zA-Z@]+|\w+|[^\w\s]", code)


def _ngrams(tokens: Sequence[str], max_n: int = MAX_N):
    for n in range(1, max_n + 1):
        for i in range(len(tokens) - n + 1):
            yield tuple(tokens[i:i + n])


_FNV_OFFSET = 1469598103934665603
_FNV_PRIME = 1099511628211
_U64 = (1 << 64) - 1


def _fnv1a_ids(ids) -> int:
    """Python mirror of the native kernel's per-ngram hash (n is the seed)."""
    h = _FNV_OFFSET ^ len(ids)
    for t in ids:
        h = ((h ^ (t & 0xFFFFFFFF)) * _FNV_PRIME) & _U64
    return h


class HashedNgramSet:
    """Membership set of n-grams keyed by the native FNV-1a hash of their
    token IDS. Same contract as a set of token tuples (collisions at
    k=500 over a <2^32 vocab are ~2^-50); vocab maps token strings to the
    ids the corpus pass used -- tokens never seen in the corpus cannot be
    trivially shared."""

    def __init__(self, vocab: dict, hashes: set):
        self.vocab = vocab
        self.hashes = hashes

    def __contains__(self, ngram) -> bool:
        ids = []
        for tok in ngram:
            i = self.vocab.get(tok)
            if i is None:
                return False
            ids.append(i)
        return _fnv1a_ids(ids) in self.hashes

    def __len__(self) -> int:
        return len(self.hashes)

    def __eq__(self, other) -> bool:
        return (isinstance(other, HashedNgramSet)
                and self.vocab == other.vocab
                and self.hashes == other.hashes)


def _shared_ngrams_native(tokenized: List[List[str]], k: int):
    """Corpus statistics on the native hashed-counting kernel: ~50x the
    Python Counter pass on DaTikZ-scale corpora (one C++ hash map per text
    + one vectorized merge), at identical exclusion semantics."""
    from ..native import count_ngrams_ids

    vocab: dict = {}
    all_h, all_c = [], []
    for tokens in tokenized:
        ids = [vocab.setdefault(t, len(vocab)) for t in tokens]
        out = count_ngrams_ids(ids, MAX_N)
        if out is None:
            return None
        all_h.append(out[0])
        all_c.append(out[1])
    import numpy as np

    hashes = np.concatenate(all_h)
    counts = np.concatenate(all_c)
    uniq, inverse = np.unique(hashes, return_inverse=True)
    totals = np.bincount(inverse, weights=counts.astype(np.float64))
    top = uniq[np.argsort(-totals, kind="stable")[:k]]
    return HashedNgramSet(vocab, set(int(h) for h in top))


def trivially_shared_ngrams(corpus: Sequence[str], k: int = TRIVIALLY_SHARED_K,
                            cache_dir: Optional[str] = None,
                            use_native: bool = True):
    """The k most frequent n-grams of the corpus, md5-cached on disk."""
    digest = hashlib.md5("\0".join(corpus).encode()).hexdigest()
    cache_dir = cache_dir or os.path.join(tempfile.gettempdir(),
                                          "detikzify_torch_crystalbleu")
    os.makedirs(cache_dir, exist_ok=True)
    cache_path = os.path.join(cache_dir, f"{digest}-{k}.pkl")
    if os.path.exists(cache_path):
        with open(cache_path, "rb") as f:
            return pickle.load(f)
    tokenized = [tex_tokenize(text) for text in corpus]
    shared = _shared_ngrams_native(tokenized, k) if use_native else None
    if shared is None:
        counts: Counter = Counter()
        for tokens in tokenized:
            counts.update(_ngrams(tokens))
        shared = set(ng for ng, _ in counts.most_common(k))
    with open(cache_path, "wb") as f:
        pickle.dump(shared, f)
    return shared


def corpus_bleu_excluding(
    candidates: Sequence[List[str]],
    references: Sequence[List[List[str]]],
    exclude: set,
    max_n: int = MAX_N,
) -> float:
    """Corpus BLEU (uniform 1..max_n weights, brevity penalty) with the
    excluded n-grams removed from candidate and reference counts."""
    clipped = [0] * max_n
    totals = [0] * max_n
    cand_len = ref_len = 0
    for cand, refs in zip(candidates, references):
        cand_len += len(cand)
        ref_len += min((len(r) for r in refs),
                       key=lambda L: (abs(L - len(cand)), L))
        for n in range(1, max_n + 1):
            cand_counts = Counter(
                ng for ng in _ngrams(cand, n) if len(ng) == n
                and ng not in exclude)
            if not cand_counts:
                continue
            max_ref: Dict[Tuple, int] = {}
            for ref in refs:
                rc = Counter(ng for ng in _ngrams(ref, n) if len(ng) == n
                             and ng not in exclude)
                for ng, c in rc.items():
                    max_ref[ng] = max(max_ref.get(ng, 0), c)
            totals[n - 1] += sum(cand_counts.values())
            clipped[n - 1] += sum(min(c, max_ref.get(ng, 0))
                                  for ng, c in cand_counts.items())
    if totals[0] == 0 or clipped[0] == 0:
        return 0.0
    # NLTK method-1-style smoothing for higher-order zero counts
    log_p = 0.0
    for n in range(max_n):
        p = (clipped[n] or 0.5) / max(totals[n], 1)
        log_p += math.log(p) / max_n
    bp = 1.0 if cand_len > ref_len else math.exp(1 - ref_len /
                                                 max(cand_len, 1))
    return bp * math.exp(log_p)


class CrystalBLEU:
    """update/compute/reset metric over (candidate, references) code pairs."""

    higher_is_better = True

    def __init__(self, corpus: Sequence[str], k: int = TRIVIALLY_SHARED_K,
                 cache_dir: Optional[str] = None):
        self.shared = trivially_shared_ngrams(list(corpus), k, cache_dir)
        self._cands: List[List[str]] = []
        self._refs: List[List[List[str]]] = []

    def update(self, candidates: Sequence[str],
               references: Sequence[Sequence[str]]) -> None:
        for cand, refs in zip(candidates, references):
            self._cands.append(tex_tokenize(cand))
            self._refs.append([tex_tokenize(r) for r in refs])

    def compute(self) -> float:
        if not self._cands:
            raise RuntimeError("no updates")
        return corpus_bleu_excluding(self._cands, self._refs, self.shared)

    def reset(self) -> None:
        self._cands, self._refs = [], []
