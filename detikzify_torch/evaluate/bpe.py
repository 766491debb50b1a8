"""Byte-level BPE without the ``tokenizers`` package.

The encoder of a ``tokenizers`` ``BPE`` model behind a ``ByteLevel``
pre-tokenizer (``add_prefix_space=False``, the GPT-2 split) and decoder,
as ``evaluate.spec_acceptance.train_bpe_tokenizer`` trains it: the text is
split by the GPT-2 pattern, each piece's UTF-8 bytes are mapped to the
GPT-2 byte alphabet, and merges are applied by rank. The card's machine
has neither ``tokenizers`` nor ``transformers``, so the speculation
measurement reads a vocabulary committed in the package
(``spec_bpe_300.json``: the tokenizer trained on ``generate_corpus(300,
seed=0)`` at vocab 512) through this class.
"""
from __future__ import annotations

import json
import os
import unicodedata
from functools import lru_cache
from typing import Dict, List, Sequence, Tuple

#: the committed vocabulary of the speculation measurement
SPEC_BPE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "spec_bpe_300.json")


@lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible map of the 256 bytes to printable characters."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _letter(c: str) -> bool:
    return unicodedata.category(c).startswith("L")


def _number(c: str) -> bool:
    return unicodedata.category(c).startswith("N")


_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def pre_tokenize(text: str) -> List[str]:
    """The GPT-2 split ``'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+|
    ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+``, matched leftmost-first."""
    out, i, n = [], 0, len(text)

    def run(j, pred):
        while j < n and pred(text[j]):
            j += 1
        return j

    def other(c):
        return not (c.isspace() or _letter(c) or _number(c))

    while i < n:
        c = text[i]
        m = next((k for k in _CONTRACTIONS if text.startswith(k, i)), None)
        if m is not None:
            out.append(m)
            i += len(m)
            continue
        j = i + 1 if c == " " and i + 1 < n else i
        matched = False
        for pred in (_letter, _number, other):
            if j < n and pred(text[j]):
                end = run(j, pred)
                out.append(text[i:end])
                i, matched = end, True
                break
        if matched:
            continue
        if c.isspace():
            end = run(i, str.isspace)
            if end < n and end - i > 1:
                end -= 1            # \s+(?!\S): leave one for the next piece
            out.append(text[i:end])
            i = end
            continue
        # a lone non-space that none of the classes took cannot happen:
        # every character is a letter, a number, a space or "other"
        raise AssertionError(repr(c))
    return out


class ByteLevelBPE:
    """Encode and decode with a byte-level BPE vocabulary and its ranked
    merges; ``bos``/``eos``/``pad`` are special ids, never produced by
    ``encode``."""

    def __init__(self, vocab: Dict[str, int],
                 merges: Sequence[Tuple[str, str]], *, pad_token="<pad>",
                 bos_token="<s>", eos_token="</s>",
                 model_max_length: int = 4096):
        self.vocab = dict(vocab)
        self.merges = [tuple(m) for m in merges]
        self.ranks = {m: r for r, m in enumerate(self.merges)}
        self.inverse = {i: t for t, i in self.vocab.items()}
        self.pad_token_id = self.vocab[pad_token]
        self.bos_token_id = self.vocab[bos_token]
        self.eos_token_id = self.vocab[eos_token]
        self.special_ids = {self.pad_token_id, self.bos_token_id,
                            self.eos_token_id}
        self.model_max_length = model_max_length
        self._byte = bytes_to_unicode()
        self._unbyte = {c: b for b, c in self._byte.items()}
        self._cache: Dict[str, List[int]] = {}

    def __len__(self) -> int:
        return len(self.vocab)

    @classmethod
    def from_file(cls, path: str = SPEC_BPE_PATH) -> "ByteLevelBPE":
        with open(path) as f:
            data = json.load(f)
        return cls(data["vocab"], data["merges"])

    def to_file(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"vocab": self.vocab,
                       "merges": [list(m) for m in self.merges]}, f,
                      ensure_ascii=False, indent=0)
            f.write("\n")

    def _bpe(self, piece: str) -> List[int]:
        hit = self._cache.get(piece)
        if hit is not None:
            return hit
        word = [self._byte[b] for b in piece.encode("utf-8")]
        while len(word) > 1:
            pairs = [(self.ranks.get((a, b)), i)
                     for i, (a, b) in enumerate(zip(word, word[1:]))]
            best = min((p for p in pairs if p[0] is not None), default=None)
            if best is None:
                break
            a, b = word[best[1]], word[best[1] + 1]
            merged, i = [], 0
            while i < len(word):
                if i + 1 < len(word) and word[i] == a and word[i + 1] == b:
                    merged.append(a + b)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        ids = [self.vocab[t] for t in word]
        self._cache[piece] = ids
        return ids

    def encode(self, text: str, add_special_tokens: bool = False
               ) -> List[int]:
        ids = [i for piece in pre_tokenize(text) for i in self._bpe(piece)]
        return [self.bos_token_id] + ids if add_special_tokens else ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True
               ) -> str:
        chars = "".join(self.inverse[int(i)] for i in ids
                        if not (skip_special_tokens
                                and int(i) in self.special_ids))
        data = bytes(self._unbyte[c] for c in chars if c in self._unbyte)
        return data.decode("utf-8", errors="replace")
