"""The tokenizer stand-in: no checkpoint's tokenizer is in the repository.

Ids below 256 are bytes; every other id that is not special decodes to a
newline when it is a multiple of 16 and to a letter otherwise. Random
weights spread their tokens over the whole vocabulary, so each request
decodes to a distinct program of several lines.
"""
from __future__ import annotations

from typing import List, Sequence


class StandInTokenizer:
    def __init__(self, vocab_size: int, image_token_id: int,
                 bos_token_id: int, eos_token_id: int, pad_token_id: int,
                 model_max_length: int):
        self.vocab_size = vocab_size
        self.image_token_id = image_token_id
        self.bos_token_id = bos_token_id
        self.eos_token_id = eos_token_id
        self.pad_token_id = pad_token_id
        self.model_max_length = model_max_length
        self.all_special_ids = [image_token_id, bos_token_id, eos_token_id]

    @classmethod
    def for_config(cls, cfg: dict) -> "StandInTokenizer":
        return cls(cfg["vocab_size"], cfg["image_token_id"],
                   cfg["bos_token_id"], cfg["eos_token_id"],
                   cfg["pad_token_id"], cfg["model_max_length"])

    def encode(self, text: str, add_special_tokens: bool = False
               ) -> List[int]:
        ids = list(text.encode("utf-8"))
        return [self.bos_token_id] + ids if add_special_tokens else ids

    def decode(self, token_ids: Sequence[int],
               skip_special_tokens: bool = False) -> str:
        out = bytearray()
        names = {self.image_token_id: b"<image>", self.bos_token_id: b"<s>",
                 self.eos_token_id: b"</s>"}
        for t in (int(t) for t in token_ids):
            if t in names:
                if not skip_special_tokens:
                    out += names[t]
            elif t < 256:
                out.append(t)
            else:
                out.append(10 if t % 16 == 0 else 97 + t % 26)
        return out.decode("utf-8", "ignore")

    def get_vocab(self):
        return {f"<id{i}>": i for i in range(self.vocab_size)}
