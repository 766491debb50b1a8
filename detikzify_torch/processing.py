"""Joint image+text preprocessing.

Equivalent of reference ``detikzify/model/processing_detikzify.py:33-127``:
prepend ``image_seq_len`` copies of the ``<image>`` token to each prompt,
optionally add bos/eos, and produce SigLIP-normalized pixel arrays. Output
layout is NHWC float32 (the JAX package's layout, kept at the public
surface); tokens are numpy int32.

Works with any tokenizer exposing ``encode/decode/bos_token_id/eos_token_id``
(HF tokenizers included). ``ByteTokenizer`` is a dependency-free byte-level
tokenizer for hermetic tests and offline benchmarks.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

import numpy as np
from PIL import Image

from .config import DetikzifyConfig
from .utils.image import load, remove_alpha, trim

# SigLIP normalization (mean=std=0.5 per channel)
IMAGE_MEAN = 0.5
IMAGE_STD = 0.5


class ByteTokenizer:
    """Byte-level tokenizer: ids 0..255 are raw bytes; specials above.

    Deterministic and dependency-free; used by the hermetic test/bench path
    (the real models use their HF tokenizers via AutoTokenizer).
    """

    def __init__(self, vocab_size: int = 512, image_token_id: int = 509,
                 bos_token_id: int = 510, eos_token_id: int = 511,
                 pad_token_id: int = 0, model_max_length: int = 2048):
        assert vocab_size > 256
        self.vocab_size = vocab_size
        self.image_token_id = image_token_id
        self.bos_token_id = bos_token_id
        self.eos_token_id = eos_token_id
        self.pad_token_id = pad_token_id
        self.model_max_length = model_max_length
        self.all_special_ids = [image_token_id, bos_token_id, eos_token_id]

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        ids = list(text.encode("utf-8"))
        if add_special_tokens:
            ids = [self.bos_token_id] + ids
        return ids

    def decode(self, token_ids: Sequence[int],
               skip_special_tokens: bool = False) -> str:
        data = bytes(t for t in token_ids
                     if t < 256 and (not skip_special_tokens
                                     or t not in self.all_special_ids))
        if not skip_special_tokens:
            # specials render as placeholders for debuggability
            parts = []
            for t in token_ids:
                if t < 256:
                    parts.append(bytes([t]))
                elif t == self.image_token_id:
                    parts.append(b"<image>")
                elif t == self.bos_token_id:
                    parts.append(b"<s>")
                elif t == self.eos_token_id:
                    parts.append(b"</s>")
            data = b"".join(parts)
        return data.decode("utf-8", "ignore")

    def get_vocab(self):
        return {f"<byte{i}>": i for i in range(256)}


def preprocess_image(image, size: int, do_trim: bool = False,
                     mean=IMAGE_MEAN, std=IMAGE_STD) -> np.ndarray:
    """PIL/path/bytes -> normalized float32 [H, W, C] array.

    Matches the reference's SiglipImageProcessor exactly: bicubic
    stretch-resize to (size, size) + rescale + mean/std normalize (0.5
    for SigLIP towers; v1 checkpoints may carry their own stats in
    preprocessor_config.json, honored by the loader). No trimming/padding
    here -- aspect-preserving square expansion happens once at the
    pipeline level (``pipeline.load``, generate.py:389-393)."""
    pil = load(image)
    if do_trim:
        pil = trim(pil)
    pil = remove_alpha(pil).resize((size, size), Image.Resampling.BICUBIC)
    arr = np.asarray(pil, np.float32) / 255.0
    return (arr - np.asarray(mean, np.float32)) \
        / np.asarray(std, np.float32)


@dataclasses.dataclass
class ProcessorOutput:
    input_ids: np.ndarray                 # [B, S] int32
    pixel_values: Optional[np.ndarray]    # [B, H, W, C] float32
    attention_mask: Optional[np.ndarray] = None

    def __getitem__(self, key):
        return getattr(self, key)


class DetikzifyProcessor:
    def __init__(self, tokenizer, cfg: DetikzifyConfig,
                 image_seq_len: Optional[int] = None,
                 model_expects_text: bool = False,
                 image_mean=IMAGE_MEAN, image_std=IMAGE_STD):
        self.tokenizer = tokenizer
        self.cfg = cfg
        self.image_seq_len = image_seq_len or cfg.image_seq_len
        self.image_token_id = cfg.image_token_id
        # True for TikZero+ checkpoints whose LLM was trained
        # caption-conditioned (reference processing_detikzify.py:53,65)
        self.model_expects_text = model_expects_text
        # checkpoint-local normalization stats (v1 towers may differ)
        self.image_mean = image_mean
        self.image_std = image_std

    @property
    def model_max_length(self) -> int:
        return min(getattr(self.tokenizer, "model_max_length", 1 << 30)
                   or (1 << 30), self.cfg.model_max_length)

    def __call__(
        self,
        images: Union[Image.Image, str, Sequence, None] = None,
        text: Union[str, Sequence[str], None] = None,
        *,
        add_bos_token: bool = False,
        add_eos_token: bool = False,
        image_seq_len: Optional[int] = None,
        truncation: bool = False,
        skip_pixels: bool = False,
    ) -> ProcessorOutput:
        if images is None and text is None:
            raise ValueError("either images or text required")
        if images is not None and not isinstance(images, (list, tuple)):
            images = [images]
        if text is None:
            text = [""] * (len(images) if images else 1)
        elif isinstance(text, str):
            text = [text]
        if images is not None and len(images) != len(text):
            raise ValueError(
                f"got {len(images)} images for {len(text)} prompts")

        seq_len = self.image_seq_len if image_seq_len is None else image_seq_len
        rows = []
        for prompt in text:
            ids = [self.image_token_id] * (seq_len if images is not None else 0)
            body = self.tokenizer.encode(prompt, add_special_tokens=False)
            if truncation:
                budget = (self.model_max_length - len(ids)
                          - bool(add_bos_token) - bool(add_eos_token))
                body = body[:max(budget, 0)]
            ids.extend(body)
            # reference appends BOS AFTER the prompt text (it is the
            # caption/code separator for TikZero+, not a sequence start --
            # processing_detikzify.py:105-106)
            if add_bos_token and self.tokenizer.bos_token_id is not None:
                ids.append(self.tokenizer.bos_token_id)
            if add_eos_token and self.tokenizer.eos_token_id is not None:
                ids.append(self.tokenizer.eos_token_id)
            rows.append(ids)

        width = max(len(r) for r in rows)
        pad = getattr(self.tokenizer, "pad_token_id", 0) or 0
        input_ids = np.full((len(rows), width), pad, np.int32)
        mask = np.zeros((len(rows), width), bool)
        for i, r in enumerate(rows):
            input_ids[i, :len(r)] = r
            mask[i, :len(r)] = True

        pixel_values = None
        # skip_pixels: token layout AS IF images were attached, but no
        # resize+normalize work -- for callers that already hold the
        # encoded image embeddings (e.g. a fused serving wave's shared
        # vision pass) and only need the ids
        if images is not None and not skip_pixels:
            pixel_values = np.stack([
                preprocess_image(img, self.cfg.vision.image_size,
                                 mean=self.image_mean, std=self.image_std)
                for img in images])
        return ProcessorOutput(input_ids=input_ids, pixel_values=pixel_values,
                               attention_mask=mask)

    def decode(self, token_ids, skip_special_tokens: bool = False) -> str:
        ids = [int(t) for t in token_ids]
        return self.tokenizer.decode(ids,
                                     skip_special_tokens=skip_special_tokens)

    def batch_decode(self, batch, **kw):
        return [self.decode(ids, **kw) for ids in batch]


def load_tokenizer(name_or_path: str):
    """HF tokenizer loader (local paths only in zero-egress environments)."""
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(name_or_path)
