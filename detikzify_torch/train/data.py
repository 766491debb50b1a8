"""Training data pipeline: tokenization with label masking + sketch-ratio
epoch dataset (a copy of ``detikzify_tpu/train/data.py``: numpy arrays,
equal to the JAX package's for the same seed and epoch; the trainer moves
them to the device).

Reference semantics:
  * ``tokenize`` (``train/pretrain.py:11-35``): processor output where
    image tokens and padding are masked to IGNORE_INDEX=-100 in labels.
  * ``ImageSketchDataset`` (``train/train.py:21-63``): per epoch, each
    example's image is replaced by a precomputed sketch or an on-the-fly
    ``SketchAugment`` with probability ``sketch_ratio``.
  * length filtering by eos position (``train/train.py:87-89``).
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from ..data.augment import SketchAugment
from ..processing import DetikzifyProcessor

IGNORE_INDEX = -100


def tokenize_batch(
    processor: DetikzifyProcessor,
    texts: Sequence[str],
    images: Optional[Sequence] = None,
    *,
    max_length: Optional[int] = None,
    add_eos: bool = True,
    mask_prompt: bool = False,
) -> Dict[str, np.ndarray]:
    """Batch -> {input_ids, attention_mask, labels, pixel_values?}."""
    # reference training adds ONLY eos, never bos (train/pretrain.py:24)
    out = processor(images=images, text=list(texts),
                    add_eos_token=add_eos, truncation=True)
    ids = out.input_ids
    if max_length is not None and ids.shape[1] > max_length:
        ids = ids[:, :max_length]
        out.attention_mask = out.attention_mask[:, :max_length]
    labels = ids.copy()
    labels[ids == processor.image_token_id] = IGNORE_INDEX
    labels[~out.attention_mask[:, :ids.shape[1]]] = IGNORE_INDEX
    pad = getattr(processor.tokenizer, "pad_token_id", None)
    if pad is not None:
        # mask pad even where attended (some tokenizers reuse eos as pad)
        is_pad = (ids == pad) & ~out.attention_mask[:, :ids.shape[1]]
        labels[is_pad] = IGNORE_INDEX
    batch = {
        "input_ids": ids.astype(np.int32),
        "attention_mask": out.attention_mask[:, :ids.shape[1]],
        "labels": labels.astype(np.int32),
    }
    if out.pixel_values is not None:
        batch["pixel_values"] = out.pixel_values
    return batch


def fits_in_context(processor: DetikzifyProcessor, text: str,
                    max_length: int) -> bool:
    """Length filter: keep examples whose eos lands inside max_length
    (reference train/train.py:87-89)."""
    n = (processor.image_seq_len + 1          # image tokens + bos
         + len(processor.tokenizer.encode(text, add_special_tokens=False))
         + 1)                                  # eos
    return n <= max_length


class SketchDataset:
    """Epoch-aware image/sketch swapping dataset.

    Items are dicts with keys ``image`` (PIL), ``text`` (str), and optional
    ``sketches`` (list of PIL images, e.g. diffusion-sketchified variants).
    Each epoch, with probability ``sketch_ratio`` an item yields a sketch:
    a precomputed one if available, else ``SketchAugment(image)``.
    """

    def __init__(self, items: List[dict], sketch_ratio: float = 0.5,
                 seed: int = 0):
        self.items = items
        self.sketch_ratio = sketch_ratio
        self.epoch = 0
        self._seed = seed
        self._augment = SketchAugment(seed=seed)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, idx: int) -> dict:
        item = dict(self.items[idx])
        rng = np.random.default_rng(
            (self._seed, self.epoch, idx, 0xD371))
        if rng.uniform() < self.sketch_ratio:
            sketches = item.get("sketches") or []
            if sketches:
                item["image"] = sketches[int(rng.integers(len(sketches)))]
            else:
                item["image"] = self._augment(item["image"])
        item.pop("sketches", None)
        return item


def batches(dataset, processor: DetikzifyProcessor, batch_size: int,
            *, max_length: int, shuffle_seed: Optional[int] = None,
            epoch: int = 0, drop_last: bool = True,
            mask_prompt: bool = False) -> Iterator[Dict[str, np.ndarray]]:
    """Shuffled, tokenized fixed-size batches for one epoch."""
    if hasattr(dataset, "set_epoch"):
        dataset.set_epoch(epoch)
    order = np.arange(len(dataset))
    if shuffle_seed is not None:
        np.random.default_rng((shuffle_seed, epoch)).shuffle(order)
    buf: List[dict] = []
    for idx in order:
        buf.append(dataset[int(idx)])
        if len(buf) == batch_size:
            yield _collate(processor, buf, max_length)
            buf = []
    if buf and not drop_last:
        yield _collate(processor, buf, max_length)


def _collate(processor, items, max_length):
    batch = tokenize_batch(
        processor,
        texts=[it["text"] for it in items],
        images=[it["image"] for it in items] if "image" in items[0] else None,
        max_length=max_length)
    # pad the sequence dim to a fixed width: every step sees one shape
    ids = batch["input_ids"]
    if ids.shape[1] < max_length:
        padw = max_length - ids.shape[1]
        pad_id = getattr(processor.tokenizer, "pad_token_id", 0) or 0
        batch["input_ids"] = np.pad(ids, ((0, 0), (0, padw)),
                                    constant_values=pad_id)
        batch["attention_mask"] = np.pad(batch["attention_mask"],
                                         ((0, 0), (0, padw)))
        batch["labels"] = np.pad(batch["labels"], ((0, 0), (0, padw)),
                                 constant_values=IGNORE_INDEX)
    return batch
