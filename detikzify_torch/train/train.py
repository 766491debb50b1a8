"""Stage-2 fine-tuning on DaTikZ-style (image, tikz-code) pairs
(counterpart of ``detikzify_tpu/train/train.py``).

Reference: ``detikzify/train/train.py:65-149`` -- full-model fine-tune with
sketch-ratio augmentation, length filtering, checkpoint auto-resume,
bs 128 (grad accum), lr 5e-5, 5 epochs, fractional-epoch saves.
"""
from __future__ import annotations

from typing import List, Optional

from ..config import DetikzifyConfig
from ..processing import DetikzifyProcessor
from .data import SketchDataset, fits_in_context
from .trainer import TrainConfig, Trainer


def train(
    output_dir: str,
    params,
    cfg: DetikzifyConfig,
    processor: DetikzifyProcessor,
    dataset: List[dict],                 # [{image, text, sketches?}, ...]
    *,
    overwrite: bool = False,
    deepspeed=None,                      # accepted for API parity; unused
    batch_size: int = 128,
    micro_batch_size: int = 1,
    learning_rate: float = 5e-5,
    epochs: int = 5,
    sketch_ratio: float = 0.5,
    max_length: Optional[int] = None,
    gradient_checkpointing: bool = False,
    device=None,
    mesh=None,
    seed: int = 0,
    log_fn=print,
):
    max_length = max_length or min(processor.model_max_length,
                                   cfg.model_max_length)
    kept = [ex for ex in dataset
            if fits_in_context(processor, ex["text"], max_length)]
    if len(kept) < len(dataset):
        log_fn(f"filtered {len(dataset) - len(kept)} over-length examples")

    tc = TrainConfig(
        output_dir=output_dir,
        learning_rate=learning_rate,
        epochs=epochs,
        micro_batch_size=micro_batch_size,
        grad_accum=max(batch_size // micro_batch_size, 1),
        max_length=max_length,
        sketch_ratio=sketch_ratio,
        gradient_checkpointing=gradient_checkpointing,
        seed=seed,
        trainable="all",
    )
    trainer = Trainer(params, cfg, processor,
                      SketchDataset(kept, sketch_ratio, seed=seed),
                      tc, mesh=mesh, device=device, log_fn=log_fn)
    state = trainer.train(resume=not overwrite)
    return state.params, processor
