"""Stage-1 modality-projector pretraining (caption -> figure alignment;
counterpart of ``detikzify_tpu/train/pretrain.py``).

Reference: ``detikzify/train/pretrain.py:11-114`` -- freeze everything
except the connector's modality projection, bs 256 via grad accum, lr 1e-3,
cosine schedule, one epoch; save only the projector weights at the end.
"""
from __future__ import annotations

from typing import List, Optional

from ..config import DetikzifyConfig
from ..processing import DetikzifyProcessor
from .checkpoint import _process_rank, save_params_npz
from .data import fits_in_context
from .trainer import TrainConfig, Trainer


def pretrain(
    output_dir: str,
    params,
    cfg: DetikzifyConfig,
    processor: DetikzifyProcessor,
    dataset: List[dict],                 # [{image, text(caption)}, ...]
    *,
    overwrite: bool = False,
    deepspeed=None,                      # API parity; ZeRO-3 guard moot here
    batch_size: int = 256,
    micro_batch_size: int = 1,
    learning_rate: float = 1e-3,
    epochs: int = 1,
    max_length: Optional[int] = None,
    device=None,
    mesh=None,
    seed: int = 0,
    log_fn=print,
):
    max_length = max_length or min(processor.model_max_length,
                                   cfg.model_max_length)
    kept = [ex for ex in dataset
            if fits_in_context(processor, ex["text"], max_length)]

    tc = TrainConfig(
        output_dir=output_dir,
        learning_rate=learning_rate,
        epochs=epochs,
        micro_batch_size=micro_batch_size,
        grad_accum=max(batch_size // micro_batch_size, 1),
        max_length=max_length,
        sketch_ratio=0.0,
        save_epoch_fraction=1.0,
        seed=seed,
        trainable="projector",
    )
    trainer = Trainer(params, cfg, processor, kept, tc, mesh=mesh,
                      device=device, log_fn=log_fn)
    state = trainer.train(resume=not overwrite)
    # partial-state save: projector only (reference pretrain.py:104-111),
    # written once
    if _process_rank() == 0:
        save_params_npz(f"{output_dir}/modality_projector.npz", state.params,
                        only="connector")
    return state.params, processor
