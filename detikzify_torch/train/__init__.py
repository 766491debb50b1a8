"""Training (counterpart of ``detikzify_tpu/train``): the stage-1
projector ``pretrain`` and the stage-2 ``train`` entry points, the
``Trainer`` loop, the step and its optimizers, checkpoints; post-training
in ``adapter`` (TikZero distillation and TikZero+) and ``grpo``."""
from . import adapter, grpo
from .pretrain import pretrain
from .train import train
from .step import (TrainState, init_state, make_optimizer, make_train_step,
                   trainable_mask)
from .trainer import TrainConfig, Trainer
from .checkpoint import Checkpointer, get_last_checkpoint, save_params_npz

__all__ = ["adapter", "grpo", "pretrain", "train", "TrainState",
           "init_state", "make_optimizer", "make_train_step", "trainable_mask", "TrainConfig", "Trainer",
           "Checkpointer", "get_last_checkpoint", "save_params_npz"]
