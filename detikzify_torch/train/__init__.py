"""Training (counterpart of ``detikzify_tpu/train``): the stage-1
projector ``pretrain`` and the stage-2 ``train`` entry points, the
``Trainer`` loop, the step and its optimizers, checkpoints."""
from .pretrain import pretrain
from .train import train
from .step import (TrainState, init_state, make_optimizer, make_train_step,
                   trainable_mask)
from .trainer import TrainConfig, Trainer
from .checkpoint import Checkpointer, get_last_checkpoint, save_params_npz

__all__ = ["pretrain", "train", "TrainState", "init_state", "make_optimizer",
           "make_train_step", "trainable_mask", "TrainConfig", "Trainer",
           "Checkpointer", "get_last_checkpoint", "save_params_npz"]
