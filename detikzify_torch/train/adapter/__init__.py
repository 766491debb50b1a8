"""TikZero post-training (counterpart of ``detikzify_tpu/train/adapter``):
adapter distillation (``pretrain``) and TikZero+ fine-tuning of the LLM
with the adapter attached (``train``)."""
from .pretrain import (AdapterDataset, DistillLossConfig, DistillState,
                       embedding_similarity_loss, make_distill_step,
                       pretrain_adapter)
from .train import (make_adapter_train_step, tokenize_adapter_batch,
                    train_adapter_llm)

# reference exposes pretrain/train at detikzify.train.adapter
pretrain = pretrain_adapter
train = train_adapter_llm

__all__ = ["AdapterDataset", "DistillLossConfig", "DistillState",
           "embedding_similarity_loss", "make_distill_step",
           "pretrain_adapter", "make_adapter_train_step",
           "tokenize_adapter_batch", "train_adapter_llm", "pretrain",
           "train"]
