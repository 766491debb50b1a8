"""TikZero training entry points: ``pretrain`` (adapter distillation) and
``train`` (TikZero+, the LLM fine-tuned with the adapter attached)."""
