"""Adapter processor: joint (caption, image) preprocessing for TikZero
(the port's own copy of ``detikzify_tpu/processing_adapter.py``).

Reference ``detikzify/model/adapter/processing_adapter.py:20-74``: wraps the
base processor, tokenizes the caption into ``adapter_input_ids`` /
``adapter_attention_mask`` (padded on the right), and substitutes
``DUMMY_IMAGE`` when no image is given (generation from a caption alone
uses the adapter's learnable blank instead at model level --
``modeling_adapter.py:500-501``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np

from .models.embedding import pad_right
from .processing import DetikzifyProcessor, ProcessorOutput
from .utils.image import DUMMY_IMAGE


@dataclasses.dataclass
class AdapterProcessorOutput(ProcessorOutput):
    adapter_input_ids: Optional[np.ndarray] = None
    adapter_attention_mask: Optional[np.ndarray] = None


class AdapterProcessor:
    def __init__(self, processor: DetikzifyProcessor, tokenizer,
                 max_length: int = 512):
        if processor is None or tokenizer is None:
            raise ValueError("processor and tokenizer are both required")
        self.processor = processor
        self.tokenizer = tokenizer
        self.max_length = max_length

    @property
    def model_max_length(self) -> int:
        return self.processor.model_max_length

    @property
    def image_token_id(self) -> int:
        return self.processor.image_token_id

    @property
    def image_seq_len(self) -> int:
        return self.processor.image_seq_len

    def __call__(self, images=None,
                 text: Union[str, Sequence[str], None] = None,
                 **kw) -> AdapterProcessorOutput:
        if images is None and text is None:
            raise ValueError("either images or text (or both) required")
        adapter_ids = adapter_mask = None
        if text is not None:
            texts = [text] if isinstance(text, str) else list(text)
            adapter_ids, adapter_mask = pad_right(self.tokenizer, texts,
                                                  self.max_length)
            if images is None:
                images = [DUMMY_IMAGE] * len(texts)
        # TikZero+ checkpoints condition the LLM prompt on the caption too:
        # image tokens + caption + <bos> separator (reference
        # processing_adapter.py:48-49, processing_detikzify.py:105-106)
        if text is not None and getattr(self.processor,
                                        "model_expects_text", False):
            base = self.processor(images=images, text=texts,
                                  add_bos_token=True, **kw)
        else:
            base = self.processor(images=images, text=None, **kw)
        return AdapterProcessorOutput(
            input_ids=base.input_ids,
            pixel_values=base.pixel_values,
            attention_mask=base.attention_mask,
            adapter_input_ids=adapter_ids,
            adapter_attention_mask=adapter_mask,
        )

    def decode(self, *a, **kw):
        return self.processor.decode(*a, **kw)

    def batch_decode(self, *a, **kw):
        return self.processor.batch_decode(*a, **kw)
