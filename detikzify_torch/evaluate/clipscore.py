"""ClipScore: SigLIP two-tower caption<->render agreement (counterpart of
``detikzify_tpu/evaluate/clipscore.py``).

Reference ``detikzify/evaluate/clipscore.py:12-69``: score =
sigmoid(cos(img_emb, txt_emb) * exp(logit_scale) + logit_bias), averaged.
Both towers run in one batched pass on their device: the vision tower
(``siglip.apply``) and the text tower (``siglip.apply_text``), each
layer's attention through K1 on the card (its fp32 kernel for the fp32
towers JAX builds by default, its bf16 one where a caller asks for bf16);
the normalisation and the sigmoid are plain PyTorch in fp32.

``models.load.load_siglip_towers`` reads a ``SiglipModel`` checkpoint's
weights without ``transformers``; ``from_siglip_checkpoint`` adds its
tokenizer through ``transformers.AutoTokenizer``, as the JAX metric does.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import VisionConfig
from ..models import siglip
from ..processing import preprocess_image


class ClipScore:
    higher_is_better = True

    def __init__(self, vision_params: siglip.SiglipVision,
                 text_params: siglip.SiglipText, cfg: VisionConfig,
                 tokenizer, *, logit_scale: float, logit_bias: float,
                 text_max_len: int = 64, preprocess: bool = True,
                 text_cfg: VisionConfig = None):
        self.vision_params = vision_params
        self.text_params = text_params
        cfg = getattr(cfg, "vision", cfg)   # accept DetikzifyConfig too
        self.cfg = cfg
        self.text_cfg = text_cfg or cfg     # towers may differ in depth
        self.tokenizer = tokenizer
        self.logit_scale = float(logit_scale)
        self.logit_bias = float(logit_bias)
        self.text_max_len = text_max_len
        self.preprocess = preprocess
        self.device = next(vision_params.parameters()).device
        self._sum, self._n = 0.0, 0

    @classmethod
    def from_siglip_checkpoint(cls, path: str, dtype=torch.float32,
                               device="cuda", **kw) -> "ClipScore":
        """Build the two-tower metric from a local transformers
        ``SiglipModel`` checkpoint directory (the reference instantiates
        google/siglip-so400m-patch14-384 from the hub,
        reference clipscore.py:23-34). ``dtype`` defaults to float32 on
        every device, as the JAX metric's; a caller may pass bfloat16."""
        import transformers

        from ..models.load import load_siglip_towers

        t = load_siglip_towers(path, dtype=dtype, device=device)
        tokenizer = transformers.AutoTokenizer.from_pretrained(path)
        return cls(t.vision, t.text, t.cfg, tokenizer,
                   logit_scale=t.logit_scale, logit_bias=t.logit_bias,
                   text_cfg=t.text_cfg, **kw)

    def _tokenize(self, texts) -> np.ndarray:
        ids = np.zeros((len(texts), self.text_max_len), np.int32)
        pad = getattr(self.tokenizer, "pad_token_id", 0) or 0
        ids[:] = pad
        for i, t in enumerate(texts):
            row = self.tokenizer.encode(t, add_special_tokens=False)
            row = row[:self.text_max_len - 1] + [self.tokenizer.eos_token_id]
            # the row starts at position 0 and the padding follows it, as
            # in the JAX metric; the text tower pools the last position
            ids[i, :len(row)] = row
        return ids

    @torch.inference_mode()
    def score_batch(self, images, texts) -> np.ndarray:
        pixels = torch.from_numpy(np.stack([
            preprocess_image(img, self.cfg.image_size,
                             do_trim=self.preprocess) for img in images]))
        tokens = torch.from_numpy(self._tokenize(list(texts)))
        img = siglip.apply(self.vision_params, self.cfg,
                           pixels.to(self.device))["pooler_output"].float()
        txt = siglip.apply_text(self.text_params, self.text_cfg,
                                tokens.to(self.device))["pooler_output"]
        txt = txt.float()
        img = img / (torch.linalg.vector_norm(img, dim=-1, keepdim=True)
                     + 1e-8)
        txt = txt / (torch.linalg.vector_norm(txt, dim=-1, keepdim=True)
                     + 1e-8)
        scale = torch.exp(torch.tensor(self.logit_scale, dtype=torch.float32))
        logits = (img * txt).sum(-1) * scale.item() + self.logit_bias
        return torch.sigmoid(logits).cpu().numpy()

    def update(self, images, text) -> None:
        if not isinstance(text, (list, tuple)):
            text = [text]
        if not isinstance(images, (list, tuple)):
            images = [images]
        scores = self.score_batch(images, text)
        self._sum += float(scores.sum())
        self._n += len(scores)

    def compute(self) -> float:
        if self._n == 0:
            raise RuntimeError("no updates")
        return self._sum / self._n

    def reset(self) -> None:
        self._sum, self._n = 0.0, 0
