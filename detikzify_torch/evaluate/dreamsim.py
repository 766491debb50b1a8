"""DreamSim perceptual similarity (counterpart of
``detikzify_tpu/evaluate/dreamsim.py``).

Reference ``detikzify/evaluate/dreamsim.py:13-89`` wraps the ``dreamsim``
package's ViT ensemble and reports 1 - distance. Three paths here:

  * ``detikzify_torch.evaluate.dreamsim_vit.DreamSimViT`` -- the ensemble
    (DINO/CLIP ViT-B/16 towers) with its weight importers; use it with
    the published LoRA-merged checkpoints or converted backbones.
  * ``DreamSim`` below -- thin wrapper over the optional ``dreamsim``
    package, gated exactly like the reference's ``[evaluate]`` extra.
  * ``SigLIPDreamSim`` -- dependency-free same-API stand-in scoring
    1 - cosine distance on SigLIP patch embeddings (clearly labeled a
    substitute, not DreamSim).
"""
from __future__ import annotations

from typing import List


class DreamSim:
    higher_is_better = True

    def __init__(self, pretrained: bool = True, device: str = "cuda",
                 **kw):
        try:
            from dreamsim import dreamsim  # type: ignore
        except ImportError as e:
            raise ImportError(
                "DreamSim requires the optional `dreamsim` package "
                "(pip install dreamsim); without it use "
                "detikzify_torch.evaluate.dreamsim_vit.DreamSimViT (the "
                "ensemble from its published checkpoints) or the "
                "dependency-free substitute "
                "detikzify_torch.evaluate.dreamsim.SigLIPDreamSim"
            ) from e
        self.model, self.preprocess = dreamsim(pretrained=pretrained,
                                               device=device, **kw)
        self.device = device
        self._scores: List[float] = []

    def update(self, img1, img2) -> None:
        import torch

        with torch.inference_mode():
            d = self.model(self.preprocess(img1).to(self.device),
                           self.preprocess(img2).to(self.device))
        self._scores.append(1.0 - float(d))

    def compute(self) -> float:
        if not self._scores:
            raise RuntimeError("no updates")
        return sum(self._scores) / len(self._scores)

    def reset(self) -> None:
        self._scores = []


class SigLIPDreamSim:
    """Substitute perceptual metric with the DreamSim API shape, backed by
    the model's SigLIP tower (mean-patch cosine). NOT the published
    DreamSim."""

    higher_is_better = True

    def __init__(self, vision_params, cfg):
        from .imagesim import ImageSim

        self._metric = ImageSim(vision_params, cfg, mode="cos_avg")
        self._scores: List[float] = []

    def update(self, img1, img2) -> None:
        self._scores.append(self._metric.score(img1, img2))

    def compute(self) -> float:
        if not self._scores:
            raise RuntimeError("no updates")
        return sum(self._scores) / len(self._scores)

    def reset(self) -> None:
        self._scores = []
