"""Kernel Inception Distance over SigLIP image features (counterpart of
``detikzify_tpu/evaluate/kid.py``).

Reference ``detikzify/evaluate/kid.py:29-74``: torchmetrics KID with a
SigLIP ``get_image_features`` wrapper, subset_size=50. The features are the
pooled output of the model's own SigLIP tower (``siglip.apply``: K1 on the
card), kept on the host in float64 as the JAX metric keeps them. Subsets
are drawn on the host with ``numpy.random.default_rng(seed)``, exactly as
JAX draws them, and each subset's unbiased polynomial-kernel MMD^2 runs in
float32 on the tower's device: JAX computes it in float32 too (x64 is
off), and a plain PyTorch product suffices, as it is plain XLA there.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..config import VisionConfig
from ..models import siglip
from ..processing import preprocess_image


def poly_mmd2(x: torch.Tensor, y: torch.Tensor, degree: int = 3,
              coef: float = 1.0) -> torch.Tensor:
    """Unbiased MMD^2 with kernel k(a,b) = (a.b/d + coef)^degree."""
    d = x.shape[-1]
    m, n = x.shape[0], y.shape[0]
    kxx = (x @ x.T / d + coef) ** degree
    kyy = (y @ y.T / d + coef) ** degree
    kxy = (x @ y.T / d + coef) ** degree
    sum_kxx = (kxx.sum() - torch.trace(kxx)) / (m * (m - 1))
    sum_kyy = (kyy.sum() - torch.trace(kyy)) / (n * (n - 1))
    sum_kxy = kxy.sum() * 2.0 / (m * n)
    return sum_kxx + sum_kyy - sum_kxy


class KernelInceptionDistance:
    higher_is_better = False

    def __init__(self, vision_params: siglip.SiglipVision, cfg: VisionConfig,
                 *, subset_size: int = 50, subsets: int = 100, seed: int = 0,
                 preprocess: bool = True):
        self.vision_params = vision_params
        cfg = getattr(cfg, "vision", cfg)   # accept DetikzifyConfig too
        self.cfg = cfg
        self.subset_size = subset_size
        self.subsets = subsets
        self.seed = seed
        self.preprocess = preprocess
        self.device = next(vision_params.parameters()).device
        self._real: List[np.ndarray] = []
        self._fake: List[np.ndarray] = []

    @torch.inference_mode()
    def _features(self, images) -> np.ndarray:
        pixels = torch.from_numpy(np.stack([
            preprocess_image(img, self.cfg.image_size,
                             do_trim=self.preprocess) for img in images]))
        out = siglip.apply(self.vision_params, self.cfg,
                           pixels.to(self.device))["pooler_output"]
        return out.float().cpu().numpy().astype(np.float64)

    def update(self, images, real: bool) -> None:
        if not isinstance(images, (list, tuple)):
            images = [images]
        (self._real if real else self._fake).append(self._features(images))

    @torch.inference_mode()
    def compute(self) -> tuple:
        """Returns (mean, std) of per-subset MMD^2, like torchmetrics."""
        real = np.concatenate(self._real)
        fake = np.concatenate(self._fake)
        n = min(len(real), len(fake), self.subset_size)
        if n < 2:
            raise RuntimeError("need at least 2 samples per distribution")
        rng = np.random.default_rng(self.seed)

        def dev(a):
            return torch.as_tensor(a, dtype=torch.float32, device=self.device)

        vals = []
        for _ in range(self.subsets):
            r = real[rng.choice(len(real), n, replace=False)]
            f = fake[rng.choice(len(fake), n, replace=False)]
            vals.append(float(poly_mmd2(dev(r), dev(f))))
        return float(np.mean(vals)), float(np.std(vals))

    def reset(self) -> None:
        self._real, self._fake = [], []
