"""ImageSim (SelfSim): perceptual similarity through the model's own vision
tower (counterpart of ``detikzify_tpu/evaluate/imagesim.py``).

Modes:
  * ``cos``      -- cosine of attention-pooled (MAP head) embeddings;
  * ``cos_avg``  -- cosine of mean patch embeddings;
  * ``emd``      -- patchwise Earth Mover's Distance through
                    ``2 * tanh(-emd2) + 1``, with EMD from entropy-
                    regularized log-domain Sinkhorn (reg 0.01, 200
                    iterations), the default of the v2 family.

The encoder pass is ``siglip.apply`` on the tower's own weights, so its
attention runs kernel K1 on the card (and K5 for the MAP head's q and o
projections of an int8 tower). Sinkhorn is plain PyTorch, as it is plain
XLA in the JAX package. Pair scores are computed in fp32 from the tower's
features (a bf16 cost matrix would quantize the distances). Renders arrive
as uint8 and are normalised on the device with the checkpoint's mean and
std. The metric state follows the update/compute/reset contract. With
the TikZero adapter's ``AdapterBundle``, ``features(image, text)``
conditions the tower on a caption (its cross-attention runs K1 over the
key-masked caption); renders are never conditioned, so only the reference
features of a search carry the caption.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from ..config import DetikzifyConfig
from ..models import siglip
from ..utils.image import DUMMY_IMAGE


def _cos(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a = a / (torch.linalg.vector_norm(a, dim=-1, keepdim=True) + 1e-8)
    b = b / (torch.linalg.vector_norm(b, dim=-1, keepdim=True) + 1e-8)
    return (a * b).sum(-1)


def sinkhorn_emd2(cost: torch.Tensor, reg: float = 0.01,
                  iters: int = 200) -> torch.Tensor:
    """Entropy-regularized EMD with uniform marginals, in fp32.
    cost: [..., N, M] -> [...]."""
    cost = cost.float()
    n, m = cost.shape[-2:]
    log_a = torch.full(cost.shape[:-1], -math.log(n), device=cost.device)
    log_b = torch.full(cost.shape[:-2] + (m,), -math.log(m),
                       device=cost.device)
    log_k = -cost / reg
    # scaled potentials: f, g are the dual potentials divided by reg
    f = torch.zeros_like(log_a)
    g = torch.zeros_like(log_b)
    for _ in range(iters):
        f = log_a - torch.logsumexp(log_k + g[..., None, :], dim=-1)
        g = log_b - torch.logsumexp(log_k + f[..., :, None], dim=-2)
    log_pi = f[..., :, None] + g[..., None, :] + log_k
    return (torch.exp(log_pi) * cost).sum(dim=(-2, -1))


def score_pairs(e1: torch.Tensor, e2: torch.Tensor, mode: str
                ) -> torch.Tensor:
    """Per-pair similarity of two feature batches, in fp32."""
    e1, e2 = e1.float(), e2.float()
    if mode == "cos":
        return _cos(e1, e2)
    if mode == "cos_avg":
        return _cos(e1.mean(dim=1), e2.mean(dim=1))
    a = e1 / (torch.linalg.vector_norm(e1, dim=-1, keepdim=True) + 1e-8)
    b = e2 / (torch.linalg.vector_norm(e2, dim=-1, keepdim=True) + 1e-8)
    cost = 1.0 - torch.einsum("bnd,bmd->bnm", a, b)
    return 2.0 * torch.tanh(-sinkhorn_emd2(cost)) + 1.0


class ImageSim:
    """Self-similarity metric. update()/compute()/reset() accumulate a mean."""

    higher_is_better = True

    def __init__(self, vision_params: siglip.SiglipVision,
                 cfg: DetikzifyConfig, mode: str = "cos",
                 preprocess: bool = True, adapter=None, image_mean=0.5,
                 image_std=0.5):
        if mode not in ("cos", "cos_avg", "emd"):
            raise ValueError(f"unknown ImageSim mode {mode!r}")
        self.vision_params = vision_params
        self.cfg = cfg
        self.mode = mode
        self.preprocess = preprocess
        self.adapter = adapter          # AdapterBundle: text conditioning
        # checkpoint-local normalisation stats: renders must be normalised
        # exactly like the model's prompt pixels
        self.image_mean = image_mean
        self.image_std = image_std
        self.device = next(vision_params.parameters()).device
        self._sum = 0.0
        self._n = 0
        self._feature_cache: "OrderedDict" = OrderedDict()

    @classmethod
    def from_detikzify(cls, params, cfg: DetikzifyConfig, *,
                       processor=None, mode: Optional[str] = None,
                       adapter=None, **kw) -> "ImageSim":
        """Build from a composite model's params; pass the model's
        ``AdapterBundle`` for text-conditioned (TikZero) scoring. ``mode``
        resolves as in the reference: explicit argument > the config's
        ``pooling_mode`` > ``"emd"``. A ``processor`` supplies the
        normalisation stats."""
        if mode is None:
            mode = getattr(cfg, "pooling_mode", None) or "emd"
        if processor is not None:
            kw.setdefault("image_mean", getattr(processor, "image_mean", 0.5))
            kw.setdefault("image_std", getattr(processor, "image_std", 0.5))
        return cls(params.vision, cfg, mode=mode, adapter=adapter, **kw)

    # ------------------------------------------------------------------
    # device functions

    def _norm(self, pixels: torch.Tensor) -> torch.Tensor:
        """uint8 pixels are normalised here; float pixels pass through."""
        if pixels.dtype == torch.uint8:
            # a scalar or a per-channel list (a checkpoint's statistics)
            mean, std = (torch.as_tensor(np.asarray(s, np.float32),
                                         device=pixels.device)
                         for s in (self.image_mean, self.image_std))
            return (pixels.float() / 255.0 - mean) / std
        return pixels

    @torch.inference_mode()
    def embed(self, pixels: torch.Tensor, adapter_inputs=None
              ) -> torch.Tensor:
        """[B, H, W, C] uint8 or normalised float -> features (pooled for
        ``cos``, every patch otherwise); caption-conditioned with
        ``adapter_inputs`` (a ``siglip.AdapterInputs``)."""
        out = siglip.apply(self.vision_params, self.cfg.vision,
                           self._norm(pixels.to(self.device)),
                           adapter=adapter_inputs)
        return (out["pooler_output"] if self.mode == "cos"
                else out["last_hidden_state"])

    @torch.inference_mode()
    def wave_score(self, pixels: torch.Tensor, ref: torch.Tensor
                   ) -> torch.Tensor:
        """Encoder pass over a render wave and its scores against ONE
        reference embedding ``ref`` [1, ...], on the device."""
        e1 = self.embed(pixels)
        return score_pairs(e1, ref.expand_as(e1), self.mode)

    # ------------------------------------------------------------------

    def _pixels(self, img) -> np.ndarray:
        """PIL/path -> uint8 [H, W, C] (normalised on the device); an
        already-normalised FLOAT array passes through. A uint8 HWC array is
        an image and goes through the resize path."""
        if img is None:
            img = DUMMY_IMAGE
        if isinstance(img, np.ndarray) and img.ndim == 3:
            if img.dtype == np.uint8:
                from PIL import Image as _Image

                img = _Image.fromarray(img)
            else:
                return np.ascontiguousarray(img, np.float32)
        from PIL import Image

        from ..utils.image import expand, load, remove_alpha

        pil = load(img) if not isinstance(img, Image.Image) else img
        if self.preprocess:
            # trim, then pad to a square at the ORIGINAL scale, then the
            # bicubic resize (stretching a trimmed rectangle would distort)
            pil = expand(pil, max(pil.size), do_trim=True)
        size = self.cfg.vision.image_size
        pil = remove_alpha(pil).resize((size, size), Image.Resampling.BICUBIC)
        return np.array(pil, np.uint8)

    def _tensor(self, pix: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(pix).to(self.device)

    def features(self, image=None, text: Optional[str] = None
                 ) -> torch.Tensor:
        """Features of one (image, text) input, either may be None,
        memoised (16-entry LRU) on (pixel bytes, text): in the MCTS loop the
        input figure is scored against every render, so its embedding is
        computed once per search."""
        if image is None and text is None:
            raise ValueError("image or text required")
        pixels = self._pixels(image)
        key = (pixels.tobytes(), text)
        hit = self._feature_cache.get(key)
        if hit is not None:
            self._feature_cache.move_to_end(key)
            return hit
        pix = self._tensor(pixels)[None]
        if text is None:
            out = self.embed(pix)
        elif self.adapter is None:
            raise ValueError("text-conditioned scoring needs an adapter")
        else:
            out = self.embed(pix, self.adapter.adapter_inputs([text]))
        self._feature_cache[key] = out
        while len(self._feature_cache) > 16:
            self._feature_cache.popitem(last=False)
        return out

    @torch.inference_mode()
    def score(self, img1=None, img2=None, text1: Optional[str] = None,
              text2: Optional[str] = None) -> float:
        e1 = self.features(img1, text1)
        e2 = self.features(img2, text2)
        return float(score_pairs(e1, e2, self.mode)[0])

    @staticmethod
    def _bucket(n: int) -> int:
        b = 1
        while b < n:
            b *= 2
        return b

    def _stack(self, imgs) -> np.ndarray:
        """Render batch padded (last render repeated) to a power of two."""
        pix = np.stack([self._pixels(i) for i in imgs])
        b = self._bucket(len(imgs))
        if b > len(imgs):
            pix = np.concatenate([pix, np.repeat(pix[-1:], b - len(imgs),
                                                 axis=0)])
        return pix

    def score_against_async(self, imgs, ref_image=None,
                            text: Optional[str] = None):
        """Enqueue the wave's encoder pass and scoring on the device without
        waiting for it. Returns (scores on the device, k); slice [:k]."""
        ref = self.features(ref_image, text)          # LRU-cached
        return self.wave_score(self._tensor(self._stack(imgs)), ref), \
            len(imgs)

    def score_against(self, imgs, ref_image=None,
                      text: Optional[str] = None) -> np.ndarray:
        """Scores of a batch of renders against ONE (cached) reference."""
        dev, k = self.score_against_async(imgs, ref_image, text)
        return dev[:k].cpu().numpy()

    @torch.inference_mode()
    def score_batch(self, imgs1, imgs2) -> np.ndarray:
        """Batched image-pair scores."""
        k = len(imgs1)
        e1 = self.embed(self._tensor(self._stack(imgs1)))
        e2 = self.embed(self._tensor(self._stack(imgs2)))
        return score_pairs(e1, e2, self.mode)[:k].cpu().numpy()

    # torchmetrics-style stateful interface -------------------------------

    def update(self, img1=None, img2=None, text1=None, text2=None) -> None:
        self._sum += self.score(img1, img2, text1, text2)
        self._n += 1

    def compute(self) -> float:
        if self._n == 0:
            raise RuntimeError("no updates")
        return self._sum / self._n

    def reset(self) -> None:
        self._sum, self._n = 0.0, 0

    def __call__(self, img1=None, img2=None, **kw) -> float:
        return self.score(img1, img2, **kw)
