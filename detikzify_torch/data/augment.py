"""Image augmentations for training (PIL + numpy; host-side dataloader path;
a copy of ``detikzify_tpu/data/augment.py``: the same seed gives the same
pixels).

Equivalents of reference ``detikzify/util/trainer.py:42-127``:
  * ``SketchAugment``  -- elastic transform + JPEG artifacts + color jitter +
    equalize + grayscale, applied in random order (simulates hand-drawn
    sketches during fine-tuning, ``train/train.py`` ds_sketch_ratio path)
  * ``FullErase``      -- blank the image (adapter pretraining partition)
  * ``EditCutOut`` / ``EditMixUp`` / ``EditCutMix`` -- box-masked image
    editing used by the multimodal adapter distillation dataset

All operate on PIL RGB images and are deterministic given a seeded
``numpy.random.Generator``.
"""
from __future__ import annotations

import io
from typing import Optional

import numpy as np
from PIL import Image, ImageEnhance, ImageOps

from ..utils.image import remove_alpha


def _rng(rng) -> np.random.Generator:
    return rng if isinstance(rng, np.random.Generator) \
        else np.random.default_rng(rng)


def elastic_transform(image: Image.Image, alpha: float = 50.0,
                      sigma: float = 5.0,
                      rng: Optional[np.random.Generator] = None
                      ) -> Image.Image:
    """Elastic deformation (Simard et al. 2003): smooth random displacement
    field, bilinear resample. Fill color white (document images)."""
    rng = _rng(rng)
    arr = np.asarray(remove_alpha(image), np.float32)
    h, w = arr.shape[:2]

    def field():
        coarse = rng.uniform(-1, 1, (max(h // 16, 2), max(w // 16, 2)))
        img = Image.fromarray(((coarse + 1) * 127.5).astype(np.uint8))
        smooth = np.asarray(img.resize((w, h), Image.BILINEAR), np.float32)
        return (smooth / 127.5 - 1.0) * alpha

    dx, dy = field(), field()
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    sx = np.clip(xs + dx, 0, w - 1)
    sy = np.clip(ys + dy, 0, h - 1)
    x0 = np.floor(sx).astype(np.int32)
    y0 = np.floor(sy).astype(np.int32)
    x1 = np.minimum(x0 + 1, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    fx = (sx - x0)[..., None]
    fy = (sy - y0)[..., None]
    out = (arr[y0, x0] * (1 - fx) * (1 - fy) + arr[y0, x1] * fx * (1 - fy)
           + arr[y1, x0] * (1 - fx) * fy + arr[y1, x1] * fx * fy)
    return Image.fromarray(out.astype(np.uint8))


def jpeg_artifacts(image: Image.Image, quality_range=(10, 40),
                   rng=None) -> Image.Image:
    rng = _rng(rng)
    buf = io.BytesIO()
    remove_alpha(image).save(buf, format="JPEG",
                             quality=int(rng.integers(*quality_range)))
    buf.seek(0)
    return Image.open(buf).convert("RGB")


def color_jitter(image: Image.Image, strength: float = 0.4,
                 rng=None) -> Image.Image:
    rng = _rng(rng)
    img = remove_alpha(image)
    for enhancer in (ImageEnhance.Brightness, ImageEnhance.Contrast,
                     ImageEnhance.Color):
        img = enhancer(img).enhance(
            1.0 + float(rng.uniform(-strength, strength)))
    return img


class SketchAugment:
    """Random-order composition of sketch-simulating transforms
    (reference ``SketchAugment``, util/trainer.py:42-53)."""

    def __init__(self, intensity: float = 1.0, seed: Optional[int] = None):
        self.intensity = intensity
        self.rng = np.random.default_rng(seed)

    def __call__(self, image: Image.Image) -> Image.Image:
        ops = [
            lambda im: elastic_transform(im, alpha=50 * self.intensity,
                                         rng=self.rng),
            lambda im: jpeg_artifacts(im, rng=self.rng),
            lambda im: color_jitter(im, 0.4 * self.intensity, rng=self.rng),
            lambda im: ImageOps.equalize(remove_alpha(im)),
            lambda im: ImageOps.grayscale(remove_alpha(im)).convert("RGB"),
        ]
        order = self.rng.permutation(len(ops))
        img = image
        for i in order:
            img = ops[i](img)
        return img


class FullErase:
    """Blank the entire image (reference util/trainer.py:55-57)."""

    def __call__(self, image: Image.Image) -> Image.Image:
        return Image.new("RGB", image.size, "white")


class _EditBase:
    """Box-masked editing base (reference EditBase, util/trainer.py:59-83)."""

    def __init__(self, scale=(0.2, 0.5), seed: Optional[int] = None):
        self.scale = scale
        self.rng = np.random.default_rng(seed)

    def _box(self, size) -> tuple:
        w, h = size
        sw = int(w * self.rng.uniform(*self.scale))
        sh = int(h * self.rng.uniform(*self.scale))
        x = int(self.rng.integers(0, max(w - sw, 1)))
        y = int(self.rng.integers(0, max(h - sh, 1)))
        return (x, y, x + sw, y + sh)


class EditCutOut(_EditBase):
    """Erase a random box to white."""

    def __call__(self, image: Image.Image) -> Image.Image:
        img = remove_alpha(image).copy()
        img.paste(Image.new("RGB", img.size, "white"), (0, 0),
                  mask=self._box_mask(img.size))
        return img

    def _box_mask(self, size):
        mask = Image.new("L", size, 0)
        from PIL import ImageDraw

        ImageDraw.Draw(mask).rectangle(self._box(size), fill=255)
        return mask


class EditMixUp(_EditBase):
    """Alpha-blend with another image."""

    def __call__(self, image: Image.Image, other: Image.Image
                 ) -> Image.Image:
        a = remove_alpha(image)
        b = remove_alpha(other).resize(a.size)
        alpha = float(self.rng.uniform(0.2, 0.5))
        return Image.blend(a, b, alpha)


class EditCutMix(_EditBase):
    """Paste a random box from another image."""

    def __call__(self, image: Image.Image, other: Image.Image
                 ) -> Image.Image:
        a = remove_alpha(image).copy()
        b = remove_alpha(other).resize(a.size)
        box = self._box(a.size)
        a.paste(b.crop(box), box[:2])
        return a
