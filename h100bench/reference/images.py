"""Figures to pixels, as the system's documented preprocessing reads
them: trim to the content's bounding box against white, pad to a centred
square with white (Lanczos), resize to the tower's size (bicubic), scale
to [0, 1], then (x - 0.5) / 0.5. PIL and NumPy only."""
from __future__ import annotations

import numpy as np
from PIL import Image, ImageChops, ImageOps


def _rgb(img: Image.Image) -> Image.Image:
    if img.mode in ("RGBA", "LA") or (img.mode == "P"
                                      and "transparency" in img.info):
        rgba = img.convert("RGBA")
        canvas = Image.new("RGBA", rgba.size, (255, 255, 255, 255))
        return Image.alpha_composite(canvas, rgba).convert("RGB")
    return img.convert("RGB")


def square(img: Image.Image, size: int, trim: bool) -> Image.Image:
    img = _rgb(img)
    if trim:
        bbox = ImageChops.difference(
            img, Image.new(img.mode, img.size, "white")).getbbox()
        if bbox:
            img = img.crop(bbox)
    return ImageOps.pad(img, (size, size), color=(255, 255, 255),
                        method=Image.Resampling.LANCZOS)


def pixels(img: Image.Image, size: int) -> np.ndarray:
    """A figure as a request carries it -> normalised float32 [H, W, 3]:
    trimmed and squared at its own scale, then resized."""
    img = square(img, max(img.size), trim=True)
    img = img.resize((size, size), Image.Resampling.BICUBIC)
    return (np.asarray(img, np.float32) / 255.0 - 0.5) / 0.5
