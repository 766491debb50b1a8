"""Host-side image utilities (PIL + numpy only; no torch).

Behavioral equivalents of reference ``detikzify/util/image.py:11-71``:
load from many sources, alpha removal onto white, content-bbox trim,
pad-to-square expansion, and PDF text redaction for leakage-controlled eval.
Resize+normalize (the hot preprocessing op) is driven by
``detikzify_torch.processing``.
"""
from __future__ import annotations

import base64
import io
import os
from typing import Union

import numpy as np
from PIL import Image, ImageChops, ImageOps

ImageInput = Union[Image.Image, str, bytes]

#: Small blank placeholder used when the adapter generates from text alone
#: (reference ``util/image.py:11``; consumed at ``processing_adapter.py:43-55``).
DUMMY_IMAGE = Image.new("RGB", (24, 24), color="white")


def convert(image: Image.Image, filetype: str) -> Image.Image:
    """Round-trip through an encoded format (e.g. force-jpeg artifacts)."""
    buf = io.BytesIO()
    image.save(buf, format=filetype)
    buf.seek(0)
    return Image.open(buf)


def remove_alpha(image: Image.Image, bg: tuple = (255, 255, 255)) -> Image.Image:
    """Composite any alpha channel onto a solid background."""
    if image.mode in ("RGBA", "LA", "PA") or (
            image.mode == "P" and "transparency" in image.info):
        rgba = image.convert("RGBA")
        canvas = Image.new("RGBA", rgba.size, bg + (255,))
        return Image.alpha_composite(canvas, rgba).convert("RGB")
    return image.convert("RGB")


def trim(image: Image.Image, border: str = "white") -> Image.Image:
    """Crop to the content bounding box against a solid border color.

    Any non-background pixel counts as content (anti-aliasing halos
    included), matching reference ``util/image.py:24-28`` exactly so
    trimmed geometry is comparable."""
    image = remove_alpha(image)
    bg = Image.new(image.mode, image.size, border)
    diff = ImageChops.difference(image, bg)
    bbox = diff.getbbox()
    return image.crop(bbox) if bbox else image


def expand(image: Image.Image, size: int, do_trim: bool = False) -> Image.Image:
    """Trim (optional) then scale-and-pad to a centered ``size`` square
    (reference ``util/image.py:30-33`` -- ImageOps.pad semantics)."""
    if do_trim:
        image = trim(image)
    image = remove_alpha(image)
    return ImageOps.pad(image, (size, size), color=(255, 255, 255),
                        method=Image.Resampling.LANCZOS)


def load(image: ImageInput, timeout: float | None = None) -> Image.Image:
    """Load an image from a PIL object, path, URL, base64 string, or bytes.

    Applies EXIF orientation like the reference loader
    (``util/image.py:36-60``).
    """
    if isinstance(image, Image.Image):
        pil = image
    elif isinstance(image, bytes):
        pil = Image.open(io.BytesIO(image))
    elif isinstance(image, str):
        if image.startswith(("http://", "https://")):
            import requests  # deferred: zero-egress envs never hit this

            resp = requests.get(image, timeout=timeout or 10)
            resp.raise_for_status()
            pil = Image.open(io.BytesIO(resp.content))
        elif os.path.isfile(image):
            pil = Image.open(image)
        else:
            # assume base64 payload, optionally data-URI prefixed
            payload = image.split(",", 1)[-1]
            pil = Image.open(io.BytesIO(base64.b64decode(payload)))
    else:
        raise TypeError(f"cannot load image from {type(image)!r}")
    pil = ImageOps.exif_transpose(pil)
    return remove_alpha(pil)


def redact(document, rot13: bool = False):
    """Redact (or rot13-scramble) all text in a PDF document in place.

    Used by leakage-controlled eval variants (reference ``util/image.py:62-71``,
    consumed by ``examples/eval.py:156-193``). ``document`` is a PyMuPDF
    document; gated on the optional ``pymupdf`` dependency.
    """
    import codecs

    for page in document:
        for word in page.get_text("words"):
            rect, text = word[:4], word[4]
            if rot13:
                page.add_redact_annot(rect, text=codecs.encode(text, "rot13"))
            else:
                page.add_redact_annot(rect)
        page.apply_redactions()
    return document


def to_array(image: Image.Image, size: int | None = None) -> np.ndarray:
    """PIL -> float32 HWC array in [0, 1], optionally square-resized."""
    if size is not None:
        image = expand(image, size)
    return np.asarray(remove_alpha(image), dtype=np.float32) / 255.0
