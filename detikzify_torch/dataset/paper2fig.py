"""Paper2Fig100k loader (counterpart of ``detikzify_tpu/dataset/paper2fig.py``;
reference ``dataset/paper2fig/paper2fig.py:23-58``).

Streams figures + captions/mentions/OCR from the Paper2Fig100k tar archive,
pads images to square. Accepts a local archive path (preferred in
zero-egress environments) or downloads from Zenodo.
"""
from __future__ import annotations

import io
import json
import tarfile
from itertools import chain
from os.path import basename
from typing import Iterator, Optional

from ..utils.image import expand, load as load_image

ARCHIVE_URL = "https://zenodo.org/records/7299423/files/Paper2Fig100k.tar.gz"

FEATURES = ("caption", "mention", "ocr", "image")


def iter_paper2fig(archive_path: str, size: int = 420) -> Iterator[dict]:
    """Yield {caption, mention, ocr, image} dicts from the archive."""
    with tarfile.open(archive_path) as tf:
        metadata = {}
        json_members = [m for m in tf if m.name.endswith(".json")]
        for figdata in chain.from_iterable(
                json.load(tf.extractfile(m)) for m in json_members):
            metadata[figdata.pop("figure_id")] = figdata
        tf.members = []  # free the member cache; re-scan for images
        with tarfile.open(archive_path) as tf2:
            for member in tf2:
                if not member.name.endswith(".png"):
                    continue
                figure_id = basename(member.name).removesuffix(".png")
                figdata = metadata.get(figure_id)
                if figdata is None:
                    continue
                image = load_image(tf2.extractfile(member).read())
                yield dict(
                    caption=figdata["captions"][0],
                    mention=[figdata["captions"][1:]],
                    ocr=[r["text"] for r in
                         figdata["ocr_result"]["ocr_result"]],
                    image=expand(image, size),
                )


def load_paper2fig(archive: Optional[str] = None, size: int = 420,
                   streaming: bool = False):
    """Returns an HF Dataset (or a generator when ``streaming``)."""
    if archive is None:
        from .download import fetch

        archive = fetch(ARCHIVE_URL)
    if streaming:
        return iter_paper2fig(archive, size)
    import datasets

    return datasets.Dataset.from_generator(
        lambda: iter_paper2fig(archive, size))
