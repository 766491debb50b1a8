"""Datasets (counterpart of ``detikzify_tpu/dataset/``): so far the
synthetic TikZ corpus, ``synthetic.generate_corpus``."""
from __future__ import annotations

from .synthetic import generate_corpus

__all__ = ["generate_corpus"]
