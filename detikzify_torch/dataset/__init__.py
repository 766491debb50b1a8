"""Dataset loaders (counterpart of ``detikzify_tpu/dataset/``; reference
``detikzify/dataset/``).

``load_dataset`` resolves the bundled builders by name, mirroring the
reference shim (``dataset/__init__.py:4-7``). Builders accept either a URL
(network environments) or a pre-downloaded local archive path (zero-egress
environments). ``datasets`` is imported only when a builder materialises
a ``Dataset`` or a name is not a bundled builder. ``synthetic.
generate_corpus`` is the synthetic TikZ corpus.
"""
from __future__ import annotations

from .paper2fig import load_paper2fig
from .scicap import load_scicap
from .synthetic import generate_corpus

_BUILDERS = {
    "paper2fig": load_paper2fig,
    "scicap": load_scicap,
}


def load_dataset(name_or_path: str, *args, **kwargs):
    """Resolve bundled builders by name; fall back to HF datasets."""
    if name_or_path in _BUILDERS:
        return _BUILDERS[name_or_path](*args, **kwargs)
    import datasets

    return datasets.load_dataset(name_or_path, *args, **kwargs)


__all__ = ["generate_corpus", "load_dataset", "load_paper2fig",
           "load_scicap"]
