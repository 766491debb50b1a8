"""Evaluation metric suite (counterpart of ``detikzify_tpu/evaluate``;
reference ``detikzify/evaluate/__init__.py``).

``ImageSim`` is the hard dependency (MCTS scoring); the rest import lazily
like the reference's ``[evaluate]`` extra gating.
"""
from .imagesim import ImageSim, sinkhorn_emd2

_LAZY = {
    "CrystalBLEU": ("crystalbleu", "CrystalBLEU"),
    "KernelInceptionDistance": ("kid", "KernelInceptionDistance"),
    "TexEditDistance": ("eed", "TexEditDistance"),
    "DreamSim": ("dreamsim", "DreamSim"),
    "SigLIPDreamSim": ("dreamsim", "SigLIPDreamSim"),
    "DreamSimViT": ("dreamsim_vit", "DreamSimViT"),
    "dreamsim_from_checkpoints": ("dreamsim_vit", "from_checkpoints"),
    "ClipScore": ("clipscore", "ClipScore"),
}


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(name)
    import importlib

    module, attr = _LAZY[name]
    return getattr(importlib.import_module(f".{module}", __name__), attr)


__all__ = ["ImageSim", "sinkhorn_emd2", *_LAZY]
