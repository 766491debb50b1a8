"""DeTikZify on PyTorch and CUDA: the port of ``detikzify_tpu`` to one
NVIDIA H100.

Same module structure as the JAX package, PyTorch idiom inside: models are
``nn.Module`` trees, every entry point takes an explicit ``device``
(``"cuda"`` by default) and randomness comes from explicit
``torch.Generator`` objects. The attention kernels are hand-written CUDA
for Hopper (``csrc/``); each has a plain PyTorch version that CPU tensors
use. This package imports neither JAX nor ``detikzify_tpu``.
"""

__version__ = "0.1.0"

from . import config
from .config import DetikzifyConfig, TextConfig, VisionConfig, get_config

__all__ = ["config", "DetikzifyConfig", "TextConfig", "VisionConfig",
           "get_config", "__version__"]
