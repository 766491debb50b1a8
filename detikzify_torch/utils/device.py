"""Device discovery helpers (counterpart of
``detikzify_tpu/utils/device.py``; reference ``util/torch.py:5-14`` picked
cuda/xpu/npu/cpu). For logging and host/device routing decisions; the
entry points themselves take an explicit ``device``."""
from __future__ import annotations


def infer_device() -> str:
    """Best available platform name: ``"gpu"`` or ``"cpu"``."""
    import torch

    return "gpu" if torch.cuda.is_available() else "cpu"


def device_count() -> int:
    """CUDA devices visible to this process (0 without a card)."""
    import torch

    return torch.cuda.device_count()
