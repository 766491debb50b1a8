from .helpers import GeneratorLock, MctsOutputs, to_svg
from .strings import ALGORITHMS, BANNER, MODELS
from .webui import build_ui, inference, launch

__all__ = ["GeneratorLock", "MctsOutputs", "to_svg", "ALGORITHMS", "BANNER",
           "MODELS", "build_ui", "inference", "launch"]
