from . import convert, detikzify, layers, llama, siglip
from .detikzify import Params

__all__ = ["convert", "detikzify", "layers", "llama", "siglip", "Params"]
