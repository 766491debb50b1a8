from . import convert, detikzify, import_hf, layers, llama, load, siglip
from .detikzify import Params

__all__ = ["convert", "detikzify", "import_hf", "layers", "llama", "load",
           "siglip", "Params"]
