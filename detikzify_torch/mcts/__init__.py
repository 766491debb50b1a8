from .montecarlo import MonteCarlo
from .node import Node, Normalizer, NormScore

__all__ = ["MonteCarlo", "Node", "Normalizer", "NormScore"]
