from .imagesim import ImageSim, sinkhorn_emd2

__all__ = ["ImageSim", "sinkhorn_emd2"]
