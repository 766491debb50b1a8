"""Training-time image augmentations (``augment``)."""
