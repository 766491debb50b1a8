"""Cooperative cancellation (the ``ExplicitAbort`` of the JAX package's
``utils/generation.py``)."""
from __future__ import annotations


class ExplicitAbort:
    """Cooperative cancellation: generation loops poll ``should_stop``."""

    def __init__(self):
        self.should_stop = False

    def reset(self) -> "ExplicitAbort":
        self.should_stop = False
        return self

    def abort(self) -> None:
        self.should_stop = True
