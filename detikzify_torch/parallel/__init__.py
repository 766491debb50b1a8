"""Replica-parallel inference (counterpart of ``detikzify_tpu/parallel``):
``ReplicaPool``, one model replica and decode engine per device."""
from .replicas import ReplicaPool, device_put

__all__ = ["ReplicaPool", "device_put"]
