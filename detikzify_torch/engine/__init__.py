from .decode import BUCKETS, DecodeEngine, Rollout, StoredPrefix

__all__ = ["BUCKETS", "DecodeEngine", "Rollout", "StoredPrefix"]
