from .functools import batchify, cache_cast, listify
from .generation import ExplicitAbort
from .image import (DUMMY_IMAGE, convert, expand, load, redact, remove_alpha,
                    to_array, trim)
from .subprocess import check_output, run, safe_killpg

__all__ = [
    "batchify", "cache_cast", "listify", "ExplicitAbort",
    "DUMMY_IMAGE", "convert", "expand", "load", "redact", "remove_alpha",
    "to_array", "trim",
    "check_output", "run", "safe_killpg",
]
