"""Small functional helpers (equivalents of reference ``util/functools.py``)."""
from __future__ import annotations

import functools
from typing import Callable, Iterable, TypeVar

T = TypeVar("T")


def cache_cast(cast_func: Callable[..., object]):
    """Memoize a function under a custom hashable key derived from its args.

    Equivalent in spirit to reference ``util/functools.py:7-23``: the wrapped
    function is cached on ``cast_func(*args, **kwargs)`` instead of the raw
    arguments (which may be unhashable, e.g. numpy arrays or PIL images).
    """

    def decorator(func):
        cache: dict = {}

        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            key = cast_func(*args, **kwargs)
            if key not in cache:
                cache[key] = func(*args, **kwargs)
            return cache[key]

        wrapper.cache = cache  # type: ignore[attr-defined]
        wrapper.cache_clear = cache.clear  # type: ignore[attr-defined]
        return wrapper

    return decorator


def listify(func: Callable[..., Iterable[T]]) -> Callable[..., list[T]]:
    """Collect a generator function's output into a list."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs) -> list[T]:
        return list(func(*args, **kwargs))

    return wrapper


def batchify(iterable: Iterable[T], batch_size: int) -> Iterable[list[T]]:
    """Yield successive fixed-size batches (last may be short)."""
    if batch_size <= 0:
        raise ValueError("batch_size must be positive")
    batch: list[T] = []
    for item in iterable:
        batch.append(item)
        if len(batch) == batch_size:
            yield batch
            batch = []
    if batch:
        yield batch
