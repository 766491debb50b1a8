"""ctypes binding of the host C++ library ``native/detikzify_native.cc``
(counterpart of ``detikzify_tpu/native.py``): EED over token ids, hashed
n-gram counts for CrystalBLEU, and a bilinear resize + normalise.

The library is built with ``g++`` at first use (seconds) into
``build/native/`` beside the package, under a name that carries a hash of
the source, so an edited source never loads a stale build; ``native/`` is
only read. Every entry point returns None where no library could be built
or loaded, and its callers then take their pure-Python versions, which are
the JAX package's semantics: a host without a compiler loses speed, not
results. ``available()`` says which path runs.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_ROOT = Path(__file__).resolve().parents[1]
SOURCE = _ROOT / "native" / "detikzify_native.cc"
BUILD_DIR = _ROOT / "build" / "native"
# the flags of native/Makefile (no -march=native: a build may be copied to
# another host of the same checkout)
CXXFLAGS = ("-O3", "-mtune=native", "-fPIC", "-shared", "-std=c++17",
            "-Wall")

_lock = threading.Lock()
_lib = None
_tried = False


def lib_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXXFLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libdetikzify_native-{digest[:16]}.so"


def _build(path: Path) -> bool:
    """Compile into a temporary file and rename it into place, so builds
    racing in several processes never load a half-written library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *CXXFLAGS, "-o", tmp, str(SOURCE)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, path)
        return True
    except (subprocess.SubprocessError, OSError):
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = lib_path()
        if not path.exists() and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        lib.eed_distance.restype = ctypes.c_double
        lib.eed_distance.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int32]
        lib.resize_normalize.restype = None
        lib.resize_normalize.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.c_float, ctypes.c_float]
        lib.count_ngrams.restype = ctypes.c_int64
        lib.count_ngrams.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64]
        _lib = lib
        return _lib


def available() -> bool:
    """True when the library is built and loaded (the native path runs)."""
    return get_lib() is not None


def eed_distance_ids(hyp: Sequence[int], ref: Sequence[int],
                     blank_id: int) -> Optional[float]:
    """Native EED over token-id sequences; None if the lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    h = np.ascontiguousarray(hyp, np.int32)
    r = np.ascontiguousarray(ref, np.int32)
    return float(lib.eed_distance(
        h.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(h),
        r.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(r),
        np.int32(blank_id)))


def count_ngrams_ids(ids: Sequence[int], max_n: int):
    """Hashed n-gram counts (FNV-1a over int32 token ids, n in the seed)
    for one text; returns (hashes u64, counts i64) or None if no lib."""
    lib = get_lib()
    if lib is None:
        return None
    arr = np.ascontiguousarray(ids, np.int32)
    cap = max(len(arr) * max_n, 1)
    hashes = np.empty((cap,), np.uint64)
    counts = np.empty((cap,), np.int64)
    n = lib.count_ngrams(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(arr),
        int(max_n),
        hashes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), cap)
    return hashes[:n], counts[:n]


def resize_normalize(image: np.ndarray, size: int, mean: float = 0.5,
                     std: float = 0.5) -> Optional[np.ndarray]:
    """uint8 HWC RGB -> normalized float32 [size, size, 3]; None if no lib."""
    lib = get_lib()
    if lib is None:
        return None
    src = np.ascontiguousarray(image, np.uint8)
    if src.ndim != 3 or src.shape[2] != 3:
        raise ValueError(f"resize_normalize: expected uint8 [H, W, 3], got "
                         f"{src.shape}")
    h, w = src.shape[:2]
    dst = np.empty((size, size, 3), np.float32)
    lib.resize_normalize(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), size,
        np.float32(mean), np.float32(std))
    return dst
