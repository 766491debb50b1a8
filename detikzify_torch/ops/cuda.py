"""Build and bind the hand-written CUDA kernels (``detikzify_torch/csrc``).

Each ``.cu`` file exposes a plain C entry point. It is compiled with
``nvcc -gencode arch=compute_90a,code=sm_90a`` into its own shared library
at first use and loaded with ``ctypes``. The library goes into
``build/kernels/`` beside the package, under a name that carries a hash of
the source, the headers it includes and the flags, so an edited source
never loads a stale build.
``build_all()`` starts one ``nvcc`` per source, all at once.

Every kernel has a :class:`CudaKernel` handle with a plain integer
``launches`` counter. The counter is bumped in exactly one place: after a
launch of the kernel returned ``cudaSuccess``, under the handle's lock, as
several threads may launch one kernel (``parallel.ReplicaPool``'s
workers, the server's scheduler).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


class CudaKernel:
    """One hand-written kernel: its source, its C symbol and its counter."""

    def __init__(self, name: str, source: str, symbol: str,
                 argtypes: Sequence, headers: Sequence[str] = ()):
        self.name = name
        self.source = CSRC / source
        self.headers = [CSRC / h for h in headers]
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._count_lock = threading.Lock()
        self.build_log = ""
        self._fn = None
        self._err = None

    @property
    def library(self) -> Path:
        text = b"".join(f.read_bytes() for f in [self.source, *self.headers])
        digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()
                                ).hexdigest()
        return BUILD_DIR / f"lib{self.source.stem}-{digest[:16]}.so"

    def _compile_cmd(self, out: Path) -> List[str]:
        return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(self.source)]

    def _start_build(self) -> Optional[tuple]:
        """Start nvcc for this kernel unless its library exists. Returns
        (process, temp path) or None."""
        lib = self.library
        if lib.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen(self._compile_cmd(Path(tmp)),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, tmp

    def _finish_build(self, started: tuple) -> None:
        proc, tmp = started
        log, _ = proc.communicate()
        self.build_log = log
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed for {self.source.name}:\n{log}")
        os.replace(tmp, self.library)

    def _load(self):
        if self._fn is None:
            with _lock:
                if self._fn is None:
                    started = self._start_build()
                    if started is not None:
                        self._finish_build(started)
                    lib = ctypes.CDLL(str(self.library))
                    fn = getattr(lib, self.symbol)
                    fn.argtypes = self.argtypes
                    fn.restype = ctypes.c_int
                    err = getattr(lib, self.symbol + "_error_string")
                    err.argtypes = [ctypes.c_int]
                    err.restype = ctypes.c_char_p
                    self._err = err
                    self._fn = fn
        return self._fn

    def launch(self, *args) -> None:
        """Call the C entry point (which launches on the given stream) and
        raise if the launch was refused."""
        rc = self._load()(*args)
        if rc != 0:
            msg = self._err(rc).decode(errors="replace")
            raise RuntimeError(f"{self.name}: CUDA error {rc}: {msg}")
        with self._count_lock:
            self.launches += 1


P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong
F = ctypes.c_float

KERNELS: Dict[str, CudaKernel] = {
    "flash_attention": CudaKernel(
        "flash_attention", "flash_attn.cu", "detikzify_flash_attention",
        [P, P, P, P, P, P, P, I, I, I, I, I, I, F, I, I, P],
        headers=["sm90.cuh"]),
    "paged_decode": CudaKernel(
        "paged_decode", "paged_decode.cu", "detikzify_paged_decode",
        [P, P, P, P, P, P, P, L, I, I, I, I, I, I, I, F, P],
        headers=["decode_split.cuh", "sm90.cuh"]),
    "decode_contig": CudaKernel(
        "decode_contig", "decode_contig.cu", "detikzify_decode_contig",
        [P, P, P, P, P, P, L, I, I, I, I, I, L, F, P],
        headers=["decode_split.cuh", "sm90.cuh"]),
    "paged_verify": CudaKernel(
        "paged_verify", "paged_verify.cu", "detikzify_paged_verify",
        [P, P, P, P, P, P, P, L, I, I, I, I, I, I, I, I, F, P],
        headers=["decode_split.cuh", "sm90.cuh"]),
    "int8_gemv": CudaKernel(
        "int8_gemv", "int8_gemv.cu", "detikzify_int8_gemv",
        [P, P, P, P, P, I, I, I, I, I, I, P], headers=["sm90.cuh"]),
}


#: key rows of one (slot, KV head) per block of the split body that K2, K3
#: and K4 share (``csrc/decode_split.cuh``)
SPLIT_ROWS = 128


def split_scratch(rows: int, n_keys: int, hd: int, device):
    """fp32 scratch for the split body's partials, (acc [hd], max, sum) for
    each of ``rows`` query rows (over all slots and KV heads) and each of
    the ceil(n_keys / SPLIT_ROWS) splits. Sized from the key capacity
    alone, so the host never reads lengths or starts."""
    import torch

    n_split = -(-n_keys // SPLIT_ROWS)
    return torch.empty(rows * n_split * (hd + 2), dtype=torch.float32,
                       device=device)


def build_all() -> Dict[str, str]:
    """Compile every kernel that is not built yet, all nvcc processes in
    parallel, then load each library. Returns each kernel's build log."""
    started = {name: k._start_build() for name, k in KERNELS.items()}
    errors = []
    for name, st in started.items():
        if st is None:
            continue
        try:
            KERNELS[name]._finish_build(st)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    for k in KERNELS.values():
        k._load()
    return {name: k.build_log for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def device_scope(device):
    """``device`` as the calling thread's current CUDA device, for a thread
    that launches kernels (PyTorch keeps the current device, and with it
    the current stream that ``stream_handle`` reads, per thread); a null
    context for a CPU device or none."""
    import contextlib

    import torch

    if isinstance(device, torch.device) and device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()
