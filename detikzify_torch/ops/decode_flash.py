"""Kernel K3: single-token decode attention over a contiguous KV cache
that reads only the rows each slot holds (``csrc/decode_contig.cu``, on
the split-and-merge body ``csrc/decode_split.cuh`` that K2 and K4 share).

Port of the Pallas TPU kernel
``detikzify_tpu/ops/decode_flash.py::decode_attend_pallas``. The caller is
``ops.attention.decode_attend``: a tensor on the CPU takes the plain
version ``decode_attend_plain`` there, a CUDA tensor comes here at every
cache length and launches the kernel or raises. The JAX package keeps
caches shorter than 1024 rows on XLA, a choice made for the TPU's launch
cost; here the kernel runs at every length.

The cache may be a view ``kc[:, :kv_limit]`` of a longer cache: its batch
stride is passed to the kernel, which reads it in place. The kernel cuts
each slot's rows into blocks of ``SPLIT_ROWS`` and merges their fp32
partials, in scratch sized from L (never from ``lengths``);
``ops.paged.decode_attend_contiguous_split`` repeats that arithmetic in
PyTorch for the tests. bf16 caches and float32 caches (``KERNEL_F32``:
every product an fp32 FFMA) are taken, as the JAX kernel reads any dtype.
"""
from __future__ import annotations

from typing import Optional

import torch

from .cuda import KERNELS, SPLIT_HEAD_DIMS, split_scratch, stream_handle

KERNEL = KERNELS["decode_contig"]
KERNEL_F32 = KERNELS["decode_contig_f32"]


def decode_attend_contiguous(
    q: torch.Tensor,          # [B, NH, Hd]
    k_cache: torch.Tensor,    # [B, L, NKV, Hd], rows and heads contiguous
    v_cache: torch.Tensor,
    lengths: torch.Tensor,    # [B] int32 valid rows per slot (clamped to L)
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Launch K3 on CUDA tensors; returns [B, NH, Hd]. Raises on anything
    the kernel does not take."""
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"decode_contig: q {tuple(q.shape)}, caches "
                         f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)}")
    b, nh, hd = q.shape
    _, length, nkv, chd = k_cache.shape
    for name, x in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if x.device != q.device or x.device.type != "cuda":
            raise ValueError(f"decode_contig: {name} on {x.device}, "
                             "expected a CUDA device (CPU tensors take "
                             "ops.attention.decode_attend_plain)")
        if (x.dtype not in (torch.bfloat16, torch.float32)
                or x.dtype != q.dtype):
            raise ValueError(f"decode_contig: {name} is {x.dtype}, q "
                             f"{q.dtype}; the kernel takes bfloat16 or "
                             "float32, one dtype")
        if x.data_ptr() % 16:
            raise ValueError(f"decode_contig: {name} is not 16-byte aligned")
    if not q.is_contiguous():
        raise ValueError("decode_contig: q is not contiguous")
    row = (nkv * hd, hd, 1)
    if (k_cache.shape[0] != b or tuple(k_cache.stride()[1:]) != row
            or k_cache.stride() != v_cache.stride()
            or k_cache.stride(0) * k_cache.element_size() % 16):
        raise ValueError(f"decode_contig: caches of strides "
                         f"{k_cache.stride()} / {v_cache.stride()}; needs "
                         f"[B={b}, L, NKV, Hd] with rows and heads "
                         "contiguous, the same strides for k and v, and a "
                         "batch stride that keeps 16-byte alignment")
    if chd != hd or hd not in SPLIT_HEAD_DIMS:
        raise ValueError(f"decode_contig: head_dim {hd} (cache {chd}); the "
                         f"kernel takes {SPLIT_HEAD_DIMS} (the JAX kernel "
                         "takes 128 only)")
    if nh % nkv or nh // nkv > 8:
        raise ValueError(f"decode_contig: NH={nh}, NKV={nkv}; needs NH a "
                         "multiple of NKV with at most 8 query rows per "
                         "KV head")
    if (tuple(lengths.shape) != (b,) or lengths.dtype != torch.int32
            or lengths.device != q.device or not lengths.is_contiguous()):
        raise ValueError(f"decode_contig: lengths must be a contiguous "
                         f"int32 [{b}] tensor on {q.device}")
    scale = (hd ** -0.5) if scale is None else float(scale)
    scratch = split_scratch(b * nh, length, hd, q.device)
    out = torch.empty_like(q)
    kernel = KERNEL_F32 if q.dtype == torch.float32 else KERNEL
    kernel.launch(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                  lengths.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                  scratch.numel(), b, nh, nkv, hd, length, k_cache.stride(0),
                  scale, stream_handle(q.device))
    return out
