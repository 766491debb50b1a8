"""Kernel K5: int8 weight-only dequant GEMV (``csrc/int8_gemv.cu``).

Port of the Pallas TPU kernel ``detikzify_tpu/ops/quant_matmul.py::
_int8_gemv``, dispatched by ``int8_matmul`` under the JAX rule: a product
with at most ``MAX_GEMV_ROWS`` rows (the product of x's leading dims), K
and N multiples of 128 and x in bf16 or fp32 is eligible. On a CUDA tensor
an eligible product launches K5 or raises; every other product (prefill
blocks, the vision tower's 900-patch rows, the MAP head's 4304-wide MLP)
is the plain dequant product, which the JAX package also leaves to its
compiler. A tensor on the CPU always takes the plain version.

Weights are ``q`` int8 ``[N, K]`` (``nn.Linear``'s ``[out, in]``, the
transpose of the JAX ``[K, N]``) with one fp32 ``scale`` per output
channel.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .cuda import KERNELS, stream_handle

KERNEL = KERNELS["int8_gemv"]
MAX_GEMV_ROWS = 64    # beyond this the product is compute-bound


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [..., K] @ w [N, K]^T`` as fp32, accumulated in fp32 and never
    rounded through a narrower type (the JAX ``preferred_element_type=
    float32``). bf16 operands on the card take one cuBLAS call with an fp32
    output, so ``w`` is not copied to fp32."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return F.linear(x, w)
    if x.is_cuda:
        y = torch.mm(x.reshape(-1, x.shape[-1]), w.t(),
                     out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[0])
    return F.linear(x.float(), w.float())


def int8_matmul_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                      out_dtype: Optional[torch.dtype] = None
                      ) -> torch.Tensor:
    """``(x @ q.to(x.dtype)^T) * scale``: products of x with the int8
    weights in x's type, summed in fp32, scaled in fp32, cast once to
    ``out_dtype`` (x's type by default)."""
    acc = matmul_f32(x, q.to(x.dtype))
    return (acc * scale).to(out_dtype or x.dtype)


def int8_gemv(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Launch K5 on ``x [M, K]`` (CUDA, bf16 or fp32, M <= 64); returns
    ``[M, N]`` in ``out_dtype`` (x's type by default; an fp32 x gives fp32
    only). Raises on anything the kernel does not take."""
    out_dtype = out_dtype or x.dtype
    if x.dim() != 2 or q.dim() != 2 or x.shape[1] != q.shape[1]:
        raise ValueError(f"int8_gemv: x {tuple(x.shape)} and q "
                         f"{tuple(q.shape)} do not form x @ q^T")
    m, k = x.shape
    n = q.shape[0]
    for name, t in (("x", x), ("q", q), ("scale", scale)):
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError(f"int8_gemv: {name} on {t.device}, expected "
                             "the CUDA device of x")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"int8_gemv: {name} is not contiguous and "
                             "16-byte aligned")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"int8_gemv: x is {x.dtype}; the kernel takes "
                         "bfloat16 or float32")
    if q.dtype != torch.int8 or scale.dtype != torch.float32 \
            or tuple(scale.shape) != (n,):
        raise ValueError(f"int8_gemv: needs q int8 [N, K] and scale float32 "
                         f"[N]; got {q.dtype} and {scale.dtype} "
                         f"{tuple(scale.shape)}")
    if out_dtype not in (torch.bfloat16, torch.float32) or (
            x.dtype == torch.float32 and out_dtype != torch.float32):
        raise ValueError(f"int8_gemv: output {out_dtype} from x {x.dtype} "
                         "is not built")
    if not 1 <= m <= MAX_GEMV_ROWS or k % 128 or n % 16:
        raise ValueError(f"int8_gemv: M={m} K={k} N={n}; needs 1 <= M <= "
                         f"{MAX_GEMV_ROWS}, K % 128 == 0, N % 16 == 0")
    y = torch.empty((m, n), dtype=out_dtype, device=x.device)
    KERNEL.launch(x.data_ptr(), q.data_ptr(), scale.data_ptr(), y.data_ptr(),
                  m, n, k, int(x.dtype == torch.float32),
                  int(out_dtype == torch.float32), stream_handle(x.device))
    return y


def int8_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x [..., K] @ dequant(q [N, K])^T -> [..., N]`` in ``out_dtype``
    (x's type by default); decode-regime products run on K5."""
    n, k = q.shape
    lead = x.shape[:-1]
    rows = 1
    for d in lead:
        rows *= d
    eligible = (rows <= MAX_GEMV_ROWS and k % 128 == 0 and n % 128 == 0
                and x.dtype in (torch.bfloat16, torch.float32))
    if x.device.type == "cpu" or not eligible:
        return int8_matmul_plain(x, q, scale, out_dtype)
    y = int8_gemv(x.reshape(rows, k).contiguous(), q, scale, out_dtype)
    return y.reshape(*lead, n)
