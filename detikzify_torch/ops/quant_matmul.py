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

The kernel's launch is planned here (:func:`gemv_plan`): narrow blocks of
16 output channels up to 8 rows (the kernel takes them from M), wide
blocks of 128 above; ``ceil(M / 8)`` tiles of 8 rows; K split over
several wide blocks when they are fewer than the card's SMs.
:func:`int8_gemv_split_plain` repeats that split arithmetic in PyTorch for
the CPU tests.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from .cuda import KERNELS, stream_handle

KERNEL = KERNELS["int8_gemv"]
MAX_GEMV_ROWS = 64    # beyond this the product is compute-bound
CHANNELS = 128        # output channels of a wide K5 block (csrc/int8_gemv.cu)
CHUNK_K = 128         # K per warp and ring stage
BLOCKS_PER_SM = 2     # wide K5 blocks an SM (__launch_bounds__)


class GemvPlan(NamedTuple):
    n_tiles: int      # tiles of 8 rows, ceil(M / 8): the kernel's NT
    warps_k: int      # warps along K: 1 (wide blocks) or 8 (narrow)
    splits: int       # blocks over K (the grid's y)
    blocks: int       # blocks over N times splits
    scratch: int      # fp32 partials, splits * M * N when split, else 0


def gemv_plan(m: int, n: int, k: int, sms: int) -> GemvPlan:
    """The launch of K5 on ``x [m, k] @ q [n, k]^T`` on a card with ``sms``
    SMs. Up to 8 rows (one tile) the kernel takes narrow blocks: 16
    channels, the block's 8 warps along K streaming the weights into
    registers, never split; they read x once per 16 channels, which costs
    little at 8 rows. More rows take wide blocks (128 channels, 8 warps along N); where they
    are fewer than the SMs (qkv, o, down, the MAP head), K is split so
    that the card holds ``BLOCKS_PER_SM`` blocks an SM, each split at
    least one 128-wide chunk."""
    n_tiles = -(-m // 8)
    warps_k = 8 if n_tiles == 1 else 1
    n_blocks = -(-n // (CHANNELS // warps_k))
    splits = 1
    if warps_k == 1 and n_blocks < sms:
        splits = max(1, min(k // CHUNK_K, BLOCKS_PER_SM * sms // n_blocks))
    return GemvPlan(n_tiles=n_tiles, warps_k=warps_k, splits=splits,
                    blocks=n_blocks * splits,
                    scratch=splits * m * n if splits > 1 else 0)


_SMS: Dict[int, int] = {}


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [..., K] @ w [N, K]^T`` as fp32, accumulated in fp32 and never
    rounded through a narrower type (the JAX ``preferred_element_type=
    float32``). bf16 operands on the card take one cuBLAS call with an fp32
    output, so ``w`` is not copied to fp32."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return F.linear(x, w)
    if x.is_cuda:
        x2 = x.reshape(-1, x.shape[-1])
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            y = _MatmulF32.apply(x2, w)
        else:
            y = torch.mm(x2, w.t(), out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[0])
    return F.linear(x.float(), w.float())


class _MatmulF32(torch.autograd.Function):
    """``torch.mm(..., out_dtype=float32)`` of a training step: that op has
    no derivative, so the backward is written out, two products of the
    fp32 cotangent rounded once to the operands' type (fp32 accumulation
    in both)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.mm(grad.to(w.dtype), w).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.mm(grad.t().to(x.dtype), x).to(w.dtype)
        return dx, dw


def int8_matmul_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                      out_dtype: Optional[torch.dtype] = None
                      ) -> torch.Tensor:
    """``(x @ q.to(x.dtype)^T) * scale``: products of x with the int8
    weights in x's type, summed in fp32, scaled in fp32, cast once to
    ``out_dtype`` (x's type by default)."""
    acc = matmul_f32(x, q.to(x.dtype))
    return (acc * scale).to(out_dtype or x.dtype)


def int8_gemv_split_plain(x: torch.Tensor, q: torch.Tensor,
                          scale: torch.Tensor, splits: int,
                          out_dtype: Optional[torch.dtype] = None
                          ) -> torch.Tensor:
    """K5's split arithmetic in PyTorch: split ``s`` of ``splits`` sums the
    128-wide chunks ``[s C / splits, (s + 1) C / splits)`` of the ``C = K /
    128`` into an fp32 partial; the partials are added in split order, then
    scaled once and cast once."""
    k = q.shape[1]
    chunks = k // CHUNK_K
    acc = None
    for s in range(splits):
        a = s * chunks // splits * CHUNK_K
        b = (s + 1) * chunks // splits * CHUNK_K
        p = matmul_f32(x[..., a:b], q[:, a:b].to(x.dtype))
        acc = p if acc is None else acc + p
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
    plan = gemv_plan(m, n, k, _sm_count(x.device))
    y = torch.empty((m, n), dtype=out_dtype, device=x.device)
    scratch = (torch.empty(plan.scratch, dtype=torch.float32, device=x.device)
               if plan.splits > 1 else None)
    KERNEL.launch(x.data_ptr(), q.data_ptr(), scale.data_ptr(), y.data_ptr(),
                  None if scratch is None else scratch.data_ptr(), m, n, k,
                  plan.splits, int(x.dtype == torch.float32),
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
