"""Kernel K1: fused attention forward (``csrc/flash_attn.cu``, and
``csrc/flash_attn_f32.cu`` for float32).

Port of the Pallas TPU kernel ``detikzify_tpu/ops/flash.py::flash_attention``,
which takes any dtype and any head_dim up to 128. bf16 inputs take
``flash_attn.cu`` at head_dim 32, 64, 72 or 128 (``HEAD_DIMS``): for S > 16
the CUDA kernel streams K/V tiles through shared memory with an online
softmax on ``wgmma``; for S <= ``SMALL_S`` (the MAP head) a cluster of
``CLUSTER`` blocks splits the keys (``split_keys`` each) and merges their
fp32 partials (see the header of ``flash_attn.cu``). float32 inputs take
``flash_attn_f32.cu`` (``KERNEL_F32``) at any head_dim up to
``MAX_HEAD_DIM_F32`` that is a multiple of 4: for S > 16 both products on
the tensor cores in 3xTF32 (each fp32 operand split into two TF32 halves,
three products summed in fp32), and for S <= ``SMALL_S`` over more than
``SPLIT_MIN_T_F32`` keys the keys split over a cluster of ``CLUSTER``
blocks in FFMA, as the bf16 path splits them.
Any other dtype or head_dim raises on the card. ``attend_split_plain``
repeats the split arithmetic in PyTorch for the tests. The plain version is
``ops.attention.attend_plain``: a tensor on the CPU takes it, a CUDA tensor
launches the kernel or raises.

``flash_attention`` is differentiable on both devices through one
``torch.autograd.Function``, ``_FlashAttention``, the counterpart of the
JAX ``custom_vjp`` (``detikzify_tpu/ops/flash.py:114-134``): its forward
launches K1 (or, on the CPU, runs the plain version without a graph) and
keeps q, k, v and the masks; its backward recomputes ``attend_plain`` on
them and returns autograd's gradients for q, k and v, as the JAX backward
differentiates ``attend_xla``. The JAX package has no backward kernel, so
neither has the port.
"""
from __future__ import annotations

from typing import Optional

import torch

from .attention import NEG_INF, _repeat_kv, attend_plain
from .cuda import KERNELS, stream_handle
from .paged import merge_partials

KERNEL = KERNELS["flash_attention"]
KERNEL_F32 = KERNELS["flash_attention_f32"]
#: bf16 head dims the kernel is built for: Llama-3.1 (128), SigLIP (72),
#: 64 and 32 (the speculation model's; tiled at 64)
HEAD_DIMS = (32, 64, 72, 128)
#: float32: any head_dim up to this that is a multiple of 4 (16-byte rows)
MAX_HEAD_DIM_F32 = 128
#: query rows at or below which the kernel splits the keys across a
#: cluster of blocks, and the blocks in it (``SMALL_S``, ``CLUSTER`` in
#: flash_attn.cu and flash_attn_f32.cu)
SMALL_S, CLUSTER = 16, 8
#: keys above which the fp32 kernel takes the split-key path at S <= 16
#: (``SPLIT_MIN_T`` in flash_attn_f32.cu)
SPLIT_MIN_T_F32 = 256


def split_keys(t: int) -> int:
    """Keys per block of the split-key path: ceil(T / CLUSTER) rounded up
    to the kernel's 64-key chunk."""
    return -(-(-(-t // CLUSTER)) // 64) * 64


def attend_split_plain(q, k, v, *, causal: bool = False, kv_mask=None,
                       scale: Optional[float] = None, q_offsets=None,
                       kv_limits=None, split: Optional[int] = None
                       ) -> torch.Tensor:
    """The kernel's split-key arithmetic in PyTorch (for the tests): the
    masked logits of ``attend_plain`` in fp32, cut into blocks of ``split``
    keys (the kernel's ``split_keys(T)`` by default), each giving (max, sum
    of exp, unnormalised P V), combined by ``merge_partials``. Returns
    [B, S, NH, Hd] in q.dtype."""
    b, s, nh, hd = q.shape
    t = k.shape[1]
    split = split_keys(t) if split is None else split
    scale = (hd ** -0.5) if scale is None else float(scale)
    kr = _repeat_kv(k.float(), nh // k.shape[2])
    vr = _repeat_kv(v.float(), nh // k.shape[2])
    logits = torch.einsum("bsnh,btnh->bnst", q.float(), kr) * scale
    visible = torch.ones((b, 1, s, t), dtype=torch.bool, device=q.device)
    if kv_mask is not None:
        visible = visible & kv_mask[:, None, None, :]
    ar_s = torch.arange(s, device=q.device)[None, None, :, None]
    ar_t = torch.arange(t, device=q.device)[None, None, None, :]
    if q_offsets is not None:
        visible = visible & (ar_t <= q_offsets[:, None, None, None] + ar_s)
        if kv_limits is not None:
            visible = visible & (ar_t < kv_limits[:, None, None, None])
    if causal:
        visible = visible & (ar_t <= ar_s + (t - s))
    logits = logits.masked_fill(~visible, NEG_INF)
    ms, ls, accs = [], [], []
    for t0 in range(0, t, split):
        x = logits[..., t0:t0 + split]                 # [B, NH, S, n]
        mx = x.amax(dim=-1)
        p = torch.exp(x - mx[..., None])
        ms.append(mx)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bnst,btnh->bnsh", p,
                                 vr[:, t0:t0 + split]))
    out = merge_partials(torch.stack(ms, -1), torch.stack(ls, -1),
                         torch.stack(accs, -2))          # [B, NH, S, Hd]
    return out.transpose(1, 2).to(q.dtype)


def flash_attention(
    q: torch.Tensor,                      # [B, S, NH, Hd]
    k: torch.Tensor,                      # [B, T, NKV, Hd]
    v: torch.Tensor,
    *,
    causal: bool = False,
    kv_mask: Optional[torch.Tensor] = None,    # [B, T] bool
    scale: Optional[float] = None,
    q_offsets: Optional[torch.Tensor] = None,  # [B] per-batch causal offset
    kv_limits: Optional[torch.Tensor] = None,  # [B] per-batch key bound
) -> torch.Tensor:
    """softmax(q k^T * scale + masks) v with GQA; returns [B, S, NH, Hd].

    With ``q_offsets``/``kv_limits`` key t is visible to query i of batch
    row b iff ``t <= q_offsets[b] + i and t < kv_limits[b]``."""
    if kv_limits is not None and q_offsets is None:
        raise ValueError("kv_limits requires q_offsets "
                         "(pass zeros for offset-free bounds)")
    return _FlashAttention.apply(q, k, v, kv_mask, q_offsets, kv_limits,
                                 causal, scale)


class _FlashAttention(torch.autograd.Function):
    """K1 forward; the backward differentiates the plain version."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, q_offsets, kv_limits, causal, scale):
        if q.device.type == "cpu":
            out = attend_plain(q, k, v, causal=causal, kv_mask=kv_mask,
                               scale=scale, q_offsets=q_offsets,
                               kv_limits=kv_limits)
        else:
            out = _launch(q, k, v, causal, kv_mask, scale, q_offsets,
                          kv_limits)
        ctx.save_for_backward(q, k, v, kv_mask, q_offsets, kv_limits)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, grad):
        q, k, v, kv_mask, q_offsets, kv_limits = ctx.saved_tensors
        # named for torch.profiler: a profile reads the recompute's device
        # time under this span
        with torch.enable_grad(), \
                torch.profiler.record_function("flash_attention_backward"):
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]
            out = attend_plain(*leaves, causal=ctx.causal, kv_mask=kv_mask,
                               scale=ctx.scale, q_offsets=q_offsets,
                               kv_limits=kv_limits)
            dq, dk, dv = torch.autograd.grad(out, leaves, grad)
        return dq, dk, dv, None, None, None, None, None


def _launch(q, k, v, causal, kv_mask, scale, q_offsets, kv_limits):
    """Check the operands against the kernel's limits and launch K1."""
    b, s, nh, hd = q.shape
    if k.dim() != 4 or k.shape[0] != b or k.shape != v.shape:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    t, nkv = k.shape[1], k.shape[2]
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"flash_attention: q is {q.dtype}; the kernel "
                         "takes bfloat16 or float32")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device or x.device.type != "cuda":
            raise ValueError(f"flash_attention: {name} on {x.device}, "
                             f"expected the CUDA device of q")
        if x.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {x.dtype}, q "
                             f"{q.dtype}; the kernel takes one dtype")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} is not contiguous "
                             "and 16-byte aligned")
    f32 = q.dtype == torch.float32
    if f32:
        hd_ok = hd % 4 == 0 and 0 < hd <= MAX_HEAD_DIM_F32
        rule = f"a multiple of 4 up to {MAX_HEAD_DIM_F32} in float32"
    else:
        hd_ok = hd in HEAD_DIMS
        rule = f"one of {HEAD_DIMS} in bfloat16"
    if k.shape[3] != hd or not hd_ok or nh % nkv:
        raise ValueError(f"flash_attention: unsupported head layout "
                         f"NH={nh} NKV={nkv} Hd={hd} (Hd must be {rule}, "
                         "NH a multiple of NKV)")
    if causal and s > t:
        raise ValueError("flash_attention: causal needs S <= T")
    if kv_mask is not None:
        if (kv_mask.dtype != torch.bool or tuple(kv_mask.shape) != (b, t)
                or kv_mask.device != q.device
                or not kv_mask.is_contiguous()):
            raise ValueError("flash_attention: kv_mask must be a contiguous "
                             f"bool [{b}, {t}] tensor on {q.device}")
    per_batch = q_offsets is not None
    if per_batch:
        if kv_limits is None:
            kv_limits = torch.full((b,), t, dtype=torch.int32,
                                   device=q.device)
        for name, x in (("q_offsets", q_offsets), ("kv_limits", kv_limits)):
            if (x.dtype != torch.int32 or tuple(x.shape) != (b,)
                    or x.device != q.device or not x.is_contiguous()):
                raise ValueError(f"flash_attention: {name} must be a "
                                 f"contiguous int32 [{b}] tensor on "
                                 f"{q.device}")
    scale = (hd ** -0.5) if scale is None else float(scale)
    out = torch.empty_like(q)
    (KERNEL_F32 if f32 else KERNEL).launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if kv_mask is None else kv_mask.data_ptr(),
        q_offsets.data_ptr() if per_batch else None,
        kv_limits.data_ptr() if per_batch else None,
        b, s, t, nh, nkv, hd, scale, int(causal), int(per_batch),
        stream_handle(q.device))
    return out
