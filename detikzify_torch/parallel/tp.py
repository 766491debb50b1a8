"""Tensor parallelism over a mesh's ``model`` axis: the collectives around
the layers and the cut of each weight (the JAX package leaves both to XLA's
SPMD partitioner; ``parallel.mesh.place_params`` applies them here).

Megatron's rule, as ``mesh.param_spec`` names it: q/k/v/gate/up/fc1 are
column-parallel (each rank computes its heads or its columns), o/down/fc2
row-parallel (each rank contracts its rows; the partial sums are added over
the model group), ``embed_tokens`` is split over hidden and ``lm_head`` over
the vocabulary (both gathered along the last dimension). Three autograd
functions carry a layer's input and output across the group:

  * ``enter``  -- identity; its backward sums the gradient over the group
                  (the input of a column-parallel layer is replicated);
  * ``reduce`` -- the sum over the group; its backward is the identity
                  (the output of a row-parallel layer);
  * ``gather`` -- the concatenation of the ranks' last dimensions; its
                  backward takes this rank's slice.

Every collective is an ``all_reduce`` (gloo on CUDA tensors has
``broadcast`` and ``all_reduce`` but no ``all_gather``; nccl refuses two
ranks on one card): a gather is the sum of each rank's part written into a
zeroed buffer, which is exact. Sums of a float type narrower than fp32 are
carried in fp32 and rounded once.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist


class Cut(NamedTuple):
    """This rank's part of a tensor: rows ``[lo, hi)`` of dimension ``dim``
    of the whole, ``size`` along it. ``shared``: other ranks hold the same
    rows (KV heads read by the query heads of several ranks); ``owner`` is
    False on such a rank when a lower rank holds them, which then writes
    them alone when the whole is rebuilt."""

    dim: int
    lo: int
    hi: int
    size: int
    owner: bool = True
    shared: bool = False


def _wide(x: torch.Tensor) -> torch.Tensor:
    """``x`` in the type its sum is carried in."""
    if x.is_floating_point() and x.element_size() < 4:
        return x.float()
    return x


class TensorParallel:
    """One model group of ``size`` ranks; this one is ``rank`` in it.
    ``group`` None with ``size`` 1 is a group of one (no collective)."""

    def __init__(self, group, rank: int, size: int):
        self.group, self.rank, self.size = group, rank, size

    def __repr__(self) -> str:
        return f"TensorParallel(rank={self.rank}, size={self.size})"

    # --- plain collectives (no autograd) ---------------------------------

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``x``, in ``x``'s type."""
        if self.size == 1:
            return x
        y = _wide(x)
        y = y.clone() if y is x else y
        dist.all_reduce(y, group=self.group)
        return y.to(x.dtype)

    def all_gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Every rank's ``x`` (one shape on all) concatenated along
        ``dim`` in rank order."""
        if self.size == 1:
            return x
        dim = dim % x.dim()
        n = x.shape[dim]
        buf = _wide(x).new_zeros(
            x.shape[:dim] + (n * self.size,) + x.shape[dim + 1:])
        buf.narrow(dim, self.rank * n, n).copy_(x)
        dist.all_reduce(buf, group=self.group)
        return buf.to(x.dtype)

    def whole(self, x: torch.Tensor, cut: Optional[Cut]) -> torch.Tensor:
        """The whole tensor of which ``x`` is this rank's ``cut`` (``x``
        itself when it is not cut). Every rank of the group calls this for
        the same tensor together."""
        if cut is None or self.size == 1:
            return x
        shape = list(x.shape)
        shape[cut.dim] = cut.size
        buf = _wide(x).new_zeros(shape)
        if cut.owner:
            buf.narrow(cut.dim, cut.lo, cut.hi - cut.lo).copy_(x)
        dist.all_reduce(buf, group=self.group)
        return buf.to(x.dtype)

    def sum_shared(self, x: torch.Tensor, cut: Cut) -> torch.Tensor:
        """``x`` (this rank's part, a gradient say) summed over the ranks
        that hold the same rows."""
        shape = list(x.shape)
        shape[cut.dim] = cut.size
        buf = _wide(x).new_zeros(shape)
        buf.narrow(cut.dim, cut.lo, cut.hi - cut.lo).copy_(x)
        dist.all_reduce(buf, group=self.group)
        return buf.narrow(cut.dim, cut.lo, cut.hi - cut.lo).to(x.dtype)

    # --- the autograd functions ------------------------------------------

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        if self.size == 1 or not (torch.is_grad_enabled()
                                  and x.requires_grad):
            return x
        return _Enter.apply(x, self)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        if self.size == 1:
            return x
        if not (torch.is_grad_enabled() and x.requires_grad):
            return self.all_reduce(x)
        return _Reduce.apply(x, self)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        if self.size == 1:
            return x
        if not (torch.is_grad_enabled() and x.requires_grad):
            return self.all_gather(x)
        return _Gather.apply(x, self)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.all_reduce(g.contiguous()), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return tp.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp, ctx.n = tp, x.shape[-1]
        return tp.all_gather(x)

    @staticmethod
    def backward(ctx, g):
        tp, n = ctx.tp, ctx.n
        return g.narrow(-1, tp.rank * n, n).contiguous(), None


class Role(NamedTuple):
    """How a dense layer runs under tensor parallelism (``layers.linear``
    reads it from the module's ``tp_role``): ``"col"`` enters the group and
    computes this rank's columns (and its slice of the bias); ``"row"``
    contracts this rank's rows, sums the partial products over the group,
    then adds the whole bias once; ``"vocab"`` (the head, read by
    ``llama.unembed``) computes this rank's logits and gathers them."""

    kind: str
    tp: TensorParallel


def head_range(rank: int, size: int, num_heads: int, num_kv_heads: int
               ) -> tuple:
    """(q heads, KV heads) of ``rank``: ``[r NH/m, (r+1) NH/m)`` query
    heads and the KV heads they read under grouped-query attention (head
    h reads KV head ``h // (NH / NKV)``). Where the KV heads do not divide
    by the ranks, several ranks hold the same KV head. Raises
    ``ValueError`` where the query heads do not divide, or a rank's query
    heads would read a part of a KV group other ranks read too."""
    if num_heads % size:
        raise ValueError(
            f"{num_heads} attention heads do not split over a model axis "
            f"of {size}")
    per = num_heads // size
    group = num_heads // num_kv_heads
    if per % group and group % per:
        raise ValueError(
            f"{per} query heads a rank do not align with KV groups of "
            f"{group} ({num_heads} heads, {num_kv_heads} KV heads, model "
            f"axis {size})")
    q0 = rank * per
    return (q0, q0 + per), (q0 // group, -(-(q0 + per) // group))
