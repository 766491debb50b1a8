"""Training step, AdamW and its schedule (counterpart of
``detikzify_tpu/train/step.py``), written by hand: no optax here.

  * ``make_optimizer`` -- AdamW with linear warmup and cosine decay, global
    norm clipping and a train/freeze split, its two moments stored in one of
    three ways: in the parameters' dtype (``optax.adamw``), in a narrower
    float (``_scale_by_adam_lowmem``) or in e4m3 with an fp32 absmax scale a
    block of 256 (``_scale_by_adam_quant8``). Each copies its JAX
    counterpart's order of operations and rounding;
  * ``make_train_step`` -- one optimizer update from a batch of
    ``grad_accum`` micro-batches: gradients summed over the micro-batches in
    ``accum_dtype``, then averaged;
  * ``trainable_mask`` -- ``"all"`` or ``"projector"`` (stage-1 pretraining
    trains only the connector): sets ``requires_grad`` leaf by leaf, so a
    frozen leaf gets no gradient, no update and no optimizer state.

The optimizer works on the leaves of the JAX tree (``convert.leaves``): a
stacked leaf's layers, and a dense kernel in its ``[in, out]`` order, make
one flat vector for the 8-bit moments' blocks, as in the JAX package.

On a mesh (``parallel.mesh.place_params``) the step takes this rank's rows
of the global batch, weighs each micro-batch's loss by this rank's share of
its label tokens, and sums the gradients over the data axis, so the update
is the unsharded one. With ``fsdp`` each layer is whole only around its
own forward and backward (``Placement.streaming``), the gradients of the
sharded tensors are reduce-scattered to this rank's slices, and each rank
updates its slice of every sharded leaf (its whole 256-element blocks for
the 8-bit moments, for which the update gathers one leaf at a time).
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Mapping, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from ..config import DetikzifyConfig
from ..models import detikzify
from ..models.convert import Leaf, leaves

QUANT_BLOCK = 256
#: the largest finite e4m3 value
_E4M3_MAX = float(torch.finfo(torch.float8_e4m3fn).max)


class TrainState(NamedTuple):
    params: nn.Module             # updated in place by each step
    opt_state: dict
    step: int


def label_smoothing_free_loss(params, cfg: DetikzifyConfig, batch: Mapping,
                              remat=False) -> torch.Tensor:
    _, loss = detikzify.forward(
        params, cfg, batch["input_ids"], batch.get("pixel_values"),
        attention_mask=batch.get("attention_mask"), labels=batch["labels"],
        remat=remat)
    return loss


def trainable_mask(params: nn.Module, mode: str) -> Dict[str, str]:
    """``"all"`` | ``"projector"``: the JAX tree's leaf paths mapped to
    ``"train"`` or ``"freeze"``; each leaf's tensors require a gradient
    exactly when it trains."""
    if mode not in ("all", "projector"):
        raise ValueError(mode)
    mask = {}
    for leaf in leaves(params):
        train = mode == "all" or leaf.path.startswith("connector/")
        mask[leaf.path] = "train" if train else "freeze"
        for t in leaf.tensors:
            if t.is_floating_point():
                t.requires_grad_(train)
    return mask


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0,
                                 exponent: float = 1.0
                                 ) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule``: linear from ``init_value`` to
    ``peak_value`` over ``warmup_steps``, then cosine down to ``end_value``
    at ``decay_steps`` (which counts the warmup) and flat after."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = decay_steps - warmup_steps
    if not cosine_steps > 0:
        raise ValueError("The cosine_decay_schedule requires positive "
                         f"decay_steps, got decay_steps={cosine_steps}.")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            if warmup_steps <= 0:
                return init_value
            frac = 1 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, cosine_steps)
        decay = 0.5 * (1 + math.cos(math.pi * c / cosine_steps))
        return peak_value * ((1 - alpha) * decay ** exponent + alpha)

    return schedule


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, summed in fp32."""
    return torch.stack([t.float().square().sum() for t in tensors]).sum(
        ).sqrt()


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay ** count`` in fp32, as JAX computes it."""
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


def _fma(x: torch.Tensor, y, z: torch.Tensor) -> torch.Tensor:
    """fp32 ``x * y + z`` rounded once (the product exact in fp64). The JAX
    moment updates ``b * m + (1 - b) * g`` compile on the CPU to a fused
    multiply-add of the gradient's product into ``b * m``; this one gives
    their moments bit for bit."""
    y = y.double() if isinstance(y, torch.Tensor) else float(np.float32(y))
    return (x.double() * y + z.double()).float()


def _rounded(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype`` (exactly representable in it)."""
    return float(torch.tensor(x, dtype=torch.float64).to(dtype))


def _flat(leaf: Leaf, tensors) -> torch.Tensor:
    """A leaf's tensors as one vector in the JAX tree's element order."""
    return torch.cat([(t.t() if leaf.transposed else t).reshape(-1)
                      for t in tensors])


def _unflat(leaf: Leaf, flat: torch.Tensor, like=None) -> List[torch.Tensor]:
    """The inverse of ``_flat``: one tensor a layer, in the port's layout
    (of ``like``'s shapes, the leaf's own by default)."""
    out, i = [], 0
    for t in (leaf.tensors if like is None else like):
        shape = t.t().shape if leaf.transposed else t.shape
        part = flat[i:i + t.numel()].reshape(shape)
        out.append(part.t() if leaf.transposed else part)
        i += t.numel()
    return out


class AdamW:
    """AdamW after ``make_optimizer``'s chain: clip by the trainable leaves'
    global norm, scale by Adam, add decayed weights, scale by the
    schedule's learning rate at the update count before the update, add to
    the parameters. ``moments``: None (the parameters' dtype, as
    ``optax.adamw``), a float dtype of two bytes or more (``lowmem``), or
    ``"quant8"`` / a one-byte float dtype (block-scaled 8-bit)."""

    def __init__(self, schedule: Callable[[int], float], *, b1: float,
                 b2: float, eps: float, weight_decay: float,
                 grad_clip: Optional[float], moments=None,
                 trainable: Optional[Mapping[str, str]] = None):
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip
        self.trainable = trainable
        if moments is None:
            self.mode, self.dtype = "adamw", None
        elif moments == "quant8" or moments.itemsize == 1:
            if moments != "quant8" and not moments.is_floating_point:
                raise ValueError(
                    f"moment_dtype {moments} unsupported: 1-byte moments "
                    "must be a float8 dtype (block-absmax scaling needs a "
                    "float format), got an integer type")
            self.mode = "quant8"
            self.dtype = (torch.float8_e4m3fn if moments == "quant8"
                          else moments)
        else:
            self.mode, self.dtype = "lowmem", moments

    def leaves(self, params) -> List[Leaf]:
        """The leaves this optimizer updates: of a module, its JAX tree's
        trainable float leaves; of a mapping of named tensors, each one."""
        if isinstance(params, Mapping):
            found = [Leaf(k, (t,), False, False) for k, t in params.items()]
        else:
            found = leaves(params)
        return [leaf for leaf in found
                if leaf.tensors[0].is_floating_point()
                and (self.trainable is None
                     or self.trainable.get(leaf.path) == "train")]

    def init(self, params) -> dict:
        moments = {}
        placement = getattr(params, "placement", None)
        for leaf in self.leaves(params):
            ts = leaf.tensors
            if self.mode == "quant8":
                # blocks of the whole leaf, over a model axis too
                nb = -(-sum(t.numel() if placement is None
                            else placement.whole_numel(t) for t in ts)
                       // QUANT_BLOCK)
                dev = ts[0].device

                def zq():
                    return torch.zeros((nb, QUANT_BLOCK), dtype=self.dtype,
                                       device=dev)
                moments[leaf.path] = {
                    "mq": zq(), "ms": torch.zeros(nb, device=dev),
                    "vq": zq(), "vs": torch.zeros(nb, device=dev)}
            else:
                moments[leaf.path] = {
                    "mu": [torch.zeros_like(t, dtype=self.dtype)
                           for t in ts],
                    "nu": [torch.zeros_like(t, dtype=self.dtype)
                           for t in ts]}
        return {"count": 0, "moments": moments}

    @torch.no_grad()
    def update(self, params, grads: Mapping[torch.Tensor, torch.Tensor],
               state: dict, placement=None,
               norm: Optional[torch.Tensor] = None) -> dict:
        """Apply one update to ``params`` in place from ``grads`` (each
        trainable tensor's gradient, keyed by the tensor) and return the
        new optimizer state. On a mesh (``placement``) ``grads`` hold this
        rank's part of the gradients summed over the data axis (see
        ``_reduce_grads``) and ``norm`` their global norm; the update
        writes this rank's master slices and the state holds this rank's
        part of the moments."""
        count = state["count"]
        train = self.leaves(params)
        gs = {leaf.path: [grads[t] for t in leaf.tensors] for leaf in train}
        if self.grad_clip is not None:
            if norm is None:
                norm = global_norm([g for v in gs.values() for g in v])
            keep = norm < self.grad_clip
            one = torch.ones((), device=norm.device)
            div = torch.where(keep, one, norm)
            mul = torch.where(keep, one, one * self.grad_clip)
            gs = {k: [g / div.to(g.dtype) * mul.to(g.dtype) for g in v]
                  for k, v in gs.items()}
        bc1 = _bias_correction(self.b1, count + 1)
        bc2 = _bias_correction(self.b2, count + 1)
        lr = -self.schedule(count)
        moments = {}
        blocks = _blocks(placement, self)
        for leaf in train:
            st = state["moments"][leaf.path]
            g = gs[leaf.path]
            if blocks:              # this rank's run of the leaf's blocks
                u, moments[leaf.path] = self._quant8(torch.cat(g), st, bc1,
                                                     bc2)
                self._write_blocks(leaf, u, lr, placement)
                continue
            ps = list(leaf.tensors)
            if self.mode == "quant8":
                u, moments[leaf.path] = self._quant8(_flat(leaf, g), st,
                                                     bc1, bc2)
                us = _unflat(leaf, u)
            else:
                if placement is not None:
                    ps = [placement.master(t) for t in ps]
                us, moments[leaf.path] = self._dense(g, st, bc1, bc2)
            for p, u in zip(ps, us):
                self._apply(p, u, lr)
        return {"count": count + 1, "moments": moments}

    def _apply(self, p: torch.Tensor, u: torch.Tensor, lr: float) -> None:
        if self.weight_decay:
            u = u + self.weight_decay * p
        # the learning rate is cast to the update's dtype first
        u = u * _rounded(lr, u.dtype)
        p.copy_((p + u).to(p.dtype))

    def _dense(self, gs, st, bc1, bc2):
        b1, b2, eps = self.b1, self.b2, self.eps
        if self.mode == "adamw":        # optax.scale_by_adam, as it rounds
            mu = [(1 - b1) * g + b1 * m for g, m in zip(gs, st["mu"])]
            nu = [(1 - b2) * (g * g) + b2 * v for g, v in zip(gs, st["nu"])]
            us = [(m / bc1) / (torch.sqrt(v / bc2) + eps)
                  for m, v in zip(mu, nu)]
            return us, {"mu": mu, "nu": nu}
        mu, nu, us = [], [], []        # _scale_by_adam_lowmem
        for g, m, v in zip(gs, st["mu"], st["nu"]):
            g32 = g.float()
            m = _fma(g32, 1.0 - b1, b1 * m.float()).to(self.dtype)
            v = _fma((1.0 - b2) * g32, g32, b2 * v.float()).to(self.dtype)
            # the update reads the moments after their downcast
            us.append((m.float() / bc1) / (torch.sqrt(v.float() / bc2) + eps))
            mu.append(m)
            nu.append(v)
        return us, {"mu": mu, "nu": nu}

    def _quant8(self, g, st, bc1, bc2):
        """``g``: a leaf's gradient in the JAX tree's element order, all of
        it or a run of its whole blocks (``st`` holds those blocks'
        moments) -> the update of the same elements and the new moments."""
        b1, b2, eps = self.b1, self.b2, self.eps
        n = g.numel()
        gf = torch.nn.functional.pad(g.float(), (0, -n % QUANT_BLOCK)
                                     ).reshape(-1, QUANT_BLOCK)
        m = st["mq"].float() * st["ms"][:, None]
        v = st["vq"].float() * st["vs"][:, None]
        m = _fma(gf, 1.0 - b1, b1 * m)
        v = _fma((1.0 - b2) * gf, gf, b2 * v)
        # the update reads the fp32 moments, before they are quantized
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        mq, ms = self._quant(m)
        vq, vs = self._quant(v)
        u = u.reshape(-1)[:n].to(g.dtype)
        return u, {"mq": mq, "ms": ms, "vq": vq, "vs": vs}

    def _write_blocks(self, leaf, u, lr, placement) -> None:
        """Apply ``u``, the update of this rank's blocks of ``leaf``, and
        gather every rank's updated elements back into the whole tensors
        and their master slices (the leaf whole only meanwhile, over the
        model axis too: each rank then keeps its part)."""
        with placement.gathered(leaf.tensors):
            whole = [placement.whole(t) for t in leaf.tensors]
            n = sum(w.numel() for w in whole)
            e0, e1, per = _element_range(placement, n)
            seg = _flat(leaf, whole)[e0:e1].clone()
            self._apply(seg, u, lr)
            new = placement.all_gather_rows(seg, per, n)
            for t, part in zip(leaf.tensors, _unflat(leaf, new, whole)):
                t.copy_(placement.part(t, part))
            placement.refresh_masters(leaf.tensors)

    def _quant(self, x):
        # the fp32 reciprocal of the constant, as XLA computes the JAX
        # division by it: the scales are equal bit for bit
        s = x.abs().amax(dim=1) * (1.0 / _E4M3_MAX)
        return (x / s.clamp_min(1e-30)[:, None]).to(self.dtype), s


def make_optimizer(
    learning_rate: float,
    *,
    total_steps: int,
    warmup_ratio: float = 0.03,
    weight_decay: float = 0.0,
    b1: float = 0.9,
    b2: float = 0.999,
    grad_clip: float = 1.0,
    trainable: Optional[Mapping[str, str]] = None,  # trainable_mask(...)
    moment_dtype=None,              # e.g. torch.bfloat16, or "quant8"
) -> AdamW:
    """AdamW + cosine schedule with linear warmup (reference hyperparams:
    cosine schedule, warmup_ratio 0.03 -- train/train.py:116-121). The
    first update runs at the schedule's count 0, a learning rate of 0."""
    schedule = warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=learning_rate,
        warmup_steps=max(int(total_steps * warmup_ratio), 1),
        decay_steps=total_steps, end_value=0.0)
    return AdamW(schedule, b1=b1, b2=b2, eps=1e-8,
                 weight_decay=weight_decay, grad_clip=grad_clip,
                 moments=moment_dtype, trainable=trainable)


def make_train_step(
    cfg: DetikzifyConfig,
    optimizer: AdamW,
    *,
    grad_accum: int = 1,
    remat=False,
    accum_dtype: Optional[torch.dtype] = None,
    loss_fn: Optional[Callable] = None,
):
    """Build a ``(state, batch) -> (state, metrics)`` step.

    ``batch`` tensors have leading dim ``grad_accum * micro_batch``; the
    step runs the micro-batches in turn and averages their gradients.
    ``accum_dtype`` sets the dtype the gradients are summed in (default:
    each parameter's own; the loss is summed in fp32 in every mode).
    ``loss_fn(params, cfg, batch)`` replaces the default loss. ``metrics``
    hold the mean loss and the global norm of the averaged gradients
    before clipping."""
    default_loss = loss_fn is None
    if loss_fn is None:
        loss_fn = label_smoothing_free_loss
    else:
        user_fn = loss_fn
        loss_fn = lambda p, c, b, r: user_fn(p, c, b)  # noqa: E731

    def grads_of(params, trained, mb, scale):
        loss = loss_fn(params, cfg, mb, remat)
        gs = torch.autograd.grad(loss if scale == 1 else loss * scale,
                                 trained, allow_unused=True)
        # a leaf the loss does not reach has a zero gradient, as in JAX
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for g, p in zip(gs, trained)]

    def train_step(state: TrainState, batch: Mapping):
        """On a mesh ``batch`` holds this rank's rows (the ``data``
        coordinate's block of the global batch). Micro-batch i is global
        rows ``[i*mb, (i+1)*mb)``; its loss is the mean over all its label
        tokens, so this rank's part is weighted by its share of them."""
        params = state.params
        placement = getattr(params, "placement", None)
        trained = [p for p in params.parameters() if p.requires_grad]
        if not trained:
            raise ValueError("no parameter requires a gradient: call "
                             "trainable_mask first")
        n_local = next(iter(batch.values())).shape[0]
        world, rank = ((1, 0) if placement is None
                       else (placement.world, placement.rank))
        n_global = n_local * world
        if n_global % grad_accum:
            raise ValueError(f"global batch {n_global} does not split into "
                             f"{grad_accum} micro-batches")
        mb, first = n_global // grad_accum, rank * n_local
        parts = []                      # (micro, local row slice)
        for i in range(grad_accum):
            lo, hi = max(i * mb, first), min((i + 1) * mb, first + n_local)
            if lo < hi:
                parts.append((i, slice(lo - first, hi - first)))
        scales, per_layer = _part_scales(placement, grad_accum, parts,
                                         batch, default_loss)
        live = [(rows, w) for (_, rows), w in zip(parts, scales) if w]
        dev = trained[0].device
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        acc = None
        with (contextlib.nullcontext() if placement is None
              else placement.streaming(per_layer)):
            for rows, scale in live:
                mloss, gs = grads_of(params, trained,
                                     {k: v[rows] for k, v in batch.items()},
                                     scale)
                loss = loss + mloss * scale
                if len(live) == 1:
                    acc = gs
                    continue
                if acc is None:
                    acc = [torch.zeros(p.shape, dtype=accum_dtype or p.dtype,
                                       device=p.device) for p in trained]
                for a, g in zip(acc, gs):
                    a.add_(g.to(a.dtype))
                del gs
        if acc is None:                 # no label token on this rank
            acc = [torch.zeros_like(p) for p in trained]
        if placement is None:
            # one micro-batch: its gradients themselves, no second copy
            grads = {p: a if grad_accum == 1 and a.dtype == p.dtype
                     else (a / grad_accum).to(p.dtype)
                     for a, p in zip(acc, trained)}
            norm = None
            metrics = {"grad_norm": global_norm(list(grads.values()))}
        else:
            loss = placement.all_reduce(loss)
            grads, norm = _reduce_grads(placement, optimizer,
                                        optimizer.leaves(params),
                                        dict(zip(trained, acc)), grad_accum)
            metrics = {"grad_norm": norm}
        del acc
        metrics["loss"] = loss / grad_accum
        opt_state = optimizer.update(params, grads, state.opt_state,
                                     placement=placement, norm=norm)
        if placement is not None:
            placement.release()
        return TrainState(params, opt_state, state.step + 1), metrics

    return train_step


def _blocks(placement, optimizer: AdamW) -> bool:
    """The 8-bit moments of a placed model: split on whole blocks over the
    data axis (``fsdp``), or over a model axis the whole leaf's blocks on
    every rank; either way the update rebuilds one leaf at a time."""
    return (placement is not None and optimizer.mode == "quant8"
            and (placement.fsdp or placement.tp.size > 1))


def _element_range(placement, n: int):
    """This rank's elements of a leaf of ``n`` (its whole 256-element
    blocks, ``Placement.block_range``) and the elements of a full run."""
    n_blocks = -(-n // QUANT_BLOCK)
    lo, hi = placement.block_range(n_blocks)
    per = -(-n_blocks // placement.block_world) * QUANT_BLOCK
    return min(lo * QUANT_BLOCK, n), min(hi * QUANT_BLOCK, n), per


def _part_scales(placement, grad_accum: int, parts, batch: Mapping,
                 token_mean: bool):
    """What each of this rank's parts (micro-batch, rows) counts for in
    its micro-batch's mean loss: its share of the micro-batch's label
    tokens (1 with no mesh). And whether every rank runs as many parts:
    only then are the layers gathered one at a time (collectives that
    every rank makes alike), else the whole model for the step."""
    if placement is None:
        return [1.0] * len(parts), True
    dev = next(iter(batch.values())).device
    weight = torch.zeros(grad_accum, dtype=torch.float64, device=dev)
    for i, rows in parts:
        weight[i] = _loss_weight({k: v[rows] for k, v in batch.items()},
                                 token_mean)
    every = torch.stack(placement.all_gather(weight)).tolist()
    total = [sum(col) for col in zip(*every)]
    local = every[placement.rank]
    scales = [local[i] / total[i] if local[i] else 0.0 for i, _ in parts]
    runs = {sum(1 for w in row if w) for row in every}
    return scales, len(runs) == 1


def _reduce_grads(placement, optimizer: AdamW, train: List[Leaf],
                  acc: Dict[torch.Tensor, torch.Tensor], grad_accum: int):
    """This rank's gradient sums -> this rank's part of the gradients of
    the global batch's mean loss, with their global norm. A sharded
    tensor's part is its slice (a reduce-scatter), a replicated one's all
    of it (an all-reduce). Under 8-bit moments with ``fsdp`` it is this
    rank's whole blocks of each leaf, in the JAX tree's element order:
    those cross the sharded dimension's slices, so each tensor is
    all-reduced and cut; the norm then sums the whole tensors' squares in
    the unsharded step's order."""
    blocks = _blocks(placement, optimizer)
    grads = {}
    # squares by where they are summed: [replicated, split over data] for
    # tensors whole over the model axis and for this rank's cut of the
    # others (a KV head held by several ranks counts on its owner alone)
    sqs = [[[], []], [[], []]]
    for leaf in train:
        e0, e1, _ = _element_range(
            placement, sum(placement.whole_numel(t) for t in leaf.tensors))
        off = 0
        for t in leaf.tensors:
            g = placement.model_reduce_grad(t, acc.pop(t))
            if blocks:
                g = placement.whole(
                    t, (placement.all_reduce(g) / grad_accum).to(t.dtype))
                sqs[0][0].append(g.float().square().sum())
                flat = (g.t() if leaf.transposed else g).reshape(-1)
                a = min(max(e0 - off, 0), g.numel())
                b = min(max(e1 - off, a), g.numel())
                grads[t] = flat[a:b].clone()
                off += g.numel()
                continue
            g = (placement.reduce_grad(t, g) / grad_accum).to(t.dtype)
            grads[t] = g
            cut = placement.cut(t)
            if cut is not None and not cut.owner:
                continue
            sqs[cut is not None][placement.splits(t)].append(
                g.float().square().sum())
    dev = next(iter(grads.values())).device

    def total(parts):
        return torch.stack(parts).sum() if parts else torch.zeros(
            (), device=dev)

    (whole, split), (cut_whole, cut_split) = [[total(p) for p in pair]
                                              for pair in sqs]
    sq = whole + placement.all_reduce(split)
    if placement.tp.size > 1:
        sq = sq + placement.tp.all_reduce(
            cut_whole + placement.all_reduce(cut_split))
    return grads, sq.sqrt()


def _loss_weight(batch: Mapping, token_mean: bool) -> float:
    """What a micro-batch's part counts for in its mean loss: its label
    tokens (the rule of ``detikzify.forward``'s loss), or its rows for a
    caller's loss."""
    if not token_mean:
        return float(next(iter(batch.values())).shape[0])
    valid = batch["labels"][:, 1:] != -100
    mask = batch.get("attention_mask")
    if mask is not None:
        valid = valid & mask[:, 1:].bool()
    return float(valid.sum())


def init_state(params: nn.Module, optimizer: AdamW) -> TrainState:
    """A fresh state; on a mesh, with this rank's part of the moments."""
    opt_state = optimizer.init(params)
    placement = getattr(params, "placement", None)
    if placement is not None:
        # dense moments of this rank's shards, 8-bit ones of whole leaves
        opt_state = placement.shard_state(
            opt_state, {leaf.path: leaf for leaf in optimizer.leaves(params)},
            cut=False)
    return TrainState(params, opt_state, 0)
