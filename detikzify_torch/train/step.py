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
"""
from __future__ import annotations

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


def _unflat(leaf: Leaf, flat: torch.Tensor) -> List[torch.Tensor]:
    """The inverse of ``_flat``: one tensor a layer, in the port's layout."""
    out, i = [], 0
    for t in leaf.tensors:
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
        for leaf in self.leaves(params):
            ts = leaf.tensors
            if self.mode == "quant8":
                nb = -(-sum(t.numel() for t in ts) // QUANT_BLOCK)
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
               state: dict) -> dict:
        """Apply one update to ``params`` in place from ``grads`` (each
        trainable tensor's gradient, keyed by the tensor) and return the
        new optimizer state."""
        count = state["count"]
        train = self.leaves(params)
        gs = {leaf.path: [grads[t] for t in leaf.tensors] for leaf in train}
        if self.grad_clip is not None:
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
        for leaf in train:
            st = state["moments"][leaf.path]
            if self.mode == "quant8":
                us, moments[leaf.path] = self._quant8(leaf, gs[leaf.path],
                                                      st, bc1, bc2)
            else:
                us, moments[leaf.path] = self._dense(gs[leaf.path], st, bc1,
                                                     bc2)
            for p, u in zip(leaf.tensors, us):
                if self.weight_decay:
                    u = u + self.weight_decay * p
                # the learning rate is cast to the update's dtype first
                u = u * _rounded(lr, u.dtype)
                p.copy_((p + u).to(p.dtype))
        return {"count": count + 1, "moments": moments}

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

    def _quant8(self, leaf, gs, st, bc1, bc2):
        b1, b2, eps = self.b1, self.b2, self.eps
        g = _flat(leaf, gs)
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
        return _unflat(leaf, u), {"mq": mq, "ms": ms, "vq": vq, "vs": vs}

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
    if loss_fn is None:
        loss_fn = label_smoothing_free_loss
    else:
        user_fn = loss_fn
        loss_fn = lambda p, c, b, r: user_fn(p, c, b)  # noqa: E731

    def train_step(state: TrainState, batch: Mapping):
        params = state.params
        trained = [p for p in params.parameters() if p.requires_grad]
        if not trained:
            raise ValueError("no parameter requires a gradient: call "
                             "trainable_mask first")

        def grads_of(mb):
            loss = loss_fn(params, cfg, mb, remat)
            gs = torch.autograd.grad(loss, trained, allow_unused=True)
            # a leaf the loss does not reach has a zero gradient, as in JAX
            return loss.detach(), [torch.zeros_like(p) if g is None else g
                                   for g, p in zip(gs, trained)]

        if grad_accum == 1:
            loss, grads = grads_of(batch)
        else:
            split = {k: v.reshape((grad_accum, -1) + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            loss = torch.zeros((), dtype=torch.float32,
                               device=trained[0].device)
            acc = [torch.zeros(p.shape, dtype=accum_dtype or p.dtype,
                               device=p.device) for p in trained]
            for i in range(grad_accum):
                mloss, gs = grads_of({k: v[i] for k, v in split.items()})
                loss = loss + mloss
                for a, g in zip(acc, gs):
                    a.add_(g.to(a.dtype))
                del gs
            loss = loss / grad_accum
            grads = [(a / grad_accum).to(p.dtype)
                     for a, p in zip(acc, trained)]
            del acc
        metrics = {"loss": loss, "grad_norm": global_norm(grads)}
        opt_state = optimizer.update(params, dict(zip(trained, grads)),
                                     state.opt_state)
        return TrainState(params, opt_state, state.step + 1), metrics

    return train_step


def init_state(params: nn.Module, optimizer: AdamW) -> TrainState:
    return TrainState(params, optimizer.init(params), 0)
