"""Device mesh and parameter sharding rules (counterpart of
``detikzify_tpu/parallel/mesh.py``) on ``torch.distributed``.

One process drives one device. ``make_mesh`` lays the processes of the
group out as a ``("data", "model")`` grid (rank ``d * model + m``) with a
process group for each row and column; ``param_spec`` is the JAX package's
rule, a pure function of the JAX tree's leaf path and shape that names the
mesh axis of each dimension; and ``place_params`` stores a model on the
mesh:

  * over ``model`` (tensor parallelism, ``parallel.tp``): each rank keeps
    the slice of each weight that ``param_spec`` gives its coordinate, cut
    on whole heads for q/k/v/o (a rank's query heads and the KV heads they
    read; where the KV heads do not divide by the ranks, a KV head is held
    by every rank that reads it and its gradient is summed over them), and
    the layers learn their collectives (``tp_role``); the engine, the
    pipeline and the train step then run every rank's shard in lockstep;
  * ``fsdp=False`` over ``data``: every rank holds the weights (broadcast
    from rank 0); the train step averages the gradients over ``data``
    (DDP);
  * ``fsdp=True`` over ``data``: each leaf whose spec names ``data`` is
    kept as this rank's slice of that dimension of its tensor-parallel
    shard (ZeRO-3 storage), and its Adam moments likewise. Inside a train
    step (``Placement.streaming``) each decoder and vision layer is whole
    only around its own forward and backward (``models.layers.run_layer``),
    the other sharded leaves (embeddings, head, connector) for the step;
    the gradients of the sharded tensors are reduce-scattered to this
    rank's slices and the update writes the master slices.

The 8-bit moments (``quant8``) are block-scaled over the whole leaf's flat
JAX-order vector, so they are split on whole 256-element blocks over
``data`` (``Placement.block_range``), not on ``param_spec``'s dimension,
and are the same on every rank of a model group: their update rebuilds one
leaf at a time whole over both axes.
"""
from __future__ import annotations

import contextlib
import os
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ..models.convert import Leaf, leaves
from .tp import Cut, Role, TensorParallel, head_range

AXES = ("data", "model")

Spec = Tuple[Optional[str], ...]


def _group_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def local_device() -> torch.device:
    """This process's device: ``cuda:<LOCAL_RANK>`` (torchrun's variable,
    else the group rank modulo the cards) when there is a card, else the
    CPU. Ranks beyond the cards share them."""
    if not torch.cuda.is_available():
        return torch.device("cpu")
    if "LOCAL_RANK" in os.environ:
        idx = int(os.environ["LOCAL_RANK"])
    else:
        idx = (dist.get_rank() if _group_initialized() else 0)
    idx %= torch.cuda.device_count()
    return torch.device("cuda", idx)


def join_group(device="cuda", backend: Optional[str] = None, *,
               init_method: Optional[str] = None,
               rank: Optional[int] = None,
               world_size: Optional[int] = None) -> torch.device:
    """Join the ``torch.distributed`` group that torchrun's environment
    describes (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``),
    or the one ``init_method``, ``rank`` and ``world_size`` name. The
    backend is the caller's: by default nccl on the card (one rank a card)
    and gloo on the CPU; ranks that share a card pass ``"gloo"`` (nccl
    refuses two ranks on one device). Returns this process's device (a
    card's ``cuda`` becomes ``cuda:<LOCAL_RANK>``, or the rank modulo the
    cards)."""
    on_card = torch.device(device).type == "cuda"
    if not _group_initialized():
        kw = {} if init_method is None else dict(
            init_method=init_method, rank=rank, world_size=world_size)
        dist.init_process_group(
            backend or ("nccl" if on_card else "gloo"), **kw)
    if not on_card:
        return torch.device(device)
    dev = local_device()
    torch.cuda.set_device(dev)
    return dev


class Mesh:
    """A ``("data", "model")`` mesh over the processes of the default
    group, one device each (``groups``: each axis's process group through
    this rank, None for an axis of one; ``coords``: this rank's index
    along each axis); without a group, one device."""

    def __init__(self, data: int, model: int, device, groups=None,
                 coords: Tuple[int, int] = (0, 0)):
        self.shape = {"data": data, "model": model}
        self.device = torch.device(device)
        self.groups = groups
        self.coords = dict(zip(AXES, coords))

    @property
    def distributed(self) -> bool:
        return self.groups is not None

    def group(self, axis: str):
        return self.groups[axis] if self.distributed else None

    def coordinate(self, axis: str) -> int:
        """This process's index along ``axis``."""
        return self.coords[axis]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device})"


def _axis_groups(data: int, model: int, rank: int) -> dict:
    """Each axis's group through ``rank`` on a ``data x model`` grid. Every
    rank creates every group, in one order; an axis of one needs none and
    an axis of the whole world is the default group."""
    world = data * model
    grid = torch.arange(world).reshape(data, model)
    out = {}
    for axis, lines in (("model", grid.tolist()),
                        ("data", grid.t().tolist())):
        if len(lines[0]) == 1:
            out[axis] = None
        elif len(lines[0]) == world:
            out[axis] = dist.group.WORLD
        else:
            for ranks in lines:
                g = dist.new_group(ranks)
                if rank in ranks:
                    out[axis] = g
    return out


def make_mesh(data: Optional[int] = None, model: int = 1,
              device=None) -> Mesh:
    """Create a ('data', 'model') mesh over the processes of the default
    ``torch.distributed`` group (one device each), or over this process's
    one device when there is no group."""
    world = dist.get_world_size() if _group_initialized() else 1
    if data is None:
        assert world % model == 0, (world, model)
        data = world // model
    assert data * model == world, f"mesh {data}x{model} != {world} devices"
    device = torch.device(device) if device is not None else local_device()
    if not _group_initialized():
        return Mesh(data, model, device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    rank = dist.get_rank()
    return Mesh(data, model, device, _axis_groups(data, model, rank),
                (rank // model, rank % model))


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------

def param_spec(path: str, shape: tuple, fsdp: bool) -> Spec:
    """Tensor-parallel spec for one parameter: the mesh axis of each
    dimension (``()`` = replicated), the JAX ``PartitionSpec``'s entries.

    Megatron-style: column-parallel for q/k/v/gate/up/fc1 (+ lm_head,
    embeddings over hidden), row-parallel for o/down/fc2. When ``fsdp`` is
    set, the remaining large dimension additionally shards over 'data'
    (ZeRO-3-style parameter sharding)."""
    ndim = len(shape)
    col = ("attn/q/", "attn/k/", "attn/v/", "mlp/gate/", "mlp/up/",
           "mlp/fc1/")
    row = ("attn/o/", "mlp/down/", "mlp/fc2/")

    def spec_for(in_axis: Optional[int], out_axis: Optional[int],
                 model_on_out: bool) -> Spec:
        dims: list = [None] * ndim
        if model_on_out and out_axis is not None:
            dims[out_axis] = "model"
            if fsdp and in_axis is not None:
                dims[in_axis] = "data"
        elif not model_on_out and in_axis is not None:
            dims[in_axis] = "model"
            if fsdp and out_axis is not None:
                dims[out_axis] = "data"
        return tuple(dims)

    if path.endswith("kernel") or "embed_tokens" in path or "position" in path:
        if "embed_tokens" in path and ndim == 2:
            # [V, D]: hidden on 'model' (vocab on 'data' under fsdp)
            return spec_for(0, 1, model_on_out=True)
        if "lm_head" in path and ndim == 2:
            return spec_for(0, 1, model_on_out=True)    # [D, V]: V on model
        if ndim >= 2:
            in_axis, out_axis = ndim - 2, ndim - 1
            if any(s in path for s in col):
                return spec_for(in_axis, out_axis, model_on_out=True)
            if any(s in path for s in row):
                # row-parallel: contracting (input) dim on 'model'
                return spec_for(in_axis, out_axis, model_on_out=False)
            if fsdp and ndim >= 2:
                return tuple([None] * (ndim - 2) + ["data", None])
    return ()  # replicated (norms, biases, gates, small tensors)


def leaf_shape(leaf: Leaf) -> tuple:
    """The JAX tree's shape of a leaf: ``[in, out]`` kernels, ``[L, ...]``
    stacked layers."""
    t = leaf.tensors[0]
    shape = tuple(t.t().shape if leaf.transposed else t.shape)
    return (len(leaf.tensors),) + shape if leaf.stacked else shape


def shard_params(params: nn.Module, mesh: Mesh, fsdp: bool = False
                 ) -> Dict[str, Spec]:
    """Each leaf's spec on ``mesh`` (keyed by its JAX path), keeping only
    the axes whose size divides the leaf's dimension."""
    out = {}
    for leaf in leaves(params):
        shape = leaf_shape(leaf)
        spec = param_spec(leaf.path, shape, fsdp)
        out[leaf.path] = tuple(
            None if axis is None or shape[i] % mesh.shape[axis] else axis
            for i, axis in enumerate(spec))
    return out


# ---------------------------------------------------------------------------
# tensor-parallel cut
# ---------------------------------------------------------------------------

def _cut(mod: nn.Module, name: str, dim: int, lo: int, hi: int,
         cuts: dict, owner: bool = True, shared: bool = False) -> None:
    """Keep rows ``[lo, hi)`` of dimension ``dim`` of ``mod``'s tensor
    ``name``: a parameter keeps its object (and ``requires_grad``), a
    buffer is replaced."""
    t = getattr(mod, name)
    part = t.detach().narrow(dim, lo, hi - lo).clone()
    cuts[(mod, name)] = Cut(dim, lo, hi, t.shape[dim], owner, shared)
    if isinstance(t, nn.Parameter):
        t.data = part
    else:
        setattr(mod, name, part)


def _cut_dense(lin: nn.Module, kind: str, lo: int, hi: int, tp, cuts: dict,
               owner: bool = True, shared: bool = False) -> None:
    """A column-parallel layer keeps output rows ``[lo, hi)`` (and their
    bias and int8 scales), a row-parallel one input columns ``[lo, hi)``
    (its bias and scales stay whole: they apply after the sum)."""
    from ..ops.quant import QuantLinear

    names = ("q", "scale") if isinstance(lin, QuantLinear) else ("weight",)
    if kind == "col":
        for name in names + (("bias",) if lin.bias is not None else ()):
            _cut(lin, name, 0, lo, hi, cuts, owner, shared)
        lin.out_features = hi - lo
    else:
        _cut(lin, names[0], 1, lo, hi, cuts)
        lin.in_features = hi - lo
    lin.tp_role = Role(kind, tp)


@torch.no_grad()
def _cut_model(params: nn.Module, tp: TensorParallel) -> dict:
    """Cut ``params`` in place to this rank's tensor-parallel shard (see
    the module's docstring); returns each cut tensor's ``Cut`` keyed by
    (module, attribute): a move to another device replaces buffers."""
    from ..models import llama, siglip

    r, m = tp.rank, tp.size
    cuts: dict = {}
    for mod in list(params.modules()):
        if isinstance(mod, (llama.Attention, siglip.Attention)):
            if hasattr(mod, "qkv"):
                raise ValueError("place the weights on the mesh before "
                                 "ops.quant.fuse_projections")
            nh, nkv = (mod.heads if isinstance(mod, llama.Attention)
                       else (mod.heads, mod.heads))
            hd = mod.head_dim
            (q0, q1), (k0, k1) = head_range(r, m, nh, nkv)
            shared = (k1 - k0) * m > nkv
            owner = r == 0 or head_range(r - 1, m, nh, nkv)[1] != (k0, k1)
            _cut_dense(mod.q, "col", q0 * hd, q1 * hd, tp, cuts)
            for name in ("k", "v"):
                _cut_dense(getattr(mod, name), "col", k0 * hd, k1 * hd, tp,
                           cuts, owner, shared)
            _cut_dense(mod.o, "row", q0 * hd, q1 * hd, tp, cuts)
            mod.heads = ((q1 - q0, k1 - k0)
                         if isinstance(mod, llama.Attention) else q1 - q0)
        elif isinstance(mod, (llama.MLP, siglip.MLP)):
            if hasattr(mod, "gateup"):
                raise ValueError("place the weights on the mesh before "
                                 "ops.quant.fuse_projections")
            col, row = (("gate", "up"), "down") if isinstance(
                mod, llama.MLP) else (("fc1",), "fc2")
            width = getattr(mod, col[0]).out_features
            if width % m:            # JAX's guard: kept whole
                continue
            n = width // m
            for name in col:
                _cut_dense(getattr(mod, name), "col", r * n, (r + 1) * n,
                           tp, cuts)
            _cut_dense(getattr(mod, row), "row", r * n, (r + 1) * n, tp,
                       cuts)
        elif isinstance(mod, llama.Llama):
            d = mod.embed_tokens.shape[1]
            if d % m == 0:           # [V, D]: hidden on 'model'
                _cut(mod, "embed_tokens", 1, r * d // m, (r + 1) * d // m,
                     cuts)
                mod.embed_tp = tp
            head = mod.lm_head
            if head is not None and head.out_features % m == 0:
                n = head.out_features // m
                _cut_dense(head, "col", r * n, (r + 1) * n, tp, cuts)
                head.tp_role = Role("vocab", tp)
    return cuts


def _data_dim(leaf: Leaf, spec: Spec) -> Optional[int]:
    """The dimension of each of the leaf's port tensors that ``spec``
    shards over 'data' (None: not sharded)."""
    if "data" not in spec:
        return None
    i = spec.index("data")
    if leaf.stacked:
        if i == 0:
            raise NotImplementedError(
                f"{leaf.path}: 'data' on the stacked layer axis")
        i -= 1
    return (1 - i) if leaf.transposed else i


class _Entry:
    """One tensor of the model: the sharded dimension (None: replicated),
    this rank's master slice, and whether the whole tensor is held. On a
    data axis of one the master is the tensor itself."""

    __slots__ = ("full", "dim", "shard", "whole")

    def __init__(self, full: torch.Tensor, dim: Optional[int],
                 shard: Optional[torch.Tensor]):
        self.full, self.dim, self.shard = full, dim, shard
        self.whole = True

    @property
    def owned(self) -> bool:
        """The whole tensor is a copy, gathered and freed."""
        return self.dim is not None and self.shard is not self.full


class _Unit:
    """The sharded tensors of one layer (``models.layers.run_layer`` calls
    ``run`` around the layer's forward)."""

    def __init__(self, placement: "Placement", entries: List[_Entry]):
        self.placement, self.entries = placement, entries

    def run(self, block, x: torch.Tensor, *args):
        """``block(x, *args)``. Inside a sharded step the layer's tensors
        are whole only around its forward and, gathered again by a hook on
        its output's gradient, around its backward; a hook on its input's
        gradient frees them after. A layer whose input needs no gradient
        but whose weights train stays whole to the step's end."""
        p = self.placement
        if not (p.in_step and self.entries):
            return block(x, *args)
        p._gather(self.entries)
        out = block(x, *args)
        if torch.is_grad_enabled() and out.requires_grad:
            if not x.requires_grad:
                return out
            out.register_hook(lambda g: p._gather(self.entries))
            x.register_hook(lambda g: p._release(self.entries))
        p._release(self.entries)
        return out


class Placement:
    """A model placed on a mesh (``place_params``): the spec of each leaf,
    this rank's tensor-parallel cut of each tensor (``cuts``; the module's
    tensors are this rank's shards), and with ``fsdp`` the master slices
    of the shards over the data axis. A sharded model's shards are valid
    only between ``gather`` and ``release`` (``gathered()``); inside
    ``streaming()`` (a train step) each decoder and vision layer is whole
    only around its own forward and backward, the rest for the whole step.
    Every rank makes these calls together."""

    def __init__(self, params: nn.Module, mesh: Mesh, fsdp: bool,
                 specs: Dict[str, Spec], cuts: Dict[int, Cut]):
        from ..models import llama, siglip

        self.mesh, self.fsdp = mesh, fsdp
        self.group = mesh.group("data")
        self.world = mesh.shape["data"]
        self.rank = mesh.coordinate("data")
        self.tp = TensorParallel(mesh.group("model"),
                                 mesh.coordinate("model"),
                                 mesh.shape["model"])
        self.specs = specs
        self.in_step = False           # inside ``streaming()``
        self._entries: Dict[int, _Entry] = {}
        self._cuts: Dict[int, Optional[Cut]] = {}
        for leaf in leaves(params):
            dim = _data_dim(leaf, self.specs[leaf.path]) if fsdp else None
            for t in leaf.tensors:
                self._cuts[id(t)] = cuts.get(id(t))
                if dim is None or not t.is_floating_point():
                    self._entries[id(t)] = _Entry(t, None, None)
                    continue
                if self.world == 1:
                    self._entries[id(t)] = _Entry(t, dim, t)
                    continue
                if not t.untyped_storage().resizable():
                    t.data = t.detach().clone()       # e.g. from numpy
                self._entries[id(t)] = _Entry(
                    t, dim, self._slice(t.detach(), dim).clone())
        in_units = set()
        for mod in params.modules():
            if isinstance(mod, (llama.Llama, siglip.SiglipVision)):
                for lp in mod.layers:
                    entries = [self._entries[id(t)] for t in lp.parameters()
                               if self._entries[id(t)].owned]
                    lp.fsdp_unit = _Unit(self, entries)
                    in_units.update(id(e) for e in entries)
        self._root = [e for e in self._owned() if id(e) not in in_units]

    # --- slices --------------------------------------------------------

    def _slice(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        n = x.shape[dim] // self.world
        return x.narrow(dim, self.rank * n, n)

    def master(self, t: torch.Tensor) -> torch.Tensor:
        """The tensor the optimizer updates for ``t``: its master slice
        when sharded, else ``t`` itself."""
        e = self._entries[id(t)]
        return t if e.dim is None else e.shard

    def splits(self, t: torch.Tensor) -> bool:
        """This rank holds a strict slice of ``t`` over the data axis."""
        return self._entries[id(t)].dim is not None and self.world > 1

    def cut(self, t: torch.Tensor) -> Optional[Cut]:
        """``t``'s tensor-parallel cut (None: whole on every rank). A
        tensor made after the placement (a fused projection) has none to
        give: it raises."""
        if id(t) not in self._cuts:
            raise ValueError(
                "a tensor made after the placement (fused projections?) "
                "has no whole over the model axis")
        return self._cuts[id(t)]

    def whole(self, t: torch.Tensor, x: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
        """The whole over the model axis of ``x`` (``t`` itself by
        default), this rank's part of ``t``'s shape: rebuilt from every
        rank's part (a collective) where ``t`` is cut."""
        return self.tp.whole(t if x is None else x, self.cut(t))

    def part(self, t: torch.Tensor, whole: torch.Tensor) -> torch.Tensor:
        """This rank's part of ``whole``, a tensor of ``t``'s whole shape
        (a view)."""
        c = self.cut(t)
        return whole if c is None else whole.narrow(c.dim, c.lo,
                                                    c.hi - c.lo)

    def whole_numel(self, t: torch.Tensor) -> int:
        c = self.cut(t)
        return t.numel() if c is None else t.numel() // (c.hi - c.lo) \
            * c.size

    def model_reduce_grad(self, t: torch.Tensor, g: torch.Tensor
                          ) -> torch.Tensor:
        """``g`` summed over the ranks that hold the same rows of ``t``
        (KV heads shared over the model axis); else ``g`` itself."""
        c = self.cut(t)
        return g if c is None or not c.shared else self.tp.sum_shared(g, c)

    @property
    def block_world(self) -> int:
        """The ranks over which the 8-bit moments' blocks are split: the
        data axis with ``fsdp``, else one (every rank holds them all)."""
        return self.world if self.fsdp else 1

    def block_range(self, n_blocks: int) -> Tuple[int, int]:
        """This rank's whole 256-element blocks of a leaf's 8-bit moments:
        contiguous runs of ``ceil(n_blocks / world)`` over the data axis
        with ``fsdp``, else all of them."""
        if self.block_world == 1:
            return 0, n_blocks
        per = -(-n_blocks // self.world)
        lo = min(self.rank * per, n_blocks)
        return lo, min(lo + per, n_blocks)

    # --- gather / release ----------------------------------------------

    def _sharded(self) -> List[_Entry]:
        return [e for e in self._entries.values() if e.dim is not None]

    def _owned(self) -> List[_Entry]:
        return [e for e in self._entries.values() if e.owned]

    def _of(self, tensors) -> List[_Entry]:
        if tensors is None:
            return self._owned()
        return [e for e in (self._entries[id(t)] for t in tensors)
                if e.owned]

    @property
    def is_full(self) -> bool:
        return all(e.whole for e in self._owned())

    @torch.no_grad()
    def _gather(self, entries: List[_Entry]) -> None:
        for e in entries:
            if e.whole:
                continue
            storage = e.full.untyped_storage()
            storage.resize_(e.full.numel() * e.full.element_size())
            parts = [torch.empty_like(e.shard) for _ in range(self.world)]
            dist.all_gather(parts, e.shard.contiguous(), group=self.group)
            # through ``.data``: a copy that the autograd graph does not
            # see, so a tensor it saved before the release stays valid
            e.full.data.copy_(torch.cat(parts, dim=e.dim))
            e.whole = True

    def _release(self, entries: List[_Entry]) -> None:
        for e in entries:
            if e.whole:
                e.full.untyped_storage().resize_(0)
                e.whole = False

    def gather(self, tensors=None) -> None:
        """Rebuild the sharded tensors (all, or those of ``tensors``) from
        the ranks' master slices."""
        self._gather(self._of(tensors))

    def release(self, tensors=None) -> None:
        """Free the whole sharded tensors (the masters stay)."""
        self._release(self._of(tensors))

    @contextlib.contextmanager
    def gathered(self, tensors=None):
        """Whole tensors inside the block, the storage as it was after."""
        entries = [e for e in self._of(tensors) if not e.whole]
        self._gather(entries)
        try:
            yield
        finally:
            self._release(entries)

    @contextlib.contextmanager
    def streaming(self, per_layer: bool = True):
        """A train step's forwards and backwards: the tensors outside the
        layers whole throughout, each layer's only around its own forward
        and backward (``_Unit.run``); with ``per_layer`` False the whole
        model throughout. Everything is freed after."""
        self._gather(self._root if per_layer else self._owned())
        self.in_step = per_layer
        try:
            yield
        finally:
            self.in_step = False
            self.release()

    @torch.no_grad()
    def refresh_masters(self, tensors=None) -> None:
        """Copy the whole tensors' slices into the masters (after the whole
        tensors were written: a restore, an 8-bit update)."""
        for e in self._of(tensors):
            e.shard.copy_(self._slice(e.full, e.dim))

    # --- collectives over the data axis ----------------------------------

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        if self.world > 1:
            dist.all_reduce(x, group=self.group)
        return x

    def all_gather(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``x`` (one shape on all), in rank order."""
        if self.world == 1:
            return [x]
        parts = [torch.empty_like(x) for _ in range(self.world)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return parts

    def reduce_grad(self, t: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        """``g``, this rank's gradient of ``t``, summed over the data axis:
        this rank's slice of the sum when ``t`` is sharded (a
        reduce-scatter), else all of it (an all-reduce)."""
        if not self.splits(t):
            return self.all_reduce(g)
        e = self._entries[id(t)]
        chunks = [c.contiguous() for c in g.chunk(self.world, e.dim)]
        out = torch.empty_like(chunks[self.rank])
        dist.reduce_scatter(out, chunks, group=self.group)
        return out

    def all_gather_rows(self, x: torch.Tensor, per: int, total: int
                        ) -> torch.Tensor:
        """Concatenate the ranks' leading rows in rank order, each rank
        holding the run ``block_range`` gives it (``per`` rows, fewer or
        none at the end), ``total`` rows in all."""
        if self.block_world == 1:
            return x
        raw = x.view(torch.uint8) if x.element_size() == 1 else x
        pad = raw.new_zeros((per,) + tuple(raw.shape[1:]))
        pad[:raw.shape[0]] = raw
        out = torch.cat(self.all_gather(pad))[:total]
        return out.view(x.dtype) if x.element_size() == 1 else out

    # --- whole weights and optimizer state -------------------------------

    def state_dict(self, params: nn.Module) -> dict:
        """``params.state_dict()`` of whole tensors over both axes (every
        rank gets it; call inside ``gathered()``)."""
        return {k: self.whole(t).detach()
                for k, t in params.state_dict(keep_vars=True).items()}

    @torch.no_grad()
    def load_state_dict(self, params: nn.Module, whole: dict) -> None:
        """Write each rank's parts of ``whole`` (a ``state_dict`` of whole
        tensors) into ``params`` and their master slices."""
        with self.gathered():
            for k, t in params.state_dict(keep_vars=True).items():
                t.data.copy_(self.part(t, whole[k]))
            self.refresh_masters()

    def shard_state(self, opt_state: dict, leaves_by_path,
                    cut: bool = True) -> dict:
        """Whole optimizer moments -> this rank's part (dense moments by
        its tensor-parallel cut, unless ``cut`` is False: moments already
        of this rank's shards, and data slice; 8-bit ones, always of the
        whole leaves, by ``block_range``)."""
        return self._map_state(opt_state, leaves_by_path, gather=False,
                               cut=cut)

    def gather_state(self, opt_state: dict, leaves_by_path) -> dict:
        """This rank's optimizer moments -> whole ones (every rank)."""
        return self._map_state(opt_state, leaves_by_path, gather=True)

    def _map_state(self, opt_state, leaves_by_path, gather: bool,
                   cut: bool = True) -> dict:
        moments = {}
        for path, st in opt_state["moments"].items():
            leaf = leaves_by_path[path]
            if "mq" in st:
                moments[path] = {k: self._blocks(v, gather)
                                 for k, v in st.items()}
            else:
                moments[path] = {k: [self._part(t, x, gather, cut)
                                     for t, x in zip(leaf.tensors, v)]
                                 for k, v in st.items()}
        return {**opt_state, "moments": moments}

    def _part(self, t, x, gather: bool, cut: bool = True):
        e = self._entries[id(t)]
        if not gather:
            x = self.part(t, x) if cut else x
            return x.clone() if e.dim is None else \
                self._slice(x, e.dim).clone()
        if e.dim is not None:
            x = torch.cat(self.all_gather(x), dim=e.dim)
        return self.whole(t, x)

    def _blocks(self, x, gather: bool):
        if not self.fsdp:
            return x
        if not gather:
            lo, hi = self.block_range(x.shape[0])
            return x[lo:hi].clone()
        n = self.all_reduce(torch.tensor([x.shape[0]], device=x.device))
        total = int(n)
        return self.all_gather_rows(x, -(-total // self.world), total)


def place_params(params: nn.Module, mesh: Mesh, fsdp: bool = False,
                 identical: bool = False) -> nn.Module:
    """Put ``params`` on this process's device of ``mesh``, the same
    weights on every rank (rank 0's, broadcast; ``identical``: every rank
    holds them already, loaded from one checkpoint or drawn from one seed,
    and none is sent), stored as ``param_spec`` says: this rank's
    tensor-parallel shard over the model axis, and over the data axis its
    master slices with ``fsdp``. The module's ``placement`` attribute holds
    the ``Placement``. With ``identical`` the cut is made where the weights
    are, before they move (load on the host: only the shard goes to the
    card). Place before ``ops.quant.fuse_projections``; quantize before or
    after (a per-output-channel int8 scale survives either cut)."""
    if mesh.shape["model"] > 1 and not mesh.distributed:
        raise ValueError(f"a model axis of {mesh.shape['model']} needs a "
                         "torch.distributed group (make_mesh)")
    specs = shard_params(params, mesh, fsdp)
    if mesh.distributed and not identical:
        params = params.to(mesh.device)
        with torch.no_grad():
            for t in list(params.parameters()) + list(params.buffers()):
                dist.broadcast(t.data, src=0)
    cuts = {}
    if mesh.shape["model"] > 1:
        cuts = _cut_model(params, TensorParallel(
            mesh.group("model"), mesh.coordinate("model"),
            mesh.shape["model"]))
    params = params.to(mesh.device)
    if not mesh.distributed:
        return params
    cuts = {id(getattr(mod, name)): c for (mod, name), c in cuts.items()}
    placement = Placement(params, mesh, fsdp, specs, cuts)
    params.placement = placement
    placement.release()
    return params


class Sharding(NamedTuple):
    """The JAX ``NamedSharding`` of an array: its mesh and spec."""

    mesh: Mesh
    spec: Spec


def data_sharding(mesh: Mesh, ndim: int) -> Sharding:
    """Batch arrays shard along the leading (batch) axis."""
    return Sharding(mesh, tuple(["data"] + [None] * (ndim - 1)))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def local_rows(x, mesh: Mesh):
    """This rank's rows of a global batch array under
    ``data_sharding``: the ``data`` coordinate's contiguous block."""
    n = x.shape[0] // mesh.shape["data"]
    r = mesh.coordinate("data")
    return x[r * n:(r + 1) * n]
