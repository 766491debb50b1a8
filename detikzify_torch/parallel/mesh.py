"""Device mesh and parameter sharding rules (counterpart of
``detikzify_tpu/parallel/mesh.py``) on ``torch.distributed``.

One process drives one device. ``make_mesh`` lays the processes of the
group out as a ``DeviceMesh`` with dims named ``("data", "model")``;
``param_spec`` is the JAX package's rule, a pure function of the JAX tree's
leaf path and shape that names the mesh axis of each dimension; and
``place_params`` stores a model over the ``data`` axis:

  * ``fsdp=False``: every rank holds the whole weights (broadcast from rank
    0); the train step averages the gradients over ``data`` (DDP);
  * ``fsdp=True``: each leaf whose spec names ``data`` is kept as this
    rank's slice of that dimension (ZeRO-3 storage), and its Adam moments
    likewise. Inside a train step (``Placement.streaming``) each decoder
    and vision layer is whole only around its own forward and backward
    (``models.layers.run_layer``), the other sharded leaves (embeddings,
    head, connector) for the step; the gradients of the sharded tensors
    are reduce-scattered to this rank's slices and the update writes the
    master slices. The 8-bit moments (``quant8``) are block-scaled over
    the leaf's flat JAX-order vector, so they are split on whole
    256-element blocks (``Placement.block_range``), not on
    ``param_spec``'s dimension: a slice boundary that cut a block would
    change its scale. Their update gathers one leaf at a time.

The ``model`` (tensor-parallel) axis has its rule here but no placement:
``place_params`` raises for ``model > 1`` (``ROADMAP.md`` queue 1).
"""
from __future__ import annotations

import contextlib
import os
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ..models.convert import Leaf, leaves

AXES = ("data", "model")
#: where the tensor-parallel placement waits
TP_ITEM = ("the mesh's `model` (tensor-parallel) axis, ROADMAP.md queue 1")

Spec = Tuple[Optional[str], ...]


def _group_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def local_device() -> torch.device:
    """This process's device: ``cuda:<LOCAL_RANK>`` (torchrun's variable,
    else the group rank modulo the cards) when there is a card, else the
    CPU."""
    if not torch.cuda.is_available():
        return torch.device("cpu")
    if "LOCAL_RANK" in os.environ:
        idx = int(os.environ["LOCAL_RANK"])
    else:
        idx = (dist.get_rank() if _group_initialized() else 0)
        idx %= torch.cuda.device_count()
    return torch.device("cuda", idx)


def join_group(device="cuda") -> torch.device:
    """Join the ``torch.distributed`` group that torchrun's environment
    describes (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``):
    nccl on the card, gloo on the CPU. Returns this process's device (a
    card's ``cuda`` becomes ``cuda:<LOCAL_RANK>``)."""
    on_card = torch.device(device).type == "cuda"
    if not _group_initialized():
        dist.init_process_group("nccl" if on_card else "gloo")
    if not on_card:
        return torch.device(device)
    dev = local_device()
    torch.cuda.set_device(dev)
    return dev


class Mesh:
    """A ``("data", "model")`` mesh over the processes of the default
    group, one device each; without a group, one device and no
    ``device_mesh``."""

    def __init__(self, data: int, model: int, device,
                 device_mesh=None):
        self.shape = {"data": data, "model": model}
        self.device = torch.device(device)
        self.device_mesh = device_mesh

    @property
    def distributed(self) -> bool:
        return self.device_mesh is not None

    def group(self, axis: str):
        return self.device_mesh.get_group(axis) if self.distributed else None

    def coordinate(self, axis: str) -> int:
        """This process's index along ``axis``."""
        return (self.device_mesh.get_local_rank(axis) if self.distributed
                else 0)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device})"


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
    from torch.distributed.device_mesh import DeviceMesh

    if device.type == "cuda":
        torch.cuda.set_device(device)
    dm = DeviceMesh(device.type, torch.arange(world).reshape(data, model),
                    mesh_dim_names=AXES)
    return Mesh(data, model, device, dm)


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
    """A model placed on a mesh's data axis (``place_params``): the spec of
    each leaf, and with ``fsdp`` the master slices of the sharded tensors.
    A sharded model's whole tensors are valid only between ``gather`` and
    ``release`` (``gathered()``); inside ``streaming()`` (a train step)
    each decoder and vision layer is whole only around its own forward and
    backward, the rest for the whole step. Every rank makes these calls
    together."""

    def __init__(self, params: nn.Module, mesh: Mesh, fsdp: bool):
        from ..models import llama, siglip

        self.mesh, self.fsdp = mesh, fsdp
        self.group = mesh.group("data")
        self.world = mesh.shape["data"]
        self.rank = mesh.coordinate("data")
        self.specs = shard_params(params, mesh, fsdp)
        self.in_step = False           # inside ``streaming()``
        self._entries: Dict[int, _Entry] = {}
        for leaf in leaves(params):
            dim = _data_dim(leaf, self.specs[leaf.path]) if fsdp else None
            for t in leaf.tensors:
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
        """This rank holds a strict slice of ``t``."""
        return self._entries[id(t)].dim is not None and self.world > 1

    def block_range(self, n_blocks: int) -> Tuple[int, int]:
        """This rank's whole 256-element blocks of a leaf's 8-bit moments:
        contiguous runs of ``ceil(n_blocks / world)``."""
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

    # --- collectives ---------------------------------------------------

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        if self.mesh.distributed:
            dist.all_reduce(x, group=self.group)
        return x

    def all_gather(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``x`` (one shape on all), in rank order."""
        if not self.mesh.distributed:
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
        if not self.mesh.distributed:
            return x
        raw = x.view(torch.uint8) if x.element_size() == 1 else x
        pad = raw.new_zeros((per,) + tuple(raw.shape[1:]))
        pad[:raw.shape[0]] = raw
        out = torch.cat(self.all_gather(pad))[:total]
        return out.view(x.dtype) if x.element_size() == 1 else out

    # --- optimizer state -------------------------------------------------

    def shard_state(self, opt_state: dict, leaves_by_path) -> dict:
        """Whole optimizer moments -> this rank's part (dense moments by
        ``local``, 8-bit ones by ``block_range``)."""
        return self._map_state(opt_state, leaves_by_path, gather=False)

    def gather_state(self, opt_state: dict, leaves_by_path) -> dict:
        """This rank's optimizer moments -> whole ones (every rank)."""
        return self._map_state(opt_state, leaves_by_path, gather=True)

    def _map_state(self, opt_state, leaves_by_path, gather: bool) -> dict:
        moments = {}
        for path, st in opt_state["moments"].items():
            leaf = leaves_by_path[path]
            if "mq" in st:
                moments[path] = {k: self._blocks(v, gather)
                                 for k, v in st.items()}
            else:
                moments[path] = {k: [self._part(t, x, gather)
                                     for t, x in zip(leaf.tensors, v)]
                                 for k, v in st.items()}
        return {**opt_state, "moments": moments}

    def _part(self, t, x, gather: bool):
        e = self._entries[id(t)]
        if e.dim is None:
            return x
        if not gather:
            return self._slice(x, e.dim).clone()
        return torch.cat(self.all_gather(x), dim=e.dim)

    def _blocks(self, x, gather: bool):
        if not self.fsdp:
            return x
        if not gather:
            lo, hi = self.block_range(x.shape[0])
            return x[lo:hi].clone()
        n = self.all_reduce(torch.tensor([x.shape[0]], device=x.device))
        total = int(n)
        return self.all_gather_rows(x, -(-total // self.world), total)


def place_params(params: nn.Module, mesh: Mesh, fsdp: bool = False
                 ) -> nn.Module:
    """Put ``params`` on this process's device of ``mesh``, the same
    weights on every rank (rank 0's), stored as ``param_spec`` says over
    the data axis; the module's ``placement`` attribute holds the
    ``Placement``. Tensor-parallel placement (``model > 1``) is not
    written yet (``TP_ITEM``)."""
    if mesh.shape["model"] > 1:
        raise NotImplementedError(
            f"placement over a model axis of {mesh.shape['model']}: "
            f"{TP_ITEM}")
    params = params.to(mesh.device)
    if not mesh.distributed:
        return params
    with torch.no_grad():
        for t in list(params.parameters()) + list(params.buffers()):
            dist.broadcast(t.data, src=0, group=mesh.group("data"))
    placement = Placement(params, mesh, fsdp)
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
