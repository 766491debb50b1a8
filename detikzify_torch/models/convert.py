"""Build the port's weights: random from a seed, or carried over from the
JAX package's ``Params``.

JAX dense kernels are ``[in, out]`` and per-layer weights are stacked
``[L, ...]`` (``detikzify_tpu/models/import_hf.py``); the port's
``nn.Linear`` weights are ``[out, in]`` and layers are a ``ModuleList``, so
``params_from_numpy`` transposes and unstacks. It also takes the trees of
``detikzify_tpu.ops.quant``: an int8 ``{'kernel_q': {'q', 'scale'}}`` leaf
becomes a ``QuantLinear`` (``q`` transposed the same way), and fused
``qkv`` / ``gateup`` projections are fused in the port's model too.
``adapter_from_numpy`` carries the JAX ``adapter.init`` /
``import_adapter`` tree (stacked blocks, ``connector``, ``dummy_input``)
into the port's ``adapter.Adapter`` the same way, and ``llama_from_numpy``
a bare JAX ``llama.init`` tree (the TikZero caption model) into a
``llama.Llama``, and ``siglip_text_from_numpy`` a JAX ``siglip.init_text``
tree (ClipScore's text tower) into a ``siglip.SiglipText``.
``params_to_numpy`` is the inverse of ``params_from_numpy``: the port's
weights (or any tensors keyed by them, such as their gradients) as the JAX
tree of numpy arrays, and ``adapter_to_numpy`` that of
``adapter_from_numpy``. ``leaves`` lists that tree's leaves with the port
tensors behind each: one tensor, or one a layer of a stacked leaf.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import AdapterConfig, DetikzifyConfig, TextConfig, VisionConfig
from ..ops.quant import FUSED, QuantLinear, fuse_module
from .adapter import Adapter
from .detikzify import Params
from .llama import Llama
from .layers import LayerNorm, RMSNorm
from .siglip import SiglipText, SiglipVision


def _as_mapping(tree) -> Mapping:
    if isinstance(tree, Mapping):
        return tree
    if hasattr(tree, "_asdict"):          # the JAX Params NamedTuple
        return tree._asdict()
    raise TypeError(f"expected a mapping of numpy arrays, got {type(tree)}")


def _draw(module: nn.Module, generator: torch.Generator) -> None:
    """Dense kernels N(0, 1/in) drawn from ``generator`` in module order,
    biases zero, norms at identity (the JAX ``layers`` inits)."""
    for mod in module.modules():
        if isinstance(mod, nn.Linear):
            mod.weight.normal_(0.0, mod.in_features ** -0.5,
                               generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (LayerNorm, RMSNorm)):
            mod.scale.fill_(1.0)
            if isinstance(mod, LayerNorm):
                mod.bias.zero_()


@torch.no_grad()
def init_random(cfg: DetikzifyConfig, device="cuda", dtype=torch.bfloat16,
                generator: Optional[torch.Generator] = None,
                seed: int = 0) -> Params:
    """Random weights allocated directly on ``device`` and drawn from
    ``generator`` (a ``torch.Generator`` on that device; one seeded with
    ``seed`` when None). Scales follow the JAX ``layers.dense_init``: dense
    kernels N(0, 1/in), embeddings / positions / probe N(0, 0.02^2), norms
    at identity, biases zero -- so a full-depth tower stays finite in
    bf16."""
    params = Params(cfg, device=device, dtype=dtype)
    if generator is None:
        generator = torch.Generator(device=params.device).manual_seed(seed)
    _draw(params, generator)
    for p in (params.vision.embeddings.position, params.text.embed_tokens):
        p.normal_(0.0, 0.02, generator=generator)
    if params.vision.head is not None:
        params.vision.head.probe.normal_(0.0, 0.02, generator=generator)
    return params


@torch.no_grad()
def init_random_adapter(vcfg: VisionConfig, acfg: AdapterConfig,
                        device="cuda", dtype=torch.bfloat16,
                        generator: Optional[torch.Generator] = None,
                        seed: int = 0) -> Adapter:
    """A random TikZero adapter drawn on ``device`` (the JAX
    ``adapter.init`` scales): dense kernels N(0, 1/in), biases zero, norms
    at identity, gates zero (sigmoid 0.5), ``dummy_input`` ones."""
    adapter = Adapter(vcfg, acfg, device=device, dtype=dtype)
    if generator is None:
        generator = torch.Generator(device=adapter.device).manual_seed(seed)
    _draw(adapter, generator)
    for blk in adapter.layers:
        blk.attn_gate.zero_()
        blk.mlp_gate.zero_()
    adapter.dummy_input.fill_(1.0)
    return adapter


@torch.no_grad()
def init_random_llama(cfg: TextConfig, device="cuda", dtype=torch.bfloat16,
                      generator: Optional[torch.Generator] = None,
                      seed: int = 0) -> Llama:
    """A random LLaMA decoder (the TikZero caption model) drawn on
    ``device``, at ``init_random``'s scales."""
    text = Llama(cfg, device=device, dtype=dtype).requires_grad_(False)
    if generator is None:
        generator = torch.Generator(device=text.embed_tokens.device
                                    ).manual_seed(seed)
    _draw(text, generator)
    text.embed_tokens.normal_(0.0, 0.02, generator=generator)
    return text


@torch.no_grad()
def init_random_siglip_vision(cfg: VisionConfig, device="cuda",
                              dtype=torch.bfloat16,
                              generator: Optional[torch.Generator] = None,
                              seed: int = 0) -> SiglipVision:
    """A random SigLIP vision tower with its MAP head (ClipScore's image
    side) drawn on ``device``, at ``init_random``'s scales."""
    vision = SiglipVision(cfg, device=device, dtype=dtype
                          ).requires_grad_(False)
    if generator is None:
        generator = torch.Generator(device=vision.embeddings.position.device
                                    ).manual_seed(seed)
    _draw(vision, generator)
    vision.embeddings.position.normal_(0.0, 0.02, generator=generator)
    vision.head.probe.normal_(0.0, 0.02, generator=generator)
    return vision


@torch.no_grad()
def init_random_siglip_text(cfg: VisionConfig, vocab_size: int = 32000,
                            max_positions: int = 64, device="cuda",
                            dtype=torch.bfloat16,
                            generator: Optional[torch.Generator] = None,
                            seed: int = 0) -> SiglipText:
    """A random SigLIP text tower (JAX ``siglip.init_text``'s scales:
    dense kernels N(0, 1/in), token and position embeddings N(0, 0.02^2),
    norms at identity, biases zero) drawn on ``device``."""
    text = SiglipText(cfg, vocab_size, max_positions, device=device,
                      dtype=dtype).requires_grad_(False)
    if generator is None:
        generator = torch.Generator(device=text.embeddings.token.device
                                    ).manual_seed(seed)
    _draw(text, generator)
    text.embeddings.token.normal_(0.0, 0.02, generator=generator)
    text.embeddings.position.normal_(0.0, 0.02, generator=generator)
    return text


def _load(module: nn.Module, tree: Mapping, layer: Optional[int]) -> None:
    def pick(arr):
        arr = np.asarray(arr)
        return arr[layer] if layer is not None else arr

    def transposed(arr):
        return torch.from_numpy(np.array(np.swapaxes(pick(arr), -1, -2)))

    if isinstance(module, (nn.Linear, QuantLinear)):
        if isinstance(module, QuantLinear):
            module.q.copy_(transposed(tree["kernel_q"]["q"]))
            module.scale.copy_(torch.from_numpy(np.array(
                pick(tree["kernel_q"]["scale"]))))
        else:
            module.weight.copy_(transposed(tree["kernel"]))
        if module.bias is not None:
            module.bias.copy_(torch.from_numpy(np.array(pick(tree["bias"]))))
        return
    for fused in FUSED:             # a fused tree: fuse this module first
        if fused in tree:
            fuse_module(module, fused)
    for name, param in module.named_parameters(recurse=False):
        param.copy_(torch.from_numpy(np.array(pick(tree[name]))))
    for name, child in list(module.named_children()):
        if child is None:
            continue
        if isinstance(child, nn.Linear) and "kernel_q" in tree[name]:
            child = QuantLinear.like(child)
            setattr(module, name, child)
        if isinstance(child, nn.ModuleList):
            for i, sub in enumerate(child):
                _load(sub, tree[name], i)
        else:
            _load(child, tree[name], layer)


@torch.no_grad()
def params_from_numpy(tree, cfg: DetikzifyConfig, device="cuda",
                      dtype=torch.float32) -> Params:
    """JAX ``Params`` (``vision``, ``connector``, ``text``) as nested dicts
    of numpy arrays -> the port's ``Params`` on ``device`` in ``dtype``."""
    tree = _as_mapping(tree)
    head = bool(_as_mapping(tree["vision"]).get("head"))
    params = Params(cfg, vision_head=head, device="cpu", dtype=torch.float32)
    for name in ("vision", "connector", "text"):
        _load(getattr(params, name), _as_mapping(tree[name]), None)
    return params.to(device=device, dtype=dtype)


@torch.no_grad()
def adapter_from_numpy(tree, vcfg: VisionConfig, acfg: AdapterConfig,
                       device="cuda", dtype=torch.float32) -> Adapter:
    """A JAX adapter tree (``layers`` stacked ``[L, ...]``, ``connector``,
    ``dummy_input`` ``[H, W, C]``) as nested dicts of numpy arrays -> the
    port's ``Adapter`` on ``device`` in ``dtype``."""
    adapter = Adapter(vcfg, acfg, device="cpu", dtype=torch.float32)
    _load(adapter, _as_mapping(tree), None)
    return adapter.to(device=device, dtype=dtype)


@torch.no_grad()
def llama_from_numpy(tree, cfg: TextConfig, device="cuda",
                     dtype=torch.float32) -> Llama:
    """A bare JAX ``llama.init`` tree as numpy arrays -> ``llama.Llama``."""
    text = Llama(cfg, device="cpu", dtype=torch.float32)
    _load(text, _as_mapping(tree), None)
    return text.requires_grad_(False).to(device=device, dtype=dtype)


@torch.no_grad()
def siglip_text_from_numpy(tree, cfg: VisionConfig, device="cuda",
                           dtype=torch.float32) -> SiglipText:
    """A JAX ``siglip.init_text`` (or ``import_siglip_text``) tree as numpy
    arrays -> ``siglip.SiglipText``; vocabulary and positions are read off
    the embeddings."""
    tree = _as_mapping(tree)
    vocab, _ = np.shape(tree["embeddings"]["token"])
    positions = np.shape(tree["embeddings"]["position"])[0]
    text = SiglipText(cfg, vocab, positions, device="cpu",
                      dtype=torch.float32)
    _load(text, tree, None)
    return text.requires_grad_(False).to(device=device, dtype=dtype)


class Leaf(NamedTuple):
    """One leaf of the JAX tree and the port's tensors behind it."""

    path: str                       # the JAX tree's keys, "/"-joined
    tensors: Tuple[torch.Tensor, ...]   # one a layer when ``stacked``
    transposed: bool                # a dense kernel: JAX keeps [in, out]
    stacked: bool                   # layers stacked on a leading axis


def _walk(module: nn.Module, prefix: str):
    """(path, tensor, transposed) of one module's leaves, in the order
    ``_load`` fills them."""
    if isinstance(module, nn.Linear):
        yield prefix + "kernel", module.weight, True
        if module.bias is not None:
            yield prefix + "bias", module.bias, False
        return
    if isinstance(module, QuantLinear):
        yield prefix + "kernel_q/q", module.q, True
        yield prefix + "kernel_q/scale", module.scale, False
        if module.bias is not None:
            yield prefix + "bias", module.bias, False
        return
    for name, param in module.named_parameters(recurse=False):
        yield prefix + name, param, False
    for name, child in module.named_children():
        if child is None:
            continue
        if isinstance(child, nn.ModuleList):
            for leaf in _stacked(child, f"{prefix}{name}/"):
                yield leaf
        else:
            yield from _walk(child, f"{prefix}{name}/")


def _stacked(layers: nn.ModuleList, prefix: str):
    per_layer = [list(_walk(layer, prefix)) for layer in layers]
    for entries in zip(*per_layer):
        yield entries[0][0], tuple(t for _, t, _ in entries), entries[0][2]


def leaves(module: nn.Module) -> List[Leaf]:
    """The JAX tree's leaves of ``module`` (``Params`` or any of its parts),
    in tree order: per-layer tensors of a ``ModuleList`` form one stacked
    leaf, as the JAX package stacks its layers ``[L, ...]``."""
    out = []
    for path, tensors, transposed in _walk(module, ""):
        stacked = isinstance(tensors, tuple)
        out.append(Leaf(path, tensors if stacked else (tensors,),
                        transposed, stacked))
    return out


@torch.no_grad()
def params_to_numpy(params: nn.Module,
                    values: Optional[Mapping[torch.Tensor, torch.Tensor]]
                    = None) -> Dict:
    """The port's weights as the JAX tree: nested dicts of numpy arrays,
    dense kernels ``[in, out]``, layers stacked ``[L, ...]``, the keys of
    the JAX ``Params``. ``values`` maps a weight to the tensor to write in
    its place (its gradient, say); weights it does not hold are written
    themselves. ``params_from_numpy`` of the result gives ``params`` back
    bit for bit. A model stored sharded on a mesh (its ``placement``) is
    written as whole leaves, over the data and the model axis: every rank
    of the mesh must call this."""
    placement = getattr(params, "placement", None)
    values = {} if values is None else values
    tree: Dict = {}
    if placement is not None and not placement.is_full:
        # the whole tensors are freed again after: copy, never view them
        with placement.gathered():
            for leaf in leaves(params):
                for t in leaf.tensors:
                    values.setdefault(t, t.detach().clone())
            return params_to_numpy(params, values)
    tp = placement is not None and placement.tp.size > 1
    for leaf in leaves(params):
        arrays = []
        for t in leaf.tensors:
            x = values.get(t, t)
            # over a model axis: the whole from every rank's part
            t = (placement.whole(t, x) if tp else x).detach().cpu()
            if t.dtype == torch.bfloat16:
                t = t.float()
            arrays.append(t.t() if leaf.transposed else t)
        arr = (torch.stack(arrays) if leaf.stacked else arrays[0]).numpy()
        node = tree
        *keys, last = leaf.path.split("/")
        for key in keys:
            node = node.setdefault(key, {})
        node[last] = np.ascontiguousarray(arr)
    return tree


def adapter_to_numpy(adapter: Adapter,
                     values: Optional[Mapping[torch.Tensor, torch.Tensor]]
                     = None) -> Dict:
    """The inverse of ``adapter_from_numpy``: the adapter (or, through
    ``values``, its gradients or any tensors keyed by its weights) as the
    JAX adapter tree, ``layers`` stacked ``[L, ...]``, dense kernels
    ``[in, out]``. ``adapter_from_numpy`` of the result gives the adapter
    back bit for bit."""
    return params_to_numpy(adapter, values)
