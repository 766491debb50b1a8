"""Seeded random weights of a DeTikZify v1 model, the yardstick's own.

The weights are made in units (the vision embeddings, each vision layer,
the final norm and attention-pooling head, the connector, the token
embedding, each decoder layer, the decoder's head). Each unit is drawn
from its own ``torch.Generator``, seeded from ``--seed`` and the unit's
index, in one ``randn`` call on the device, then scaled tensor by tensor
and cast to bfloat16, the type the weights are served in. So the program
and the plain reference draw the same numbers unit by unit, and the
reference can run layer by layer without holding the model.

Scales: dense weights N(0, 1/fan_in); token, position and probe
embeddings and every bias N(0, 0.02^2); norm scales 1 + N(0, 0.02^2).
Biases and norms are drawn rather than left at 0 and 1 so that a path
that drops one of them reads wrong.

Names are the yardstick's (``vision.layers.3.attn.q.weight``); ``port.py``
maps them onto the program's modules. Imports nothing of the program.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

DENSE, SMALL, NORM = "dense", "small", "norm"

Spec = Tuple[str, Tuple[int, ...], str, int]   # name, shape, kind, fan_in


def _linear(name: str, out: int, inp: int, bias: bool) -> List[Spec]:
    specs = [(f"{name}.weight", (out, inp), DENSE, inp)]
    if bias:
        specs.append((f"{name}.bias", (out,), SMALL, 0))
    return specs


def _layer_norm(name: str, d: int) -> List[Spec]:
    return [(f"{name}.weight", (d,), NORM, 0), (f"{name}.bias", (d,), SMALL, 0)]


def _vision_block(prefix: str, d: int, inter: int) -> List[Spec]:
    specs: List[Spec] = []
    for proj in ("q", "k", "v", "o"):
        specs += _linear(f"{prefix}.attn.{proj}", d, d, True)
    specs += _linear(f"{prefix}.mlp.fc1", inter, d, True)
    specs += _linear(f"{prefix}.mlp.fc2", d, inter, True)
    return specs


def units(cfg: dict) -> List[Tuple[str, List[Spec]]]:
    """The model's units in drawing order: (unit name, tensor specs)."""
    v, t = cfg["vision"], cfg
    dv, iv = v["hidden_size"], v["intermediate_size"]
    dt, it = t["hidden_size"], t["intermediate_size"]
    hd = dt // t["num_attention_heads"]
    nq, nkv = t["num_attention_heads"] * hd, t["num_key_value_heads"] * hd
    patch_in = v["num_channels"] * v["patch_size"] ** 2
    n_patches = (v["image_size"] // v["patch_size"]) ** 2
    out = [("vision.embed",
            _linear("vision.patch", dv, patch_in, True)
            + [("vision.position", (n_patches, dv), SMALL, 0)])]
    for i in range(v["num_hidden_layers"]):
        p = f"vision.layers.{i}"
        out.append((p, _layer_norm(f"{p}.ln1", dv) + _layer_norm(f"{p}.ln2", dv)
                    + _vision_block(p, dv, iv)))
    out.append(("vision.post",
                _layer_norm("vision.post_ln", dv)
                + [("vision.head.probe", (1, 1, dv), SMALL, 0)]
                + _layer_norm("vision.head.ln", dv)
                + _vision_block("vision.head", dv, iv)))
    out.append(("connector",
                _linear("connector", dt, dv * cfg["concat_factor"],
                        cfg["projector_bias"])))
    out.append(("text.embed", [("text.embed", (t["vocab_size"], dt), SMALL, 0)]))
    bias = t.get("attention_bias", False)
    for i in range(t["num_hidden_layers"]):
        p = f"text.layers.{i}"
        specs = [(f"{p}.input_ln.weight", (dt,), NORM, 0),
                 (f"{p}.post_ln.weight", (dt,), NORM, 0)]
        specs += _linear(f"{p}.attn.q", nq, dt, bias)
        specs += _linear(f"{p}.attn.k", nkv, dt, bias)
        specs += _linear(f"{p}.attn.v", nkv, dt, bias)
        specs += _linear(f"{p}.attn.o", dt, nq, False)
        specs += _linear(f"{p}.mlp.gate", it, dt, False)
        specs += _linear(f"{p}.mlp.up", it, dt, False)
        specs += _linear(f"{p}.mlp.down", dt, it, False)
        out.append((p, specs))
    out.append(("text.head", [("text.norm.weight", (dt,), NORM, 0)]
                + _linear("text.lm_head", t["vocab_size"], dt, False)))
    return out


def unit_seed(seed: int, index: int) -> int:
    """The generator seed of unit ``index``: any whole ``seed`` (negative
    or above 64 bits too) maps into the generator's 64-bit range."""
    return (int(seed) * 1_000_003 + index + 1) % (1 << 63)


@torch.no_grad()
def draw(cfg: dict, seed: int, unit: str, device,
         dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """One unit's tensors, drawn on ``device`` in ``dtype``."""
    table = units(cfg)
    index = [name for name, _ in table].index(unit)
    specs = table[index][1]
    total = sum(_numel(shape) for _, shape, _, _ in specs)
    gen = torch.Generator(device=device).manual_seed(unit_seed(seed, index))
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    out, off = {}, 0
    for name, shape, kind, fan_in in specs:
        n = _numel(shape)
        z = flat[off:off + n].view(shape)
        off += n
        if kind == DENSE:
            w = z * fan_in ** -0.5
        elif kind == SMALL:
            w = z * 0.02
        else:
            w = 1.0 + 0.02 * z
        out[name] = w.to(dtype)
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def parameter_count(cfg: dict) -> int:
    return sum(_numel(shape) for _, specs in units(cfg)
               for _, shape, _, _ in specs)
