"""A DeTikZify v1 model in plain PyTorch: float32 products, TF32 off.

It follows the published v1 description: a SigLIP so400m tower (patch
embedding, learned positions, pre-norm blocks with GELU-tanh MLPs) read
at block ``feature_layer`` through the final layer norm, three patches
concatenated per image token and projected by a biased linear layer into
a LLaMA decoder (RMSNorm, rotate-half RoPE, causal multi-head attention,
SiLU-gated MLP, an untied head).

Weights come unit by unit from ``h100bench.weights.draw`` and are rounded
to ``precision`` (``quant.round_weight``) where the configuration
quantizes them: every dense projection of the tower and the decoder's
projections and head, not the patch embedding, the connector or the
token embedding. Activations are held in the type the configuration
states (``activations``): with ``bf16`` each operation computes in
float32 from bfloat16 inputs and rounds its output to bfloat16 (every
product, norm, rotation, attention output, activation function, gate
and residual sum), the head's logits excepted, which stay float32.
Nothing here is batched across requests or cached: each sequence runs
whole, layer by layer, so only one unit's weights are held at a time.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from .. import weights as yard
from .quant import LEVELS, round_weight

QUANTIZED = ("attn.q.", "attn.k.", "attn.v.", "attn.o.", "mlp.fc1.",
             "mlp.fc2.", "mlp.gate.", "mlp.up.", "mlp.down.", "lm_head.")


@contextlib.contextmanager
def fp32_exact():
    """TF32 off for the duration (it rounds float32 products to 10 bits)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def _to_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _exact(x: torch.Tensor) -> torch.Tensor:
    return x


class Weights:
    """The model's weights for one seed and one precision, drawn unit by
    unit when asked for. ``precision`` names the weights' rounding
    (``quant.round_weight``); the configuration's ``activations`` the
    rounding of every operation's output (``rnd``)."""

    def __init__(self, cfg: dict, seed: int, precision: str, device):
        self.cfg, self.seed = cfg, seed
        self.precision = precision
        self.device = device
        acts = cfg.get("activations", "float32")
        if acts not in ("bf16", "float32"):
            raise ValueError(f"unknown activations {acts!r}")
        self.rnd = _to_bf16 if acts == "bf16" else _exact

    def unit(self, name: str) -> Dict[str, torch.Tensor]:
        raw = yard.draw(self.cfg, self.seed, name, self.device)
        out = {}
        for key, w in raw.items():
            if w.dim() == 2 and any(q in key for q in QUANTIZED):
                out[key] = round_weight(w, self.precision)
            else:
                out[key] = w.float()
            del w
        out["rnd"] = self.rnd
        out["int_weights"] = self.precision in LEVELS
        return out


def _linear(w: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    """A product, its output rounded; an integer weight's bias is added
    to the rounded product and rounded again, as weight-only integer
    products add it after their own output."""
    r, bias = w["rnd"], w.get(f"{name}.bias")
    if bias is not None and w["int_weights"] and any(
            q in name + "." for q in QUANTIZED):
        return r(r(F.linear(x, w[f"{name}.weight"])) + bias)
    return r(F.linear(x, w[f"{name}.weight"], bias))


def _layer_norm(w: dict, name: str, x: torch.Tensor, eps: float):
    return w["rnd"](F.layer_norm(x, x.shape[-1:], w[f"{name}.weight"],
                                 w[f"{name}.bias"], eps))


def _rms_norm(w: dict, name: str, x: torch.Tensor, eps: float):
    y = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)
    return w["rnd"](y * w[name])


def _attend(q, k, v, causal: bool) -> torch.Tensor:
    """q [H, S, d], k/v [H, T, d] -> [H, S, d]; causal masks keys after
    each query's own position (queries are the last S of T)."""
    scores = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
    if causal:
        s, t = scores.shape[-2:]
        mask = torch.ones(s, t, dtype=torch.bool, device=q.device).tril(t - s)
        scores = scores.masked_fill(~mask, float("-inf"))
    return torch.softmax(scores, dim=-1) @ v


def _vision_block(w: dict, p: str, x: torch.Tensor, heads: int,
                  eps: float) -> torch.Tensor:
    """A pre-norm encoder block on x [N, D]."""
    r = w["rnd"]
    d = x.shape[-1]
    hd = d // heads
    h = _layer_norm(w, f"{p}.ln1", x, eps)
    q = _linear(w, f"{p}.attn.q", h).view(-1, heads, hd).transpose(0, 1)
    k = _linear(w, f"{p}.attn.k", h).view(-1, heads, hd).transpose(0, 1)
    v = _linear(w, f"{p}.attn.v", h).view(-1, heads, hd).transpose(0, 1)
    att = r(_attend(q, k, v, causal=False)).transpose(0, 1).reshape(-1, d)
    x = r(x + _linear(w, f"{p}.attn.o", att))
    h = _layer_norm(w, f"{p}.ln2", x, eps)
    h = _linear(w, f"{p}.mlp.fc2", r(F.gelu(_linear(w, f"{p}.mlp.fc1", h),
                                             approximate="tanh")))
    return r(x + h)


def _patches(pix: torch.Tensor, patch: int) -> torch.Tensor:
    """[H, W, C] -> [(H/p)(W/p), C*p*p], rows and columns past the last
    whole patch dropped, each patch flattened channel-major (C, ph, pw),
    the layout of a Conv2d weight [D, C, ph, pw]."""
    h, w_, c = pix.shape
    gh, gw = h // patch, w_ // patch
    x = pix[:gh * patch, :gw * patch].reshape(gh, patch, gw, patch, c)
    return x.permute(0, 2, 4, 1, 3).reshape(gh * gw, c * patch * patch)


def vision(weights: Weights, images: Sequence[torch.Tensor]
           ) -> List[torch.Tensor]:
    """Normalised images [H, W, 3] -> per image the prompt's image tokens
    [image_seq_len, D_text]: block ``feature_layer`` through the final
    norm, then the connector."""
    cfg = weights.cfg
    r = weights.rnd
    v = cfg["vision"]
    eps, heads = v["layer_norm_eps"], v["num_attention_heads"]
    n_blocks = cfg["feature_layer"] % v["num_hidden_layers"] + 1
    w = weights.unit("vision.embed")
    xs = [r(_linear(w, "vision.patch",
                    _patches(r(img.float()), v["patch_size"]))
            + w["vision.position"]) for img in images]
    for i in range(n_blocks):
        w = weights.unit(f"vision.layers.{i}")
        xs = [_vision_block(w, f"vision.layers.{i}", x, heads, eps)
              for x in xs]
    w = weights.unit("vision.post")
    xs = [_layer_norm(w, "vision.post_ln", x, eps) for x in xs]
    cf = cfg["concat_factor"]
    seq = (v["image_size"] // v["patch_size"]) ** 2 // cf
    w = weights.unit("connector")
    return [_linear(w, "connector",
                    x[-seq * cf:].reshape(seq, cf * x.shape[-1]))
            for x in xs]


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Rotate-half RoPE on x [H, S, d] at integer positions [S]."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, device=x.device,
                                       dtype=torch.float32) / d)
    ang = positions.float()[:, None] * inv[None]
    ang = torch.cat([ang, ang], dim=-1)
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return x * torch.cos(ang) + torch.cat([-x2, x1], dim=-1) * torch.sin(ang)


def decoder_logits(weights: Weights, token_ids: Sequence[Sequence[int]],
                   image_tokens: Sequence[torch.Tensor],
                   from_pos: Sequence[int]) -> List[torch.Tensor]:
    """Logits of each sequence at positions ``from_pos[i]`` - 1 onwards
    (the positions that predict tokens ``from_pos[i]``...), [n, V]
    float32. The k-th ``<image>`` token of a sequence takes row k of its
    image tokens."""
    cfg = weights.cfg
    dev = weights.device
    heads, kv_heads = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    d = cfg["hidden_size"]
    hd = d // heads
    eps = cfg["rms_norm_eps"]
    r = weights.rnd
    ids = [torch.as_tensor(list(t), dtype=torch.long, device=dev)
           for t in token_ids]
    emb = weights.unit("text.embed")["text.embed"]
    xs = []
    for t, img in zip(ids, image_tokens):
        x = emb[t].clone()
        is_img = t == cfg["image_token_id"]
        k = (is_img.long().cumsum(0) - 1).clamp(0, img.shape[0] - 1)
        x[is_img] = r(img.float())[k[is_img]]
        xs.append(x)
    del emb
    for i in range(cfg["num_hidden_layers"]):
        p = f"text.layers.{i}"
        w = weights.unit(p)
        for j, x in enumerate(xs):
            pos = torch.arange(x.shape[0], device=dev)
            h = _rms_norm(w, f"{p}.input_ln.weight", x, eps)
            q = _linear(w, f"{p}.attn.q", h).view(-1, heads, hd).transpose(0, 1)
            k = _linear(w, f"{p}.attn.k", h).view(-1, kv_heads, hd).transpose(0, 1)
            v = _linear(w, f"{p}.attn.v", h).view(-1, kv_heads, hd).transpose(0, 1)
            q = r(_rope(q, pos, cfg["rope_theta"]))
            k = r(_rope(k, pos, cfg["rope_theta"]))
            if kv_heads != heads:
                k = k.repeat_interleave(heads // kv_heads, dim=0)
                v = v.repeat_interleave(heads // kv_heads, dim=0)
            att = r(_attend(q, k, v, causal=True)).transpose(0, 1).reshape(-1, d)
            x = r(x + _linear(w, f"{p}.attn.o", att))
            h = _rms_norm(w, f"{p}.post_ln.weight", x, eps)
            h = r(r(F.silu(_linear(w, f"{p}.mlp.gate", h)))
                  * _linear(w, f"{p}.mlp.up", h))
            xs[j] = r(x + _linear(w, f"{p}.mlp.down", h))
        del w
    w = weights.unit("text.head")
    return [F.linear(_rms_norm(w, "text.norm.weight", x[start - 1:], eps),
                     w["text.lm_head.weight"])
            for x, start in zip(xs, from_pos)]
