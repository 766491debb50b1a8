"""HF checkpoint -> the port's ``Params`` (counterpart of
``detikzify_tpu/models/import_hf.py``).

Maps ``nllg/detikzify-v2*`` (and compatible) checkpoints, and the v1
family's LLaMA checkpoint with its timm SigLIP tower, onto ``Params``. The
checkpoint's ``[out, in]`` is ``nn.Linear``'s own layout, so a tensor goes
into its module as it is: no transpose, no stacking, and no copy where the
file's dtype is the one asked for (the parameters then view the file's
copy-on-write mapping; ``load.load_weights`` moves them to the card). The
modules are built on ``meta`` first, so nothing is allocated twice. Key
names follow the reference's module paths, e.g.
``model.vision_model.encoder.layers.3.self_attn.q_proj.weight``.

``import_adapter`` fills the TikZero adapter from the reference's bare
keys (``layers.N.cross_attn.q_proj.weight``, ``connector.*``,
``dummy_input`` ``[C, H, W]``) or from the ``adapter.`` subtree of a
composite checkpoint. ``import_siglip_text`` (ClipScore's text tower) waits
for its slice (ROADMAP queue 1, eval suite).
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, Mapping

import torch
from torch import nn

from ..config import AdapterConfig, DetikzifyConfig, TextConfig, VisionConfig
from . import siglip
from .adapter import Adapter
from .detikzify import Params
from .llama import Llama
from .safetensors_io import load_file


def load_state_dict_from_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one ``*.safetensors`` file, or of every shard in a
    directory (each file's header is read, so no index is needed), as CPU
    tensors viewing the files (``safetensors_io.load_file``)."""
    files = [path] if path.endswith(".safetensors") else \
        sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if not files:
        raise FileNotFoundError(f"no safetensors found at {path}")
    state: Dict[str, torch.Tensor] = {}
    for f in files:
        state.update(load_file(f))
    return state


class _Src:
    """State-dict view with prefix stripping and access tracking."""

    def __init__(self, state: Mapping[str, torch.Tensor]):
        self.state = dict(state)
        self.used: set = set()

    def __call__(self, key: str) -> torch.Tensor:
        for candidate in (key, "model." + key):
            if candidate in self.state:
                self.used.add(candidate)
                return torch.as_tensor(self.state[candidate])
        raise KeyError(key)

    def has(self, key: str) -> bool:
        return key in self.state or ("model." + key) in self.state

    def unused(self):
        return sorted(set(self.state) - self.used)


def _put(module: nn.Module, name: str, value: torch.Tensor, dtype) -> None:
    """``module.name`` becomes ``value`` in ``dtype`` (the same tensor when
    it already is), after a check of its shape."""
    old = getattr(module, name)
    if old is not None and tuple(old.shape) != tuple(value.shape):
        raise ValueError(f"{type(module).__name__}.{name}: checkpoint shape "
                         f"{tuple(value.shape)}, model {tuple(old.shape)}")
    setattr(module, name, nn.Parameter(value.to(dtype).contiguous(),
                                       requires_grad=False))


def _linear(lin: nn.Linear, weight: torch.Tensor, bias, dtype) -> None:
    """A dense layer from ``[out, in]`` weights; it has a bias exactly when
    the checkpoint has one, as the JAX tree does."""
    _put(lin, "weight", weight, dtype)
    if bias is None:
        lin.bias = None
    else:
        lin.bias = nn.Parameter(bias.to(dtype).contiguous(),
                                requires_grad=False)


def _lin(src: _Src, name: str, lin: nn.Linear, dtype) -> None:
    _linear(lin, src(f"{name}.weight"),
            src(f"{name}.bias") if src.has(f"{name}.bias") else None, dtype)


def _ln(src: _Src, name: str, norm: nn.Module, dtype) -> None:
    _put(norm, "scale", src(f"{name}.weight"), dtype)
    _put(norm, "bias", src(f"{name}.bias"), dtype)


def _rms(src: _Src, name: str, norm: nn.Module, dtype) -> None:
    _put(norm, "scale", src(f"{name}.weight"), dtype)


def _mlp(src: _Src, name: str, mlp: nn.Module, dtype) -> None:
    _lin(src, f"{name}.fc1", mlp.fc1, dtype)
    _lin(src, f"{name}.fc2", mlp.fc2, dtype)


def import_vision(src: _Src, vision: siglip.SiglipVision, cfg: VisionConfig,
                  dtype=torch.bfloat16, prefix: str = "vision_model") -> None:
    """Fill a SigLIP tower from HF names, in place. The conv patch weight
    ``[D, C, p, p]`` flattens to the (C, ph, pw) order of ``patchify``;
    torch ``nn.MultiheadAttention`` packs the MAP head's q/k/v into one
    ``in_proj``. A checkpoint without a head leaves ``vision.head`` None
    (mean pooling)."""
    d = cfg.hidden_size
    emb = vision.embeddings
    _linear(emb.patch,
            src(f"{prefix}.embeddings.patch_embedding.weight").reshape(d, -1),
            src(f"{prefix}.embeddings.patch_embedding.bias"), dtype)
    _put(emb, "position",
         src(f"{prefix}.embeddings.position_embedding.weight"), dtype)
    for i, lp in enumerate(vision.layers):
        base = f"{prefix}.encoder.layers.{i}"
        _ln(src, f"{base}.layer_norm1", lp.ln1, dtype)
        for ours, theirs in (("q", "q_proj"), ("k", "k_proj"),
                             ("v", "v_proj"), ("o", "out_proj")):
            _lin(src, f"{base}.self_attn.{theirs}", getattr(lp.attn, ours),
                 dtype)
        _ln(src, f"{base}.layer_norm2", lp.ln2, dtype)
        _mlp(src, f"{base}.mlp", lp.mlp, dtype)
    _ln(src, f"{prefix}.post_layernorm", vision.post_ln, dtype)

    if not src.has(f"{prefix}.head.probe"):
        vision.head = None
        return
    head = vision.head
    _put(head, "probe", src(f"{prefix}.head.probe"), dtype)
    ws = src(f"{prefix}.head.attention.in_proj_weight").chunk(3, dim=0)
    bs = src(f"{prefix}.head.attention.in_proj_bias").chunk(3, dim=0)
    for name, w, b in zip("qkv", ws, bs):
        _linear(getattr(head.attn, name), w, b, dtype)
    _lin(src, f"{prefix}.head.attention.out_proj", head.attn.o, dtype)
    _ln(src, f"{prefix}.head.layernorm", head.ln, dtype)
    _mlp(src, f"{prefix}.head.mlp", head.mlp, dtype)


def import_timm_vision(state: Mapping[str, torch.Tensor],
                       vision: siglip.SiglipVision, cfg: VisionConfig,
                       dtype=torch.bfloat16, prefix: str = "") -> None:
    """Fill a SigLIP tower from a timm ViT, in place (the v1 models' tower;
    reference ``model/v1/modeling_detikzify.py:49-73``). timm names blocks
    ``blocks.{i}.*`` and packs q/k/v into ``attn.qkv``, and the MAP head's
    k/v into ``attn_pool.kv``."""
    src = _Src(state)
    p = prefix
    d = cfg.hidden_size
    emb = vision.embeddings
    _linear(emb.patch, src(f"{p}patch_embed.proj.weight").reshape(d, -1),
            src(f"{p}patch_embed.proj.bias"), dtype)
    pos = src(f"{p}pos_embed")
    _put(emb, "position", pos[0] if pos.dim() == 3 else pos, dtype)
    for i, lp in enumerate(vision.layers):
        base = f"{p}blocks.{i}"
        _ln(src, f"{base}.norm1", lp.ln1, dtype)
        ws = src(f"{base}.attn.qkv.weight").chunk(3, dim=0)
        bs = src(f"{base}.attn.qkv.bias").chunk(3, dim=0)
        for name, w, b in zip("qkv", ws, bs):
            _linear(getattr(lp.attn, name), w, b, dtype)
        _lin(src, f"{base}.attn.proj", lp.attn.o, dtype)
        _ln(src, f"{base}.norm2", lp.ln2, dtype)
        _mlp(src, f"{base}.mlp", lp.mlp, dtype)
    _ln(src, f"{p}norm", vision.post_ln, dtype)

    if not src.has(f"{p}attn_pool.latent"):
        vision.head = None
        return
    head = vision.head
    _put(head, "probe", src(f"{p}attn_pool.latent"), dtype)
    _lin(src, f"{p}attn_pool.q", head.attn.q, dtype)
    ws = src(f"{p}attn_pool.kv.weight").chunk(2, dim=0)
    bs = src(f"{p}attn_pool.kv.bias").chunk(2, dim=0)
    for name, w, b in zip("kv", ws, bs):
        _linear(getattr(head.attn, name), w, b, dtype)
    _lin(src, f"{p}attn_pool.proj", head.attn.o, dtype)
    _ln(src, f"{p}attn_pool.norm", head.ln, dtype)
    _mlp(src, f"{p}attn_pool.mlp", head.mlp, dtype)


def import_text(src: _Src, text: Llama, cfg: TextConfig,
                dtype=torch.bfloat16, prefix: str = "text_model") -> None:
    """Fill a LLaMA decoder from HF names, in place. A checkpoint's
    ``lm_head`` is taken even where the config ties the embeddings; an
    absent one with untied embeddings is ``embed_tokens``."""
    _put(text, "embed_tokens", src(f"{prefix}.embed_tokens.weight"), dtype)
    for i, lp in enumerate(text.layers):
        base = f"{prefix}.layers.{i}"
        _rms(src, f"{base}.input_layernorm", lp.input_ln, dtype)
        for ours, theirs in (("q", "q_proj"), ("k", "k_proj"),
                             ("v", "v_proj"), ("o", "o_proj")):
            _lin(src, f"{base}.self_attn.{theirs}", getattr(lp.attn, ours),
                 dtype)
        _rms(src, f"{base}.post_attention_layernorm", lp.post_ln, dtype)
        for name in ("gate", "up", "down"):
            _lin(src, f"{base}.mlp.{name}_proj", getattr(lp.mlp, name),
                 dtype)
    _rms(src, f"{prefix}.norm", text.norm, dtype)
    if src.has("lm_head.weight") or not cfg.tie_word_embeddings:
        head = src("lm_head.weight") if src.has("lm_head.weight") \
            else text.embed_tokens
        text.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size,
                                 bias=False, device="meta", dtype=dtype)
        _put(text.lm_head, "weight", head, dtype)


def _check_filled(params: Params) -> Params:
    missing = [n for n, t in (*params.named_parameters(),
                              *params.named_buffers()) if t.is_meta]
    if missing:
        raise ValueError(f"checkpoint lacks {len(missing)} weights: "
                         f"{missing[:10]}")
    return params


def import_detikzify(state: Mapping[str, torch.Tensor], cfg: DetikzifyConfig,
                     dtype=torch.bfloat16, strict: bool = True) -> Params:
    """A v2 checkpoint's state dict -> ``Params`` on the host. ``strict``
    refuses keys that map to nothing (an ``adapter.*`` subtree excepted)."""
    src = _Src(state)
    # real reference checkpoints nest the tower one level deeper: the
    # DetikzifyModel holds a SiglipVisionModel WRAPPER whose own submodule
    # is vision_model (modeling_detikzify.py:125), so keys read
    # model.vision_model.vision_model.*
    vp = ("vision_model.vision_model"
          if src.has("vision_model.vision_model.embeddings."
                     "patch_embedding.weight") else "vision_model")
    params = Params(cfg, device="meta", dtype=dtype)
    import_vision(src, params.vision, cfg.vision, dtype, prefix=vp)
    _lin(src, "connector.modality_projection.proj", params.connector.proj,
         dtype)
    import_text(src, params.text, cfg.text, dtype)
    if strict:
        leftovers = [k for k in src.unused() if not k.startswith("adapter")]
        if leftovers:
            raise ValueError(f"unmapped checkpoint keys: {leftovers[:10]}"
                             f" (+{max(0, len(leftovers) - 10)} more)")
    return _check_filled(params)


def import_v1(state: Mapping[str, torch.Tensor],
              vision_state: Mapping[str, torch.Tensor],
              cfg: DetikzifyConfig, dtype=torch.bfloat16) -> Params:
    """A v1 checkpoint -> ``Params`` on the host: LLaMA decoder and
    ``mm_projector`` weights in ``state``; the timm vision tower arrives
    separately (the reference downloads it at load time,
    ``model/v1/__init__.py:24-56``)."""
    text_state = {}
    for k, v in dict(state).items():
        if k.startswith("model.mm_projector") or k.startswith("mm_projector"):
            continue
        if k.startswith("model."):
            text_state["text_model." + k[len("model."):]] = v
        else:
            text_state[k] = v
    params = Params(cfg, device="meta", dtype=dtype)
    import_text(_Src(text_state), params.text, cfg.text, dtype)
    proj_w = next(v for k, v in state.items()
                  if "mm_projector" in k and k.endswith("weight"))
    proj_b = next((v for k, v in state.items()
                   if "mm_projector" in k and k.endswith("bias")), None)
    _linear(params.connector.proj, torch.as_tensor(proj_w),
            None if proj_b is None else torch.as_tensor(proj_b), dtype)
    import_timm_vision(vision_state, params.vision, cfg.vision, dtype)
    return _check_filled(params)


def import_adapter(state: Mapping[str, torch.Tensor], vcfg: VisionConfig,
                   acfg: AdapterConfig, dtype=torch.bfloat16,
                   prefix: str = "adapter") -> Adapter:
    """TikZero adapter weights -> ``Adapter`` on the host, one block per
    vision layer. A layer the checkpoint lacks (the reference stores
    ``None`` for inactive layers, ``modeling_adapter.py:365-371``) gets a
    zero block, which the encoder skips by the
    ``cross_attn_every_n_layers`` rule."""
    src = _Src(state)
    # CrossAttentionAdapter.save_pretrained writes BARE keys (layers.N...,
    # connector.*, dummy_input); a composite checkpoint nests them under
    # the adapter. prefix
    if src.has("dummy_input"):
        prefix = ""
    if prefix:
        prefix = prefix.rstrip(".") + "."
    adapter = Adapter(vcfg, acfg, device="meta", dtype=dtype)
    for idx, blk in enumerate(adapter.layers):
        base = f"{prefix}layers.{idx}"
        if not src.has(f"{base}.layer_norm1.weight"):
            blk.to_empty(device="cpu")
            for p in blk.parameters():
                p.zero_()
            continue
        _ln(src, f"{base}.layer_norm1", blk.ln1, dtype)
        for ours, theirs in (("q", "q_proj"), ("k", "k_proj"),
                             ("v", "v_proj"), ("o", "out_proj")):
            _lin(src, f"{base}.cross_attn.{theirs}", getattr(blk.attn, ours),
                 dtype)
        _ln(src, f"{base}.cross_attn.q_norm", blk.attn.q_norm, dtype)
        _ln(src, f"{base}.cross_attn.k_norm", blk.attn.k_norm, dtype)
        _ln(src, f"{base}.layer_norm2", blk.ln2, dtype)
        _mlp(src, f"{base}.mlp", blk.mlp, dtype)
        _put(blk, "attn_gate", src(f"{base}.cross_attn_attn_gate"), dtype)
        _put(blk, "mlp_gate", src(f"{base}.cross_attn_mlp_gate"), dtype)
    _lin(src, f"{prefix}connector", adapter.connector, dtype)
    # [C, H, W] -> [H, W, C]
    _put(adapter, "dummy_input",
         src(f"{prefix}dummy_input").permute(1, 2, 0), dtype)
    missing = [n for n, t in adapter.named_parameters() if t.is_meta]
    if missing:
        raise ValueError(f"adapter checkpoint lacks {len(missing)} weights: "
                         f"{missing[:10]}")
    return adapter


def config_from_hf_json(path_or_dict) -> DetikzifyConfig:
    """Build a DetikzifyConfig from an HF ``config.json``."""
    if isinstance(path_or_dict, str):
        with open(path_or_dict) as f:
            hf = json.load(f)
    else:
        hf = dict(path_or_dict)
    if "patch_token_id" in hf or "DetikzifyForCausalLM" in \
            hf.get("architectures", []):
        return _v1_config_from_hf(hf)
    v = hf.get("vision_config", {})
    t = hf.get("text_config", {})
    vision = VisionConfig(
        hidden_size=v.get("hidden_size", 1152),
        intermediate_size=v.get("intermediate_size", 4304),
        num_hidden_layers=v.get("num_hidden_layers", 27),
        num_attention_heads=v.get("num_attention_heads", 16),
        image_size=v.get("image_size", 420),
        patch_size=v.get("patch_size", 14),
        hidden_act=v.get("hidden_act", "gelu_pytorch_tanh"),
        layer_norm_eps=v.get("layer_norm_eps", 1e-6),
    )
    text = TextConfig(
        vocab_size=t.get("vocab_size", 128256),
        hidden_size=t.get("hidden_size", 4096),
        intermediate_size=t.get("intermediate_size", 14336),
        num_hidden_layers=t.get("num_hidden_layers", 32),
        num_attention_heads=t.get("num_attention_heads", 32),
        num_key_value_heads=t.get("num_key_value_heads", 8),
        max_position_embeddings=t.get("max_position_embeddings", 131072),
        rms_norm_eps=t.get("rms_norm_eps", 1e-5),
        rope_theta=t.get("rope_theta", 500000.0),
        rope_scaling=t.get("rope_scaling"),
        tie_word_embeddings=hf.get("tie_word_embeddings",
                                   t.get("tie_word_embeddings", False)),
        hidden_act=t.get("hidden_act", "silu"),
        attention_bias=t.get("attention_bias", False),
    )
    return DetikzifyConfig(
        vision=vision, text=text,
        image_token_id=hf.get("image_token_id", 128005),
        bos_token_id=t.get("bos_token_id", hf.get("bos_token_id", 128000)),
        eos_token_id=t.get("eos_token_id", hf.get("eos_token_id", 128001)),
        pad_token_id=hf.get("pad_token_id", 128004),
        concat_factor=hf.get("concat_factor", 3),
        # None when the checkpoint does not declare one: SelfSim then falls
        # back to "emd" exactly like the reference (imagesim.py:64)
        pooling_mode=hf.get("pooling_mode"),
    )


# HF ``LlamaConfig``'s defaults, for fields a plain ``config.json`` omits
_LLAMA_DEFAULTS = dict(
    vocab_size=32000, hidden_size=4096, intermediate_size=11008,
    num_hidden_layers=32, num_attention_heads=32,
    max_position_embeddings=2048, rms_norm_eps=1e-6, rope_theta=10000.0,
    rope_scaling=None, tie_word_embeddings=False, hidden_act="silu",
    attention_bias=False)


def text_config_from_hf_json(path_or_dict) -> TextConfig:
    """A LLaMA decoder's ``TextConfig`` from an HF ``config.json``: its
    ``text_config`` where it has one (a composite checkpoint), else the
    flat fields of a plain LLaMA checkpoint such as
    ``meta-llama/Llama-3.2-1B``'s (``rope_scaling`` and tied embeddings
    included)."""
    if isinstance(path_or_dict, str):
        with open(path_or_dict) as f:
            hf = json.load(f)
    else:
        hf = dict(path_or_dict)
    if "text_config" in hf:
        return config_from_hf_json(hf).text
    # a field the file leaves out takes HF ``LlamaConfig``'s default
    kw = {f: hf.get(f, d) for f, d in _LLAMA_DEFAULTS.items()}
    # HF LLaMA: no num_key_value_heads means one KV head per query head
    kw["num_key_value_heads"] = hf.get("num_key_value_heads",
                                       kw["num_attention_heads"])
    return TextConfig(**kw)


def _v1_config_from_hf(hf: dict) -> DetikzifyConfig:
    """v1 legacy config: flat LLaMA fields + mm_* vision wiring
    (reference ``model/v1/configuration_detikzify.py:3-13``)."""
    text = TextConfig(
        vocab_size=hf.get("vocab_size", 32000),
        hidden_size=hf.get("hidden_size", 2048),
        intermediate_size=hf.get("intermediate_size", 5632),
        num_hidden_layers=hf.get("num_hidden_layers", 22),
        num_attention_heads=hf.get("num_attention_heads", 32),
        num_key_value_heads=hf.get("num_key_value_heads",
                                   hf.get("num_attention_heads", 32)),
        max_position_embeddings=hf.get("max_position_embeddings", 2048),
        rms_norm_eps=hf.get("rms_norm_eps", 1e-5),
        rope_theta=hf.get("rope_theta", 10000.0),
        hidden_act=hf.get("hidden_act", "silu"),
        tie_word_embeddings=hf.get("tie_word_embeddings", False),
    )
    # timm SigLIP so400m/384: hidden 1152, 27 layers, image 384, patch 14
    vision = VisionConfig(image_size=hf.get("vision_image_size", 384))
    return DetikzifyConfig(
        vision=vision, text=text,
        image_token_id=hf.get("patch_token_id",
                              hf.get("image_token_id", 32000)),
        bos_token_id=hf.get("bos_token_id", 1),
        eos_token_id=hf.get("eos_token_id", 2),
        pad_token_id=hf.get("pad_token_id", 0) or 0,
        concat_factor=hf.get("concat_patches", 3),
        feature_layer=hf.get("feature_layer"),
        projector_bias=True,
        # the reference v1 config's pooling_mode PROPERTY unconditionally
        # returns "cos" (v1/configuration_detikzify.py:12-13), shadowing
        # any value a config.json might carry -- pin it, don't read it
        pooling_mode="cos",
        is_v1=True,
    )
