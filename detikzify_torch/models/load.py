"""Model loading, saving and registry (counterpart of
``detikzify_tpu/models/load.py``; reference ``detikzify/model/__init__.py:
20-61``).

  * ``load(name_or_path)`` -- resolve a checkpoint directory (or a
    registered model name) and build ``(params, config, processor)``. It is
    two halves: ``load_params``, the weights, which needs neither
    ``transformers`` nor ``safetensors`` and so runs on the card's machine,
    and ``load_processor``, which adds the checkpoint's tokenizer through
    ``transformers``;
  * ``save_pretrained(...)`` -- export weights in the reference's tensor
    names, in the safetensors format written by ``safetensors_io``, so
    checkpoints round-trip between the port, the JAX package and the
    reference;
  * ``register(name, path)`` -- the local model registry (stands in for
    the HF Auto* registration; zero-egress environments resolve names to
    local paths).

``quantize=True`` follows the JAX rule: full precision never touches the
card. The weights are imported on the host, each projection is quantized
there and only its int8 form is placed on the card
(``ops.quant.quantize_params_host``), then the rest moves.

TikZero adapters: ``load_adapter`` attaches an adapter and its frozen
caption model, as ``load`` does for a checkpoint with an ``adapter/``
folder when ``adapter_embedding_model`` names the caption model. Its
weight half, ``load_adapter_params``, needs no ``transformers``.
``save_adapter`` writes the reference's bare adapter keys and
``save_embedding_model`` a plain LLaMA checkpoint (``model.*`` keys and a
flat ``config.json``, the layout of ``meta-llama/Llama-3.2-1B``).
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import AdapterConfig, DetikzifyConfig, TextConfig, VisionConfig
from ..ops.quant import quantize_params_host
from ..processing import DetikzifyProcessor, load_tokenizer
from . import import_hf
from .adapter import Adapter
from .detikzify import Params
from .llama import Llama
from .safetensors_io import save_file

# name -> local path or hub id (reference webui/strings.py model registry)
MODEL_REGISTRY: Dict[str, str] = {
    "detikzify-v2.5-8b": "nllg/detikzify-v2.5-8b",
    "detikzify-v2-8b": "nllg/detikzify-v2-8b",
    "detikzify-ds-1.3b": "nllg/detikzify-ds-1.3b",
    "detikzify-ds-7b": "nllg/detikzify-ds-7b",
    "detikzify-tl-1.1b": "nllg/detikzify-tl-1.1b",
    "detikzify-cl-7b": "nllg/detikzify-cl-7b",
}

def register(name: str, path: str) -> None:
    """Register a model name -> checkpoint path mapping."""
    MODEL_REGISTRY[name] = path


def _resolve(name_or_path: str) -> str:
    path = MODEL_REGISTRY.get(name_or_path, name_or_path)
    if os.path.isdir(path):
        return path
    # HF cache layout fallback (offline environments)
    cache = os.environ.get("HF_HOME", os.path.expanduser("~/.cache/huggingface"))
    hub_dir = os.path.join(cache, "hub",
                           "models--" + path.replace("/", "--"))
    if os.path.isdir(hub_dir):
        snaps = os.path.join(hub_dir, "snapshots")
        if os.path.isdir(snaps):
            entries = sorted(os.listdir(snaps))
            if entries:
                return os.path.join(snaps, entries[-1])
    raise FileNotFoundError(
        f"cannot resolve model {name_or_path!r}: not a local directory and "
        f"not in the local HF cache (this build runs zero-egress; download "
        f"checkpoints out-of-band or register() a local path)")


def load(
    model_name_or_path: str,
    *,
    dtype=torch.bfloat16,
    modality_projector: Optional[str] = None,
    adapter_embedding_model: Optional[str] = None,
    vision_tower: Optional[str] = None,   # v1: timm tower checkpoint path
    quantize: bool = False,
    device="cuda",
):
    """Load (params on ``device``, config, processor) from a checkpoint.

    v1 legacy checkpoints (LLaVA-style, reference ``model/v1/__init__.py:
    24-56``) are detected from their config and need ``vision_tower``
    pointing at the timm SigLIP checkpoint (the reference downloads it from
    the timm hub at load time). A checkpoint with an ``adapter/`` folder
    loaded with ``adapter_embedding_model`` (the caption model's
    checkpoint) gives ``(params, config, AdapterProcessor, AdapterBundle)``
    (``load_adapter``); without one the folder is ignored, as in JAX."""
    path = _resolve(model_name_or_path)
    params, cfg = load_params(path, dtype=dtype,
                              modality_projector=modality_projector,
                              vision_tower=vision_tower, quantize=quantize,
                              device=device)
    processor = load_processor(path, cfg, vision_tower=vision_tower)
    adapter_dir = os.path.join(path, "adapter")
    if os.path.isdir(adapter_dir) and adapter_embedding_model is not None:
        return load_adapter(params, cfg, processor, adapter_dir,
                            adapter_embedding_model, dtype=dtype,
                            device=device)
    return params, cfg, processor


def load_params(model_name_or_path: str, *, dtype=torch.bfloat16,
                modality_projector: Optional[str] = None,
                vision_tower: Optional[str] = None, quantize: bool = False,
                device="cuda") -> Tuple[Params, DetikzifyConfig]:
    """The weight half of ``load``: (params on ``device``, config)."""
    path = _resolve(model_name_or_path)
    cfg = import_hf.config_from_hf_json(os.path.join(path, "config.json"))
    return load_weights(path, cfg, dtype=dtype,
                        modality_projector=modality_projector,
                        vision_tower=vision_tower, quantize=quantize,
                        device=device), cfg


@torch.no_grad()
def load_weights(path: str, cfg: DetikzifyConfig, *, dtype=torch.bfloat16,
                 modality_projector: Optional[str] = None,
                 vision_tower: Optional[str] = None, quantize: bool = False,
                 device="cuda") -> Params:
    """The safetensors of checkpoint directory ``path`` as ``Params`` of
    ``cfg`` on ``device``. The weights are read through a mapping of the
    files, so each reaches the card in one host-to-device copy; with
    ``quantize`` each projection is quantized on the host first."""
    if cfg.is_v1 and vision_tower is None:
        raise ValueError(
            "v1 checkpoints need vision_tower= (path to the timm SigLIP "
            "so400m tower weights; zero-egress builds cannot fetch it)")
    state = import_hf.load_state_dict_from_safetensors(path)
    if cfg.is_v1:
        vstate = import_hf.load_state_dict_from_safetensors(
            _resolve(vision_tower))
        params = import_hf.import_v1(state, vstate, cfg, dtype=dtype)
    else:
        params = import_hf.import_detikzify(state, cfg, dtype=dtype)
        if modality_projector is not None:
            _overlay_projector(params, modality_projector, dtype)
    if quantize:
        quantize_params_host(params, device=device)
    return params.to(device)


def load_processor(path: str, cfg: DetikzifyConfig,
                   vision_tower: Optional[str] = None) -> DetikzifyProcessor:
    """The processor half of ``load``: the checkpoint's tokenizer (through
    ``transformers``), prompt layout and image statistics (a v1 model's
    from its tower)."""
    path = _resolve(path)
    tokenizer = load_tokenizer(path)
    if cfg.is_v1:
        mean, std = _image_stats(_resolve(vision_tower))
        return DetikzifyProcessor(tokenizer, cfg, image_mean=mean,
                                  image_std=std)
    mean, std = _image_stats(path)
    return DetikzifyProcessor(
        tokenizer, cfg, model_expects_text=_processor_expects_text(path),
        image_mean=mean, image_std=std)


def _processor_expects_text(path: str) -> bool:
    """TikZero+ checkpoints mark caption-conditioned prompts in their HF
    processor config (reference processing_detikzify.py:53,65)."""
    pc = os.path.join(path, "processor_config.json")
    if os.path.isfile(pc):
        with open(pc) as f:
            return bool(json.load(f).get("model_expects_text", False))
    return False


def _image_stats(path: str):
    """Checkpoint-local normalization stats from preprocessor_config.json
    (the reference's v1 loader derives them from the timm data config;
    SigLIP default 0.5/0.5 otherwise)."""
    pc = os.path.join(path, "preprocessor_config.json")
    if os.path.isfile(pc):
        with open(pc) as f:
            d = json.load(f)
        if "image_mean" in d or "image_std" in d:
            return (d.get("image_mean", 0.5), d.get("image_std", 0.5))
    return 0.5, 0.5


def _overlay_projector(params: Params, path: str, dtype) -> Params:
    """Overlay separately-trained modality-projector weights
    (reference model/__init__.py:47-56): an ``.npz`` holding the JAX
    ``proj/kernel`` ``[in, out]``, or safetensors holding ``[out, in]``.
    The projection keeps no bias, as in the JAX package."""
    if path.endswith(".npz"):
        with np.load(path) as data:
            weight = torch.from_numpy(np.ascontiguousarray(
                data["proj/kernel"].T))
    else:
        state = import_hf.load_state_dict_from_safetensors(path)
        key = next(k for k in state if "proj" in k and k.endswith("weight"))
        weight = state[key]
    proj = params.connector.proj
    proj.weight = nn.Parameter(weight.to(proj.weight.device, dtype),
                               requires_grad=False)
    proj.bias = None
    return params


@torch.no_grad()
def load_adapter_params(adapter_path: str, vcfg: VisionConfig,
                        embedding_model: str, *,
                        acfg: Optional[AdapterConfig] = None,
                        dtype=torch.bfloat16, device="cuda"
                        ) -> Tuple[Adapter, AdapterConfig, Llama, TextConfig]:
    """The weight half of ``load_adapter``: (adapter, its config, caption
    model, its config), both models on ``device``. Each is built on
    ``meta`` and filled with tensors viewing the mapped files; the caption
    model's ``model.*`` keys read as ``text_model.*`` (a tied model has no
    ``lm_head``). ``acfg`` defaults to ``AdapterConfig`` with the caption
    model's width."""
    embed_path = _resolve(embedding_model)
    embed_cfg = import_hf.text_config_from_hf_json(
        os.path.join(embed_path, "config.json"))
    acfg = acfg or AdapterConfig(embedding_hidden_size=embed_cfg.hidden_size)
    adapter = import_hf.import_adapter(
        import_hf.load_state_dict_from_safetensors(adapter_path), vcfg, acfg,
        dtype=dtype)
    state = import_hf.load_state_dict_from_safetensors(embed_path)
    state = {("text_model." + k[len("model."):] if k.startswith("model.")
              else k): v for k, v in state.items()}
    embed = Llama(embed_cfg, device="meta", dtype=dtype)
    import_hf.import_text(import_hf._Src(state), embed, embed_cfg, dtype)
    missing = [n for n, t in embed.named_parameters() if t.is_meta]
    if missing:
        raise ValueError(f"caption model lacks {len(missing)} weights: "
                         f"{missing[:10]}")
    embed.requires_grad_(False)
    return adapter.to(device), acfg, embed.to(device), embed_cfg


def load_adapter(params, cfg: DetikzifyConfig, processor, adapter_path: str,
                 embedding_model: str, *, dtype=torch.bfloat16,
                 max_caption_length: int = 512, device="cuda"):
    """Attach a TikZero adapter: returns (params, cfg with ``adapter`` set,
    ``AdapterProcessor``, ``AdapterBundle``). ``embedding_model`` is the
    frozen caption model's checkpoint (the reference uses
    meta-llama/Llama-3.2-1B); its tokenizer comes through
    ``transformers``."""
    from ..processing_adapter import AdapterProcessor
    from .embedding import AdapterBundle

    adapter, acfg, embed, embed_cfg = load_adapter_params(
        adapter_path, cfg.vision, embedding_model, acfg=cfg.adapter,
        dtype=dtype, device=device)
    tok = load_tokenizer(_resolve(embedding_model))
    bundle = AdapterBundle(adapter_params=adapter, adapter_cfg=acfg,
                           embed_params=embed, embed_cfg=embed_cfg,
                           tokenizer=tok, max_length=max_caption_length)
    aprocessor = AdapterProcessor(processor, tok,
                                  max_length=max_caption_length)
    return params, cfg.replace(adapter=acfg), aprocessor, bundle


def has_adapter(obj) -> bool:
    """Reference ``has_adapter`` (adapter/__init__.py:6-7)."""
    return getattr(obj, "adapter", None) is not None


# ---------------------------------------------------------------------------
# export: params -> reference-compatible safetensors
# ---------------------------------------------------------------------------

def _plain(lin: nn.Module, name: str) -> torch.Tensor:
    if not isinstance(lin, nn.Linear):
        raise ValueError(f"{name}: cannot export a {type(lin).__name__}; "
                         "save_pretrained takes unquantized weights, as the "
                         "JAX package's does")
    return lin.weight


def _export_vision(vision, out: dict, prefix: str, cfg) -> None:
    emb = vision.embeddings
    d, p, c = (cfg.hidden_size, cfg.patch_size, cfg.num_channels)
    # the port's [D, C*p*p] patch weight is the conv's [D, C, p, p]
    out[f"{prefix}.embeddings.patch_embedding.weight"] = \
        _plain(emb.patch, "patch").reshape(d, c, p, p)
    out[f"{prefix}.embeddings.patch_embedding.bias"] = emb.patch.bias
    out[f"{prefix}.embeddings.position_embedding.weight"] = emb.position

    for i, lp in enumerate(vision.layers):
        base = f"{prefix}.encoder.layers.{i}"
        out[f"{base}.layer_norm1.weight"] = lp.ln1.scale
        out[f"{base}.layer_norm1.bias"] = lp.ln1.bias
        for ours, theirs in (("q", "q_proj"), ("k", "k_proj"),
                             ("v", "v_proj"), ("o", "out_proj")):
            lin = getattr(lp.attn, ours)
            out[f"{base}.self_attn.{theirs}.weight"] = _plain(lin, base)
            out[f"{base}.self_attn.{theirs}.bias"] = lin.bias
        out[f"{base}.layer_norm2.weight"] = lp.ln2.scale
        out[f"{base}.layer_norm2.bias"] = lp.ln2.bias
        for fc in ("fc1", "fc2"):
            lin = getattr(lp.mlp, fc)
            out[f"{base}.mlp.{fc}.weight"] = _plain(lin, base)
            out[f"{base}.mlp.{fc}.bias"] = lin.bias

    out[f"{prefix}.post_layernorm.weight"] = vision.post_ln.scale
    out[f"{prefix}.post_layernorm.bias"] = vision.post_ln.bias

    head = vision.head
    if head is not None:
        out[f"{prefix}.head.probe"] = head.probe
        # torch nn.MultiheadAttention packs q/k/v into one in_proj
        out[f"{prefix}.head.attention.in_proj_weight"] = torch.cat(
            [_plain(getattr(head.attn, x), "head") for x in "qkv"])
        out[f"{prefix}.head.attention.in_proj_bias"] = torch.cat(
            [getattr(head.attn, x).bias for x in "qkv"])
        out[f"{prefix}.head.attention.out_proj.weight"] = \
            _plain(head.attn.o, "head")
        out[f"{prefix}.head.attention.out_proj.bias"] = head.attn.o.bias
        out[f"{prefix}.head.layernorm.weight"] = head.ln.scale
        out[f"{prefix}.head.layernorm.bias"] = head.ln.bias
        for fc in ("fc1", "fc2"):
            lin = getattr(head.mlp, fc)
            out[f"{prefix}.head.mlp.{fc}.weight"] = _plain(lin, "head")
            out[f"{prefix}.head.mlp.{fc}.bias"] = lin.bias


def _export_text(text, out: dict, prefix: str) -> None:
    out[f"{prefix}.embed_tokens.weight"] = text.embed_tokens
    for i, lp in enumerate(text.layers):
        base = f"{prefix}.layers.{i}"
        if hasattr(lp.attn, "qkv") or hasattr(lp.mlp, "gateup"):
            raise ValueError(f"{base}: cannot export fused projections; "
                             "save_pretrained takes the unfused layout, as "
                             "the JAX package's does")
        out[f"{base}.input_layernorm.weight"] = lp.input_ln.scale
        for ours, theirs in (("q", "q_proj"), ("k", "k_proj"),
                             ("v", "v_proj"), ("o", "o_proj")):
            out[f"{base}.self_attn.{theirs}.weight"] = \
                _plain(getattr(lp.attn, ours), base)
        out[f"{base}.post_attention_layernorm.weight"] = lp.post_ln.scale
        for name in ("gate", "up", "down"):
            out[f"{base}.mlp.{name}_proj.weight"] = \
                _plain(getattr(lp.mlp, name), base)
    out[f"{prefix}.norm.weight"] = text.norm.scale


def _export_state(params: Params, cfg: DetikzifyConfig
                 ) -> Dict[str, torch.Tensor]:
    """The reference's state dict of ``params``: views of the weights
    where they live (no copy but the MAP head's packed ``in_proj``)."""
    out: Dict[str, torch.Tensor] = {}
    # the reference model nests SiglipVisionModel under an extra
    # ``vision_model`` attribute (modeling_detikzify.py:125), so its
    # state-dict prefix is model.vision_model.vision_model
    _export_vision(params.vision, out, "model.vision_model.vision_model",
                   cfg.vision)
    out["model.connector.modality_projection.proj.weight"] = \
        _plain(params.connector.proj, "connector")
    _export_text(params.text, out, "model.text_model")
    if params.text.lm_head is not None:
        out["lm_head.weight"] = _plain(params.text.lm_head, "lm_head")
    return {k: v.detach() for k, v in out.items()}


def save_pretrained(path: str, params: Params, cfg: DetikzifyConfig,
                    processor: Optional[DetikzifyProcessor] = None) -> int:
    """Export to a reference-compatible checkpoint directory; returns the
    bytes of ``model.safetensors``."""
    state = _export_state(params, cfg)
    os.makedirs(path, exist_ok=True)
    nbytes = save_file(state, os.path.join(path, "model.safetensors"))

    hf_cfg = {
        "architectures": ["DetikzifyForConditionalGeneration"],
        "model_type": "detikzify",
        "image_token_id": cfg.image_token_id,
        "pad_token_id": cfg.pad_token_id,
        "concat_factor": cfg.concat_factor,
        # declared SelfSim mode must survive a save/load round trip --
        # config_from_hf_json reads it and ImageSim.from_detikzify falls
        # back to "emd" when absent (reference imagesim.py:64)
        **({"pooling_mode": cfg.pooling_mode}
           if cfg.pooling_mode is not None else {}),
        "vision_config": {
            "hidden_size": cfg.vision.hidden_size,
            "intermediate_size": cfg.vision.intermediate_size,
            "num_hidden_layers": cfg.vision.num_hidden_layers,
            "num_attention_heads": cfg.vision.num_attention_heads,
            "image_size": cfg.vision.image_size,
            "patch_size": cfg.vision.patch_size,
            "hidden_act": cfg.vision.hidden_act,
            "layer_norm_eps": cfg.vision.layer_norm_eps,
        },
        "text_config": {
            "vocab_size": cfg.text.vocab_size,
            "hidden_size": cfg.text.hidden_size,
            "intermediate_size": cfg.text.intermediate_size,
            "num_hidden_layers": cfg.text.num_hidden_layers,
            "num_attention_heads": cfg.text.num_attention_heads,
            "num_key_value_heads": cfg.text.num_key_value_heads,
            "max_position_embeddings": cfg.text.max_position_embeddings,
            "rms_norm_eps": cfg.text.rms_norm_eps,
            "rope_theta": cfg.text.rope_theta,
            "rope_scaling": cfg.text.rope_scaling,
            "bos_token_id": cfg.bos_token_id,
            "eos_token_id": cfg.eos_token_id,
            "hidden_act": cfg.text.hidden_act,
            "tie_word_embeddings": cfg.text.tie_word_embeddings,
        },
    }
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_cfg, f, indent=2)

    if processor is not None:
        # the processor artifacts the reference's AutoProcessor path needs
        # (reference model/__init__.py:44), so a full export round-trips
        # through the reference's own ``detikzify.model.load()``
        tok = getattr(processor, "tokenizer", None)
        image_token = None
        if tok is not None and hasattr(tok, "save_pretrained"):
            tok.save_pretrained(path)
            if hasattr(tok, "convert_ids_to_tokens"):
                image_token = tok.convert_ids_to_tokens(cfg.image_token_id)
        with open(os.path.join(path, "preprocessor_config.json"), "w") as f:
            json.dump({
                "image_processor_type": "SiglipImageProcessor",
                "processor_class": "DetikzifyProcessor",
                "size": {"height": cfg.vision.image_size,
                         "width": cfg.vision.image_size},
                # a scalar statistic holds for every channel
                "image_mean": np.broadcast_to(
                    processor.image_mean, (cfg.vision.num_channels,)).tolist(),
                "image_std": np.broadcast_to(
                    processor.image_std, (cfg.vision.num_channels,)).tolist(),
                "do_resize": True, "do_rescale": True,
                "do_normalize": True, "do_convert_rgb": True,
            }, f, indent=2)
        proc_cfg = {
            "processor_class": "DetikzifyProcessor",
            "image_seq_len": processor.image_seq_len,
        }
        if image_token is not None:
            proc_cfg["image_token"] = image_token
        if processor.model_expects_text:
            proc_cfg["model_expects_text"] = True
        with open(os.path.join(path, "processor_config.json"), "w") as f:
            json.dump(proc_cfg, f, indent=2)
    return nbytes


def save_adapter(path: str, adapter: Adapter, acfg: AdapterConfig) -> int:
    """Export TikZero adapter weights in the reference's layout (inverse of
    ``import_adapter``): the BARE keys of ``CrossAttentionAdapter.
    save_pretrained`` (``layers.{i}...``, ``connector.*``, ``dummy_input``
    ``[C, H, W]``) in ``path/model.safetensors``. The layers that
    ``acfg.cross_attn_every_n_layers`` leaves inactive (those the encoder
    skips) are omitted like the reference's ``None`` entries. Returns the
    bytes written."""
    every = acfg.cross_attn_every_n_layers
    out: Dict[str, torch.Tensor] = {}
    for i, blk in enumerate(adapter.layers):
        if (i + 1) % every != 0:
            continue
        base = f"layers.{i}"
        out[f"{base}.layer_norm1.weight"] = blk.ln1.scale
        out[f"{base}.layer_norm1.bias"] = blk.ln1.bias
        for ours, theirs in (("q", "q_proj"), ("k", "k_proj"),
                             ("v", "v_proj"), ("o", "out_proj")):
            lin = getattr(blk.attn, ours)
            out[f"{base}.cross_attn.{theirs}.weight"] = _plain(lin, base)
            out[f"{base}.cross_attn.{theirs}.bias"] = lin.bias
        for norm in ("q_norm", "k_norm"):
            out[f"{base}.cross_attn.{norm}.weight"] = \
                getattr(blk.attn, norm).scale
            out[f"{base}.cross_attn.{norm}.bias"] = \
                getattr(blk.attn, norm).bias
        out[f"{base}.layer_norm2.weight"] = blk.ln2.scale
        out[f"{base}.layer_norm2.bias"] = blk.ln2.bias
        for fc in ("fc1", "fc2"):
            lin = getattr(blk.mlp, fc)
            out[f"{base}.mlp.{fc}.weight"] = _plain(lin, base)
            out[f"{base}.mlp.{fc}.bias"] = lin.bias
        out[f"{base}.cross_attn_attn_gate"] = blk.attn_gate
        out[f"{base}.cross_attn_mlp_gate"] = blk.mlp_gate
    out["connector.weight"] = _plain(adapter.connector, "connector")
    out["connector.bias"] = adapter.connector.bias
    out["dummy_input"] = adapter.dummy_input.permute(2, 0, 1)
    os.makedirs(path, exist_ok=True)
    return save_file({k: v.detach() for k, v in out.items()},
                     os.path.join(path, "model.safetensors"))


def save_embedding_model(path: str, embed: Llama, cfg: TextConfig) -> int:
    """Export a caption model as a plain LLaMA checkpoint: ``model.*`` keys
    (``lm_head`` only when untied) and a flat ``config.json``, the layout
    of ``meta-llama/Llama-3.2-1B``, which ``load_adapter_params`` reads.
    Returns the bytes of ``model.safetensors``."""
    out: Dict[str, torch.Tensor] = {}
    _export_text(embed, out, "model")
    if embed.lm_head is not None and not cfg.tie_word_embeddings:
        out["lm_head.weight"] = _plain(embed.lm_head, "lm_head")
    os.makedirs(path, exist_ok=True)
    nbytes = save_file({k: v.detach() for k, v in out.items()},
                       os.path.join(path, "model.safetensors"))
    hf_cfg = {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
              **{k: getattr(cfg, k) for k in (
                  "vocab_size", "hidden_size", "intermediate_size",
                  "num_hidden_layers", "num_attention_heads",
                  "num_key_value_heads", "max_position_embeddings",
                  "rms_norm_eps", "rope_theta", "rope_scaling",
                  "tie_word_embeddings", "hidden_act", "attention_bias")},
              "head_dim": cfg.head_dim,
              "torch_dtype": str(embed.embed_tokens.dtype).replace(
                  "torch.", "")}
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_cfg, f, indent=2)
    return nbytes
