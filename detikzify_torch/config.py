"""Typed configuration system (the port's own copy of the JAX package's
``config.py``; presets and fields are identical).

A single dataclass-based config tree replaces the reference's three-tier
config sprawl (HF ``PretrainedConfig`` + per-script argparse + env vars; see
reference ``detikzify/model/configuration_detikzify.py:28-120``). Every config
serializes to/from plain JSON dicts so it can be stored inside checkpoints.

Architecture numbers mirror the reference model families:
  * vision tower: SigLIP so400m (hidden 1152, 27 layers, 16 heads, image 420,
    patch 14) -- reference ``configuration_detikzify.py:33-39``.
  * v2 text tower: LLaMA-3.1-8B family, ``image_token_id=128005``,
    ``concat_factor=3`` -- reference ``configuration_detikzify.py:83-120``.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


def _asdict(cfg) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


class _ConfigBase:
    def to_dict(self) -> Dict[str, Any]:
        d = _asdict(self)
        d["__class__"] = type(self).__name__
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]):
        d = dict(d)
        d.pop("__class__", None)
        fields = {f.name for f in dataclasses.fields(cls)}
        kwargs = {}
        for k, v in d.items():
            if k not in fields:
                continue
            ftype = next(f for f in dataclasses.fields(cls) if f.name == k)
            if dataclasses.is_dataclass(ftype.type) and isinstance(v, dict):
                kwargs[k] = ftype.type.from_dict(v)  # type: ignore[union-attr]
            else:
                kwargs[k] = v
        # nested dataclasses declared via string annotations
        for f in dataclasses.fields(cls):
            if f.name in kwargs and isinstance(kwargs[f.name], dict):
                sub = _NESTED.get(f.name)
                if sub is not None:
                    kwargs[f.name] = sub.from_dict(kwargs[f.name])
        return cls(**kwargs)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class VisionConfig(_ConfigBase):
    """SigLIP-style ViT encoder config (reference ``DetikzifyVisionConfig``)."""

    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    num_channels: int = 3
    image_size: int = 420
    patch_size: int = 14
    hidden_act: str = "gelu_pytorch_tanh"
    layer_norm_eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


@dataclass(frozen=True)
class TextConfig(_ConfigBase):
    """LLaMA-family decoder config."""

    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    max_position_embeddings: int = 131072
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    rope_scaling: Optional[Dict[str, Any]] = None
    tie_word_embeddings: bool = False
    hidden_act: str = "silu"
    attention_bias: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


@dataclass(frozen=True)
class AdapterConfig(_ConfigBase):
    """TikZero gated cross-attention adapter config.

    Mirrors reference ``model/adapter/modeling_adapter.py:355-394``: a cross
    attention block is inserted every ``cross_attn_every_n_layers`` vision
    layers; caption embeddings come from a frozen external embedding model.
    """

    embedding_hidden_size: int = 2048  # Llama-3.2-1B hidden size
    cross_attn_every_n_layers: int = 1
    num_attention_heads: int = 16
    dropout: float = 0.0


@dataclass(frozen=True)
class DetikzifyConfig(_ConfigBase):
    """Composite model config (reference ``DetikzifyConfig``)."""

    vision: VisionConfig = field(default_factory=VisionConfig)
    text: TextConfig = field(default_factory=TextConfig)
    adapter: Optional[AdapterConfig] = None
    image_token_id: int = 128005
    bos_token_id: int = 128000
    eos_token_id: int = 128001
    pad_token_id: int = 128004
    concat_factor: int = 3
    model_max_length: int = 4096
    dtype: str = "bfloat16"
    # v1 (legacy LLaVA-style) knobs -- reference model/v1/:
    # tap vision features at an intermediate layer (None = v2 behavior:
    # final post-norm hidden state), biased projector, pooling mode used by
    # SelfSim. ``pooling_mode=None`` means "not declared by the checkpoint":
    # ImageSim.from_detikzify then falls back to "emd", exactly like the
    # reference's getattr(config, "pooling_mode", "emd") (imagesim.py:64);
    # v1 checkpoints pin "cos" (v1 configuration_detikzify.py:12-13)
    feature_layer: Optional[int] = None
    projector_bias: bool = False
    pooling_mode: Optional[str] = None
    is_v1: bool = False

    @property
    def image_seq_len(self) -> int:
        """Number of <image> placeholder tokens per prompt (900/3 = 300)."""
        return self.vision.num_patches // self.concat_factor

    @property
    def projection_in(self) -> int:
        return self.vision.hidden_size * self.concat_factor


_NESTED = {"vision": VisionConfig, "text": TextConfig, "adapter": AdapterConfig}


# ---------------------------------------------------------------------------
# Presets matching the reference model zoo (BASELINE.md tracked configs).
# ---------------------------------------------------------------------------

def _tinyllama_text() -> TextConfig:
    return TextConfig(
        vocab_size=32002, hidden_size=2048, intermediate_size=5632,
        num_hidden_layers=22, num_attention_heads=32, num_key_value_heads=4,
        max_position_embeddings=2048, rope_theta=10000.0, rms_norm_eps=1e-5)


def _deepseek13_text() -> TextConfig:
    return TextConfig(
        vocab_size=32258, hidden_size=2048, intermediate_size=5504,
        num_hidden_layers=24, num_attention_heads=16, num_key_value_heads=16,
        max_position_embeddings=16384, rope_theta=100000.0, rms_norm_eps=1e-6)


def _deepseek7_text() -> TextConfig:
    return TextConfig(
        vocab_size=32258, hidden_size=4096, intermediate_size=11008,
        num_hidden_layers=30, num_attention_heads=32, num_key_value_heads=32,
        max_position_embeddings=16384, rope_theta=100000.0, rms_norm_eps=1e-6)


def _codellama7_text() -> TextConfig:
    return TextConfig(
        vocab_size=32018, hidden_size=4096, intermediate_size=11008,
        num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=32,
        max_position_embeddings=16384, rope_theta=1000000.0,
        rms_norm_eps=1e-5)


def _llama31_8b_text() -> TextConfig:
    return TextConfig(
        vocab_size=128256, hidden_size=4096, intermediate_size=14336,
        num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
        rope_theta=500000.0,
        rope_scaling={"rope_type": "llama3", "factor": 8.0,
                      "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                      "original_max_position_embeddings": 8192})


def tiny_test_config(vocab_size: int = 512) -> DetikzifyConfig:
    """A minutes-fast config for unit tests (runs on CPU)."""
    return DetikzifyConfig(
        vision=VisionConfig(hidden_size=48, intermediate_size=96,
                            num_hidden_layers=2, num_attention_heads=4,
                            image_size=42, patch_size=14),
        text=TextConfig(vocab_size=vocab_size, hidden_size=64,
                        intermediate_size=128, num_hidden_layers=2,
                        num_attention_heads=4, num_key_value_heads=2,
                        max_position_embeddings=1024, rope_theta=10000.0),
        image_token_id=vocab_size - 3,
        bos_token_id=vocab_size - 2,
        eos_token_id=vocab_size - 1,
        pad_token_id=0,
        concat_factor=3,
        model_max_length=256,
        dtype="float32",
        pooling_mode="cos",     # keep hermetic tests on the cheap mode
    )


PRESETS = {
    # v1 family (reference detikzify/model/v1/__init__.py:10-15)
    "detikzify-tl-1.1b": DetikzifyConfig(
        text=_tinyllama_text(), image_token_id=32000, bos_token_id=1,
        eos_token_id=2, pad_token_id=32001, model_max_length=2048,
        is_v1=True, projector_bias=True, pooling_mode="cos"),
    "detikzify-ds-1.3b": DetikzifyConfig(
        text=_deepseek13_text(), image_token_id=32013, bos_token_id=32013,
        eos_token_id=32014, pad_token_id=32014, model_max_length=2048,
        is_v1=True, projector_bias=True, pooling_mode="cos"),
    "detikzify-ds-7b": DetikzifyConfig(
        text=_deepseek7_text(), image_token_id=32013, bos_token_id=32013,
        eos_token_id=32014, pad_token_id=32014, model_max_length=2048,
        is_v1=True, projector_bias=True, pooling_mode="cos"),
    # CodeLlama-7b v1 (reference model/v1/__init__.py:14); real checkpoints
    # override these via _v1_config_from_hf -- this mirrors the zoo offline
    "detikzify-cl-7b": DetikzifyConfig(
        text=_codellama7_text(), image_token_id=32016, bos_token_id=1,
        eos_token_id=2, pad_token_id=32017, model_max_length=2048,
        is_v1=True, projector_bias=True, pooling_mode="cos"),
    # v2 family (reference configuration_detikzify.py defaults)
    "detikzify-v2-8b": DetikzifyConfig(text=_llama31_8b_text()),
    "detikzify-v2.5-8b": DetikzifyConfig(text=_llama31_8b_text()),
    # TikZero: v2 + cross-attention adapter
    "tikzero-adapter": DetikzifyConfig(
        text=_llama31_8b_text(), adapter=AdapterConfig()),
    "tiny-test": tiny_test_config(),
}


def get_config(name: str) -> DetikzifyConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    return PRESETS[name]
