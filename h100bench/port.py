"""The system under test, built from a configuration file: the port's
config, its weights (the yardstick's, copied in and then prepared by the
port itself: int8 quantization and fused projections where the file says
``"weights": "int8"``) and its processor around the tokenizer stand-in.
The only module of the harness, with the drivers, that imports the port.
"""
from __future__ import annotations

import torch

from . import weights as yard
from .tokenizer import StandInTokenizer

# yardstick name part -> the port's module path part
_RENAMES = (("vision.patch.", "vision.embeddings.patch."),
            ("vision.position", "vision.embeddings.position"),
            ("connector.", "connector.proj."),
            ("text.embed", "text.embed_tokens"))
_NORMS = ("ln1", "ln2", "post_ln", "ln", "input_ln", "norm")


def port_name(name: str) -> str:
    for old, new in _RENAMES:
        if name.startswith(old):
            name = new + name[len(old):]
            break
    module, _, leaf = name.rpartition(".")
    if leaf == "weight" and module.rpartition(".")[2] in _NORMS:
        return f"{module}.scale"
    return name


def port_config(cfg: dict):
    from detikzify_torch.config import (DetikzifyConfig, TextConfig,
                                        VisionConfig)

    text = TextConfig(**{k: cfg[k] for k in (
        "vocab_size", "hidden_size", "intermediate_size",
        "num_hidden_layers", "num_attention_heads", "num_key_value_heads",
        "max_position_embeddings", "rms_norm_eps", "rope_theta",
        "rope_scaling", "tie_word_embeddings", "hidden_act",
        "attention_bias")})
    return DetikzifyConfig(
        vision=VisionConfig(**cfg["vision"]), text=text,
        image_token_id=cfg["image_token_id"],
        bos_token_id=cfg["bos_token_id"], eos_token_id=cfg["eos_token_id"],
        pad_token_id=cfg["pad_token_id"],
        concat_factor=cfg["concat_factor"],
        model_max_length=cfg["model_max_length"], dtype="bfloat16",
        feature_layer=cfg["feature_layer"],
        projector_bias=cfg["projector_bias"],
        pooling_mode=cfg["pooling_mode"], is_v1=True)


@torch.no_grad()
def port_params(cfg: dict, pcfg, seed: int, device):
    """The port's ``Params`` holding the yardstick's weights for ``seed``,
    prepared as the configuration serves them."""
    from detikzify_torch.models.detikzify import Params
    from detikzify_torch.ops.quant import fuse_projections, quantize_params

    params = Params(pcfg, device=device, dtype=torch.bfloat16)
    expected = {n for n, _ in params.named_parameters()}
    filled = set()
    for unit, _ in yard.units(cfg):
        for name, w in yard.draw(cfg, seed, unit, device).items():
            target = port_name(name)
            params.get_parameter(target).copy_(w)
            filled.add(target)
    if filled != expected:
        raise RuntimeError(f"weights not filled: {sorted(expected - filled)}"
                           f"; unknown: {sorted(filled - expected)}")
    if cfg["weights"] == "int8":
        fuse_projections(quantize_params(params))
    elif cfg["weights"] != "bf16":
        raise ValueError(f"unknown weights {cfg['weights']!r}")
    return params


def processor(cfg: dict, pcfg):
    from detikzify_torch.processing import DetikzifyProcessor

    return DetikzifyProcessor(StandInTokenizer.for_config(cfg), pcfg)
