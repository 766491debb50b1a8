"""The DreamSim perceptual-similarity ensemble in PyTorch (counterpart of
``detikzify_tpu/evaluate/dreamsim_jax.py``).

Reference ``detikzify/evaluate/dreamsim.py:13-89`` wraps the ``dreamsim``
torch package: an ensemble of three ViT-B/16 backbones (DINO, CLIP,
OpenCLIP -- LoRA weights already merged in the published checkpoints).
Each backbone embeds an image to its CLS feature (plus the CLIP visual
projection where present), embeddings are L2-normalized per model and
concatenated, and the distance is ``1 - cos`` between two images'
concatenated embeddings. The metric reported is ``1 - distance``.

  * ``vit_apply`` covers both backbone flavors:
    - ``variant="vit"``:  pre-norm ViT with CLS token and final LayerNorm
      (DINO / HF ViTModel layout)
    - ``variant="clip"``: CLIP vision tower (ln_pre -> blocks -> ln_post
      on CLS, optional visual projection, quick-gelu)
  * weight importers from the public state-dict namings: `import_vit_hf`
    (transformers ViTModel), `import_clip_hf` (transformers
    CLIPVisionModel[WithProjection]), `import_vit_timm` (timm / DINO /
    dreamsim-checkpoint naming) and `import_dreamsim_merged`;
  * `DreamSimViT`: the ensemble metric with the reference's
    update/compute/reset surface;
  * `save_ensemble` / `load_ensemble`: the JAX package's ``.npz`` +
    ``manifest.json`` format, so an ensemble either package saved loads in
    the other.

The parameters are the JAX trees, as dicts of fp32 tensors: dense kernels
``[in, out]`` and every layer's weights stacked ``[L, ...]``. The JAX
package computes this ViT's attention as plain XLA, so here it is plain
PyTorch (matmul and softmax in fp32) on the parameters' device; ``gelu``
is the tanh approximation, ``jax.nn.gelu``'s default.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# per-backbone input normalization (the dreamsim package's processors)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
#: the ``format`` of a ``save_ensemble`` manifest (the JAX package's)
MANIFEST_FORMAT = "detikzify_tpu.dreamsim.v1"


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    patch_size: int = 16
    image_size: int = 224
    variant: str = "vit"            # "vit" | "clip"
    hidden_act: str = "gelu"        # "gelu" | "quick_gelu"
    layer_norm_eps: float = 1e-6
    proj_dim: Optional[int] = None  # CLIP visual projection width

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def embed_dim(self) -> int:
        return self.proj_dim or self.hidden_size


def _act(name: str):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    return lambda x: F.gelu(x, approximate="tanh")


def _ln(p, x, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def _linear(p, x):
    y = x @ p["kernel"]
    if "bias" in p:
        y = y + p["bias"]
    return y


def _mha(p, x, heads: int):
    b, s, d = x.shape
    hd = d // heads

    def split(t):
        return t.reshape(b, s, heads, hd).transpose(1, 2)

    q, k, v = (split(_linear(p[n], x)) for n in ("q", "k", "v"))
    attn = torch.softmax((q @ k.transpose(-1, -2)) * (hd ** -0.5), dim=-1)
    out = (attn @ v).transpose(1, 2).reshape(b, s, d)
    return _linear(p["o"], out)


def _block(p, x, cfg: ViTConfig):
    act = _act(cfg.hidden_act)
    x = x + _mha(p["attn"], _ln(p["ln1"], x, cfg.layer_norm_eps),
                 cfg.num_attention_heads)
    h = _linear(p["mlp"]["fc1"], _ln(p["ln2"], x, cfg.layer_norm_eps))
    return x + _linear(p["mlp"]["fc2"], act(h))


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


@torch.inference_mode()
def vit_apply(params: dict, cfg: ViTConfig, pixels: torch.Tensor
              ) -> torch.Tensor:
    """pixels [B, H, W, C] (already normalized) -> CLS embedding
    [B, embed_dim], on the parameters' device."""
    b = pixels.shape[0]
    p = cfg.patch_size
    g = cfg.image_size // p
    patches = pixels.reshape(b, g, p, g, p, 3).permute(0, 1, 3, 2, 4, 5)
    patches = patches.reshape(b, cfg.num_patches, p * p * 3)
    x = _linear(params["patch"], patches.float())
    cls = params["cls_token"].expand(b, 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1) + params["position"]

    if cfg.variant == "clip" or "ln_pre" in params:
        # explicit for the clip variant; optional for timm-layout towers
        # (dreamsim's clip-as-dino keeps CLIP's ln_pre as timm norm_pre)
        x = _ln(params["ln_pre"], x, cfg.layer_norm_eps)

    layers = params["layers"]
    for i in range(layers["ln1"]["scale"].shape[0]):
        x = _block(_tree_map(lambda t: t[i], layers), x, cfg)

    if cfg.variant == "clip":
        out = _ln(params["ln_post"], x[:, 0], cfg.layer_norm_eps)
        if "proj" in params:
            out = out @ params["proj"]
        return out
    out = _ln(params["post_ln"], x, cfg.layer_norm_eps)[:, 0]
    if "proj" in params:
        # dreamsim's clip-as-dino towers: a timm-layout ViT whose CLS
        # feature is sent through the retained CLIP visual projection
        out = out @ params["proj"]
    return out


# ---------------------------------------------------------------------------
# importers (fp32 tensors on the host; ``to_device`` places a tree)
# ---------------------------------------------------------------------------

def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().float().numpy()
    return np.asarray(t)


def _t(arr) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr, np.float32).copy())


def _lin_np(state, name):
    p = {"kernel": _t(_np(state[f"{name}.weight"]).T)}
    if f"{name}.bias" in state:
        p["bias"] = _t(_np(state[f"{name}.bias"]))
    return p


def _ln_np(state, name):
    return {"scale": _t(_np(state[f"{name}.weight"])),
            "bias": _t(_np(state[f"{name}.bias"]))}


def _stack(items):
    return _tree_map(lambda *xs: torch.stack(xs), *items)


def to_device(tree: dict, device) -> dict:
    return _tree_map(lambda t: t.to(device), tree)


def _conv_to_linear(weight) -> torch.Tensor:
    """[D, C, p, p] conv kernel -> [p*p*C, D] matmul kernel matching the
    (h, w, c)-ordered patch flattening in vit_apply."""
    w = _np(weight).transpose(2, 3, 1, 0)      # [p, p, C, D]
    return _t(w.reshape(-1, w.shape[-1]))


def import_vit_hf(state: dict, cfg: ViTConfig, prefix: str = "vit"
                  ) -> dict:
    """transformers ViTModel state dict (DINO checkpoints are published in
    this layout, e.g. facebook/dino-vitb16) -> vit_apply params."""
    s = {k.removeprefix(f"{prefix}.") if k.startswith(f"{prefix}.")
         else k: v for k, v in state.items()}
    layers = []
    for i in range(cfg.num_hidden_layers):
        b = f"encoder.layer.{i}"
        layers.append({
            "ln1": _ln_np(s, f"{b}.layernorm_before"),
            "attn": {
                "q": _lin_np(s, f"{b}.attention.attention.query"),
                "k": _lin_np(s, f"{b}.attention.attention.key"),
                "v": _lin_np(s, f"{b}.attention.attention.value"),
                "o": _lin_np(s, f"{b}.attention.output.dense"),
            },
            "ln2": _ln_np(s, f"{b}.layernorm_after"),
            "mlp": {"fc1": _lin_np(s, f"{b}.intermediate.dense"),
                    "fc2": _lin_np(s, f"{b}.output.dense")},
        })
    return {
        "patch": {
            "kernel": _conv_to_linear(
                s["embeddings.patch_embeddings.projection.weight"]),
            "bias": _t(_np(s["embeddings.patch_embeddings.projection.bias"])),
        },
        "cls_token": _t(_np(s["embeddings.cls_token"])[0]),
        "position": _t(_np(s["embeddings.position_embeddings"])[0]),
        "layers": _stack(layers),
        "post_ln": _ln_np(s, "layernorm"),
    }


def import_vit_timm(state: dict, cfg: ViTConfig) -> dict:
    """timm / DINO-repo / dreamsim-checkpoint naming (cls_token, pos_embed,
    blocks.{i}.attn.qkv, ...) -> vit_apply params."""
    layers = []
    for i in range(cfg.num_hidden_layers):
        b = f"blocks.{i}"
        qw, kw, vw = np.split(_np(state[f"{b}.attn.qkv.weight"]), 3, axis=0)
        qb, kb, vb = np.split(_np(state[f"{b}.attn.qkv.bias"]), 3, axis=0)
        layers.append({
            "ln1": _ln_np(state, f"{b}.norm1"),
            "attn": {
                "q": {"kernel": _t(qw.T), "bias": _t(qb)},
                "k": {"kernel": _t(kw.T), "bias": _t(kb)},
                "v": {"kernel": _t(vw.T), "bias": _t(vb)},
                "o": _lin_np(state, f"{b}.attn.proj"),
            },
            "ln2": _ln_np(state, f"{b}.norm2"),
            "mlp": {"fc1": _lin_np(state, f"{b}.mlp.fc1"),
                    "fc2": _lin_np(state, f"{b}.mlp.fc2")},
        })
    params = {
        "patch": {
            "kernel": _conv_to_linear(state["patch_embed.proj.weight"]),
            "bias": _t(_np(state["patch_embed.proj.bias"])),
        },
        "cls_token": _t(_np(state["cls_token"])[0]),
        "position": _t(_np(state["pos_embed"])[0]),
        "layers": _stack(layers),
        "post_ln": _ln_np(state, "norm"),
    }
    if "norm_pre.weight" in state:   # clip-as-dino keeps CLIP's ln_pre
        params["ln_pre"] = _ln_np(state, "norm_pre")
    if "proj" in state:              # retained CLIP visual projection
        params["proj"] = _t(_np(state["proj"]))
    return params


def import_clip_hf(state: dict, cfg: ViTConfig) -> dict:
    """transformers CLIPVisionModel(WithProjection) state dict ->
    vit_apply params (variant='clip')."""
    s = {k.removeprefix("vision_model."): v for k, v in state.items()}
    layers = []
    for i in range(cfg.num_hidden_layers):
        b = f"encoder.layers.{i}"
        layers.append({
            "ln1": _ln_np(s, f"{b}.layer_norm1"),
            "attn": {
                "q": _lin_np(s, f"{b}.self_attn.q_proj"),
                "k": _lin_np(s, f"{b}.self_attn.k_proj"),
                "v": _lin_np(s, f"{b}.self_attn.v_proj"),
                "o": _lin_np(s, f"{b}.self_attn.out_proj"),
            },
            "ln2": _ln_np(s, f"{b}.layer_norm2"),
            "mlp": {"fc1": _lin_np(s, f"{b}.mlp.fc1"),
                    "fc2": _lin_np(s, f"{b}.mlp.fc2")},
        })
    # HF spells it "pre_layrnorm" (sic)
    pre = "pre_layrnorm" if "pre_layrnorm.weight" in s else "pre_layernorm"
    params = {
        "patch": {
            "kernel": _conv_to_linear(
                s["embeddings.patch_embedding.weight"]),
        },
        "cls_token": _t(_np(s["embeddings.class_embedding"]).reshape(1, -1)),
        "position": _t(_np(s["embeddings.position_embedding.weight"])),
        "ln_pre": _ln_np(s, pre),
        "layers": _stack(layers),
        "ln_post": _ln_np(s, "post_layernorm"),
    }
    if "embeddings.patch_embedding.bias" in s:
        params["patch"]["bias"] = _t(_np(s["embeddings.patch_embedding.bias"]))
    else:
        params["patch"]["bias"] = torch.zeros((cfg.hidden_size,))
    if "visual_projection.weight" in state:
        params["proj"] = _t(_np(state["visual_projection.weight"]).T)
    return params


# ---------------------------------------------------------------------------
# the ensemble metric
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Extractor:
    params: dict
    cfg: ViTConfig
    mean: Tuple[float, float, float] = IMAGENET_MEAN
    std: Tuple[float, float, float] = IMAGENET_STD


class DreamSimViT:
    """DreamSim-ensemble perceptual similarity, update/compute/reset API.

    ``update(img1, img2)`` accumulates ``1 - distance`` where distance is
    ``1 - cos`` over the per-extractor-normalized concatenated CLS
    embeddings -- the reference torch metric's exact computation
    (``detikzify/evaluate/dreamsim.py:67-86``). Each backbone runs on the
    device its parameters live on."""

    higher_is_better = True

    def __init__(self, extractors: Sequence[Extractor],
                 preprocess: bool = True):
        if not extractors:
            raise ValueError("at least one extractor required")
        self.extractors = list(extractors)
        self.preprocess = preprocess
        self._scores: List[float] = []

    def _pixels01(self, img, size: int) -> np.ndarray:
        from PIL import Image

        from ..utils.image import expand, load, remove_alpha, trim

        pil = load(img) if not isinstance(img, Image.Image) else img
        if self.preprocess:
            pil = expand(trim(remove_alpha(pil)), max(pil.size))
        pil = remove_alpha(pil).resize((size, size),
                                       Image.Resampling.BICUBIC)
        return np.asarray(pil, np.float32) / 255.0

    @torch.inference_mode()
    def embed(self, img) -> np.ndarray:
        """Concatenated per-model-normalized embedding of one image."""
        parts = []
        for ex in self.extractors:
            dev = ex.params["patch"]["kernel"].device
            mean = torch.tensor(ex.mean, dtype=torch.float32, device=dev)
            std = torch.tensor(ex.std, dtype=torch.float32, device=dev)
            pixels = torch.from_numpy(
                self._pixels01(img, ex.cfg.image_size))[None].to(dev)
            e = vit_apply(ex.params, ex.cfg, (pixels - mean) / std)
            e = e / (torch.linalg.vector_norm(e, dim=-1, keepdim=True)
                     + 1e-8)
            parts.append(e[0].cpu().numpy())
        return np.concatenate(parts)

    def similarity(self, img1, img2) -> float:
        e1, e2 = self.embed(img1), self.embed(img2)
        denom = (np.linalg.norm(e1) * np.linalg.norm(e2)) or 1.0
        return float(e1 @ e2 / denom)

    def update(self, img1, img2) -> None:
        if isinstance(img1, (list, tuple)) or isinstance(img2, (list, tuple)):
            if len(img1) != len(img2):
                raise ValueError(f"{len(img1)} images against {len(img2)}")
            for a, b in zip(img1, img2):
                self.update(a, b)
            return
        # score += 1 - distance == cosine similarity
        self._scores.append(self.similarity(img1, img2))

    def compute(self) -> float:
        if not self._scores:
            raise RuntimeError("no updates")
        return float(np.mean(self._scores))

    def reset(self) -> None:
        self._scores = []


def _cfg_from_checkpoint(path: str, defaults: ViTConfig) -> ViTConfig:
    """Override backbone dims from the checkpoint's HF config.json when
    present (keeps tiny test checkpoints and non-base variants loadable);
    the ViT-B/16 defaults apply otherwise."""
    cfg_path = os.path.join(path if os.path.isdir(path)
                            else os.path.dirname(path), "config.json")
    if not os.path.exists(cfg_path):
        return defaults
    with open(cfg_path) as f:
        hf = json.load(f)
    hf = hf.get("vision_config", hf)   # CLIPVisionModel nests under this
    updates = {}
    for name in ("hidden_size", "num_hidden_layers", "num_attention_heads",
                 "intermediate_size", "patch_size", "image_size"):
        if name in hf:
            updates[name] = hf[name]
    if defaults.variant == "clip" and "projection_dim" in hf:
        updates["proj_dim"] = hf["projection_dim"]
    return dataclasses.replace(defaults, **updates)


def from_checkpoints(dino_path: Optional[str] = None,
                     clip_path: Optional[str] = None,
                     open_clip_path: Optional[str] = None,
                     device="cuda") -> DreamSimViT:
    """Build the ensemble on ``device`` from local safetensors checkpoints
    of the three backbones (HF layouts: ViTModel for DINO,
    CLIPVisionModelWithProjection for CLIP/OpenCLIP). Pass only the
    backbones you have -- DreamSim's 'single' variants use one."""
    from ..models.import_hf import load_state_dict_from_safetensors

    extractors = []
    if dino_path:
        cfg = _cfg_from_checkpoint(
            dino_path, ViTConfig(variant="vit", layer_norm_eps=1e-12))
        state = load_state_dict_from_safetensors(dino_path)
        extractors.append(Extractor(
            to_device(import_vit_hf(state, cfg), device), cfg,
            IMAGENET_MEAN, IMAGENET_STD))
    for path in (clip_path, open_clip_path):
        if path:
            cfg = _cfg_from_checkpoint(
                path, ViTConfig(variant="clip", hidden_act="quick_gelu",
                                layer_norm_eps=1e-5, proj_dim=512))
            state = load_state_dict_from_safetensors(path)
            extractors.append(Extractor(
                to_device(import_clip_hf(state, cfg), device), cfg,
                CLIP_MEAN, CLIP_STD))
    if not extractors:
        raise ValueError("at least one backbone checkpoint required")
    return DreamSimViT(extractors)


# ---------------------------------------------------------------------------
# dreamsim-package merged checkpoints (the published LoRA-merged weights)
# ---------------------------------------------------------------------------

#: branch name -> per-branch input normalization. The published ensemble
#: (reference detikzify/evaluate/dreamsim.py:40-66 via the ``dreamsim``
#: package) is DINO + CLIP + OpenCLIP ViT-B/16 towers, all stored in
#: timm/DINO naming after the package's *_as_dino wrapping; the two CLIP
#: towers carry a retained visual projection.
ENSEMBLE_BRANCHES = (
    ("dino_vitb16", (IMAGENET_MEAN, IMAGENET_STD)),
    ("clip_vitb16", (CLIP_MEAN, CLIP_STD)),
    ("open_clip_vitb16", (CLIP_MEAN, CLIP_STD)),
)


def import_dreamsim_merged(obj, cfg: Optional[ViTConfig] = None
                           ) -> Tuple[dict, ViTConfig]:
    """One LoRA-merged dreamsim tower (torch state dict, timm naming;
    either the raw state dict or ``{"model": sd, "proj": tensor}``) ->
    (``vit_apply`` params on the host, inferred config). ``cfg`` defaults
    to the shapes read off the checkpoint (ViT-B/16 at 224 for the
    published ensemble)."""
    if isinstance(obj, dict) and "model" in obj and any(
            k.startswith("blocks.") for k in obj["model"]):
        state = dict(obj["model"])
        if "proj" in obj and obj["proj"] is not None:
            state["proj"] = obj["proj"]
    else:
        state = obj
    if cfg is None:
        n_layers = 1 + max(int(k.split(".")[1]) for k in state
                           if k.startswith("blocks."))
        hidden = _np(state["cls_token"]).shape[-1]
        heads = max(hidden // 64, 1)
        inter = _np(state["blocks.0.mlp.fc1.weight"]).shape[0]
        n_patches = _np(state["pos_embed"]).shape[1] - 1
        patch = _np(state["patch_embed.proj.weight"]).shape[-1]
        side = int(round(n_patches ** 0.5)) * patch
        cfg = ViTConfig(hidden_size=hidden, num_hidden_layers=n_layers,
                        num_attention_heads=heads,
                        intermediate_size=inter, patch_size=patch,
                        image_size=side, variant="vit",
                        layer_norm_eps=1e-6,
                        proj_dim=_np(state["proj"]).shape[-1]
                        if "proj" in state else None)
    return import_vit_timm(state, cfg), cfg


def from_dreamsim_checkpoint(paths: dict, device="cuda") -> DreamSimViT:
    """Build the ensemble on ``device`` straight from dreamsim-package
    merged ``.pth`` files: ``paths`` maps branch name (see
    ENSEMBLE_BRANCHES) to a torch checkpoint path."""
    norm = dict(ENSEMBLE_BRANCHES)
    extractors = []
    for branch, path in paths.items():
        obj = torch.load(path, map_location="cpu", weights_only=True)
        params, cfg = import_dreamsim_merged(obj)
        mean, std = norm.get(branch, (IMAGENET_MEAN, IMAGENET_STD))
        extractors.append(Extractor(to_device(params, device), cfg, mean,
                                    std))
    return DreamSimViT(extractors)


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree.detach().cpu().numpy()


def _unflatten(flat: dict, device) -> dict:
    out: dict = {}
    for key, value in flat.items():
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.from_numpy(np.array(value)).to(device)
    return out


def _digest(flat: dict) -> str:
    digest = hashlib.sha256()
    for key in sorted(flat):
        digest.update(key.encode())
        digest.update(np.ascontiguousarray(flat[key]).tobytes())
    return digest.hexdigest()


def save_ensemble(path: str, ds: DreamSimViT) -> dict:
    """Persist an ensemble in the JAX package's format: one ``.npz`` per
    branch + ``manifest.json`` (config, normalization, array sha256 per
    branch). Returns the manifest."""
    os.makedirs(path, exist_ok=True)
    manifest = {"format": MANIFEST_FORMAT, "branches": []}
    for i, ex in enumerate(ds.extractors):
        flat = dict(_flatten(ex.params))
        fname = f"branch{i}.npz"
        np.savez(os.path.join(path, fname), **flat)
        manifest["branches"].append({
            "file": fname,
            "sha256": _digest(flat),
            "n_params": int(sum(v.size for v in flat.values())),
            "config": dataclasses.asdict(ex.cfg),
            "mean": list(ex.mean), "std": list(ex.std),
        })
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


def load_ensemble(path: str, device="cuda") -> DreamSimViT:
    """Load a ``save_ensemble`` directory (either package's) onto
    ``device``, verifying each branch's sha256 against the manifest."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    extractors = []
    for spec in manifest["branches"]:
        with np.load(os.path.join(path, spec["file"])) as npz:
            flat = dict(npz)
        if _digest(flat) != spec["sha256"]:
            raise ValueError(
                f"{spec['file']}: sha256 mismatch vs manifest "
                f"(corrupted or tampered conversion)")
        cfg = ViTConfig(**spec["config"])
        extractors.append(Extractor(_unflatten(flat, device), cfg,
                                    tuple(spec["mean"]),
                                    tuple(spec["std"])))
    return DreamSimViT(extractors)
