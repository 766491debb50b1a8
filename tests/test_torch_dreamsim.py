"""The port's DreamSim ensemble (``evaluate/dreamsim_vit.py``) against the
JAX package's (``evaluate/dreamsim_jax.py``) and against the transformers
towers, on the CPU in fp32.

Mirrors ``tests/test_dreamsim.py`` (tower parity with transformers'
ViTModel and CLIPVisionModelWithProjection at 5e-4, the timm naming, the
ensemble metric; its converter-tool dry run waits for the tools' port) and
holds the port against JAX: every importer gives JAX's arrays exactly,
``vit_apply`` agrees within 1e-5, the ensemble's similarity within 1e-5,
and ensembles saved by either package load in the other and score alike.
"""
import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from PIL import Image, ImageDraw

from detikzify_tpu.evaluate import dreamsim_jax as J
from detikzify_torch.evaluate import dreamsim_vit as T

torch.set_num_threads(1)

ATOL = 5e-4          # against transformers' towers (as the JAX suite)
PARITY = 1e-5        # against the JAX package


def tiny_cfg(mod, **kw):
    return mod.ViTConfig(hidden_size=32, num_hidden_layers=2,
                         num_attention_heads=4, intermediate_size=64,
                         patch_size=8, image_size=32, **kw)


VIT = dict(variant="vit", layer_norm_eps=1e-12)
CLIP = dict(variant="clip", hidden_act="quick_gelu", layer_norm_eps=1e-5,
            proj_dim=16)


def _pixels(rng, size):
    return rng.standard_normal((2, size, size, 3)).astype(np.float32)


def _hf_vit(seed):
    import transformers

    torch.manual_seed(seed)
    return transformers.ViTModel(transformers.ViTConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=64, image_size=32, patch_size=8),
        add_pooling_layer=False).eval()


def _hf_clip(seed):
    import transformers

    torch.manual_seed(seed)
    return transformers.CLIPVisionModelWithProjection(
        transformers.CLIPVisionConfig(
            hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, image_size=32, patch_size=8,
            projection_dim=16, hidden_act="quick_gelu")).eval()


def _timm_state(hf, layers):
    """The timm/DINO naming of an HF ViTModel's weights (packed qkv)."""
    timm = {
        "cls_token": hf["embeddings.cls_token"],
        "pos_embed": hf["embeddings.position_embeddings"],
        "patch_embed.proj.weight":
            hf["embeddings.patch_embeddings.projection.weight"],
        "patch_embed.proj.bias":
            hf["embeddings.patch_embeddings.projection.bias"],
        "norm.weight": hf["layernorm.weight"],
        "norm.bias": hf["layernorm.bias"],
    }
    for i in range(layers):
        h, t = f"encoder.layer.{i}", f"blocks.{i}"
        timm[f"{t}.norm1.weight"] = hf[f"{h}.layernorm_before.weight"]
        timm[f"{t}.norm1.bias"] = hf[f"{h}.layernorm_before.bias"]
        for kind in ("weight", "bias"):
            timm[f"{t}.attn.qkv.{kind}"] = torch.cat(
                [hf[f"{h}.attention.attention.{n}.{kind}"]
                 for n in ("query", "key", "value")])
            timm[f"{t}.attn.proj.{kind}"] = \
                hf[f"{h}.attention.output.dense.{kind}"]
            timm[f"{t}.norm2.{kind}"] = hf[f"{h}.layernorm_after.{kind}"]
            timm[f"{t}.mlp.fc1.{kind}"] = hf[f"{h}.intermediate.dense.{kind}"]
            timm[f"{t}.mlp.fc2.{kind}"] = hf[f"{h}.output.dense.{kind}"]
    return timm


def _same_tree(got: dict, want: dict) -> None:
    """The port's tree holds JAX's arrays exactly, key for key."""
    assert got.keys() == want.keys()
    for k in got:
        if isinstance(got[k], dict):
            _same_tree(got[k], want[k])
        else:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def _both(params_t, params_j, cfg_t, cfg_j, pix):
    got = T.vit_apply(params_t, cfg_t, torch.from_numpy(pix)).numpy()
    want = np.asarray(J.vit_apply(params_j, cfg_j, jnp.asarray(pix)))
    np.testing.assert_allclose(got, want, rtol=0, atol=PARITY)
    return got


def test_vit_parity_hf_vitmodel():
    model = _hf_vit(0)
    cfg_t, cfg_j = tiny_cfg(T, **VIT), tiny_cfg(J, **VIT)
    pix = _pixels(np.random.default_rng(0), 32)
    with torch.inference_mode():
        want = model(torch.from_numpy(pix.transpose(0, 3, 1, 2))
                     ).last_hidden_state[:, 0].numpy()
    state = model.state_dict()
    params = T.import_vit_hf(state, cfg_t)
    _same_tree(params, J.import_vit_hf(state, cfg_j))
    got = _both(params, J.import_vit_hf(state, cfg_j), cfg_t, cfg_j, pix)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-3)


def test_vit_parity_timm_naming():
    """timm/DINO-style state dict (packed qkv) maps to the same tower."""
    model = _hf_vit(1)
    cfg_t, cfg_j = tiny_cfg(T, **VIT), tiny_cfg(J, **VIT)
    timm = _timm_state(model.state_dict(), cfg_t.num_hidden_layers)
    pix = _pixels(np.random.default_rng(1), 32)
    with torch.inference_mode():
        want = model(torch.from_numpy(pix.transpose(0, 3, 1, 2))
                     ).last_hidden_state[:, 0].numpy()
    params = T.import_vit_timm(timm, cfg_t)
    _same_tree(params, J.import_vit_timm(timm, cfg_j))
    got = _both(params, J.import_vit_timm(timm, cfg_j), cfg_t, cfg_j, pix)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-3)


def test_clip_parity_hf():
    model = _hf_clip(2)
    cfg_t, cfg_j = tiny_cfg(T, **CLIP), tiny_cfg(J, **CLIP)
    pix = _pixels(np.random.default_rng(2), 32)
    with torch.inference_mode():
        want = model(torch.from_numpy(pix.transpose(0, 3, 1, 2))
                     ).image_embeds.numpy()
    state = model.state_dict()
    params = T.import_clip_hf(state, cfg_t)
    _same_tree(params, J.import_clip_hf(state, cfg_j))
    got = _both(params, J.import_clip_hf(state, cfg_j), cfg_t, cfg_j, pix)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-3)


def _images():
    img1 = Image.new("RGB", (32, 32), "white")
    ImageDraw.Draw(img1).rectangle([4, 4, 27, 27], outline="black", width=2)
    img2 = Image.new("RGB", (32, 32), "white")
    ImageDraw.Draw(img2).ellipse([2, 10, 29, 22], fill="blue")
    img3 = Image.new("RGB", (48, 40), "white")
    ImageDraw.Draw(img3).line([0, 0, 40, 30], fill="red", width=3)
    return img1, img2, img3


def _ensembles():
    vit, clip = _hf_vit(3).state_dict(), _hf_clip(4).state_dict()
    out = []
    for mod, cls in ((T, T.DreamSimViT), (J, J.DreamSimJAX)):
        vcfg, ccfg = tiny_cfg(mod, **VIT), tiny_cfg(mod, **CLIP)
        ex = [mod.Extractor(mod.import_vit_hf(vit, vcfg), vcfg),
              mod.Extractor(mod.import_clip_hf(clip, ccfg), ccfg,
                            mod.CLIP_MEAN, mod.CLIP_STD)]
        if mod is T:
            ex = [T.Extractor(T.to_device(e.params, "cpu"), e.cfg, e.mean,
                              e.std) for e in ex]
        out.append(cls(ex))
    return out


def test_dreamsim_ensemble_metric():
    """Identical images score 1.0, different images lower; embeddings
    concatenate across backbones."""
    metric, _ = _ensembles()
    img1, img2, _ = _images()
    assert metric.embed(img1).shape == (32 + 16,)
    metric.update(img1, img1.copy())
    same = metric.compute()
    metric.reset()
    metric.update([img1], [img2])
    diff = metric.compute()
    assert same == pytest.approx(1.0, abs=1e-5)
    assert diff < same
    metric.reset()
    with pytest.raises(RuntimeError):
        metric.compute()
    with pytest.raises(ValueError):
        metric.update([img1], [img1, img2])


def test_dreamsim_ensemble_matches_jax():
    tm, jm = _ensembles()
    imgs = _images()
    np.testing.assert_allclose(tm.embed(imgs[2]), jm.embed(imgs[2]),
                               rtol=0, atol=PARITY)
    for a in imgs:
        for b in imgs:
            assert tm.similarity(a, b) == pytest.approx(jm.similarity(a, b),
                                                        abs=PARITY)
    for m in (tm, jm):
        m.update(list(imgs), list(imgs[::-1]))
    assert tm.compute() == pytest.approx(jm.compute(), abs=PARITY)


def test_ensemble_files_cross_packages(tmp_path):
    """A JAX ``save_ensemble`` loads in the port (and the port's in JAX),
    scoring as the saved ensemble; the manifest's sha256 guards it."""
    tm, jm = _ensembles()
    imgs = _images()
    J.save_ensemble(str(tmp_path / "j"), jm)
    manifest = T.save_ensemble(str(tmp_path / "t"), tm)
    assert manifest["format"] == T.MANIFEST_FORMAT
    with open(tmp_path / "j" / "manifest.json") as f:
        assert json.load(f) == manifest
    back = T.load_ensemble(str(tmp_path / "j"), device="cpu")
    for a, b in zip(back.extractors, tm.extractors):
        _same_tree(a.params, {k: v for k, v in b.params.items()})
        assert a.cfg == b.cfg and a.mean == b.mean and a.std == b.std
    assert back.similarity(imgs[0], imgs[1]) == tm.similarity(imgs[0],
                                                              imgs[1])
    jback = J.load_ensemble(str(tmp_path / "t"))
    assert jback.similarity(imgs[0], imgs[1]) == pytest.approx(
        back.similarity(imgs[0], imgs[1]), abs=PARITY)
    target = tmp_path / "j" / "branch0.npz"
    blob = bytearray(target.read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    target.write_bytes(bytes(blob))
    with pytest.raises(Exception):
        T.load_ensemble(str(tmp_path / "j"), device="cpu")


def _timm_tower(seed, *, norm_pre=False, d=32, layers=2, patch=8, side=32):
    g = torch.Generator().manual_seed(seed)

    def t(*shape):
        return torch.randn(*shape, generator=g) * 0.02

    n = (side // patch) ** 2
    sd = {"cls_token": t(1, 1, d), "pos_embed": t(1, n + 1, d),
          "patch_embed.proj.weight": t(d, 3, patch, patch),
          "patch_embed.proj.bias": t(d), "norm.weight": 1 + t(d),
          "norm.bias": t(d)}
    if norm_pre:
        sd["norm_pre.weight"] = 1 + t(d)
        sd["norm_pre.bias"] = t(d)
    for i in range(layers):
        b = f"blocks.{i}"
        sd.update({
            f"{b}.norm1.weight": 1 + t(d), f"{b}.norm1.bias": t(d),
            f"{b}.attn.qkv.weight": t(3 * d, d), f"{b}.attn.qkv.bias": t(3 * d),
            f"{b}.attn.proj.weight": t(d, d), f"{b}.attn.proj.bias": t(d),
            f"{b}.norm2.weight": 1 + t(d), f"{b}.norm2.bias": t(d),
            f"{b}.mlp.fc1.weight": t(2 * d, d), f"{b}.mlp.fc1.bias": t(2 * d),
            f"{b}.mlp.fc2.weight": t(d, 2 * d), f"{b}.mlp.fc2.bias": t(d),
        })
    return sd


def test_dreamsim_checkpoints_match_jax(tmp_path):
    """The three dreamsim-package branch layouts (a raw timm state dict;
    ``{"model", "proj"}`` with CLIP's ln_pre; a state dict carrying its
    own ``proj``) written as ``.pth`` load through
    ``from_dreamsim_checkpoint`` as JAX loads them: the same configs,
    arrays and similarities."""
    torch.save(_timm_tower(0), tmp_path / "dino.pth")
    torch.save({"model": _timm_tower(1, norm_pre=True),
                "proj": torch.randn(32, 16, generator=torch.Generator()
                                    .manual_seed(2)) * 0.02},
               tmp_path / "clip.pth")
    oclip = _timm_tower(3, norm_pre=True)
    oclip["proj"] = torch.randn(32, 16, generator=torch.Generator()
                                .manual_seed(4)) * 0.02
    torch.save(oclip, tmp_path / "oclip.pth")
    paths = {"dino_vitb16": str(tmp_path / "dino.pth"),
             "clip_vitb16": str(tmp_path / "clip.pth"),
             "open_clip_vitb16": str(tmp_path / "oclip.pth")}
    tm = T.from_dreamsim_checkpoint(paths, device="cpu")
    jm = J.from_dreamsim_checkpoint(paths)
    for a, b in zip(tm.extractors, jm.extractors):
        assert a.cfg.__dict__ == b.cfg.__dict__
        assert (a.mean, a.std) == (b.mean, b.std)
        _same_tree(a.params, b.params)
    assert "ln_pre" in tm.extractors[1].params
    assert tm.extractors[2].cfg.proj_dim == 16
    img1, img2, _ = _images()
    assert tm.embed(img1).shape == (32 + 16 + 16,)
    assert tm.similarity(img1, img1) == pytest.approx(1.0, abs=1e-5)
    assert tm.similarity(img1, img2) == pytest.approx(
        jm.similarity(img1, img2), abs=PARITY)


def test_from_checkpoints_matches_jax(tmp_path):
    """HF-layout backbones as safetensors directories with their
    ``config.json`` (read for the tower's widths)."""
    from safetensors.torch import save_file

    vit, clip = _hf_vit(5), _hf_clip(6)
    for name, model in (("dino", vit), ("clip", clip)):
        (tmp_path / name).mkdir()
        save_file({k: v.contiguous() for k, v in model.state_dict().items()},
                  str(tmp_path / name / "model.safetensors"))
        model.config.to_json_file(str(tmp_path / name / "config.json"))
    kw = dict(dino_path=str(tmp_path / "dino"),
              clip_path=str(tmp_path / "clip"))
    tm = T.from_checkpoints(device="cpu", **kw)
    jm = J.from_checkpoints(**kw)
    assert [e.cfg.__dict__ for e in tm.extractors] == \
        [e.cfg.__dict__ for e in jm.extractors]
    img1, img2, _ = _images()
    assert tm.similarity(img1, img2) == pytest.approx(
        jm.similarity(img1, img2), abs=PARITY)
    with pytest.raises(ValueError):
        T.from_checkpoints(device="cpu")


def test_dreamsim_wrapper_names_the_substitutes():
    from detikzify_torch.evaluate.dreamsim import DreamSim

    with pytest.raises(ImportError) as err:
        DreamSim()
    assert "DreamSimViT" in str(err.value)
    assert "SigLIPDreamSim" in str(err.value)


def test_siglip_dreamsim_matches_jax():
    import jax

    from detikzify_tpu.config import tiny_test_config
    from detikzify_tpu.evaluate.dreamsim import SigLIPDreamSim as JSim
    from detikzify_tpu.models import detikzify as jdet
    from detikzify_torch.config import tiny_test_config as t_tiny
    from detikzify_torch.evaluate.dreamsim import SigLIPDreamSim as TSim
    from detikzify_torch.models import convert

    cfg = tiny_test_config()
    jp = jdet.init(jax.random.PRNGKey(5), cfg)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp._asdict()),
                                   t_tiny(), device="cpu")
    metrics = [TSim(tp.vision, t_tiny()), JSim(jp.vision, cfg)]
    img1, img2, img3 = _images()
    for m in metrics:
        m.update(img1, img2)
        m.update(img3, img3)
    assert metrics[0].compute() == pytest.approx(metrics[1].compute(),
                                                 abs=1e-4)
