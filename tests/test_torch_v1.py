"""The port's v1 family (LLaVA-style, timm SigLIP tower, feature-layer
tap) against the JAX package, on the CPU (mirrors ``tests/test_v1.py``).

The same numpy state dicts, in the reference's names, go through the JAX
``import_v1`` / ``import_timm_vision`` and the port's: the towers' outputs,
the tapped image tokens and the logits agree within 3e-4 at feature layers
0, 1 and -1 and with the 56 px image whose 16 patches lose their first to
the 3->1 connector. ``sample()`` and greedy ``simulate()`` with the
``FakeBackend`` compiler give the JAX streams, scores and tree, with
SelfSim pinned to ``cos``. A v1 checkpoint written to disk loads through
``load.load_weights`` with its tower.
"""
import concurrent.futures as cf
import json
import random

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image, ImageDraw

from detikzify_tpu.config import VisionConfig, tiny_test_config
from detikzify_tpu.infer import DetikzifyPipeline as JPipeline
from detikzify_tpu.infer import FakeBackend as JFake
from detikzify_tpu.infer import set_backend as j_set_backend
from detikzify_tpu.models import detikzify as jdet
from detikzify_tpu.models import import_hf as jimport
from detikzify_tpu.models import siglip as jsiglip
from detikzify_tpu.processing import ByteTokenizer as JTok
from detikzify_tpu.processing import DetikzifyProcessor as JProc
from detikzify_torch.config import VisionConfig as TVisionConfig
from detikzify_torch.config import tiny_test_config as t_tiny_test_config
from detikzify_torch.infer import DetikzifyPipeline as TPipeline
from detikzify_torch.infer import FakeBackend as TFake
from detikzify_torch.infer import set_backend as t_set_backend
from detikzify_torch.models import detikzify as tdet
from detikzify_torch.models import import_hf as timport
from detikzify_torch.models import load as tload
from detikzify_torch.models import siglip as tsiglip
from detikzify_torch.models.safetensors_io import save_file
from detikzify_torch.processing import ByteTokenizer as TTok
from detikzify_torch.processing import DetikzifyProcessor as TProc

torch.set_num_threads(1)

TOL = 3e-4
VOCAB = 512


def _timm_state(cfg, rng, head: bool = True):
    """Synthetic timm-format SigLIP ViT state dict (numpy)."""
    d, i, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    p, c = cfg.patch_size, cfg.num_channels
    s = {}

    def lin(name, din, dout):
        s[f"{name}.weight"] = rng.standard_normal(
            (dout, din)).astype(np.float32) * 0.05
        s[f"{name}.bias"] = rng.standard_normal(
            (dout,)).astype(np.float32) * 0.01

    def ln(name, dim):
        s[f"{name}.weight"] = 1 + 0.1 * rng.standard_normal(
            (dim,)).astype(np.float32)
        s[f"{name}.bias"] = 0.1 * rng.standard_normal(
            (dim,)).astype(np.float32)

    s["patch_embed.proj.weight"] = rng.standard_normal(
        (d, c, p, p)).astype(np.float32) * 0.05
    s["patch_embed.proj.bias"] = rng.standard_normal(
        (d,)).astype(np.float32) * 0.01
    s["pos_embed"] = rng.standard_normal(
        (1, cfg.num_patches, d)).astype(np.float32) * 0.02
    for idx in range(L):
        ln(f"blocks.{idx}.norm1", d)
        lin(f"blocks.{idx}.attn.qkv", d, 3 * d)
        lin(f"blocks.{idx}.attn.proj", d, d)
        ln(f"blocks.{idx}.norm2", d)
        lin(f"blocks.{idx}.mlp.fc1", d, i)
        lin(f"blocks.{idx}.mlp.fc2", i, d)
    ln("norm", d)
    if head:
        s["attn_pool.latent"] = rng.standard_normal(
            (1, 1, d)).astype(np.float32) * 0.02
        lin("attn_pool.q", d, d)
        lin("attn_pool.kv", d, 2 * d)
        lin("attn_pool.proj", d, d)
        ln("attn_pool.norm", d)
        lin("attn_pool.mlp.fc1", d, i)
        lin("attn_pool.mlp.fc2", i, d)
    return s


def _llama_state(cfg, rng):
    """A v1 checkpoint's LLaMA ``model.*`` keys, ``lm_head`` and the biased
    ``mm_projector`` (numpy)."""
    t = cfg.text
    d, hd = t.hidden_size, t.head_dim
    state = {
        "model.mm_projector.weight": rng.standard_normal(
            (d, cfg.projection_in)).astype(np.float32) * 0.05,
        "model.mm_projector.bias": rng.standard_normal(
            (d,)).astype(np.float32) * 0.01,
        "model.embed_tokens.weight": rng.standard_normal(
            (t.vocab_size, d)).astype(np.float32) * 0.02,
        "model.norm.weight": np.ones((d,), np.float32),
        "lm_head.weight": rng.standard_normal(
            (t.vocab_size, d)).astype(np.float32) * 0.05,
    }
    nq, nkv = t.num_attention_heads * hd, t.num_key_value_heads * hd
    for i in range(t.num_hidden_layers):
        b = f"model.layers.{i}"
        state[f"{b}.input_layernorm.weight"] = np.ones((d,), np.float32)
        state[f"{b}.post_attention_layernorm.weight"] = np.ones(
            (d,), np.float32)
        for n, shp in (("q_proj", (nq, d)), ("k_proj", (nkv, d)),
                       ("v_proj", (nkv, d)), ("o_proj", (d, nq))):
            state[f"{b}.self_attn.{n}.weight"] = rng.standard_normal(
                shp).astype(np.float32) * 0.1
        for n, shp in (("gate_proj", (t.intermediate_size, d)),
                       ("up_proj", (t.intermediate_size, d)),
                       ("down_proj", (d, t.intermediate_size))):
            state[f"{b}.mlp.{n}.weight"] = rng.standard_normal(
                shp).astype(np.float32) * 0.1
    return state


def _torch(state):
    return {k: torch.from_numpy(v) for k, v in state.items()}


def _v1_cfgs(feature_layer=0, image_size=42):
    base = tiny_test_config(vocab_size=VOCAB)
    kw = dict(feature_layer=feature_layer, projector_bias=True, is_v1=True,
              pooling_mode="cos")
    cfg = base.replace(vision=base.vision.replace(image_size=image_size),
                       **kw)
    tbase = t_tiny_test_config(vocab_size=VOCAB)
    tcfg = tbase.replace(vision=tbase.vision.replace(image_size=image_size),
                         **kw)
    assert cfg.to_dict() == tcfg.to_dict()
    return cfg, tcfg


def _imported(cfg, tcfg, seed):
    rng = np.random.default_rng(seed)
    vstate, state = _timm_state(cfg.vision, rng), _llama_state(cfg, rng)
    jp = jimport.import_v1(state, vstate, cfg, dtype=jnp.float32)
    tp = timport.import_v1(_torch(state), _torch(vstate), tcfg,
                           dtype=torch.float32)
    return jp, tp, state, vstate


def _pixels(cfg, seed):
    size = getattr(cfg, "vision", cfg).image_size
    return np.random.default_rng(seed).standard_normal(
        (2, size, size, 3)).astype(np.float32)


# ---------------------------------------------------------------------------
# the tower and the tap
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("head", [True, False])
def test_import_timm_vision_matches_jax(head):
    cfg = VisionConfig(hidden_size=48, intermediate_size=96,
                       num_hidden_layers=2, num_attention_heads=4,
                       image_size=42, patch_size=14)
    tcfg = TVisionConfig(**{k: v for k, v in cfg.to_dict().items()
                            if k != "__class__"})
    state = _timm_state(cfg, np.random.default_rng(0), head=head)
    jv = jimport.import_timm_vision(state, cfg, dtype=jnp.float32)
    tv = tsiglip.SiglipVision(tcfg, device="meta")
    timport.import_timm_vision(_torch(state), tv, tcfg, dtype=torch.float32)
    assert (tv.head is None) == (not head)
    pix = _pixels(cfg, 1)
    want = jsiglip.apply(jv, cfg, jnp.asarray(pix), attn_impl="xla",
                         output_hidden_states=True)
    got = tsiglip.apply(tv, tcfg, torch.from_numpy(pix),
                        output_hidden_states=True)
    for key in ("last_hidden_state", "pooler_output"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=TOL, rtol=TOL)
    assert len(got["hidden_states"]) == cfg.num_hidden_layers
    for i, h in enumerate(got["hidden_states"]):
        np.testing.assert_allclose(h.numpy(),
                                   np.asarray(want["hidden_states"][i]),
                                   atol=TOL, rtol=TOL)


def test_hidden_state_stops_at_the_tapped_layer():
    _, tcfg = _v1_cfgs()
    _, tp, _, _ = _imported(*_v1_cfgs(), seed=2)
    pix = torch.from_numpy(_pixels(tcfg, 3))
    every = tsiglip.apply(tp.vision, tcfg.vision, pix,
                          output_hidden_states=True)["hidden_states"]
    assert "hidden_states" not in tsiglip.apply(tp.vision, tcfg.vision, pix)
    for layer in (0, 1, -1, -2):
        assert torch.equal(tsiglip.hidden_state(tp.vision, tcfg.vision, pix,
                                                layer), every[layer])
    for layer in (2, -3):
        with pytest.raises(IndexError):
            tsiglip.hidden_state(tp.vision, tcfg.vision, pix, layer)


@pytest.mark.parametrize("size", [42, 48, 384])
def test_patchify_drops_the_remainder_like_the_conv(size):
    """The patch embedding equals a torch ``Conv2d`` of stride 14 (the
    reference's, and timm's), which drops the pixels past the last whole
    patch: 384 px gives 27 x 27 = 729 patches, as the v1 tower has."""
    g = torch.Generator().manual_seed(size)
    d, p = 8, 14
    pix = torch.randn(2, size, size, 3, generator=g)
    conv_w = torch.randn(d, 3, p, p, generator=g)
    want = torch.nn.functional.conv2d(pix.permute(0, 3, 1, 2), conv_w,
                                      stride=p)
    want = want.flatten(2).transpose(1, 2)              # [B, N, D]
    got = tsiglip.patchify(pix, p) @ conv_w.reshape(d, -1).t()
    assert got.shape == want.shape == (2, (size // p) ** 2, d)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    if size % p == 0:         # where the JAX package's patchify is defined
        np.testing.assert_array_equal(
            tsiglip.patchify(pix, p).numpy(),
            np.asarray(jsiglip.patchify(jnp.asarray(pix.numpy()), p)))


@pytest.mark.parametrize("feature_layer", [0, 1, -1])
def test_v1_encode_image_and_logits_match_jax(feature_layer):
    cfg, tcfg = _v1_cfgs(feature_layer)
    jp, tp, _, _ = _imported(cfg, tcfg, seed=4)
    assert tp.connector.proj.bias is not None
    pix = _pixels(cfg, 5)
    want = np.asarray(jdet.encode_image(jp, cfg, jnp.asarray(pix),
                                        attn_impl="xla"))
    with torch.no_grad():
        got = tdet.encode_image(tp, tcfg, torch.from_numpy(pix)).numpy()
    assert got.shape == (2, cfg.image_seq_len, cfg.text.hidden_size)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)

    ids = np.full((2, cfg.image_seq_len + 3), cfg.image_token_id, np.int32)
    ids[:, cfg.image_seq_len:] = [cfg.bos_token_id, 5, 6]
    jl, _ = jdet.forward(jp, cfg, jnp.asarray(ids), jnp.asarray(pix),
                         attn_impl="xla")
    with torch.no_grad():
        tl, _ = tdet.forward(tp, tcfg, torch.from_numpy(ids),
                             torch.from_numpy(pix))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                               rtol=TOL)


def test_v1_front_truncation_matches_jax():
    """16 patches with concat 3: image_seq_len 5, the first patch dropped
    (reference v1:132-137); another tap gives other features."""
    cfg, tcfg = _v1_cfgs(0, image_size=56)
    assert cfg.image_seq_len == tcfg.image_seq_len == 5
    jp, tp, _, _ = _imported(cfg, tcfg, seed=6)
    pix = _pixels(cfg, 7)
    want = np.asarray(jdet.vision_features(jp, cfg, jnp.asarray(pix),
                                           attn_impl="xla"))
    with torch.no_grad():
        got = tdet.vision_features(tp, tcfg, torch.from_numpy(pix))
        full = tsiglip.hidden_state(tp.vision, tcfg.vision,
                                    torch.from_numpy(pix), 0)
        emb = tdet.encode_image(tp, tcfg, torch.from_numpy(pix))
        emb1 = tdet.encode_image(tp, tcfg.replace(feature_layer=1),
                                 torch.from_numpy(pix))
    assert tuple(got.shape) == (2, 15, cfg.vision.hidden_size)
    assert full.shape[1] == 16
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    assert tuple(emb.shape) == (2, 5, cfg.text.hidden_size)
    assert float((emb - emb1).abs().max()) > 1e-5


def test_v1_checkpoint_loads_from_disk(tmp_path):
    """A v1 checkpoint and its tower written in the reference's names load
    through ``load_weights`` with ``vision_tower=`` to the imported
    weights; the tower's preprocessor stats reach the processor half."""
    cfg, tcfg = _v1_cfgs(1)
    jp, _, state, vstate = _imported(cfg, tcfg, seed=8)
    ckpt, tower = tmp_path / "ckpt", tmp_path / "tower"
    ckpt.mkdir()
    tower.mkdir()
    save_file(_torch(state), str(ckpt / "model.safetensors"))
    save_file(_torch(vstate), str(tower / "model.safetensors"))
    with open(tower / "preprocessor_config.json", "w") as f:
        json.dump({"image_mean": [0.5, 0.5, 0.5],
                   "image_std": [0.25, 0.25, 0.25]}, f)
    with pytest.raises(ValueError, match="vision_tower"):
        tload.load_weights(str(ckpt), tcfg, device="cpu")
    tp = tload.load_weights(str(ckpt), tcfg, dtype=torch.float32,
                            vision_tower=str(tower), device="cpu")
    assert tload._image_stats(str(tower)) == ([0.5] * 3, [0.25] * 3)
    pix = _pixels(cfg, 9)
    want = np.asarray(jdet.encode_image(jp, cfg, jnp.asarray(pix),
                                        attn_impl="xla"))
    with torch.no_grad():
        got = tdet.encode_image(tp, tcfg, torch.from_numpy(pix)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_v1_config_json_needs_the_tower(tmp_path):
    hf = {"architectures": ["DetikzifyForCausalLM"], "vocab_size": VOCAB,
          "patch_token_id": VOCAB - 3, "feature_layer": 25}
    with open(tmp_path / "config.json", "w") as f:
        json.dump(hf, f)
    with pytest.raises(ValueError, match="vision_tower"):
        tload.load_params(str(tmp_path), device="cpu")
    cfg = timport.config_from_hf_json(str(tmp_path / "config.json"))
    assert cfg.is_v1 and cfg.feature_layer == 25
    assert cfg.vision.num_patches == 729 and cfg.image_seq_len == 243


# ---------------------------------------------------------------------------
# the inference stack on v1
# ---------------------------------------------------------------------------

def _figure():
    img = Image.new("RGB", (80, 60), "white")
    d = ImageDraw.Draw(img)
    d.rectangle([5, 5, 75, 55], outline="black", width=2)
    d.ellipse([20, 15, 60, 45], outline="red", width=2)
    return img


@pytest.fixture(scope="module")
def v1_pipes():
    """JAX and port pipelines on the same imported v1 weights: greedy,
    8 slots, SelfSim from the model (which v1 pins to cos)."""
    j_set_backend(JFake())
    t_set_backend(TFake())
    cfg, tcfg = _v1_cfgs(0)
    jp, tp, _, _ = _imported(cfg, tcfg, seed=10)

    def tok(cls, c):
        return cls(vocab_size=VOCAB, image_token_id=c.image_token_id,
                   bos_token_id=c.bos_token_id, eos_token_id=c.eos_token_id,
                   model_max_length=96)

    jproc = JProc(tok(JTok, cfg), cfg)
    tproc = TProc(tok(TTok, tcfg), tcfg)
    # cut a line at every third token id in both packages, so that the
    # search grows a tree of several levels
    for proc in (jproc, tproc):
        proc.tokenizer._detikzify_newline_table = {
            i: (1, True) for i in range(0, VOCAB, 3)}
    kw = dict(num_slots=8, max_len=96, temperature=0.0, metric="model")
    jpipe = JPipeline(jp, cfg, jproc, **kw)
    tpipe = TPipeline(tp, tcfg, tproc, device="cpu", **kw)
    dispatch = jpipe.metric.score_against_async

    def ready_dispatch(*a, **k):       # results ready before the next check
        dev, n = dispatch(*a, **k)
        return jax.block_until_ready(dev), n

    jpipe.metric.score_against_async = ready_dispatch
    for pipe in (jpipe, tpipe):
        def submit_doc(doc):
            doc.compile()
            fut = cf.Future()
            fut.set_result(doc)
            return fut

        pipe.compiler.submit_doc = submit_doc
    yield jpipe, tpipe
    tpipe.close()
    j_set_backend(None)
    t_set_backend(None)


def test_v1_metric_resolves_to_cos(v1_pipes):
    jpipe, tpipe = v1_pipes
    assert tpipe.metric.mode == jpipe.metric.mode == "cos"


def test_v1_sample_matches_jax(v1_pipes):
    jpipe, tpipe = v1_pipes
    want = jpipe.sample(image=_figure(), max_new_tokens=24)
    got = tpipe.sample(image=_figure(), max_new_tokens=24)
    assert got.code == want.code
    batch = [d.code for d in tpipe.sample_batch([_figure()] * 2,
                                                max_new_tokens=12)]
    assert batch == [d.code for d in jpipe.sample_batch([_figure()] * 2,
                                                        max_new_tokens=12)]
    eng = tpipe.engine
    assert eng.num_active == 0 and eng.num_free_slots == eng.num_slots


def _tree(node):
    return (len(node.token_ids), node.is_widen_node, node.visits,
            tuple(_tree(c) for c in node.children))


@pytest.mark.parametrize("parallelism", [1, 8])
def test_v1_simulate_matches_jax(v1_pipes, parallelism):
    runs = []
    for pipe in v1_pipes:
        random.seed(0)                      # UCT ties break at random
        gen = pipe.generator(image=_figure(), metric=pipe.metric,
                             max_new_tokens=24)
        try:
            out = list(gen.simulate(8, parallelism=parallelism))
            runs.append(([sc for sc, _ in out], [d.code for _, d in out],
                         _tree(gen.root)))
        finally:
            gen.close()
    (jscores, jcodes, jtree), (tscores, tcodes, ttree) = runs
    assert len(tcodes) == 8 and tcodes == jcodes
    np.testing.assert_allclose(tscores, jscores, rtol=0, atol=1e-4)
    assert ttree == jtree
    assert any(sc > -1 for sc in tscores)   # some renders were scored
