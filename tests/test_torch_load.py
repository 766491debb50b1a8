"""The port's checkpoint IO (``models/import_hf.py``, ``models/load.py``,
``models/safetensors_io.py``) against the JAX package, on the CPU.

The safetensors format is held against the ``safetensors`` package (the
port's writer read by it, and its files and the JAX package's read by the
port). Checkpoints go both ways at ``tiny-test`` in fp32: one written by
the JAX ``save_pretrained`` and loaded by the port gives the JAX logits
within 3e-4 and the same greedy tokens; the port's export has the JAX
export's keys, shapes and values and loads in the JAX package. An int8
load matches the JAX package's bit for bit. The small parts mirror
``tests/test_load.py``.
"""
import dataclasses
import json
import os
import struct

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from detikzify_tpu.config import tiny_test_config
from detikzify_tpu.models import detikzify as jdet
from detikzify_tpu.models import import_hf as jimport
from detikzify_tpu.models import load as jload
from detikzify_tpu.ops import quant as jquant
from detikzify_torch.config import tiny_test_config as t_tiny_test_config
from detikzify_torch.models import convert
from detikzify_torch.models import detikzify as tdet
from detikzify_torch.models import import_hf as timport
from detikzify_torch.models import load as tload
from detikzify_torch.models import safetensors_io
from detikzify_torch.ops.quant import QuantLinear, fuse_projections

torch.set_num_threads(1)

TOL = 3e-4


@pytest.fixture(scope="module")
def model():
    """(JAX cfg, JAX fp32 params, port cfg, the same weights in the
    port)."""
    cfg = tiny_test_config(vocab_size=512)
    jp = jdet.init(jax.random.PRNGKey(11), cfg)
    tcfg = t_tiny_test_config(vocab_size=512)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp._asdict()),
                                   tcfg, device="cpu")
    return cfg, jp, tcfg, tp


@pytest.fixture(scope="module")
def jax_ckpt(model, tmp_path_factory):
    cfg, jp, _, _ = model
    path = str(tmp_path_factory.mktemp("jax") / "ckpt")
    jload.save_pretrained(path, jp, cfg)
    return path


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    ids = np.full((1, cfg.image_seq_len + 4), cfg.image_token_id, np.int32)
    ids[0, cfg.image_seq_len:] = [cfg.bos_token_id, 5, 6, 7]
    pix = rng.standard_normal((1, cfg.vision.image_size,
                               cfg.vision.image_size, 3)).astype(np.float32)
    return ids, pix


def _jlogits(jp, cfg, ids, pix):
    return np.asarray(jdet.forward(jp, cfg, jnp.asarray(ids),
                                   jnp.asarray(pix), attn_impl="xla")[0])


def _tlogits(tp, tcfg, ids, pix):
    with torch.no_grad():
        return tdet.forward(tp, tcfg, torch.from_numpy(ids),
                            torch.from_numpy(pix))[0].numpy()


def _greedy(logits_fn, cfg, steps=8):
    """Greedy tokens from repeated full forwards (the image prompt, then
    each argmax appended)."""
    ids, pix = _inputs(cfg, 1)
    out = []
    for _ in range(steps):
        tok = int(logits_fn(ids, pix)[0, -1].argmax())
        out.append(tok)
        ids = np.concatenate([ids, [[tok]]], axis=1).astype(np.int32)
    return out


def _tokenizer_dir(path, cfg):
    """A word-level HF tokenizer saved into ``path`` (as test_load.py)."""
    transformers = pytest.importorskip("transformers")
    from tokenizers import Tokenizer, models, pre_tokenizers

    vocab = {f"tok{i}": i for i in range(120)}
    vocab.update({"<s>": cfg.bos_token_id, "</s>": cfg.eos_token_id,
                  "<image>": cfg.image_token_id, "<pad>": 120})
    tok = Tokenizer(models.WordLevel(vocab, unk_token="tok0"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    transformers.PreTrainedTokenizerFast(
        tokenizer_object=tok, bos_token="<s>", eos_token="</s>",
        pad_token="<pad>", model_max_length=96).save_pretrained(path)


# ---------------------------------------------------------------------------
# the safetensors format
# ---------------------------------------------------------------------------

def _tensors():
    g = torch.Generator().manual_seed(0)
    return {
        "f32": torch.randn(3, 5, generator=g),
        "f16": torch.randn(7, generator=g).half(),
        "bf16": torch.randn(4, 6, generator=g).to(torch.bfloat16),
        "i8": torch.randint(-127, 128, (5, 3), generator=g,
                            dtype=torch.int8),
        "i32": torch.arange(6, dtype=torch.int32).reshape(2, 3),
        "i64": torch.arange(3, dtype=torch.int64) - 1,
        "u8": torch.arange(9, dtype=torch.uint8),
        "bool": torch.tensor([True, False, True]),
        "scalar": torch.tensor(2.5),
        "empty": torch.zeros(0, 4),
    }


@pytest.mark.parametrize("reader", ["torch", "numpy"])
def test_writer_read_by_safetensors(tmp_path, reader):
    from safetensors import safe_open

    ts = _tensors()
    path = str(tmp_path / "x.safetensors")
    nbytes = safetensors_io.save_file(ts, path)
    assert nbytes == os.path.getsize(path)
    with safe_open(path, framework="pt" if reader == "torch" else "np") as f:
        assert set(f.keys()) == set(ts)
        for k, want in ts.items():
            got = f.get_tensor(k)
            if reader == "numpy":
                # numpy reads BF16 as ml_dtypes' bfloat16: compare its bits
                got = np.asarray(got)
                if k == "bf16":
                    got = got.view(np.uint16)
                    want = want.view(torch.uint16)
                got = torch.from_numpy(got)
            assert got.dtype == want.dtype and torch.equal(got, want), k


def test_reader_reads_safetensors_files(tmp_path):
    """Files of the safetensors package, a ``__metadata__`` entry
    included."""
    from safetensors.torch import save_file

    ts = _tensors()
    path = str(tmp_path / "x.safetensors")
    save_file(ts, path, metadata={"format": "pt"})
    got = safetensors_io.load_file(path)
    assert set(got) == set(ts)
    for k, want in ts.items():
        assert got[k].dtype == want.dtype and torch.equal(got[k], want), k


def test_bf16_and_int8_round_trip_bit_exact(tmp_path):
    g = torch.Generator().manual_seed(1)
    ts = {"w": torch.randn(64, 48, generator=g).to(torch.bfloat16),
          "q": torch.randint(-127, 128, (48, 64), generator=g,
                             dtype=torch.int8)}
    path = str(tmp_path / "x.safetensors")
    safetensors_io.save_file(ts, path)
    got = safetensors_io.load_file(path)
    assert torch.equal(got["w"].view(torch.int16), ts["w"].view(torch.int16))
    assert torch.equal(got["q"], ts["q"])
    # the tensors view the file's mapping; writing to them leaves the file
    got["q"].zero_()
    assert torch.equal(safetensors_io.load_file(path)["q"], ts["q"])


def test_reader_copies_an_unaligned_tensor(tmp_path):
    """A 3-byte U8 tensor first puts the F32 and I64 tensors at offsets
    that are not multiples of their element size."""
    f32 = np.arange(5, dtype=np.float32) * 1.25
    i64 = np.array([-3, 1 << 40], np.int64)
    header = {"u8": {"dtype": "U8", "shape": [3], "data_offsets": [0, 3]},
              "f32": {"dtype": "F32", "shape": [5], "data_offsets": [3, 23]},
              "i64": {"dtype": "I64", "shape": [2],
                      "data_offsets": [23, 39]}}
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    path = str(tmp_path / "x.safetensors")
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)) + blob + bytes([7, 8, 9])
                + f32.tobytes() + i64.tobytes())
    got = safetensors_io.load_file(path)
    assert got["u8"].tolist() == [7, 8, 9]
    np.testing.assert_array_equal(got["f32"].numpy(), f32)
    np.testing.assert_array_equal(got["i64"].numpy(), i64)


def test_reader_merges_two_shards(tmp_path):
    from safetensors.numpy import save_file

    a = {"model.a": np.arange(4, dtype=np.float32)}
    b = {"model.b": np.ones((2, 2), np.int32)}
    save_file(a, str(tmp_path / "model-00001-of-00002.safetensors"))
    save_file(b, str(tmp_path / "model-00002-of-00002.safetensors"))
    with open(tmp_path / "model.safetensors.index.json", "w") as f:
        json.dump({"weight_map": {"model.a": "model-00001-of-00002."
                                  "safetensors", "model.b": "model-00002-"
                                  "of-00002.safetensors"}}, f)
    got = timport.load_state_dict_from_safetensors(str(tmp_path))
    assert set(got) == {"model.a", "model.b"}
    np.testing.assert_array_equal(got["model.a"].numpy(), a["model.a"])
    np.testing.assert_array_equal(got["model.b"].numpy(), b["model.b"])
    one = timport.load_state_dict_from_safetensors(
        str(tmp_path / "model-00002-of-00002.safetensors"))
    assert set(one) == {"model.b"}
    with pytest.raises(FileNotFoundError):
        timport.load_state_dict_from_safetensors(str(tmp_path / "none"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reader_reads_jax_export(model, tmp_path, dtype):
    from safetensors.numpy import load_file

    cfg, jp, _, _ = model
    jp = jax.tree.map(lambda x: x.astype(dtype), jp)
    path = str(tmp_path / "ckpt")
    jload.save_pretrained(path, jp, cfg)
    want = load_file(f"{path}/model.safetensors")
    got = timport.load_state_dict_from_safetensors(path)
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if dtype == "bfloat16":
            assert g.dtype == torch.bfloat16
            g, w = g.view(torch.int16), np.asarray(w).view(np.int16)
        np.testing.assert_array_equal(g.numpy(), w)


# ---------------------------------------------------------------------------
# checkpoints across the two packages
# ---------------------------------------------------------------------------

def test_jax_export_loads_in_port(model, jax_ckpt):
    cfg, jp, _, _ = model
    tp, tcfg = tload.load_params(jax_ckpt, dtype=torch.float32,
                                 device="cpu")
    assert tcfg.to_dict() == jimport.config_from_hf_json(
        f"{jax_ckpt}/config.json").to_dict()
    ids, pix = _inputs(cfg)
    np.testing.assert_allclose(_tlogits(tp, tcfg, ids, pix),
                               _jlogits(jp, cfg, ids, pix),
                               atol=TOL, rtol=TOL)
    assert _greedy(lambda i, p: _tlogits(tp, tcfg, i, p), cfg) == \
        _greedy(lambda i, p: _jlogits(jp, cfg, i, p), cfg)


def test_load_weights_views_the_file_in_its_dtype(jax_ckpt, model):
    """Weights in the file's own dtype are not copied on the host: the
    parameters view the file's mapping."""
    _, _, tcfg, _ = model
    tp = tload.load_weights(jax_ckpt, tcfg, dtype=torch.float32,
                            device="cpu")
    state = timport.load_state_dict_from_safetensors(jax_ckpt)
    w = tp.text.layers[0].mlp.down.weight
    assert not w.untyped_storage().resizable()     # a mapping, not the heap
    np.testing.assert_array_equal(
        w.numpy(), state["model.text_model.layers.0.mlp.down_proj.weight"])
    assert tp.dtype == torch.float32 and not w.requires_grad


def test_port_export_matches_jax_export(model, jax_ckpt, tmp_path):
    from safetensors.numpy import load_file

    cfg, jp, tcfg, tp = model
    path = str(tmp_path / "port")
    nbytes = tload.save_pretrained(path, tp, tcfg)
    assert nbytes == os.path.getsize(f"{path}/model.safetensors")
    got = load_file(f"{path}/model.safetensors")
    want = load_file(f"{jax_ckpt}/model.safetensors")
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with open(f"{path}/config.json") as f, \
            open(f"{jax_ckpt}/config.json") as g:
        assert json.load(f) == json.load(g)
    # and the JAX package loads it
    cfg2 = jimport.config_from_hf_json(f"{path}/config.json")
    jp2 = jimport.import_detikzify(
        jimport.load_state_dict_from_safetensors(path), cfg2,
        dtype=jnp.float32)
    ids, pix = _inputs(cfg)
    np.testing.assert_allclose(_jlogits(jp2, cfg2, ids, pix),
                               _tlogits(tp, tcfg, ids, pix),
                               atol=TOL, rtol=TOL)


def test_export_writes_bf16_in_its_dtype(model, tmp_path):
    from safetensors.torch import load_file

    _, _, tcfg, tp = model
    tb = tp.to(torch.bfloat16)
    try:
        tload.save_pretrained(str(tmp_path), tb, tcfg)
        got = load_file(str(tmp_path / "model.safetensors"))
        w = got["model.text_model.layers.1.self_attn.k_proj.weight"]
        assert w.dtype == torch.bfloat16
        assert torch.equal(w, tb.text.layers[1].attn.k.weight)
    finally:
        tp.to(torch.float32)


def test_export_refuses_int8_and_fused(model, tmp_path):
    _, jp, tcfg, _ = model
    tree = jax.tree.map(np.asarray, jp._asdict())
    fused = fuse_projections(convert.params_from_numpy(tree, tcfg,
                                                       device="cpu"))
    with pytest.raises(ValueError, match="fused"):
        tload.save_pretrained(str(tmp_path / "a"), fused, tcfg)
    q = convert.params_from_numpy(
        jax.tree.map(np.asarray, jquant.quantize_params(jp)._asdict()),
        tcfg, device="cpu")
    with pytest.raises(ValueError, match="QuantLinear"):
        tload.save_pretrained(str(tmp_path / "b"), q, tcfg)


def test_quantized_load_matches_jax(model, jax_ckpt, tmp_path):
    """``load_params(quantize=True)`` against the JAX ``load(quantize=
    True)``: every int8 ``q`` equal, every ``scale`` bit-identical, the
    rest in the requested dtype."""
    cfg, _, _, _ = model
    _tokenizer_dir(jax_ckpt, cfg)
    jparams, _, _ = jload.load(jax_ckpt, quantize=True)
    tp, _ = tload.load_params(jax_ckpt, quantize=True, device="cpu")
    jt = jax.tree.map(np.asarray, jparams._asdict())
    pairs = [(tp.text.lm_head, jt["text"]["lm_head"]),
             (tp.vision.head.attn.q, jt["vision"]["head"]["attn"]["q"])]
    for i in range(len(tp.text.layers)):
        for name in ("q", "k", "v", "o"):
            pairs.append((getattr(tp.text.layers[i].attn, name),
                          _layer(jt["text"]["layers"]["attn"][name], i)))
        for name in ("gate", "up", "down"):
            pairs.append((getattr(tp.text.layers[i].mlp, name),
                          _layer(jt["text"]["layers"]["mlp"][name], i)))
        pairs.append((tp.vision.layers[i].mlp.fc1,
                      _layer(jt["vision"]["layers"]["mlp"]["fc1"], i)))
    for lin, leaf in pairs:
        assert isinstance(lin, QuantLinear)
        np.testing.assert_array_equal(lin.q.numpy(),
                                      leaf["kernel_q"]["q"].T)
        np.testing.assert_array_equal(lin.scale.numpy().view(np.int32),
                                      leaf["kernel_q"]["scale"]
                                      .view(np.int32))
    # 7 projections a text layer, 6 a vision layer, the MAP head's 6, and
    # the lm_head
    n_quant = sum(isinstance(m, QuantLinear) for m in tp.modules())
    assert n_quant == 2 * 7 + 2 * 6 + 6 + 1
    assert tp.text.embed_tokens.dtype == torch.bfloat16


def _layer(tree, i):
    return jax.tree.map(lambda x: x[i], tree)


def test_lm_head_absent_takes_embed_tokens(model, tmp_path):
    """Untied embeddings and no ``lm_head.weight``: the head is
    ``embed_tokens``, as in the JAX importer."""
    from safetensors.numpy import load_file, save_file

    cfg, jp, tcfg, _ = model
    path = str(tmp_path)
    jload.save_pretrained(path, jp, cfg)
    state = load_file(f"{path}/model.safetensors")
    del state["lm_head.weight"]
    save_file(state, f"{path}/model.safetensors")
    tp, _ = tload.load_params(path, dtype=torch.float32, device="cpu")
    assert torch.equal(tp.text.lm_head.weight, tp.text.embed_tokens)
    jp2 = jimport.import_detikzify(jimport.load_state_dict_from_safetensors(
        path), cfg, dtype=jnp.float32)
    ids, pix = _inputs(cfg)
    np.testing.assert_allclose(_tlogits(tp, tcfg, ids, pix),
                               _jlogits(jp2, cfg, ids, pix),
                               atol=TOL, rtol=TOL)


def test_import_unnested_prefix_and_strict(model, jax_ckpt):
    """Keys under ``model.vision_model.*`` (no nested tower) load too; a
    key that maps to nothing is refused unless ``strict=False``; an
    ``adapter.*`` subtree is left alone."""
    cfg, jp, tcfg, _ = model
    state = {k.replace("vision_model.vision_model", "vision_model"): v
             for k, v in timport.load_state_dict_from_safetensors(
                 jax_ckpt).items()}
    tp = timport.import_detikzify(state, tcfg, dtype=torch.float32)
    ids, pix = _inputs(cfg)
    np.testing.assert_allclose(_tlogits(tp, tcfg, ids, pix),
                               _jlogits(jp, cfg, ids, pix),
                               atol=TOL, rtol=TOL)
    extra = dict(state, **{"model.stray.weight": torch.zeros(2),
                           "adapter.layers.0.x": torch.zeros(1)})
    with pytest.raises(ValueError, match="unmapped"):
        timport.import_detikzify(extra, tcfg, dtype=torch.float32)
    timport.import_detikzify(extra, tcfg, dtype=torch.float32, strict=False)
    del state["model.text_model.norm.weight"]
    with pytest.raises(KeyError):
        timport.import_detikzify(state, tcfg, dtype=torch.float32)


def test_headless_tower_loads_as_mean_pooling(model, jax_ckpt):
    cfg, jp, tcfg, _ = model
    state = {k: v for k, v in timport.load_state_dict_from_safetensors(
        jax_ckpt).items() if ".head." not in k}
    tp = timport.import_detikzify(state, tcfg, dtype=torch.float32)
    assert tp.vision.head is None
    jstate = {k: v for k, v in jimport.load_state_dict_from_safetensors(
        jax_ckpt).items() if ".head." not in k}
    jp2 = jimport.import_detikzify(jstate, cfg, dtype=jnp.float32)
    from detikzify_tpu.models import siglip as jsiglip
    from detikzify_torch.models import siglip as tsiglip

    _, pix = _inputs(cfg)
    want = jsiglip.apply(jp2.vision, cfg.vision, jnp.asarray(pix),
                         attn_impl="xla")["pooler_output"]
    got = tsiglip.apply(tp.vision, tcfg.vision,
                        torch.from_numpy(pix))["pooler_output"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

V2_HF = {
    "architectures": ["DetikzifyForConditionalGeneration"],
    "image_token_id": 128005, "pad_token_id": 128004, "concat_factor": 3,
    "vision_config": {"hidden_size": 1152, "num_hidden_layers": 27,
                      "image_size": 420},
    "text_config": {"vocab_size": 128256, "num_key_value_heads": 8,
                    "rope_scaling": {"rope_type": "llama3", "factor": 8.0,
                                     "low_freq_factor": 1.0,
                                     "high_freq_factor": 4.0,
                                     "original_max_position_embeddings":
                                         8192},
                    "bos_token_id": 128000, "eos_token_id": 128001},
}
V1_HF = {
    "architectures": ["DetikzifyForCausalLM"],
    "vocab_size": 32002, "hidden_size": 2048, "intermediate_size": 5632,
    "num_hidden_layers": 22, "num_attention_heads": 32,
    "num_key_value_heads": 4, "patch_token_id": 32000, "concat_patches": 3,
    "feature_layer": 25, "rope_theta": 10000.0, "pad_token_id": None,
}


@pytest.mark.parametrize("hf", [V2_HF, V1_HF, {"patch_token_id": 7},
                                {}], ids=["v2", "v1", "v1-bare", "empty"])
def test_config_from_hf_json_matches_jax(hf):
    got = timport.config_from_hf_json(hf)
    want = jimport.config_from_hf_json(hf)
    assert got.to_dict() == want.to_dict()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_config_json_round_trip_matches_jax(jax_ckpt, model):
    cfg = model[0]
    path = f"{jax_ckpt}/config.json"
    got = timport.config_from_hf_json(path)
    assert got.to_dict() == jimport.config_from_hf_json(path).to_dict()
    # every field config.json carries survives (dtype and model_max_length
    # are not written, in either package)
    assert dataclasses.replace(got, dtype=cfg.dtype, model_max_length=cfg.
                               model_max_length).to_dict() == cfg.to_dict()
    assert got.pooling_mode == "cos"


# ---------------------------------------------------------------------------
# the small parts (mirrored from tests/test_load.py)
# ---------------------------------------------------------------------------

def test_registry_and_resolve(tmp_path, monkeypatch):
    tload.register("my-model", str(tmp_path))
    try:
        assert tload._resolve("my-model") == str(tmp_path)
    finally:
        del tload.MODEL_REGISTRY["my-model"]
    for name in ("detikzify-v2.5-8b", "detikzify-v2-8b",
                 "detikzify-ds-1.3b", "detikzify-ds-7b",
                 "detikzify-tl-1.1b", "detikzify-cl-7b"):
        assert tload.MODEL_REGISTRY[name] == jload.MODEL_REGISTRY[name]
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    with pytest.raises(FileNotFoundError):
        tload._resolve("nonexistent/model")
    snaps = tmp_path / "hf" / "hub" / "models--org--name" / "snapshots"
    for rev in ("aaa", "bbb"):
        (snaps / rev).mkdir(parents=True)
    assert tload._resolve("org/name") == str(snaps / "bbb") == \
        jload._resolve("org/name")


@pytest.mark.parametrize("content", [None, {"image_mean": [0.4, 0.4, 0.4],
                                            "image_std": [0.2, 0.2, 0.2]},
                                     {"image_std": [0.3] * 3}, {"x": 1}])
def test_image_stats_match_jax(tmp_path, content):
    if content is not None:
        with open(tmp_path / "preprocessor_config.json", "w") as f:
            json.dump(content, f)
    assert tload._image_stats(str(tmp_path)) == \
        jload._image_stats(str(tmp_path))


@pytest.mark.parametrize("content", [None, {"model_expects_text": True},
                                     {"image_seq_len": 3}])
def test_processor_expects_text_matches_jax(tmp_path, content):
    if content is not None:
        with open(tmp_path / "processor_config.json", "w") as f:
            json.dump(content, f)
    assert tload._processor_expects_text(str(tmp_path)) == \
        jload._processor_expects_text(str(tmp_path))


@pytest.mark.parametrize("kind", ["npz", "safetensors"])
def test_projector_overlay_matches_jax(model, jax_ckpt, tmp_path, kind):
    from safetensors.numpy import save_file

    cfg, _, tcfg, _ = model
    rng = np.random.default_rng(5)
    kernel = rng.standard_normal((cfg.projection_in,
                                  cfg.text.hidden_size)).astype(np.float32)
    if kind == "npz":
        proj = str(tmp_path / "proj.npz")
        np.savez(proj, **{"proj/kernel": kernel})
    else:
        proj = str(tmp_path / "proj.safetensors")
        save_file({"modality_projection.proj.weight":
                   np.ascontiguousarray(kernel.T)}, proj)
    tp, _ = tload.load_params(jax_ckpt, dtype=torch.float32, device="cpu",
                              modality_projector=proj)
    np.testing.assert_array_equal(tp.connector.proj.weight.numpy(),
                                  kernel.T)
    assert tp.connector.proj.bias is None
    jp = jload._overlay_projector(jimport.import_detikzify(
        jimport.load_state_dict_from_safetensors(jax_ckpt), cfg,
        dtype=jnp.float32), proj, jnp.float32)
    ids, pix = _inputs(cfg)
    np.testing.assert_allclose(_tlogits(tp, tcfg, ids, pix),
                               _jlogits(jp, cfg, ids, pix),
                               atol=TOL, rtol=TOL)


def test_full_load_with_tokenizer_matches_jax(model, tmp_path):
    """load(): config, weights and a word-level HF tokenizer directory;
    the processor lays out prompts as the JAX one does."""
    cfg, jp, _, _ = model
    path = str(tmp_path / "ckpt")
    jload.save_pretrained(path, jp, cfg)
    _tokenizer_dir(path, cfg)
    with open(f"{path}/preprocessor_config.json", "w") as f:
        json.dump({"image_mean": [0.4, 0.4, 0.4],
                   "image_std": [0.2, 0.2, 0.2]}, f)
    tp, tcfg, tproc = tload.load(path, dtype=torch.float32, device="cpu")
    jp2, jcfg, jproc = jload.load(path, dtype=jnp.float32)
    assert tcfg.to_dict() == jcfg.to_dict()
    assert tproc.image_mean == jproc.image_mean == [0.4, 0.4, 0.4]
    assert tproc.model_expects_text == jproc.model_expects_text
    from PIL import Image

    img = Image.new("RGB", (42, 42), "white")
    got = tproc(images=img, text="tok1 tok2", add_bos_token=True)
    want = jproc(images=img, text="tok1 tok2", add_bos_token=True)
    np.testing.assert_array_equal(got.input_ids, want.input_ids)
    np.testing.assert_allclose(got.pixel_values[0, 0, 0], 3.0, atol=1e-5)
    ids = got.input_ids
    np.testing.assert_allclose(_tlogits(tp, tcfg, ids, got.pixel_values),
                               _jlogits(jp2, jcfg, ids, want.pixel_values),
                               atol=TOL, rtol=TOL)


def test_export_with_processor_round_trips(model, tmp_path):
    """save_pretrained(processor=...) writes the processor configs; a
    scalar image statistic is written for every channel."""
    from detikzify_torch.processing import ByteTokenizer, DetikzifyProcessor

    _, _, tcfg, tp = model
    proc = DetikzifyProcessor(ByteTokenizer(), tcfg)
    tload.save_pretrained(str(tmp_path), tp, tcfg, processor=proc)
    with open(tmp_path / "preprocessor_config.json") as f:
        pre = json.load(f)
    assert pre["image_mean"] == [0.5] * 3 and pre["image_std"] == [0.5] * 3
    with open(tmp_path / "processor_config.json") as f:
        assert json.load(f) == {"processor_class": "DetikzifyProcessor",
                                "image_seq_len": tcfg.image_seq_len}
    assert tload._image_stats(str(tmp_path)) == ([0.5] * 3, [0.5] * 3)
    assert not tload._processor_expects_text(str(tmp_path))


def _jax_adapter(cfg, seed=1):
    """A JAX adapter tree at ``cfg``'s vision widths for a 48-wide caption
    model, its gates moved off zero, as numpy arrays."""
    from detikzify_tpu.config import AdapterConfig
    from detikzify_tpu.models import adapter as jadapter

    tree = jadapter.init(jax.random.PRNGKey(seed), cfg.vision,
                         AdapterConfig(embedding_hidden_size=48))
    tree = jax.tree.map(np.asarray, tree)
    n = cfg.vision.num_hidden_layers
    tree["layers"]["attn_gate"] = np.linspace(-1, 1, n, dtype=np.float32
                                              )[:, None]
    tree["layers"]["mlp_gate"] = np.linspace(1, -1, n, dtype=np.float32
                                             )[:, None]
    return tree


def _adapter_cfgs():
    from detikzify_torch.config import AdapterConfig

    return AdapterConfig(embedding_hidden_size=48)


def _assert_adapter_equal(tadapter_, jtree, vcfg, acfg):
    """The port's adapter equals the JAX tree bit for bit."""
    want = convert.adapter_from_numpy(jtree, vcfg, acfg, device="cpu")
    got, exp = tadapter_.state_dict(), want.state_dict()
    assert list(got) == list(exp)
    for k in exp:
        assert got[k].dtype == exp[k].dtype and torch.equal(got[k], exp[k]), k


def _prefixed(path, out):
    """The bare adapter keys of ``path`` under ``adapter.`` in ``out``, as
    a composite checkpoint nests them."""
    from safetensors.numpy import save_file

    state = jimport.load_state_dict_from_safetensors(path)
    os.makedirs(out, exist_ok=True)
    save_file({f"adapter.{k}": np.ascontiguousarray(v)
               for k, v in state.items()}, f"{out}/model.safetensors")
    return out


@pytest.mark.parametrize("keys", ["bare", "prefixed"])
def test_jax_adapter_checkpoint_loads_in_port(model, tmp_path, keys):
    """An adapter written by the JAX ``save_adapter`` loads into the port
    equal to the JAX tree, bit for bit, from the reference's bare keys and
    from the ``adapter.`` subtree of a composite checkpoint."""
    cfg, _, tcfg, _ = model
    jtree = _jax_adapter(cfg)
    path = str(tmp_path / "bare")
    jload.save_adapter(path, jtree, cfg.vision)
    if keys == "prefixed":
        path = _prefixed(path, str(tmp_path / "prefixed"))
    acfg = _adapter_cfgs()
    got = timport.import_adapter(timport.load_state_dict_from_safetensors(
        path), tcfg.vision, acfg, dtype=torch.float32)
    _assert_adapter_equal(got, jtree, tcfg.vision, acfg)


@pytest.mark.parametrize("keys", ["bare", "prefixed"])
@pytest.mark.parametrize("every", [1, 2])
def test_port_adapter_checkpoint_loads_in_jax(model, tmp_path, keys, every):
    """An adapter written by the port's ``save_adapter`` has the JAX
    export's keys and values, and loads through the JAX
    ``import_adapter`` equal to it bit for bit; with
    ``cross_attn_every_n_layers=2`` the inactive layer is omitted and both
    packages import it as zeros."""
    cfg, _, tcfg, _ = model
    jtree = _jax_adapter(cfg)
    acfg = _adapter_cfgs()
    tad = convert.adapter_from_numpy(jtree, tcfg.vision, acfg, device="cpu")
    path, jpath = str(tmp_path / "port"), str(tmp_path / "jax")
    assert tload.save_adapter(path, tad, dataclasses.replace(
        acfg, cross_attn_every_n_layers=every)) > 0
    jload.save_adapter(jpath, jtree, cfg.vision, active_every=every)
    ours = safetensors_io.load_file(f"{path}/model.safetensors")
    theirs = jimport.load_state_dict_from_safetensors(jpath)
    assert sorted(ours) == sorted(theirs)
    for k in theirs:
        np.testing.assert_array_equal(ours[k].numpy(), theirs[k], err_msg=k)
    if keys == "prefixed":
        path = _prefixed(path, str(tmp_path / "prefixed"))
    from detikzify_tpu.config import AdapterConfig

    back = jax.tree.map(np.asarray, jimport.import_adapter(
        jimport.load_state_dict_from_safetensors(path), cfg.vision,
        AdapterConfig(embedding_hidden_size=48), dtype=jnp.float32))
    if every == 2:      # layer 0 is inactive: zeros in both packages
        jtree = jax.tree.map(lambda x: x, jtree)
        jtree["layers"] = jax.tree.map(
            lambda x: np.concatenate([np.zeros_like(x[:1]), x[1:]]),
            jtree["layers"])
        tback = timport.import_adapter(timport.load_state_dict_from_safetensors(
            path), tcfg.vision, acfg, dtype=torch.float32)
        _assert_adapter_equal(tback, jtree, tcfg.vision, acfg)
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(jtree))
    assert len(flat_back) == len(flat_want)
    for kp, leaf in flat_back:
        want = flat_want[kp]
        assert leaf.dtype == want.dtype, kp
        np.testing.assert_array_equal(leaf, want, err_msg=str(kp))


def _caption_model(tmp_path, cfg, tokenizer=True):
    """A 2-layer, 48-wide caption model from a JAX init, written by the
    port as a plain LLaMA checkpoint; its ``config.json`` also carries a
    ``text_config``, which the JAX loader reads. Returns (path, the JAX
    tree, the TextConfig)."""
    from detikzify_tpu.config import TextConfig
    from detikzify_tpu.models import llama as jllama
    from detikzify_torch.config import TextConfig as TTextConfig

    kw = dict(vocab_size=512, hidden_size=48, intermediate_size=96,
              num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, max_position_embeddings=256,
              rope_theta=10000.0)
    jtree = jax.tree.map(np.asarray, jllama.init(jax.random.PRNGKey(3),
                                                 TextConfig(**kw)))
    tcfg = TTextConfig(**kw)
    path = str(tmp_path / "caption_model")
    tload.save_embedding_model(path, convert.llama_from_numpy(
        jtree, tcfg, device="cpu"), tcfg)
    with open(f"{path}/config.json") as f:
        hf = json.load(f)
    hf["text_config"] = dict(kw)
    with open(f"{path}/config.json", "w") as f:
        json.dump(hf, f)
    if tokenizer:
        _tokenizer_dir(path, cfg)
    return path, jtree, tcfg


def test_adapter_checkpoint_not_ported(model, jax_ckpt, tmp_path):
    """load(..., adapter_embedding_model=) on a checkpoint with an
    ``adapter/`` folder: the adapter processor and bundle on the CPU, the
    adapter and caption model equal to the JAX loader's bit for bit, the
    same caption embeddings and ids; without an embedding model the folder
    is ignored, as in JAX."""
    from detikzify_torch.models.embedding import AdapterBundle
    from detikzify_torch.processing_adapter import AdapterProcessor

    cfg, _, _, _ = model
    path = tmp_path / "with_adapter"
    os.makedirs(path)
    for name in ("config.json", "model.safetensors"):
        os.symlink(f"{jax_ckpt}/{name}", path / name)
    _tokenizer_dir(str(path), cfg)
    jload.save_adapter(str(path / "adapter"), _jax_adapter(cfg), cfg.vision)
    embed_path, _, _ = _caption_model(tmp_path, cfg)

    tp, tcfg, tproc, tbundle = tload.load(
        str(path), adapter_embedding_model=embed_path, dtype=torch.float32,
        device="cpu")
    jp, jcfg, jproc, jbundle = jload.load(
        str(path), adapter_embedding_model=embed_path, dtype=jnp.float32)
    assert isinstance(tproc, AdapterProcessor)
    assert isinstance(tbundle, AdapterBundle)
    assert tbundle.embed_params.embed_tokens.device.type == "cpu"
    want_cfg = jcfg.to_dict()
    want_cfg["adapter"]["embedding_hidden_size"] = 48   # the caption width
    assert tcfg.to_dict() == want_cfg
    assert tbundle.embed_cfg.to_dict() == jbundle.embed_cfg.to_dict()
    _assert_adapter_equal(tbundle.adapter_params, jax.tree.map(
        np.asarray, jbundle.adapter_params), tcfg.vision, tcfg.adapter)
    want = convert.llama_from_numpy(jax.tree.map(
        np.asarray, jbundle.embed_params), tbundle.embed_cfg, device="cpu")
    for k, v in want.state_dict().items():
        assert torch.equal(tbundle.embed_params.state_dict()[k], v), k
    texts = ["tok1 tok2 tok3", "tok4"]
    th, tm = tbundle.embed_captions(texts)
    jh, jm = jbundle.embed_captions(texts)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=TOL,
                               rtol=TOL)
    got, exp = tproc(text="tok5 tok6"), jproc(text="tok5 tok6")
    np.testing.assert_array_equal(got.input_ids, exp.input_ids)
    np.testing.assert_array_equal(got.adapter_input_ids,
                                  exp.adapter_input_ids)
    # without an embedding model the adapter folder is ignored, as in JAX
    tp, _ = tload.load_params(str(path), dtype=torch.float32, device="cpu")
    assert tload.has_adapter(tp) is False


def _outcome(fn):
    """What a call gives: ("ok", its value) or ("raise", the error type)."""
    try:
        return "ok", fn()
    except Exception as e:  # noqa: BLE001 -- compared across packages
        return "raise", type(e).__name__


@pytest.mark.parametrize("with_image", [False, True])
@pytest.mark.parametrize("expects_text", [False, True])
def test_pipeline_from_load_matches_jax(model, jax_ckpt, tmp_path,
                                        expects_text, with_image):
    """DetikzifyPipeline built from the 4-tuple that ``load(...,
    adapter_embedding_model=)`` returns (its AdapterProcessor, not the base
    processor): the root prompt, the number of image embeddings and the
    greedy stream equal JAX's pipeline built from JAX's own ``load``, for
    a caption alone and with a figure, on a DeTikZify and a TikZero+
    checkpoint (``model_expects_text``)."""
    from PIL import Image, ImageDraw

    from detikzify_tpu.infer import DetikzifyPipeline as JPipeline
    from detikzify_tpu.infer import FakeBackend as JFake
    from detikzify_tpu.infer import set_backend as j_set_backend
    from detikzify_torch.infer import DetikzifyPipeline as TPipeline
    from detikzify_torch.infer import FakeBackend as TFake
    from detikzify_torch.infer import set_backend as t_set_backend

    cfg, _, _, _ = model
    path = tmp_path / "ckpt"
    os.makedirs(path)
    for name in ("config.json", "model.safetensors"):
        os.symlink(f"{jax_ckpt}/{name}", path / name)
    _tokenizer_dir(str(path), cfg)
    if expects_text:
        with open(path / "processor_config.json", "w") as f:
            json.dump({"model_expects_text": True}, f)
    jload.save_adapter(str(path / "adapter"), _jax_adapter(cfg), cfg.vision)
    embed_path, _, _ = _caption_model(tmp_path, cfg)
    tp, tcfg, tproc, tbundle = tload.load(
        str(path), adapter_embedding_model=embed_path, dtype=torch.float32,
        device="cpu")
    jp, jcfg, jproc, jbundle = jload.load(
        str(path), adapter_embedding_model=embed_path, dtype=jnp.float32)
    assert tproc.processor.model_expects_text is expects_text
    img = Image.new("RGB", (100, 80), "white")
    ImageDraw.Draw(img).ellipse([10, 10, 90, 70], outline="blue", width=2)
    kw = dict(text="tok5 tok6 tok7", max_new_tokens=8)
    if with_image:
        kw["image"] = img
    pkw = dict(num_slots=2, max_len=96, temperature=0.0, metric="fast")
    j_set_backend(JFake())
    t_set_backend(TFake())
    jpipe = JPipeline(jp, jcfg, jproc, adapter=jbundle, **pkw)
    tpipe = TPipeline(tp, tcfg, tproc, adapter=tbundle, device="cpu", **pkw)
    try:
        def run(pipe):
            def go():
                gen = pipe.generator(**kw)
                try:
                    return (gen.root.token_ids,
                            tuple(np.asarray(gen.image_embeds).shape),
                            pipe.sample(**kw).code)
                finally:
                    gen.close()
            return _outcome(go)

        want, got = run(jpipe), run(tpipe)
        assert got == want
        if got[0] == "ok":
            root, shape, _ = got[1]
            # one image token for each image embedding row
            assert root.count(tcfg.image_token_id) == shape[1] == \
                tcfg.image_seq_len
    finally:
        tpipe.close()
        j_set_backend(None)
        t_set_backend(None)


def test_load_adapter_params_without_tokenizer(model, tmp_path):
    """The weight half of load_adapter needs no tokenizer (no
    ``transformers`` on the card's machine): a caption-model directory
    without one loads, tied embeddings without an ``lm_head``."""
    from detikzify_torch.config import TextConfig
    from detikzify_torch.models import llama as tllama

    cfg, _, tcfg, _ = model
    jload.save_adapter(str(tmp_path / "adapter"), _jax_adapter(cfg),
                       cfg.vision)
    ecfg = TextConfig(vocab_size=512, hidden_size=48, intermediate_size=96,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, rope_theta=500000.0,
                      rope_scaling={"rope_type": "llama3", "factor": 32.0,
                                    "low_freq_factor": 1.0,
                                    "high_freq_factor": 4.0,
                                    "original_max_position_embeddings":
                                        8192},
                      tie_word_embeddings=True)
    src = tllama.Llama(ecfg, device="cpu", dtype=torch.float32)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in src.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    path = str(tmp_path / "embed")
    tload.save_embedding_model(path, src, ecfg)
    assert "lm_head.weight" not in safetensors_io.load_file(
        f"{path}/model.safetensors")
    adapter, acfg, embed, got_cfg = tload.load_adapter_params(
        str(tmp_path / "adapter"), tcfg.vision, path, dtype=torch.float32,
        device="cpu")
    assert got_cfg == ecfg and acfg.embedding_hidden_size == 48
    assert embed.lm_head is None
    for k, v in src.state_dict().items():
        assert torch.equal(embed.state_dict()[k], v), k
    assert not any(p.requires_grad for p in (*adapter.parameters(),
                                             *embed.parameters()))


@pytest.mark.parametrize("hf", [
    {"hidden_size": 2048, "intermediate_size": 8192, "num_hidden_layers": 16,
     "num_attention_heads": 32, "num_key_value_heads": 8,
     "vocab_size": 128256, "rope_theta": 500000.0,
     "rope_scaling": {"rope_type": "llama3", "factor": 32.0},
     "tie_word_embeddings": True},
    {"hidden_size": 64, "num_attention_heads": 4},
    {"text_config": {"hidden_size": 96, "num_attention_heads": 8}}])
def test_text_config_from_hf_json(hf):
    """A caption model's config: the flat fields of a plain LLaMA
    ``config.json`` (one KV head per query head where it names none), or
    the ``text_config`` of a composite one as the JAX reader takes it."""
    got = timport.text_config_from_hf_json(hf)
    if "text_config" in hf:
        assert got.to_dict() == jimport.config_from_hf_json(hf).text.to_dict()
        return
    for k, v in hf.items():
        assert getattr(got, k) == v
    if "num_key_value_heads" not in hf:
        assert got.num_key_value_heads == hf["num_attention_heads"]
    # the fields the file leaves out: HF LlamaConfig's defaults
    hf_cfg = pytest.importorskip("transformers").LlamaConfig(
        **{k: v for k, v in hf.items() if k != "rope_scaling"})
    for k in ("vocab_size", "hidden_size", "intermediate_size",
              "num_hidden_layers", "num_attention_heads",
              "num_key_value_heads", "max_position_embeddings",
              "rms_norm_eps", "rope_theta", "tie_word_embeddings",
              "hidden_act", "attention_bias"):
        assert getattr(got, k) == getattr(hf_cfg, k), k
    if "rope_scaling" not in hf:
        assert got.rope_scaling is None


def test_load_defaults_to_the_card(jax_ckpt):
    """Entry points run on the card unless the caller asks for the CPU."""
    import inspect

    for fn in (tload.load, tload.load_params, tload.load_weights):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            tload.load_params(jax_ckpt)
