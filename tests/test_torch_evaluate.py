"""The port's evaluation suite (``detikzify_torch/evaluate``, ``native.py``,
the SigLIP text tower) against the JAX package, on the CPU in fp32.

Mirrors ``tests/test_evaluate.py`` for the modules this suite ports
(SelfSim's own tests are in ``test_torch_imagesim.py``) and holds each
against JAX on the same inputs, made from a numpy seed:
- the text tower's outputs, ClipScore's scores and ``import_siglip_text``
  within 1e-5 absolute;
- ``poly_mmd2`` within 1e-5 relative; KID's features within 1e-5, and
  ``compute()``'s mean and std on the same subsets within 1e-5 relative
  on JAX's features, 1e-4 relative on the port's own;
- ``tex_tokenize``, CrystalBLEU (and its trivially-shared n-grams), EED,
  the harness aggregates, ``PredictionCache`` and the greedy
  ``generate_until_compilable`` results EXACTLY, and the native library
  equal to the Python versions;
- ``gather_interleaved`` and ``allreduce_sum`` across two processes of a
  gloo group.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image, ImageDraw

from detikzify_tpu.config import tiny_test_config
from detikzify_tpu.evaluate import clipscore as jclip
from detikzify_tpu.evaluate import crystalbleu as jbleu
from detikzify_tpu.evaluate import eed as jeed
from detikzify_tpu.evaluate import harness as jharness
from detikzify_tpu.evaluate import kid as jkid
from detikzify_tpu.infer import DetikzifyPipeline as JPipeline
from detikzify_tpu.infer import FakeBackend as JFake
from detikzify_tpu.infer import TikzDocument as JDoc
from detikzify_tpu.infer import set_backend as j_set_backend
from detikzify_tpu.models import detikzify as jdet
from detikzify_tpu.models import import_hf as jimport
from detikzify_tpu.models import siglip as jsiglip
from detikzify_tpu.processing import ByteTokenizer as JTok
from detikzify_tpu.processing import DetikzifyProcessor as JProc
from detikzify_torch import evaluate as tevaluate
from detikzify_torch import native as tnative
from detikzify_torch.config import VisionConfig as TVisionConfig
from detikzify_torch.config import tiny_test_config as t_tiny_test_config
from detikzify_torch.evaluate import clipscore as tclip
from detikzify_torch.evaluate import crystalbleu as tbleu
from detikzify_torch.evaluate import dist as tdist
from detikzify_torch.evaluate import eed as teed
from detikzify_torch.evaluate import harness as tharness
from detikzify_torch.evaluate import kid as tkid
from detikzify_torch.infer import DetikzifyPipeline as TPipeline
from detikzify_torch.infer import FakeBackend as TFake
from detikzify_torch.infer import TikzDocument as TDoc
from detikzify_torch.infer import set_backend as t_set_backend
from detikzify_torch.models import convert, import_hf, load, siglip
from detikzify_torch.processing import ByteTokenizer as TTok
from detikzify_torch.processing import DetikzifyProcessor as TProc

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
VOCAB, POSITIONS = 300, 16

PROGRAMS = [
    "\\documentclass{standalone}\n\\usepackage{tikz}\n\\begin{document}\n"
    "\\begin{tikzpicture}\n\\draw[red, thick] (0,0) -- (1,1);\n"
    "\\node at (0.5, 0.2) {a label};\n\\end{tikzpicture}\n\\end{document}",
    "\\begin{tikzpicture}\\draw (0,0) circle (1);\\end{tikzpicture}",
    "\\draw (0,0) -- (1,1);\n\\draw (0,0) -- (2,2);",
    "\\node at (0,0) {x};\n\\node at (1,1) {y}; % comment\n\\fill circle",
    "plain words, numbers 3.14 and $x^2$ math",
]


def _img(seed, size=64):
    img = Image.new("RGB", (size, size), "white")
    d = ImageDraw.Draw(img)
    rng = np.random.default_rng(seed)
    for _ in range(4):
        x0, x1 = sorted(int(v) for v in rng.integers(0, size - 1, 2))
        y0, y1 = sorted(int(v) for v in rng.integers(0, size - 1, 2))
        d.rectangle([x0, y0, x1, y1],
                    outline=tuple(int(c) for c in rng.integers(0, 200, 3)))
    return img


@pytest.fixture(scope="module")
def towers():
    """A tiny-test model (its vision tower scores KID and ClipScore's
    image side) and a SigLIP text tower, JAX and port on the same
    weights."""
    cfg = tiny_test_config()
    jp = jdet.init(jax.random.PRNGKey(3), cfg)
    tcfg = t_tiny_test_config()
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp._asdict()),
                                   tcfg, device="cpu")
    jtext = jsiglip.init_text(jax.random.PRNGKey(4), cfg.vision,
                              vocab_size=VOCAB, max_positions=POSITIONS)
    ttext = convert.siglip_text_from_numpy(
        jax.tree.map(np.asarray, jtext), tcfg.vision, device="cpu")
    return cfg, jp, jtext, tcfg, tp, ttext


def _tok(cls):
    return cls(vocab_size=VOCAB, image_token_id=VOCAB - 3,
               bos_token_id=VOCAB - 2, eos_token_id=VOCAB - 1)


# ---------------------------------------------------------------------------
# the SigLIP text tower and ClipScore
# ---------------------------------------------------------------------------

def test_siglip_text_tower():
    cfg = TVisionConfig(hidden_size=32, intermediate_size=64,
                        num_hidden_layers=2, num_attention_heads=4,
                        image_size=28, patch_size=14)
    text = convert.init_random_siglip_text(cfg, vocab_size=100,
                                           max_positions=16, device="cpu",
                                           dtype=torch.float32)
    out = siglip.apply_text(text, cfg, torch.zeros((2, 16), dtype=torch.long))
    assert out["pooler_output"].shape == (2, 32)
    assert out["last_hidden_state"].shape == (2, 16, 32)
    assert torch.isfinite(out["pooler_output"]).all()


def test_apply_text_matches_jax(towers):
    cfg, _, jtext, tcfg, _, ttext = towers
    ids = np.random.default_rng(0).integers(0, VOCAB, (3, POSITIONS),
                                            dtype=np.int32)
    want = jsiglip.apply_text(jtext, cfg.vision, jnp.asarray(ids))
    got = siglip.apply_text(ttext, tcfg.vision, torch.from_numpy(ids))
    for key in ("pooler_output", "last_hidden_state"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=1e-5)


def _siglip_text_state(cfg, rng):
    """A SigLIP text tower in ``SiglipModel`` names, random."""
    d, i = cfg.hidden_size, cfg.intermediate_size

    def t(*shape):
        return rng.standard_normal(shape).astype(np.float32) * 0.1

    state = {"text_model.embeddings.token_embedding.weight": t(VOCAB, d),
             "text_model.embeddings.position_embedding.weight":
                 t(POSITIONS, d),
             "text_model.final_layer_norm.weight": 1 + t(d),
             "text_model.final_layer_norm.bias": t(d),
             "text_model.head.weight": t(d, d),
             "text_model.head.bias": t(d)}
    for n in range(cfg.num_hidden_layers):
        base = f"text_model.encoder.layers.{n}"
        for ln in ("layer_norm1", "layer_norm2"):
            state[f"{base}.{ln}.weight"] = 1 + t(d)
            state[f"{base}.{ln}.bias"] = t(d)
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            state[f"{base}.self_attn.{proj}.weight"] = t(d, d)
            state[f"{base}.self_attn.{proj}.bias"] = t(d)
        state[f"{base}.mlp.fc1.weight"] = t(i, d)
        state[f"{base}.mlp.fc1.bias"] = t(i)
        state[f"{base}.mlp.fc2.weight"] = t(d, i)
        state[f"{base}.mlp.fc2.bias"] = t(d)
    return state


def test_import_siglip_text_matches_jax(towers):
    cfg, tcfg = towers[0], towers[3]
    rng = np.random.default_rng(1)
    state = _siglip_text_state(cfg.vision, rng)
    jtext = jimport.import_siglip_text(jimport._Src(state), cfg.vision,
                                       jnp.float32)
    ttext = siglip.SiglipText(tcfg.vision, VOCAB, POSITIONS, device="meta",
                              dtype=torch.float32)
    src = import_hf._Src({k: torch.from_numpy(v) for k, v in state.items()})
    import_hf.import_siglip_text(src, ttext, tcfg.vision, torch.float32)
    assert not src.unused()
    assert not any(p.is_meta for p in ttext.parameters())
    ids = rng.integers(0, VOCAB, (2, POSITIONS), dtype=np.int32)
    want = jsiglip.apply_text(jtext, cfg.vision, jnp.asarray(ids))
    got = siglip.apply_text(ttext, tcfg.vision, torch.from_numpy(ids))
    np.testing.assert_allclose(got["pooler_output"].numpy(),
                               np.asarray(want["pooler_output"]),
                               rtol=0, atol=1e-5)


def _clip_pair(towers, **kw):
    cfg, jp, jtext, tcfg, tp, ttext = towers
    common = dict(logit_scale=np.log(10.0), logit_bias=-2.5,
                  text_max_len=POSITIONS, **kw)
    return (jclip.ClipScore(jp.vision, jtext, cfg, _tok(JTok), **common),
            tclip.ClipScore(tp.vision, ttext, tcfg, _tok(TTok), **common))


def test_clipscore_matches_jax(towers):
    jmetric, tmetric = _clip_pair(towers)
    images = [_img(i) for i in range(3)]
    texts = ["a red square", "", "x" * 40]     # the last one is cut
    want = jmetric.score_batch(images, texts)
    got = tmetric.score_batch(images, texts)
    assert got.shape == (3,) and ((got > 0) & (got < 1)).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tmetric._tokenize(texts),
                                  jmetric._tokenize(texts))
    for m in (jmetric, tmetric):
        m.update(images, texts)
        m.update(images[0], "one more")
    assert tmetric.compute() == pytest.approx(jmetric.compute(), abs=1e-5)
    tmetric.reset()
    with pytest.raises(RuntimeError):
        tmetric.compute()


def test_siglip_towers_round_trip_and_clipscore(towers, tmp_path):
    """``save_siglip_towers`` writes a ``SiglipModel`` directory that
    ``load_siglip_towers`` (no transformers) reads back bit for bit, and
    ClipScore on the loaded towers scores as on the written ones."""
    cfg, _, _, tcfg, tp, ttext = towers
    # the file keeps both scalars in float32, as HF's does
    written = load.SiglipTowers(tp.vision, ttext, tcfg.vision, tcfg.vision,
                                float(np.float32(np.log(10.0))), -2.5)
    load.save_siglip_towers(str(tmp_path), written)
    with open(tmp_path / "config.json") as f:
        hf = json.load(f)
    assert hf["text_config"]["vocab_size"] == VOCAB
    back = load.load_siglip_towers(str(tmp_path), dtype=torch.float32,
                                   device="cpu")
    for a, b in ((written.vision, back.vision), (written.text, back.text)):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys()
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert back.cfg == tcfg.vision and back.text_cfg == tcfg.vision
    assert back.logit_scale == written.logit_scale
    assert back.logit_bias == written.logit_bias
    kw = dict(logit_scale=back.logit_scale, logit_bias=back.logit_bias,
              text_max_len=POSITIONS)
    images, texts = [_img(5), _img(6)], ["one", "two words"]
    got = tclip.ClipScore(back.vision, back.text, back.cfg, _tok(TTok),
                          text_cfg=back.text_cfg, **kw).score_batch(
        images, texts)
    want = tclip.ClipScore(tp.vision, ttext, tcfg, _tok(TTok),
                           **kw).score_batch(images, texts)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# KID
# ---------------------------------------------------------------------------

def test_poly_mmd2_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((20, 16)).astype(np.float32)
    y = (rng.standard_normal((24, 16)) + 0.5).astype(np.float32)
    want = float(jkid.poly_mmd2(jnp.asarray(x), jnp.asarray(y)))
    got = float(tkid.poly_mmd2(torch.from_numpy(x), torch.from_numpy(y)))
    assert got == pytest.approx(want, rel=1e-5)


def test_poly_mmd2_discrimination():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((40, 16)))
    same = float(tkid.poly_mmd2(x[:20], x[20:]))
    shifted = float(tkid.poly_mmd2(x[:20], x[20:] + 3.0))
    assert shifted > same


def test_kid_matches_jax(towers):
    """The features agree within 1e-5; on the same features (and so the
    same host-drawn subsets) ``compute()``'s mean and std agree within
    1e-5 relative, and end to end (each package's own features) within
    1e-4 relative: MMD^2 is a difference of three fp32 kernel sums some
    100x its size, so the features' rounding differences grow ~10x."""
    cfg, jp, _, tcfg, tp, _ = towers
    real = [_img(i) for i in range(6)]
    fake = [_img(i + 100) for i in range(6)]
    jm = jkid.KernelInceptionDistance(jp.vision, cfg, subset_size=4,
                                      subsets=8)
    tm = tkid.KernelInceptionDistance(tp.vision, tcfg, subset_size=4,
                                      subsets=8)
    for metric in (jm, tm):
        metric.update(real, real=True)
        metric.update(fake[:3], real=False)
        metric.update(fake[3:], real=False)
    for mine, theirs in ((tm._real, jm._real), (tm._fake, jm._fake)):
        assert [a.dtype for a in mine] == [np.float64] * len(mine)
        np.testing.assert_allclose(np.concatenate(mine),
                                   np.concatenate(theirs), rtol=0, atol=1e-5)
    jmean, jstd = jm.compute()
    tmean, tstd = tm.compute()
    assert np.isfinite(tmean) and tstd >= 0
    assert tmean == pytest.approx(jmean, rel=1e-4)
    assert tstd == pytest.approx(jstd, rel=1e-4)
    tm._real, tm._fake = jm._real, jm._fake
    tmean, tstd = tm.compute()
    assert tmean == pytest.approx(jmean, rel=1e-5)
    assert tstd == pytest.approx(jstd, rel=1e-5)
    tm.reset()
    with pytest.raises(ValueError):
        tm.compute()                    # nothing to concatenate


# ---------------------------------------------------------------------------
# CrystalBLEU, EED, the native library
# ---------------------------------------------------------------------------

def test_tex_tokenize():
    toks = tbleu.tex_tokenize("\\draw[red] (0,0) -- (1,1);")
    assert "\\draw" in toks or "\\draw[" in "".join(toks)
    assert len(toks) > 5


def test_tex_tokenize_matches_jax():
    for code in PROGRAMS:
        assert tbleu.tex_tokenize(code) == jbleu.tex_tokenize(code)


def test_crystalbleu_scores(tmp_path):
    corpus = ["\\draw (0,0) -- (1,1);" for _ in range(4)]
    metric = tbleu.CrystalBLEU(corpus, k=2, cache_dir=str(tmp_path))
    metric.update(["\\draw (0,0) -- (1,1);"], [["\\draw (0,0) -- (1,1);"]])
    perfect = metric.compute()
    metric.reset()
    metric.update(["\\fill circle"], [["\\draw (0,0) -- (1,1);"]])
    bad = metric.compute()
    assert perfect > bad >= 0.0


def test_crystalbleu_cache(tmp_path):
    corpus = ["a b c d e"] * 3
    s1 = tbleu.trivially_shared_ngrams(corpus, k=5, cache_dir=str(tmp_path))
    s2 = tbleu.trivially_shared_ngrams(corpus, k=5, cache_dir=str(tmp_path))
    assert s1 == s2 and len(s1) == 5


@pytest.mark.parametrize("use_native", [True, False])
def test_trivially_shared_ngrams_match_jax(tmp_path, use_native):
    """Both corpus passes select the same n-grams as JAX's: the native one
    the same token vocabulary and hashes, the Python one the same
    tuples."""
    corpus = PROGRAMS * 3
    got = tbleu.trivially_shared_ngrams(corpus, k=12,
                                        cache_dir=str(tmp_path / "t"),
                                        use_native=use_native)
    want = jbleu.trivially_shared_ngrams(corpus, k=12,
                                         cache_dir=str(tmp_path / "j"),
                                         use_native=use_native)
    if use_native:
        assert tnative.available()
        assert isinstance(got, tbleu.HashedNgramSet)
        assert (got.vocab, got.hashes) == (want.vocab, want.hashes)
    else:
        assert got == want


def test_trivially_shared_native_matches_python(tmp_path):
    """The native hashed corpus pass selects the same trivially-shared
    n-grams (up to top-k ties) as the Python Counter path."""
    from collections import Counter

    corpus = [
        "\\draw (0,0) -- (1,1);\n\\draw (0,0) -- (2,2);",
        "\\begin{tikzpicture}\\draw (0,0) circle (1);\\end{tikzpicture}",
        "\\node at (0,0) {x};\n\\node at (1,1) {y};",
    ] * 3
    k = 12
    assert tnative.available()
    nat = tbleu.trivially_shared_ngrams(corpus, k=k,
                                        cache_dir=str(tmp_path / "n"),
                                        use_native=True)
    py = tbleu.trivially_shared_ngrams(corpus, k=k,
                                       cache_dir=str(tmp_path / "p"),
                                       use_native=False)
    assert isinstance(nat, tbleu.HashedNgramSet) and len(nat) == len(py) == k
    counts = Counter()
    for text in corpus:
        counts.update(tbleu._ngrams(tbleu.tex_tokenize(text)))
    ranked = counts.most_common()
    threshold = ranked[k - 1][1]
    members = {ng for ng in counts if ng in nat}
    assert {ng for ng, c in ranked if c > threshold} <= members
    assert not ({ng for ng, c in ranked if c < threshold} & members)
    assert ("nonexistent-token",) not in nat


def test_crystalbleu_matches_jax(tmp_path):
    refs = PROGRAMS
    cands = [PROGRAMS[1], PROGRAMS[0].replace("red", "blue"), "\\fill",
             PROGRAMS[3][:30], ""]
    scores = []
    for mod, sub in ((tbleu, "t"), (jbleu, "j")):
        metric = mod.CrystalBLEU(refs, k=8, cache_dir=str(tmp_path / sub))
        metric.update(cands, [[r] for r in refs])
        scores.append(metric.compute())
    assert scores[0] == scores[1] and scores[0] > 0


def test_corpus_bleu_matches_nltk():
    nltk = pytest.importorskip("nltk")
    from nltk.translate.bleu_score import corpus_bleu as nltk_bleu

    cands = [list("the cat sat on the mat".split()),
             list("a quick brown fox jumps".split()),
             list("over the lazy dog again today".split())]
    refs = [[list("the cat is on the mat".split())],
            [list("the quick brown fox jumped".split())],
            [list("over the lazy dog again".split())]]
    want = nltk_bleu(refs, cands, weights=(0.25,) * 4)
    got = tbleu.corpus_bleu_excluding(cands, refs, exclude=set())
    assert got == pytest.approx(want, abs=1e-9)
    assert got == jbleu.corpus_bleu_excluding(cands, refs, exclude=set())


def test_eed_bounds():
    assert teed.extended_edit_distance(list("abc"), list("abc")) == \
        pytest.approx(0.0, abs=1e-9)
    far = teed.extended_edit_distance(list("abc"), list("xyzw"))
    assert 0 < far <= 1.0
    metric = teed.TexEditDistance()
    metric.update(["\\draw (0,0);"], [["\\draw (0,0);"]])
    assert metric.compute() == pytest.approx(0.0, abs=1e-9)


def test_eed_matches_jax_native_and_python():
    assert tnative.available()
    pairs = [(list(" ".join(tbleu.tex_tokenize(a))),
              list(" ".join(tbleu.tex_tokenize(b))))
             for a in PROGRAMS for b in PROGRAMS[:3]]
    pairs += [(list("abc"), list("xyzw")), ([], list("ab")), (list("a"), [])]
    for h, r in pairs:
        got = teed.extended_edit_distance(h, r)
        assert got == jeed.extended_edit_distance(h, r)
        assert got == teed._extended_edit_distance_py(h, r)
    metrics = [teed.TexEditDistance(), jeed.TexEditDistance()]
    for m in metrics:
        m.update(PROGRAMS, [[PROGRAMS[0], p] for p in PROGRAMS[::-1]])
    assert metrics[0].compute() == metrics[1].compute()
    assert metrics[0]._scores == metrics[1]._scores


def test_native_library_is_built_outside_the_source_tree():
    assert tnative.available()
    path = tnative.lib_path()
    assert path.exists() and path.parent == ROOT / "build" / "native"
    img = np.random.default_rng(0).integers(0, 256, (30, 50, 3), np.uint8)
    got = tnative.resize_normalize(img, 16)
    assert got.shape == (16, 16, 3) and np.isfinite(got).all()
    from detikzify_tpu import native as jnative

    if jnative.available():
        np.testing.assert_array_equal(got, jnative.resize_normalize(img, 16))


# ---------------------------------------------------------------------------
# the harness
# ---------------------------------------------------------------------------

def test_winsorize_and_aggregates():
    vals = [1.0] * 18 + [100.0, -100.0]
    w = tharness.winsorize(vals, 0.05)
    assert w.max() < 100 and w.min() > -100
    eff = tharness.mean_token_efficiency([[10, 10, 5], [4]])
    assert 0 < eff <= 1
    assert tharness.mean_sampling_throughput([3, 3, 3]) == pytest.approx(3.0)


def test_aggregates_match_jax():
    rng = np.random.default_rng(3)
    vals = list(rng.standard_normal(37) * 10)
    lengths = [list(rng.integers(1, 400, int(n)))
               for n in rng.integers(1, 9, 25)] + [[], [0, 0]]
    counts = list(rng.integers(1, 30, 25))
    for name, args in (("winsorize", (vals, 0.1)),
                       ("mean_token_efficiency", (lengths,)),
                       ("mean_sampling_throughput", (counts,)),
                       ("p50_time_to_first_compile", (vals,))):
        got = getattr(tharness, name)(*args)
        want = getattr(jharness, name)(*args)
        np.testing.assert_array_equal(got, want)
    assert np.isnan(tharness.p50_time_to_first_compile([]))
    assert tharness.mean_sampling_throughput([]) == 0.0


def test_prediction_cache(tmp_path):
    cache = tharness.PredictionCache(str(tmp_path / "preds.jsonl"))
    cache.put("item1", {"code": "x"})
    cache2 = tharness.PredictionCache(str(tmp_path / "preds.jsonl"))
    assert cache2.get("item1")["code"] == "x"
    assert cache2.get("missing") is None


def test_prediction_cache_matches_jax(tmp_path):
    """Either package reads the other's cache: the same file, rows and
    last-write-wins."""
    rows = [("a-0", {"code": "\\draw;", "score": 0.5, "lengths": [3, 4]}),
            ("a-1", {"code": "", "score": -1.0, "lengths": []}),
            ("a-0", {"code": "again", "score": 0.7, "lengths": [1]})]
    files = []
    for mod, name in ((jharness, "j.jsonl"), (tharness, "t.jsonl")):
        cache = mod.PredictionCache(str(tmp_path / name))
        for key, row in rows:
            cache.put(key, row)
        files.append((tmp_path / name).read_text())
    assert files[0] == files[1]
    back = tharness.PredictionCache(str(tmp_path / "j.jsonl"))
    want = jharness.PredictionCache(str(tmp_path / "t.jsonl"))
    assert back._data == want._data and back.get("a-0")["code"] == "again"


def test_shard_indices_striped():
    assert tharness.shard_indices(10, 0, 4) == [0, 4, 8]
    assert tharness.shard_indices(10, 3, 4) == [3, 7]
    all_idx = sorted(sum((tharness.shard_indices(10, p, 4)
                          for p in range(4)), []))
    assert all_idx == list(range(10))
    # one process without a process group, as JAX with one process
    assert tdist.process_index_count() == (0, 1)
    assert tharness.shard_indices(5) == jharness.shard_indices(5) == \
        list(range(5))


def test_gather_interleaved_single_process():
    local = [(3, "d"), (0, {"a": 1}), (2, [1, 2])]
    got = tharness.gather_interleaved(local, 5)
    assert got == jharness.gather_interleaved(local, 5)
    assert got == [{"a": 1}, [1, 2], "d"]


def test_sync_metric_single_process():
    class Metric:
        _sum, _n = 3.0, 4

    assert tdist.sync_metric(Metric()) == 0.75
    assert tdist.allreduce_sum(1.0, 2.0) == (1.0, 2.0)
    Metric._n = 0
    with pytest.raises(RuntimeError):
        tdist.sync_metric(Metric())


def test_redacted_render_matches_jax():
    j_set_backend(JFake())
    t_set_backend(TFake())
    try:
        for code in PROGRAMS[:3]:
            for rot13 in (False, True):
                want = jharness.redacted_render(JDoc(code), rot13=rot13)
                got = tharness.redacted_render(TDoc(code), rot13=rot13)
                assert got.size == (420, 420)
                np.testing.assert_array_equal(np.asarray(got),
                                              np.asarray(want))
    finally:
        j_set_backend(None)
        t_set_backend(None)


# two processes of a gloo group, rendezvous through a file under tmp_path
_WORKER = textwrap.dedent("""
    import json, sys
    import torch.distributed as dist
    from detikzify_torch.evaluate import dist as edist, harness
    rank, world, init, out, case = sys.argv[1:6]
    rank, world = int(rank), int(world)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        if case == "gather":
            big = "x" * (1 << 21)                  # ~2 MiB when JSON-encoded
            per_proc = [[(0, big), (4, "a")], [(1, {"v": 2}), (3, "tail  "),
                                               (5, [1, 2, 3])]]
            idx = harness.shard_indices(6)
            res = harness.gather_interleaved(per_proc[rank], 6)
            res = {"shard": idx, "rows": res,
                   "who": edist.process_index_count()}
        else:
            class Metric:
                _sum, _n = float(rank + 1), 2 * (rank + 1)
            res = {"sums": edist.allreduce_sum(rank + 1.0, 10.0 * (rank + 1)),
                   "mean": edist.sync_metric(Metric())}
    finally:
        dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(res, f)
""")


def _two_processes(tmp_path, case: str) -> list:
    init = f"file://{tmp_path / 'rendezvous'}"
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(rank), "2", init,
         str(tmp_path / f"out{rank}.json"), case], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(2)]
    try:
        for p in procs:
            p.wait(timeout=60)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p in procs:
        assert p.returncode == 0, p.stderr.read()[-2000:]
    return [json.loads((tmp_path / f"out{r}.json").read_text())
            for r in range(2)]


def test_gather_interleaved_two_processes(tmp_path):
    """Unequal shards, a >1 MiB row and a whitespace-tailed string come
    back whole and in item order on every rank."""
    outs = _two_processes(tmp_path, "gather")
    big = "x" * (1 << 21)
    for rank, out in enumerate(outs):
        assert out["who"] == [rank, 2]
        assert out["shard"] == list(range(rank, 6, 2))
        assert out["rows"] == [big, {"v": 2}, "tail  ", "a", [1, 2, 3]]


def test_allreduce_sum_two_processes(tmp_path):
    outs = _two_processes(tmp_path, "allreduce")
    for out in outs:
        assert out["sums"] == [3.0, 30.0]
        assert out["mean"] == pytest.approx(3.0 / 6.0)


# ---------------------------------------------------------------------------
# generate_until_compilable against the JAX harness over the JAX pipeline
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pipelines():
    j_set_backend(JFake())
    t_set_backend(TFake())
    cfg = tiny_test_config(vocab_size=512)
    jparams = jdet.init(jax.random.PRNGKey(7), cfg)
    tcfg = t_tiny_test_config(vocab_size=512)
    tparams = convert.params_from_numpy(
        jax.tree.map(np.asarray, jparams._asdict()), tcfg, device="cpu")

    def tok(cls, c):
        return cls(vocab_size=512, image_token_id=c.image_token_id,
                   bos_token_id=c.bos_token_id, eos_token_id=c.eos_token_id,
                   model_max_length=64)

    kw = dict(num_slots=4, max_len=64, temperature=0.0)
    jpipe = JPipeline(jparams, cfg, JProc(tok(JTok, cfg), cfg), **kw)
    tpipe = TPipeline(tparams, tcfg, TProc(tok(TTok, tcfg), tcfg),
                      device="cpu", **kw)
    yield jpipe, tpipe
    tpipe.close()
    j_set_backend(None)
    t_set_backend(None)


@pytest.mark.parametrize("mode", ["fast", "score_improve"])
def test_generate_until_compilable_matches_jax(pipelines, mode):
    """Greedy, FakeBackend, SelfSim (the pipelines' default metric): the
    same best program, program count and lengths as the JAX harness. Fast
    mode stops at the first compilable program; score-improvement mode
    (a minimum time never reached) runs out its expansions."""
    jpipe, tpipe = pipelines
    fig = _img(9, size=120)
    kw = (dict() if mode == "fast"
          else dict(score_improve=True, min_seconds=1e9, max_expansions=3))
    want = jharness.generate_until_compilable(jpipe, fig, **kw)
    got = tharness.generate_until_compilable(tpipe, fig, **kw)
    assert got.best_code == want.best_code
    assert got.num_programs == want.num_programs
    assert got.program_lengths == want.program_lengths
    assert got.compiled == want.compiled
    assert got.best_score == pytest.approx(want.best_score, abs=1e-4)
    if mode == "score_improve":
        assert got.num_programs == 3
    eng = tpipe.engine
    assert eng.num_active == 0 and eng.num_free_slots == eng.num_slots


# ---------------------------------------------------------------------------
# the package surface
# ---------------------------------------------------------------------------

def test_lazy_exports():
    from detikzify_torch.evaluate import dreamsim, dreamsim_vit

    assert tevaluate.CrystalBLEU is tbleu.CrystalBLEU
    assert tevaluate.KernelInceptionDistance is tkid.KernelInceptionDistance
    assert tevaluate.TexEditDistance is teed.TexEditDistance
    assert tevaluate.ClipScore is tclip.ClipScore
    assert tevaluate.DreamSim is dreamsim.DreamSim
    assert tevaluate.SigLIPDreamSim is dreamsim.SigLIPDreamSim
    assert tevaluate.DreamSimViT is dreamsim_vit.DreamSimViT
    assert tevaluate.dreamsim_from_checkpoints is \
        dreamsim_vit.from_checkpoints
    with pytest.raises(AttributeError):
        tevaluate.NoSuchMetric  # noqa: B018
    assert set(tevaluate.__all__) >= {"ImageSim", "ClipScore",
                                      "DreamSimViT"}
