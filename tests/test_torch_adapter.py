"""The port's TikZero adapter against the JAX package, on the CPU in fp32.

The JAX ``tests/test_adapter.py`` setup (``tiny-test`` with
``AdapterConfig(embedding_hidden_size=48, num_attention_heads=4)`` and a
2-layer caption model) is built in JAX and carried into the port by
``convert``. Held: ``siglip.apply(adapter=)`` at every_n 1 and 2,
``embed_captions`` and ``make_inputs`` within 3e-4; ``AdapterProcessor``
ids and masks equal; greedy ``sample()`` streams (figure + caption, caption
alone) identical; a text-conditioned greedy ``simulate()`` with the same
solution stream, scores (1e-5) and tree. The rest mirrors
``tests/test_adapter.py``.
"""
import os
import random

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image, ImageDraw

from detikzify_tpu.config import AdapterConfig, TextConfig, tiny_test_config
from detikzify_tpu.evaluate.imagesim import ImageSim as JImageSim
from detikzify_tpu.infer import DetikzifyPipeline as JPipeline
from detikzify_tpu.infer import FakeBackend as JFake
from detikzify_tpu.infer import set_backend as j_set_backend
from detikzify_tpu.models import adapter as jadapter
from detikzify_tpu.models import detikzify as jdet
from detikzify_tpu.models import llama as jllama
from detikzify_tpu.models import siglip as jsiglip
from detikzify_tpu.models.embedding import AdapterBundle as JBundle
from detikzify_tpu.processing import ByteTokenizer as JTok
from detikzify_tpu.processing import DetikzifyProcessor as JProc
from detikzify_tpu.processing_adapter import AdapterProcessor as JAProc
from detikzify_torch.config import AdapterConfig as TAdapterConfig
from detikzify_torch.config import TextConfig as TTextConfig
from detikzify_torch.config import tiny_test_config as t_tiny_test_config
from detikzify_torch.evaluate import ImageSim as TImageSim
from detikzify_torch.infer import DetikzifyPipeline as TPipeline
from detikzify_torch.infer import FakeBackend as TFake
from detikzify_torch.infer import set_backend as t_set_backend
from detikzify_torch.models import adapter as tadapter
from detikzify_torch.models import convert
from detikzify_torch.models import siglip as tsiglip
from detikzify_torch.models.embedding import AdapterBundle as TBundle
from detikzify_torch.processing import ByteTokenizer as TTok
from detikzify_torch.processing import DetikzifyProcessor as TProc
from detikzify_torch.processing_adapter import AdapterProcessor as TAProc

torch.set_num_threads(1)

TOL = 3e-4
EMBED = dict(vocab_size=512, hidden_size=48, intermediate_size=96,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=256,
             rope_theta=10000.0)
CAPTIONS = ["a scatter plot", "completely different caption text"]


@pytest.fixture(scope="module", autouse=True)
def fake_compilers():
    j_set_backend(JFake())
    t_set_backend(TFake())
    yield
    j_set_backend(None)
    t_set_backend(None)


def _tok(cls, cfg):
    return cls(vocab_size=512, image_token_id=cfg.image_token_id,
               bos_token_id=cfg.bos_token_id, eos_token_id=cfg.eos_token_id,
               model_max_length=96)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    """(JAX side, port side): each a dict of cfg, params, bundle and
    processor, the port's weights carried from the JAX ones."""
    acfg = AdapterConfig(embedding_hidden_size=48, num_attention_heads=4)
    cfg = tiny_test_config(vocab_size=512).replace(adapter=acfg)
    jp = jdet.init(jax.random.PRNGKey(0), cfg)
    ja = jadapter.init(jax.random.PRNGKey(1), cfg.vision, acfg)
    # gates at zero give sigmoid 0.5: move them so each block's own gate
    # value is held too
    ja["layers"]["attn_gate"] = ja["layers"]["attn_gate"] + jnp.asarray(
        [[0.3], [-0.7]])
    ja["layers"]["mlp_gate"] = ja["layers"]["mlp_gate"] + jnp.asarray(
        [[-0.2], [0.9]])
    ecfg = TextConfig(**EMBED)
    je = jllama.init(jax.random.PRNGKey(2), ecfg)
    jtok = _tok(JTok, cfg)
    jbundle = JBundle(adapter_params=ja, adapter_cfg=acfg, embed_params=je,
                      embed_cfg=ecfg, tokenizer=jtok, max_length=32)

    tacfg = TAdapterConfig(embedding_hidden_size=48, num_attention_heads=4)
    tcfg = t_tiny_test_config(vocab_size=512).replace(adapter=tacfg)
    tp = convert.params_from_numpy(_np(jp._asdict()), tcfg, device="cpu")
    ta = convert.adapter_from_numpy(_np(ja), tcfg.vision, tacfg,
                                    device="cpu")
    tecfg = TTextConfig(**EMBED)
    te = convert.llama_from_numpy(_np(je), tecfg, device="cpu")
    ttok = _tok(TTok, tcfg)
    tbundle = TBundle(adapter_params=ta, adapter_cfg=tacfg, embed_params=te,
                      embed_cfg=tecfg, tokenizer=ttok, max_length=32)
    return (dict(cfg=cfg, params=jp, bundle=jbundle,
                 processor=JProc(jtok, cfg)),
            dict(cfg=tcfg, params=tp, bundle=tbundle,
                 processor=TProc(ttok, tcfg)))


def _figure():
    img = Image.new("RGB", (100, 80), "white")
    ImageDraw.Draw(img).ellipse([10, 10, 90, 70], outline="blue", width=2)
    return img


def _pixels(cfg, seed=0, b=2):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.vision.image_size, cfg.vision.image_size, 3)).astype(
            np.float32)


# ---------------------------------------------------------------------------
# the modules, within fp32 3e-4
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("every", [1, 2])
def test_apply_with_adapter_matches_jax(setup, every):
    """The caption-conditioned tower: cross-attention before each active
    layer (every_n 1: both; 2: the second only), two captions of different
    lengths padded on the right."""
    j, t = setup
    pix = _pixels(j["cfg"])
    jai = j["bundle"].adapter_inputs(CAPTIONS)
    jai = jai._replace(config=jai.config.replace(
        cross_attn_every_n_layers=every))
    want = jsiglip.apply(j["params"].vision, j["cfg"].vision,
                         jnp.asarray(pix), adapter=jai, attn_impl="xla")
    tai = t["bundle"].adapter_inputs(CAPTIONS)
    tai = tai._replace(config=tai.config.replace(
        cross_attn_every_n_layers=every))
    with torch.no_grad():
        got = tsiglip.apply(t["params"].vision, t["cfg"].vision,
                            torch.from_numpy(pix), adapter=tai)
    for key in ("last_hidden_state", "pooler_output"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=TOL, rtol=TOL)
    # the adapter moved the features, and every_n changes which layers
    plain = tsiglip.apply(t["params"].vision, t["cfg"].vision,
                          torch.from_numpy(pix))
    assert float((plain["pooler_output"] - got["pooler_output"]).abs()
                 .max()) > 1e-4


def test_inactive_layers_are_skipped_not_computed(setup, monkeypatch):
    """every_n = 2 runs the cross-attention block before the second layer
    only: the first layer's block is never entered."""
    _, t = setup
    ai = t["bundle"].adapter_inputs(CAPTIONS[:1])
    ai = ai._replace(config=ai.config.replace(cross_attn_every_n_layers=2))
    seen = []
    layer = tsiglip._cross_attn_layer

    def spy(ap, x, adapter, eps):
        seen.append(next(i for i, b in enumerate(adapter.params) if b is ap))
        return layer(ap, x, adapter, eps)

    monkeypatch.setattr(tsiglip, "_cross_attn_layer", spy)
    with torch.no_grad():
        tsiglip.apply(t["params"].vision, t["cfg"].vision,
                      torch.from_numpy(_pixels(t["cfg"], b=1)), adapter=ai)
    assert seen == [1]


def test_embed_captions_and_make_inputs_match_jax(setup):
    j, t = setup
    jh, jm = j["bundle"].embed_captions(CAPTIONS)
    th, tm = t["bundle"].embed_captions(CAPTIONS)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert not tm.numpy().all()             # the short caption is padded
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=TOL,
                               rtol=TOL)
    jai = j["bundle"].adapter_inputs(CAPTIONS)
    tai = t["bundle"].adapter_inputs(CAPTIONS)
    np.testing.assert_allclose(tai.cross_states.numpy(),
                               np.asarray(jai.cross_states), atol=TOL,
                               rtol=TOL)
    assert tai.cross_mask.dtype == torch.bool
    assert tai.cross_mask.is_contiguous()
    np.testing.assert_array_equal(tai.cross_mask.numpy(),
                                  np.asarray(jai.cross_mask))
    np.testing.assert_array_equal(
        tadapter.dummy_pixels(t["bundle"].adapter_params, 3).numpy(),
        np.asarray(jadapter.dummy_pixels(j["bundle"].adapter_params, 3)))


def test_encode_image_with_adapter_matches_jax(setup):
    """The connector's image tokens from a caption-conditioned tower, and
    the engine's ``encode_image(adapter_inputs=)``."""
    from detikzify_torch.engine import DecodeEngine
    from detikzify_torch.models import detikzify as tdet

    j, t = setup
    pix = _pixels(j["cfg"], seed=1, b=1)
    want = jdet.encode_image(j["params"], j["cfg"], jnp.asarray(pix),
                             adapter=j["bundle"].adapter_inputs(CAPTIONS[:1]),
                             attn_impl="xla")
    tai = t["bundle"].adapter_inputs(CAPTIONS[:1])
    with torch.no_grad():
        got = tdet.encode_image(t["params"], t["cfg"], torch.from_numpy(pix),
                                adapter=tai)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    eng = DecodeEngine(t["params"], t["cfg"], num_slots=1, max_len=96,
                       device="cpu")
    np.testing.assert_array_equal(
        eng.encode_image(pix, adapter_inputs=tai).numpy(), got.numpy())


# ---------------------------------------------------------------------------
# the processor: ids and masks equal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["image+caption", "caption", "tikzero+",
                                  "captions"])
def test_adapter_processor_matches_jax(setup, case):
    j, t = setup
    procs = []
    for side, cls in ((j, JProc), (t, TProc)):
        base = side["processor"]
        if case == "tikzero+":
            base = cls(base.tokenizer, side["cfg"], model_expects_text=True)
        procs.append((JAProc if side is j else TAProc)(
            base, side["bundle"].tokenizer, max_length=16))
    kw = {"image+caption": dict(images=_figure(), text="a blue ellipse"),
          "caption": dict(text="a caption"),
          "tikzero+": dict(text="cap"),
          "captions": dict(text=["a", "a much longer caption, cut at 16"])
          }[case]
    want, got = procs[0](**kw), procs[1](**kw)
    for key in ("input_ids", "attention_mask", "adapter_input_ids",
                "adapter_attention_mask"):
        w, g = getattr(want, key), getattr(got, key)
        assert (w is None) == (g is None), key
        if w is not None:
            assert g.dtype == w.dtype, key
            np.testing.assert_array_equal(g, w, err_msg=key)
    np.testing.assert_allclose(got.pixel_values, want.pixel_values,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# sample() and simulate() against JAX
# ---------------------------------------------------------------------------

def _pipes(setup, **kw):
    j, t = setup
    kw = dict(num_slots=4, max_len=96, temperature=0.0, **kw)
    jpipe = JPipeline(j["params"], j["cfg"], j["processor"],
                      adapter=j["bundle"], **kw)
    tpipe = TPipeline(t["params"], t["cfg"], t["processor"], device="cpu",
                      adapter=t["bundle"], **kw)
    return jpipe, tpipe


@pytest.mark.parametrize("with_image", [True, False])
def test_sample_streams_match_jax(setup, with_image):
    """Greedy sample(): the same code from a figure and a caption, and from
    a caption alone (the adapter's blank image, image tokens prepended)."""
    jpipe, tpipe = _pipes(setup, metric="fast")
    try:
        kw = dict(text="a blue ellipse", max_new_tokens=24)
        if with_image:
            kw["image"] = _figure()
        want = jpipe.sample(**kw)
        got = tpipe.sample(**kw)
        assert got.code == want.code
        # the caption conditions the stream: a different one, or none,
        # gives other image tokens
        gen = tpipe.generator(**kw)
        other = tpipe.generator(**dict(kw, text="zzz"))
        try:
            assert not torch.equal(gen.image_embeds, other.image_embeds)
            assert len(gen.root.token_ids) == t_tiny_test_config(
                vocab_size=512).image_seq_len
            assert gen.max_length == len(gen.root.token_ids) + 24
        finally:
            gen.close()
            other.close()
    finally:
        tpipe.close()


def _sync_compiles(pipe):
    """Compile on submit and hand back a finished future, in both
    packages, so the parallel loop sees every compile done at once."""
    import concurrent.futures as cf

    def submit_doc(doc):
        doc.compile()
        fut = cf.Future()
        fut.set_result(doc)
        return fut

    pipe.compiler.submit_doc = submit_doc


def _tree(node):
    return (len(node.token_ids), node.is_widen_node, node.visits,
            tuple(_tree(c) for c in node.children))


@pytest.fixture(scope="module")
def parity_pipes(setup):
    """Greedy JAX and port pipelines with SelfSim (EMD) built on the
    adapter, a newline every third token id so the search grows a tree."""
    j, t = setup
    jsim = JImageSim.from_detikzify(j["params"], j["cfg"],
                                    processor=j["processor"], mode="emd",
                                    adapter=j["bundle"])
    dispatch = jsim.score_against_async

    def ready_dispatch(imgs, ref_image=None, text=None):
        # results ready before the next check; the ``text`` keyword keeps
        # the JAX search on its batched wave path
        dev, n = dispatch(imgs, ref_image, text=text)
        return jax.block_until_ready(dev), n

    jsim.score_against_async = ready_dispatch
    tsim = TImageSim.from_detikzify(t["params"], t["cfg"],
                                    processor=t["processor"], mode="emd",
                                    adapter=t["bundle"])
    jpipe, tpipe = _pipes(setup, metric=None)
    jpipe.metric, tpipe.metric = jsim, tsim
    for pipe in (jpipe, tpipe):
        pipe.processor.tokenizer._detikzify_newline_table = {
            i: (1, True) for i in range(0, 512, 3)}
        _sync_compiles(pipe)
    yield jpipe, tpipe
    for pipe in (jpipe, tpipe):
        del pipe.processor.tokenizer._detikzify_newline_table
    tpipe.close()


@pytest.mark.parametrize("with_image", [True, False])
@pytest.mark.parametrize("parallelism", [1, 4])
def test_text_conditioned_simulate_matches_jax(parity_pipes, parallelism,
                                              with_image):
    """Greedy text-conditioned simulate() under FakeBackend: the same
    solution stream, scores within 1e-5, the same tree."""
    runs = []
    for pipe in parity_pipes:
        random.seed(0)
        kw = dict(text="a blue ellipse", metric=pipe.metric,
                  max_new_tokens=24)
        if with_image:
            kw["image"] = _figure()
        gen = pipe.generator(**kw)
        try:
            out = list(gen.simulate(8, parallelism=parallelism))
            runs.append(([sc for sc, _ in out], [d.code for _, d in out],
                         _tree(gen.root)))
        finally:
            gen.close()
    (jscores, jcodes, jtree), (tscores, tcodes, ttree) = runs
    assert len(tcodes) == 8 and tcodes == jcodes
    np.testing.assert_allclose(tscores, jscores, rtol=0, atol=1e-5)
    assert ttree == jtree
    assert any(sc > -1 for sc in tscores)


# ---------------------------------------------------------------------------
# mirrors of tests/test_adapter.py
# ---------------------------------------------------------------------------

def test_adapter_conditions_vision(setup):
    """Caption cross-attention changes the encoder output, and two
    captions give two outputs."""
    _, t = setup
    pix = torch.from_numpy(_pixels(t["cfg"], b=1))
    vp, vcfg = t["params"].vision, t["cfg"].vision
    with torch.no_grad():
        plain = tsiglip.apply(vp, vcfg, pix)["pooler_output"]
        c1 = tsiglip.apply(vp, vcfg, pix, adapter=t["bundle"].adapter_inputs(
            ["a scatter plot"]))["pooler_output"]
        c2 = tsiglip.apply(vp, vcfg, pix, adapter=t["bundle"].adapter_inputs(
            ["completely different caption text"]))["pooler_output"]
    assert float((c1 - plain).abs().max()) > 1e-4
    assert float((c1 - c2).abs().max()) > 1e-6


def test_adapter_processor(setup):
    _, t = setup
    cfg, processor = t["cfg"], t["processor"]
    tok = t["bundle"].tokenizer
    ap = TAProc(processor, tok, max_length=16)
    out = ap(text="a caption")
    assert out.adapter_input_ids is not None
    assert out.pixel_values is not None          # DUMMY_IMAGE substituted
    assert out.input_ids.shape[1] == cfg.image_seq_len
    both = ap(images=_figure(), text="cap")
    assert both.pixel_values.shape[0] == 1
    with pytest.raises(ValueError):
        ap()
    plus = TProc(processor.tokenizer, cfg, model_expects_text=True)
    out_plus = TAProc(plus, tok, max_length=16)(text="cap")
    row = list(out_plus.input_ids[0])
    assert row[:cfg.image_seq_len] == [cfg.image_token_id] * cfg.image_seq_len
    assert row[cfg.image_seq_len:] == tok.encode("cap") + [cfg.bos_token_id]


def test_text_conditioned_pipeline(setup):
    """Full TikZero path: caption alone, figure and caption, and a scored
    simulate() with the caption; text without an adapter is refused."""
    j, t = setup
    pipe = TPipeline(t["params"], t["cfg"], t["processor"], num_slots=2,
                     max_len=96, adapter=t["bundle"], device="cpu")
    try:
        assert isinstance(pipe.sample(text="a diagram of a cycle",
                                      max_new_tokens=16).code, str)
        assert isinstance(pipe.sample(image=_figure(), text="a blue ellipse",
                                      max_new_tokens=16).code, str)
        results = list(pipe.simulate(text="a blue ellipse", expansions=2,
                                     max_new_tokens=16))
        assert len(results) == 2
        with pytest.raises(ValueError, match="Either image or text"):
            pipe.sample()
    finally:
        pipe.close()
    plain = TPipeline(t["params"], t["cfg"], t["processor"], num_slots=1,
                      max_len=96, metric="fast", device="cpu")
    try:
        with pytest.raises(ValueError, match="adapter"):
            plain.sample(text="a caption")
    finally:
        plain.close()


def test_tokenize_caption_condition(setup):
    """TikZero+ (``model_expects_text``): the root prompt is image tokens,
    the caption and a BOS separator, as in JAX, for a figure and for a
    caption alone; the caption model's own ids come padded on the
    right."""
    j, t = setup
    roots = []
    for side, cls, pipe_cls, kw in ((j, JProc, JPipeline, {}),
                                    (t, TProc, TPipeline, {"device": "cpu"})):
        plus = cls(side["processor"].tokenizer, side["cfg"],
                   model_expects_text=True)
        pipe = pipe_cls(side["params"], side["cfg"], plus, num_slots=1,
                        max_len=96, metric="fast", adapter=side["bundle"],
                        **kw)
        for image in (_figure(), None):
            gen = pipe.generator(image=image, text="cap")
            roots.append(gen.root.token_ids)
            gen.close()
    cfg = t["cfg"]
    cap = t["bundle"].tokenizer.encode("cap")
    want = tuple([cfg.image_token_id] * cfg.image_seq_len + cap
                 + [cfg.bos_token_id])
    assert roots == [want] * 4
    ids, mask = t["bundle"].tokenize(["cap", "a"])
    assert ids.dtype == np.int32 and mask.dtype == bool
    assert list(ids[0]) == t["bundle"].tokenizer.encode(
        "cap", add_special_tokens=True)
    assert list(mask[1]) == [True, True, False, False]


def test_adapter_save_import_roundtrip(setup, tmp_path):
    """save_adapter -> import_adapter reproduces the adapter and its
    effect, bit for bit."""
    from detikzify_torch.models import import_hf
    from detikzify_torch.models.load import save_adapter

    _, t = setup
    cfg, a = t["cfg"], t["bundle"].adapter_params
    path = str(tmp_path / "adapter")
    assert save_adapter(path, a, cfg.adapter) > 0
    assert os.path.exists(f"{path}/model.safetensors")
    back = import_hf.import_adapter(
        import_hf.load_state_dict_from_safetensors(path), cfg.vision,
        cfg.adapter, dtype=torch.float32)
    for (n1, p1), (n2, p2) in zip(a.state_dict().items(),
                                  back.state_dict().items()):
        assert n1 == n2 and torch.equal(p1, p2), n1
    pix = torch.from_numpy(_pixels(cfg, seed=3, b=1))
    hidden, mask = t["bundle"].embed_captions(["roundtrip caption"])
    with torch.no_grad():
        out1 = tsiglip.apply(t["params"].vision, cfg.vision, pix,
                             adapter=tadapter.make_inputs(a, cfg.adapter,
                                                          hidden, mask))
        out2 = tsiglip.apply(t["params"].vision, cfg.vision, pix,
                             adapter=tadapter.make_inputs(back, cfg.adapter,
                                                          hidden, mask))
    assert torch.equal(out1["pooler_output"], out2["pooler_output"])


def test_text_conditioned_wave_scoring_matches_per_call(setup):
    """A text-conditioned MCTS search scores its renders in batched waves,
    and each wave score equals the per-call score() (only the reference
    embedding carries the caption)."""
    _, t = setup
    text = "a blue ellipse"
    pipe = TPipeline(t["params"], t["cfg"], t["processor"], num_slots=4,
                     max_len=96, adapter=t["bundle"], device="cpu")
    metric = pipe.metric
    calls = {"wave": 0}
    orig = metric.score_against_async

    def spy(imgs, ref_image=None, text=None):
        calls["wave"] += 1
        return orig(imgs, ref_image, text=text)

    metric.score_against_async = spy
    img = _figure()
    try:
        results = list(pipe.simulate(image=img, text=text, expansions=4,
                                     parallelism=4, max_new_tokens=16))
    finally:
        pipe.close()
    assert len(results) == 4
    assert calls["wave"] >= 1, "text-conditioned search did not batch"
    from detikzify_torch.utils.image import expand

    ref = expand(img, max(img.size), do_trim=True)
    scored = 0
    for score, doc in results:
        if doc.is_rasterizable and score != -1:
            per_call = float(metric.score(img1=doc.rasterize(), img2=ref,
                                          text2=text))
            np.testing.assert_allclose(score, per_call, atol=1e-5)
            scored += 1
    assert scored > 0


def test_random_adapter_init(setup):
    """``init_random_adapter``: the JAX init's scales (dense N(0, 1/in), norms at
    identity, gates and biases zero, a blank of ones), one block per vision
    layer, drawn from the seed."""
    _, t = setup
    cfg = t["cfg"]
    a = convert.init_random_adapter(cfg.vision, cfg.adapter, device="cpu",
                                    dtype=torch.float32, seed=5)
    b = convert.init_random_adapter(cfg.vision, cfg.adapter, device="cpu",
                                    dtype=torch.float32, seed=5)
    assert len(a.layers) == cfg.vision.num_hidden_layers
    for (n, x), (_, y) in zip(a.state_dict().items(),
                              b.state_dict().items()):
        assert torch.equal(x, y), n
    blk = a.layers[0]
    assert float(blk.attn_gate) == 0.0 and float(blk.mlp_gate) == 0.0
    assert torch.equal(blk.attn.q_norm.scale, torch.ones(12))
    d = cfg.vision.hidden_size
    assert abs(float(blk.attn.q.weight.std()) - d ** -0.5) < 0.2 * d ** -0.5
    assert torch.equal(a.dummy_input, torch.ones_like(a.dummy_input))
    assert tuple(a.connector.weight.shape) == (d, 48)


def test_score_passes_the_caption_or_propagates(setup):
    """Per-render score(): a metric that takes ``text2`` gets the caption,
    one without it is called with the two images, and an error raised
    inside the metric propagates rather than retrying without the
    caption."""
    _, t = setup
    seen = []

    class WithText:
        def score(self, img1=None, img2=None, text1=None, text2=None):
            seen.append(text2)
            return 0.25

    class Textless:
        def score(self, img1, img2):
            seen.append("images")
            return 0.5

    class Broken:
        def score(self, img1=None, img2=None, text1=None, text2=None):
            raise TypeError("inside the metric")

    pipe = TPipeline(t["params"], t["cfg"], t["processor"], num_slots=2,
                     max_len=96, adapter=t["bundle"], device="cpu",
                     metric="fast")
    try:
        for metric, want in ((WithText(), 0.25), (Textless(), 0.5),
                             (Broken(), None)):
            gen = pipe.generator(image=_figure(), text="a caption",
                                 metric=metric)
            try:
                if want is None:
                    with pytest.raises(TypeError, match="inside the metric"):
                        gen.score(_figure())
                else:
                    assert gen.score(_figure()) == want
            finally:
                gen.close()
    finally:
        pipe.close()
    assert seen == ["a caption", "images"]
