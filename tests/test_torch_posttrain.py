"""The port's post-training against the JAX package, on the CPU in fp32.

TikZero adapter distillation (``train.adapter.pretrain``), TikZero+
(``train.adapter.train``) and GRPO (``train.grpo``). The JAX
``tests/test_adapter.py`` setup (``tiny_test_config(vocab_size=512)`` with
``AdapterConfig(embedding_hidden_size=48, num_attention_heads=4)`` and a
2-layer caption model) is built in JAX and carried into the port by
``convert``; inputs are made from a numpy seed and go through both.
Tolerances: ``embedding_similarity_loss`` 1e-6; a step's loss, terms and
metrics 1e-5; weights after plain-SGD steps 1e-4 of each leaf's largest
(+1e-6); data bit for bit; ``refine``'s optimizer 1e-6 in fp32 and, in
bf16, a bf16 unit of the weight and 2^-5 of the learning rate a step;
whole runs with Adam 1e-4 (and, for the leaves whose gradient is zero
but for rounding, the learning rates' sum).
Mirrors ``tests/test_adapter.py``'s training tests and ``tests/
test_grpo.py``; the sampled GRPO behaviours run in the port alone (its
sampler draws from Philox, JAX's from threefry).
"""
import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from PIL import Image, ImageDraw

from detikzify_tpu.config import AdapterConfig, TextConfig, tiny_test_config
from detikzify_tpu.engine import DecodeEngine as JEngine
from detikzify_tpu.evaluate.imagesim import ImageSim as JImageSim
from detikzify_tpu.infer import CompileService as JCompile
from detikzify_tpu.infer import FakeBackend as JFake
from detikzify_tpu.models import adapter as jadapter
from detikzify_tpu.models import detikzify as jdet
from detikzify_tpu.models import llama as jllama
from detikzify_tpu.models.embedding import AdapterBundle as JBundle
from detikzify_tpu.ops.sampling import SamplingParams as JSampling
from detikzify_tpu.processing import ByteTokenizer as JTok
from detikzify_tpu.processing import DetikzifyProcessor as JProc
from detikzify_tpu.processing_adapter import AdapterProcessor as JAProc
from detikzify_tpu.train import adapter as jtad
from detikzify_tpu.train import grpo as jgrpo
from detikzify_tpu.train.adapter.train import AdapterLLMState as JLLMState
from detikzify_torch.config import AdapterConfig as TAdapterConfig
from detikzify_torch.config import TextConfig as TTextConfig
from detikzify_torch.config import tiny_test_config as t_tiny_test_config
from detikzify_torch.engine import DecodeEngine as TEngine
from detikzify_torch.evaluate import ImageSim as TImageSim
from detikzify_torch.infer import CompileService as TCompile
from detikzify_torch.infer import FakeBackend as TFake
from detikzify_torch.models import adapter as tadapter
from detikzify_torch.models import convert
from detikzify_torch.models.embedding import AdapterBundle as TBundle
from detikzify_torch.ops.sampling import SamplingParams as TSampling
from detikzify_torch.processing import ByteTokenizer as TTok
from detikzify_torch.processing import DetikzifyProcessor as TProc
from detikzify_torch.processing_adapter import AdapterProcessor as TAProc
from detikzify_torch.train import adapter as ttad
from detikzify_torch.train import grpo as tgrpo
from detikzify_torch.train.adapter.train import AdapterLLMState as TLLMState
from detikzify_torch.train.step import AdamW

torch.set_num_threads(1)

EMBED = dict(vocab_size=512, hidden_size=48, intermediate_size=96,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=256,
             rope_theta=10000.0)
#: the adapter leaves whose gradient is zero but for rounding: a bias added
#: to every key is a shift softmax does not see
KEY_SHIFT_LEAVES = ("layers/attn/k/bias", "layers/attn/k_norm/bias")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tok(cls, cfg, max_length=96):
    return cls(vocab_size=512, image_token_id=cfg.image_token_id,
               bos_token_id=cfg.bos_token_id, eos_token_id=cfg.eos_token_id,
               model_max_length=max_length)


@pytest.fixture(scope="module")
def setup():
    """(JAX side, port side): each a dict of cfg, params, bundle and
    processor; the port's weights carried from the JAX ones. ``tree`` and
    ``atree`` keep the JAX weights as numpy, to check nothing moved."""
    acfg = AdapterConfig(embedding_hidden_size=48, num_attention_heads=4)
    cfg = tiny_test_config(vocab_size=512).replace(adapter=acfg)
    jp = jdet.init(jax.random.PRNGKey(0), cfg)
    ja = jadapter.init(jax.random.PRNGKey(1), cfg.vision, acfg)
    ecfg = TextConfig(**EMBED)
    je = jllama.init(jax.random.PRNGKey(2), ecfg)
    jtok = _tok(JTok, cfg)
    jb = JBundle(adapter_params=ja, adapter_cfg=acfg, embed_params=je,
                 embed_cfg=ecfg, tokenizer=jtok, max_length=32)
    tacfg = TAdapterConfig(embedding_hidden_size=48, num_attention_heads=4)
    tcfg = t_tiny_test_config(vocab_size=512).replace(adapter=tacfg)
    tecfg = TTextConfig(**EMBED)
    tree, atree = _np(jp._asdict()), _np(ja)
    ttok = _tok(TTok, tcfg)

    def port_bundle():
        return TBundle(convert.adapter_from_numpy(atree, tcfg.vision, tacfg,
                                                  device="cpu"),
                       tacfg, convert.llama_from_numpy(_np(je), tecfg,
                                                       device="cpu"),
                       tecfg, ttok, max_length=32)

    j = dict(cfg=cfg, params=jp, bundle=jb, proc=JProc(jtok, cfg), tok=jtok)
    t = dict(cfg=tcfg, params=convert.params_from_numpy(tree, tcfg,
                                                        device="cpu"),
             bundle=port_bundle(), proc=TProc(ttok, tcfg), tok=ttok,
             new_bundle=port_bundle)
    return j, t, tree, atree


def _figure(seed=0):
    img = Image.new("RGB", (100, 80), "white")
    d = ImageDraw.Draw(img)
    d.ellipse([10 + seed, 10, 90, 70 - seed], outline="blue", width=2)
    d.line([5, 75 - seed, 95, 5 + 2 * seed], fill=(200, 30, 30), width=3)
    return img


def _named(tree) -> dict:
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _close(got_tree, want_tree, rtol_of_max=1e-4, atol=1e-6, loose=(),
           loose_atol=0.0):
    """Every leaf within ``rtol_of_max`` of its largest magnitude plus
    ``atol``; leaves named in ``loose`` within ``loose_atol``."""
    got, want = _named(got_tree), _named(want_tree)
    assert set(got) == set(want)
    for name, w in want.items():
        err = float(np.abs(got[name] - w).max())
        tol = (loose_atol if name in loose
               else rtol_of_max * float(np.abs(w).max()) + atol)
        assert err <= tol, (name, err, tol)


def _equal(got_tree, want_tree):
    got, want = _named(got_tree), _named(want_tree)
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_array_equal(got[name], w, err_msg=name)


class SGD:
    """Plain SGD (``optax.sgd``) with the port's ``AdamW`` interface."""

    def __init__(self, lr: float):
        self.lr = lr

    def init(self, params) -> dict:
        return {}

    @torch.no_grad()
    def update(self, params, grads, state) -> dict:
        for p, g in grads.items():
            p.copy_(p + g * -self.lr)
        return state


def _adam(lr):
    """``optax.adam(lr)`` with the port's ``AdamW``."""
    return AdamW(lambda count: lr, b1=0.9, b2=0.999, eps=1e-8,
                 weight_decay=0.0, grad_clip=None)


# ------------------------------------------------------------ distillation


def test_embedding_similarity_loss_zero_for_identical():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 5, 8)).astype(np.float32))
    loss = ttad.embedding_similarity_loss
    assert float(loss(x, x, "cosine")) < 1e-6
    assert float(loss(x, x, "l2")) == 0.0
    assert float(loss(x, x, "cosine", relational=True)) < 1e-6
    with pytest.raises(ValueError):
        loss(x, x, "dot")


@pytest.mark.parametrize("relational", [False, True],
                         ids=["elementwise", "relational"])
@pytest.mark.parametrize("kind", ["cosine", "l2"])
def test_embedding_similarity_loss_matches_jax(kind, relational):
    rng = np.random.default_rng(3)
    for shape in ((2, 5, 8), (3, 8)):       # patches, and pooled outputs
        s, t = (rng.standard_normal(shape).astype(np.float32)
                for _ in range(2))
        want = float(jtad.embedding_similarity_loss(
            jnp.asarray(s), jnp.asarray(t), kind, relational))
        got = float(ttad.embedding_similarity_loss(
            torch.from_numpy(s), torch.from_numpy(t), kind, relational))
        assert abs(got - want) <= 1e-6, (shape, got, want)


def _distill_batch(j, seed=0):
    """Pixels from a seed and the JAX caption model's hidden states, as
    numpy: both steps see the same inputs."""
    size = j["cfg"].vision.image_size
    rng = np.random.default_rng(seed)
    hidden, mask = j["bundle"].embed_captions(["caption one",
                                               "caption number two"])
    return {"teacher_pixels": rng.standard_normal(
                (2, size, size, 3)).astype(np.float32),
            "student_pixels": rng.standard_normal(
                (2, size, size, 3)).astype(np.float32) * 0.1,
            "caption_hidden": np.asarray(hidden),
            "caption_mask": np.asarray(mask)}


def _torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def test_distill_step_matches_jax(setup):
    """Loss, its four terms and ``per_layer`` within 1e-5; the adapter
    after 2 SGD steps within 1e-4; the tower untouched."""
    j, t, tree, atree = setup
    batch = _distill_batch(j)
    jopt = optax.sgd(0.05)
    jstep = jax.jit(jtad.make_distill_step(
        j["cfg"], j["params"].vision, jopt,
        jtad.DistillLossConfig()))
    jstate = jtad.DistillState(j["bundle"].adapter_params,
                               jopt.init(j["bundle"].adapter_params), 0)
    adapter = t["new_bundle"]().adapter_params.requires_grad_(True)
    topt = SGD(0.05)
    tstep = ttad.make_distill_step(t["cfg"], t["params"].vision, topt,
                                   ttad.DistillLossConfig())
    tstate = ttad.DistillState(adapter, topt.init(adapter), 0)
    for _ in range(2):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tstate, tm = tstep(tstate, _torch(batch))
        assert set(tm) == set(jm)
        for k in ("loss", "pool", "avg", "patch", "layer"):
            assert abs(float(tm[k]) - float(jm[k])) <= 1e-5, k
        np.testing.assert_allclose(tm["per_layer"].numpy(),
                                   np.asarray(jm["per_layer"]), rtol=0,
                                   atol=1e-5)
    assert tm["per_layer"].shape == (t["cfg"].vision.num_hidden_layers,)
    assert tstate.step == 2
    _close(convert.adapter_to_numpy(adapter), _np(jstate.adapter_params))
    _equal(convert.params_to_numpy(t["params"].vision), tree["vision"])
    # the steps moved the adapter
    moved = convert.adapter_to_numpy(adapter)["connector"]["kernel"]
    assert np.abs(moved - atree["connector"]["kernel"]).max() > 0


def test_distill_step_trains_adapter(setup):
    """The JAX test's drive (Adam 1e-3, 5 steps) in the port: the loss
    falls."""
    j, t, _, _ = setup
    bundle = t["new_bundle"]()
    adapter = bundle.adapter_params.requires_grad_(True)
    opt = _adam(1e-3)
    step = ttad.make_distill_step(t["cfg"], t["params"].vision, opt,
                                  ttad.DistillLossConfig())
    state = ttad.DistillState(adapter, opt.init(adapter), 0)
    size = t["cfg"].vision.image_size
    hidden, mask = bundle.embed_captions(["caption one", "caption two"])
    rng = np.random.default_rng(0)
    batch = {"teacher_pixels": torch.from_numpy(rng.standard_normal(
                 (2, size, size, 3)).astype(np.float32)),
             "student_pixels": torch.zeros((2, size, size, 3)),
             "caption_hidden": hidden, "caption_mask": mask}
    losses = []
    for _ in range(5):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0]
    assert metrics["per_layer"].shape == (t["cfg"].vision.num_hidden_layers,)


def test_embed_captions_output_enters_the_graph(setup):
    """``embed_captions`` runs under ``no_grad``, not ``inference_mode``:
    its hidden states and mask are ordinary tensors, and the distillation
    step's backward runs through them into the adapter's connector."""
    _, t, _, _ = setup
    bundle = t["new_bundle"]()
    hidden, mask = bundle.embed_captions(["a caption", "another"])
    assert not hidden.is_inference() and not mask.is_inference()
    assert not hidden.requires_grad
    adapter = bundle.adapter_params.requires_grad_(True)
    grads = {}

    class Capture(SGD):
        def update(self, params, g, state):
            grads.update(g)
            return state

    step = ttad.make_distill_step(t["cfg"], t["params"].vision,
                                  Capture(0.0), ttad.DistillLossConfig())
    size = t["cfg"].vision.image_size
    step(ttad.DistillState(adapter, {}, 0), {
        "teacher_pixels": torch.ones((2, size, size, 3)),
        "student_pixels": torch.zeros((2, size, size, 3)),
        "caption_hidden": hidden, "caption_mask": mask})
    assert float(grads[adapter.connector.weight].abs().max()) > 0
    # the tower is not differentiated
    assert not any(p.requires_grad for p in t["params"].parameters())


def test_adapter_dataset_students_equal_jax():
    """For a seed, the same mode, edit and partner: student images equal
    bit for bit over indices that hit all three modes and the edits."""
    items = [{"image": _figure(i), "text": f"c{i}"} for i in range(5)]
    jd = jtad.AdapterDataset(items, seed=7)
    td = ttad.AdapterDataset(items, seed=7)
    modes = np.random.default_rng(7)
    seen = set()
    for idx in [0, 1, 2, 3, 4] * 3:
        mode = int(modes.integers(3))
        if mode == 2:
            seen.add(2 + int(modes.integers(3)))
            modes.integers(5)
        else:
            seen.add(mode)
        a, b = jd[idx]["student_image"], td[idx]["student_image"]
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert {0, 1} <= seen and len(seen & {2, 3, 4}) >= 2
    assert len(td) == 5


def test_pretrain_adapter_end_to_end_matches_jax(setup, tmp_path):
    """4 figures, batch 2, one epoch: the adapter within 1e-4 of JAX's (the
    key-shift leaves within the learning rate: Adam turns their rounding
    noise into a step of either sign), a checkpoint written per epoch,
    the tower untouched and the adapter frozen again."""
    j, t, tree, _ = setup
    data = [{"image": _figure(i), "text": f"a figure with {i} circles"}
            for i in range(4)]
    kw = dict(batch_size=2, micro_batch_size=2, learning_rate=1e-3,
              epochs=1, seed=3)
    b = j["bundle"]        # a fresh bundle: the loop replaces its adapter
    jb = JBundle(b.adapter_params, b.adapter_cfg, b.embed_params,
                 b.embed_cfg, b.tokenizer, max_length=b.max_length)
    jout = jtad.pretrain_adapter(str(tmp_path / "jax"), jb, j["cfg"],
                                 j["params"].vision, data,
                                 log_fn=lambda m: None, **kw)
    bundle = t["new_bundle"]()
    logs = []
    tout = ttad.pretrain_adapter(str(tmp_path / "port"), bundle, t["cfg"],
                                 t["params"].vision, data,
                                 log_fn=logs.append, **kw)
    assert tout is bundle.adapter_params
    assert not any(p.requires_grad for p in tout.parameters())
    # two updates, the first at the warmup's learning rate 0
    _close(convert.adapter_to_numpy(tout), _np(jout),
           loose=KEY_SHIFT_LEAVES, loose_atol=1e-3 * 1.01 + 1e-6)
    assert (tmp_path / "port" / "checkpoint-2" / "meta.json").exists()
    saved = torch.load(tmp_path / "port" / "checkpoint-2" / "state.pt",
                       weights_only=True)
    assert torch.equal(saved["params"]["connector.weight"],
                       tout.connector.weight)
    _equal(convert.params_to_numpy(t["params"].vision), tree["vision"])


def test_adapter_to_numpy_round_trip(setup):
    _, t, _, atree = setup
    adapter = t["bundle"].adapter_params
    back = convert.adapter_to_numpy(adapter)
    _equal(back, atree)
    again = convert.adapter_from_numpy(back, t["cfg"].vision,
                                       t["cfg"].adapter, device="cpu")
    for (n, a), (_, b) in zip(adapter.state_dict().items(),
                              again.state_dict().items()):
        assert torch.equal(a, b), n
    # gradients (any tensors keyed by the weights) in the JAX layout
    grads = convert.adapter_to_numpy(adapter, {
        adapter.connector.weight: torch.ones_like(adapter.connector.weight)})
    assert (grads["connector"]["kernel"] == 1).all()
    assert grads["connector"]["kernel"].shape == atree["connector"][
        "kernel"].shape


# ---------------------------------------------------------------- TikZero+


def _aprocs(j, t):
    return (JAProc(j["proc"], j["tok"], max_length=16),
            TAProc(t["proc"], t["tok"], max_length=16))


def test_tokenize_caption_condition(setup):
    j, t, _, _ = setup
    _, ap = _aprocs(j, t)
    batch = ttad.tokenize_adapter_batch(
        ap, captions=["cap"], codes=["xy;"], caption_condition=True)
    ids, labels = batch["input_ids"][0], batch["labels"][0]
    seq = t["proc"].image_seq_len
    cap_len = len(t["tok"].encode("cap"))
    sep = seq + cap_len
    assert ids[sep] == t["cfg"].bos_token_id
    assert (labels[:sep + 1] == -100).all()
    code_ids = t["tok"].encode("xy;")
    assert list(labels[sep + 1:sep + 1 + len(code_ids)]) == code_ids
    assert labels[sep + 1 + len(code_ids)] == t["cfg"].eos_token_id


@pytest.mark.parametrize("caption_condition", [True, False],
                         ids=["caption_condition", "image"])
def test_tokenize_adapter_batch_equal_jax(setup, caption_condition):
    j, t, _, _ = setup
    jap, tap = _aprocs(j, t)
    kw = dict(captions=["a cap", "a much longer caption here"],
              codes=["\\draw (0,0);", "xy;"],
              images=[_figure(0), _figure(2)],
              caption_condition=caption_condition)
    want = jtad.tokenize_adapter_batch(jap, **kw)
    got = ttad.tokenize_adapter_batch(tap, **kw)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
        assert got[k].dtype == np.asarray(v).dtype, k


def _llm_batch(j, t, caption_condition=True):
    jap, tap = _aprocs(j, t)
    kw = dict(captions=["cap one", "cap two two"],
              codes=["\\draw (0,0) -- (1,1);", "xy;"],
              images=[_figure(1), _figure(3)],
              caption_condition=caption_condition)
    batch = ttad.tokenize_adapter_batch(tap, **kw)
    hidden, mask = j["bundle"].embed_captions(kw["captions"])
    batch.pop("adapter_input_ids")
    batch.pop("adapter_attention_mask")
    batch["caption_hidden"] = np.asarray(hidden)
    batch["caption_mask"] = np.asarray(mask)
    return batch


def test_adapter_llm_step_matches_jax(setup):
    """Loss within 1e-5 and the text tower after 2 SGD steps within 1e-4;
    vision, connector and adapter untouched."""
    j, t, tree, atree = setup
    batch = _llm_batch(j, t)
    jopt = optax.sgd(0.05)
    jstep = jax.jit(jtad.make_adapter_train_step(
        j["cfg"], j["params"], j["bundle"], jopt, attn_impl="xla"))
    jstate = JLLMState(j["params"].text,
                                        jopt.init(j["params"].text), 0)
    params = t["params"]
    text = convert.params_from_numpy(tree, t["cfg"], device="cpu").text
    text.requires_grad_(True)
    topt = SGD(0.05)
    tstep = ttad.make_adapter_train_step(t["cfg"], params, t["bundle"], topt)
    tstate = TLLMState(text, topt.init(text), 0)
    for _ in range(2):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tstate, tm = tstep(tstate, _torch(batch))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5
    _close(convert.params_to_numpy(text), _np(jstate.text_params))
    frozen = convert.params_to_numpy(params)
    for part in ("vision", "connector", "text"):
        _equal(frozen[part], tree[part])
    _equal(convert.adapter_to_numpy(t["bundle"].adapter_params), atree)


def test_adapter_llm_step_freezes_everything_but_text(setup):
    """The JAX test's drive (Adam 1e-2, one caption-conditioned step on the
    adapter's blank image) in the port."""
    j, t, tree, _ = setup
    _, ap = _aprocs(j, t)
    params = t["params"]
    text = convert.params_from_numpy(tree, t["cfg"], device="cpu").text
    text.requires_grad_(True)
    opt = _adam(1e-2)
    step = ttad.make_adapter_train_step(t["cfg"], params, t["bundle"], opt)
    state = TLLMState(text, opt.init(text), 0)
    batch = _torch(ttad.tokenize_adapter_batch(
        ap, captions=["cap"], codes=["xy;"], caption_condition=True))
    hidden, mask = t["bundle"].embed_captions(["cap"])
    batch.pop("adapter_input_ids")
    batch.pop("adapter_attention_mask")
    batch.update(caption_hidden=hidden, caption_mask=mask,
                 pixel_values=tadapter.dummy_pixels(
                     t["bundle"].adapter_params, 1))
    new_state, metrics = step(state, batch)
    assert np.isfinite(float(metrics["loss"]))
    delta = float((new_state.text_params.embed_tokens.detach()
                   - params.text.embed_tokens).abs().max())
    assert delta > 0
    _equal(convert.params_to_numpy(params)["text"], tree["text"])


@pytest.mark.parametrize("mode", ["caption_condition", "image", "text_only"])
def test_train_adapter_llm_end_to_end_matches_jax(setup, tmp_path, mode):
    """4 items, micro 2, one epoch (2 steps, the first at learning rate 0):
    the returned text tower within 1e-4 of JAX's, the returned vision and
    connector the caller's, the caller's ``params`` unchanged, one
    checkpoint written."""
    j, t, tree, _ = setup
    jap, tap = _aprocs(j, t)
    items = [{"caption": f"cap {i}", "code": f"\\draw ({i},0) -- (1,{i});"}
             for i in range(4)]
    if mode == "image":
        for i, it in enumerate(items):
            it["image"] = _figure(i)
    kw = dict(caption_condition=mode == "caption_condition",
              micro_batch_size=2, learning_rate=1e-3, seed=5)
    jout = jtad.train_adapter_llm(str(tmp_path / "jax"), j["params"],
                                  j["cfg"], jap, j["bundle"], items,
                                  log_fn=lambda m: None, **kw)
    params = t["params"]
    tout = ttad.train_adapter_llm(str(tmp_path / "port"), params, t["cfg"],
                                  tap, t["bundle"], items,
                                  log_fn=lambda m: None, **kw)
    assert tout.vision is params.vision
    assert tout.connector is params.connector
    assert tout.text is not params.text
    assert not any(p.requires_grad for p in tout.parameters())
    _close(convert.params_to_numpy(tout.text), _np(jout.text))
    moved = convert.params_to_numpy(tout.text)["embed_tokens"]
    assert np.abs(moved - tree["text"]["embed_tokens"]).max() > 0
    _equal(convert.params_to_numpy(params)["text"], tree["text"])
    assert (tmp_path / "port" / "checkpoint-2" / "meta.json").exists()


# -------------------------------------------------------------------- GRPO


def test_group_advantages():
    rewards = np.array([1.0, 0.0, 1.0, 1.0])
    adv = tgrpo.group_advantages(rewards, 2)
    assert adv[0] > 0 > adv[1]
    assert adv[2] == adv[3] == pytest.approx(0.0)
    r = np.random.default_rng(0).standard_normal(24)
    for g in (4, 8):
        np.testing.assert_allclose(tgrpo.group_advantages(r, g),
                                   jgrpo.group_advantages(r, g), rtol=0,
                                   atol=1e-6)


def _grpo_inputs(cfg, seed=0, b=2, s=10, vocab=512):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (b, s)).astype(np.int32)
    mask = np.zeros((b, s), bool)
    mask[:, 4:] = True
    mask[-1, -2:] = False              # a shorter rollout, padded
    return tokens, mask


def test_sequence_logprobs_matches_jax(setup):
    j, t, _, _ = setup
    tokens, mask = _grpo_inputs(j["cfg"])
    want = np.asarray(jgrpo.sequence_logprobs(
        j["params"], j["cfg"], jnp.asarray(tokens), None, jnp.asarray(mask),
        attn_impl="xla"))
    got = tgrpo.sequence_logprobs(t["params"], t["cfg"],
                                  torch.from_numpy(tokens), None,
                                  torch.from_numpy(mask)).numpy()
    assert got.shape == (2, 9)
    assert (got[:, :3] == 0).all() and (got[:, 3:7] < 0).all()
    assert (got[-1, -2:] == 0).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


GRPO_CASES = ("implied", "pinned", "kl", "vision_feats", "pixel_values")


@pytest.mark.parametrize("case", GRPO_CASES)
def test_grpo_step_matches_jax(setup, case):
    """Loss, ratio_mean and logp_mean within 1e-5; the weights after one
    SGD step within 1e-4 (the tower too when the pixels carry grads)."""
    j, t, tree, _ = setup
    cfg, tcfg = j["cfg"], t["cfg"]
    seq = cfg.image_seq_len
    tokens, mask = _grpo_inputs(cfg, seed=1, s=seq + 8)
    mask[:, :seq + 1] = False
    gcfg = dict(clip_eps=0.2, learning_rate=1e-3)
    if case in ("vision_feats", "pixel_values"):
        tokens[:, :seq] = cfg.image_token_id
    rng = np.random.default_rng(2)
    batch = {"tokens": tokens, "completion_mask": mask,
             "advantages": np.asarray([1.0, -0.5], np.float32)}
    jlp = np.asarray(jgrpo.sequence_logprobs(
        j["params"], cfg, jnp.asarray(tokens), None, jnp.asarray(mask),
        attn_impl="xla"))
    if case == "pinned":
        batch["old_logprobs"] = (jlp + rng.uniform(
            -0.3, 0.3, jlp.shape)).astype(np.float32)
    if case == "kl":
        gcfg["beta"] = 0.04
        batch["ref_logprobs"] = (jlp + rng.uniform(
            -0.5, 0.5, jlp.shape)).astype(np.float32)
    size = cfg.vision.image_size
    if case == "vision_feats":
        batch["vision_feats"] = rng.standard_normal(
            (2, seq * cfg.concat_factor, cfg.vision.hidden_size)).astype(
                np.float32)
    if case == "pixel_values":
        batch["pixel_values"] = rng.standard_normal(
            (2, size, size, 3)).astype(np.float32)
    jstep = jax.jit(jgrpo.make_grpo_step(cfg, optax.sgd(1e-2),
                                         jgrpo.GRPOConfig(**gcfg),
                                         attn_impl="xla"))
    jstate = jgrpo.GRPOState(j["params"], optax.sgd(1e-2).init(
        j["params"]), 0)
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    params = convert.params_from_numpy(tree, tcfg, device="cpu")
    params.requires_grad_(True)
    tstep = tgrpo.make_grpo_step(tcfg, SGD(1e-2), tgrpo.GRPOConfig(**gcfg))
    tstate, tm = tstep(tgrpo.GRPOState(params, {}, 0), _torch(batch))
    assert tstate.step == 1
    for k in ("loss", "ratio_mean", "logp_mean"):
        assert abs(float(tm[k]) - float(jm[k])) <= 1e-5, k
    if case == "implied":
        assert float(tm["ratio_mean"]) == pytest.approx(1.0, abs=1e-6)
    _close(convert.params_to_numpy(params), _np(jstate.params._asdict()))
    moved = convert.params_to_numpy(params)
    assert np.abs(moved["text"]["embed_tokens"]
                  - tree["text"]["embed_tokens"]).max() > 0
    vision_moved = np.abs(moved["vision"]["embeddings"]["patch"]["kernel"]
                          - tree["vision"]["embeddings"]["patch"]["kernel"]
                          ).max()
    assert (vision_moved > 0) == (case == "pixel_values")


def test_grpo_step_clipping_with_old_logprobs(setup):
    """Explicit old_logprobs equal to the policy's give the implied path's
    loss; far below it, the clipped surrogate caps the loss at
    -(1+eps)*adv exactly."""
    _, t, tree, _ = setup
    tcfg = t["cfg"]
    gcfg = tgrpo.GRPOConfig(clip_eps=0.2, learning_rate=1e-3)
    tokens, mask = _grpo_inputs(tcfg)
    mask[-1, -2:] = True
    base = {"tokens": torch.from_numpy(tokens),
            "completion_mask": torch.from_numpy(mask),
            "advantages": torch.tensor([1.0, 1.0])}
    lp = tgrpo.sequence_logprobs(t["params"], tcfg, base["tokens"], None,
                                 base["completion_mask"]).detach()

    def loss_of(batch):
        params = convert.params_from_numpy(tree, tcfg, device="cpu")
        params.requires_grad_(True)
        step = tgrpo.make_grpo_step(tcfg, SGD(1e-3), gcfg)
        return float(step(tgrpo.GRPOState(params, {}, 0), batch)[1]["loss"])

    implied = loss_of(dict(base))
    pinned = loss_of(dict(base, old_logprobs=lp))
    assert implied == pytest.approx(pinned, rel=1e-5)
    assert loss_of(dict(base, old_logprobs=lp - 5.0)) == pytest.approx(
        -(1 + gcfg.clip_eps), rel=1e-5)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_refine_optimizer_matches_optax(setup, dtype):
    """``refine``'s optimizer against ``optax.chain(clip_by_global_norm,
    adamw)`` under ``multi_transform`` freezing the tower, 5 updates (the
    clip acting in some): fp32 within 1e-6; bf16 weights with bf16
    moments within, at each of the 5 updates, a bf16 unit of the weight
    and 2^-5 of the learning rate (the update's roundings) (+1e-6)."""
    j, t, tree, _ = setup
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    gcfg = tgrpo.GRPOConfig(learning_rate=1e-2, grad_clip=1.0)
    jp = jax.tree.map(lambda x: jnp.asarray(x, jdt), j["params"])
    mask = jax.tree.map(lambda _: "train", jp)._replace(
        vision=jax.tree.map(lambda _: "freeze", jp.vision))
    jopt = optax.multi_transform(
        {"train": optax.chain(optax.clip_by_global_norm(gcfg.grad_clip),
                              optax.adamw(gcfg.learning_rate)),
         "freeze": optax.set_to_zero()}, mask)
    params = convert.params_from_numpy(tree, t["cfg"], device="cpu",
                                       dtype=tdt)
    topt = tgrpo.make_refine_optimizer(params, gcfg)
    assert not any(p.requires_grad for p in params.vision.parameters())
    assert all(p.requires_grad for p in params.text.parameters())
    js, ts = jopt.init(jp), topt.init(params)
    assert not any(k.startswith("vision/") for k in ts["moments"])
    update = jax.jit(jopt.update)
    rng = np.random.default_rng(4)
    for i in range(5):
        scale = 10.0 ** (i - 3)           # the global norm crosses 1
        gtree = jax.tree.map(
            lambda x: (rng.standard_normal(x.shape) * scale).astype(
                np.float32), tree)
        jg = jax.tree.map(lambda x: jnp.asarray(x, jdt), jdet.Params(**gtree))
        u, js = update(jg, js, jp)
        jp = optax.apply_updates(jp, u)
        gparams = convert.params_from_numpy(gtree, t["cfg"], device="cpu",
                                            dtype=tdt)
        grads = {p: g for lp, lg in zip(convert.leaves(params),
                                        convert.leaves(gparams))
                 if not lp.path.startswith("vision/")
                 for p, g in zip(lp.tensors, lg.tensors)}
        ts = topt.update(params, grads, ts)
    got, want = (_named(convert.params_to_numpy(params)),
                 _named(_np(jax.tree.map(lambda x: x.astype(jnp.float32),
                                         jp._asdict()))))
    assert set(got) == set(want)
    for name, w in want.items():
        if dtype == "fp32":
            tol = 1e-6
        else:
            # at each of the 5 updates, a bf16 unit of the weight (a weight
            # that rounds to a neighbour stays there) and 2^-5 of the
            # learning rate: XLA keeps the fused update's intermediates in
            # fp32, the port rounds each of its ~10 operations to bf16
            tol = 5 * (2.0 ** -7 * np.abs(w)
                       + 2.0 ** -5 * gcfg.learning_rate) + 1e-6
        err = np.abs(got[name] - w)
        assert (err <= tol).all(), (name, float((err / tol).max()))
    for name in got:            # the frozen tower, as given
        if name.startswith("vision/"):
            np.testing.assert_array_equal(got[name], want[name])
    if dtype == "bf16":
        m = ts["moments"]["text/embed_tokens"]
        assert m["mu"][0].dtype == torch.bfloat16


CODES = ["\\draw (0,0) -- (1,1);", "\\node {a};\n\\errorline",
         "\\draw (0,0) circle (1);", "\\begin{scope}\n\\draw (0,0);",
         "\\fill (1,1) rectangle (2,2);"]


@pytest.mark.parametrize("strict", [False, True])
def test_selfsim_reward_matches_jax(setup, strict):
    """Rewards equal to JAX's within 1e-5: -1 where a program does not
    rasterize (an injected error) or, with ``strict``, compiled with
    errors (an unclosed scope, rendered anyway)."""
    j, t, _, _ = setup
    imgs = [_figure(i) for i in range(len(CODES))]
    jr = jgrpo.SelfSimReward(JImageSim.from_detikzify(j["params"], j["cfg"]),
                             JCompile(workers=2, backend=JFake()),
                             strict=strict)
    tr = tgrpo.SelfSimReward(TImageSim.from_detikzify(t["params"], t["cfg"]),
                             TCompile(workers=2, backend=TFake()),
                             strict=strict)
    want, got = jr(imgs, CODES), tr(imgs, CODES)
    assert got[1] == -1.0 and (got[3] == -1.0) == strict
    assert (got[[0, 2, 4]] > -1).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _staggered(engine_cls):
    """A greedy engine whose rollouts stop after 3, 5, 7, 9, ... new
    tokens in the order they start: prefixes of one greedy stream, of
    different lengths, so the group's gradient does not cancel."""

    class Staggered(engine_cls):
        started = 0

        def start_many(self, prompts, image_embeds=None, *,
                       max_new_tokens=1024, **kw):
            lens = [min(max_new_tokens, 3 + 2 * ((self.started + i) % 4))
                    for i in range(len(prompts))]
            self.started += len(prompts)
            return super().start_many(prompts, image_embeds,
                                      max_new_tokens=lens, **kw)

    return Staggered


def test_refine_matches_jax_greedy(setup):
    """``refine`` end to end in both packages on greedy engines (passed in
    through ``engine=``) with a reward by rollout index: 2 steps with the
    KL anchor and 2 updates a batch (the ref and old log-prob passes).
    The refined weights within 1e-4 of JAX's, the tower shared and
    untouched, the caller's ``params`` (the KL anchor) unchanged."""
    j, t, tree, _ = setup
    cfg, tcfg = j["cfg"], t["cfg"]
    gcfg = dict(num_generations=4, max_new_tokens=9, learning_rate=1e-3,
                beta=0.04, updates_per_batch=2)
    max_len = cfg.image_seq_len + 2 + 9
    imgs = [_figure(0), _figure(4)]
    rewards = []

    def reward(images, codes):
        rewards.append(list(codes))
        return np.arange(len(codes), dtype=np.float64)

    jeng = _staggered(JEngine)(j["params"], cfg, num_slots=4,
                               max_len=max_len,
                               sampling=JSampling(temperature=0.0))
    jlogs = []
    jout = jgrpo.refine(j["params"], cfg, j["proc"], imgs, reward,
                        gcfg=jgrpo.GRPOConfig(**gcfg), engine=jeng,
                        steps=2, prompts_per_step=2, attn_impl="xla",
                        log_fn=jlogs.append)
    params = t["params"]
    teng = _staggered(TEngine)(params, tcfg, num_slots=4, max_len=max_len,
                               sampling=TSampling(temperature=0.0),
                               device="cpu")
    tlogs = []
    tout = tgrpo.refine(params, tcfg, t["proc"], imgs, reward,
                        gcfg=tgrpo.GRPOConfig(**gcfg), engine=teng,
                        steps=2, prompts_per_step=2, log_fn=tlogs.append)
    # the same rollouts (decoded programs) on both sides
    assert rewards[:2] == rewards[2:]
    assert len(tlogs) == 2 and teng.params is tout
    assert tout.vision is params.vision and tout.text is not params.text
    _close(convert.params_to_numpy(tout), _np(jout._asdict()))
    moved = convert.params_to_numpy(tout)
    assert np.abs(moved["text"]["embed_tokens"]
                  - tree["text"]["embed_tokens"]).max() > 0
    assert np.abs(moved["connector"]["proj"]["kernel"]
                  - tree["connector"]["proj"]["kernel"]).max() > 0
    for part in ("vision", "connector", "text"):
        _equal(convert.params_to_numpy(params)[part], tree[part])
    # the logged loss and ratio agree
    for a, b in zip(tlogs, jlogs):
        got = [float(x.split()[0].rstrip(",")) for x in
               (a.split("loss ")[1], a.split("ratio ")[1])]
        want = [float(x.split()[0].rstrip(",")) for x in
                (b.split("loss ")[1], b.split("ratio ")[1])]
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


# ---------------------------------- GRPO's sampled behaviours (port alone)


@pytest.fixture(scope="module")
def policy():
    cfg = t_tiny_test_config(vocab_size=512)
    tok = TTok(vocab_size=512, image_token_id=cfg.image_token_id,
               bos_token_id=cfg.bos_token_id, eos_token_id=cfg.eos_token_id,
               model_max_length=64)
    return cfg, TProc(tok, cfg)


def _params(cfg, seed):
    """The JAX tests' weights, ``detikzify.init(PRNGKey(seed))``."""
    tree = _np(jdet.init(jax.random.PRNGKey(seed),
                         tiny_test_config(vocab_size=512))._asdict())
    return convert.params_from_numpy(tree, cfg, device="cpu")


def _letters(codes):
    """A dense reward: the share of lowercase letters in each program. (The
    JAX tests reward the share of 'x', which rests on its sampler drawing
    an 'x' within the first steps; the port's sampler draws other tokens,
    and a 1-in-512 token gives most runs no signal at all.)"""
    return np.asarray([sum("a" <= ch <= "z" for ch in c) / max(len(c), 1)
                       for c in codes])


def _reward(policy, params):
    cfg, _ = policy
    return tgrpo.SelfSimReward(TImageSim.from_detikzify(params, cfg),
                               TCompile(workers=2, backend=TFake()))


def test_refine_runs_and_updates(policy):
    cfg, proc = policy
    params = _params(cfg, 1)
    before = convert.params_to_numpy(params)
    img = Image.new("RGB", (80, 80), "white")
    ImageDraw.Draw(img).rectangle([10, 10, 70, 70], outline="black")
    logs = []
    new = tgrpo.refine(params, cfg, proc, [img], _reward(policy, params),
                       gcfg=tgrpo.GRPOConfig(num_generations=4,
                                             max_new_tokens=12,
                                             learning_rate=1e-4),
                       steps=2, log_fn=logs.append)
    assert len(logs) == 2 and "reward mean" in logs[0]
    after = convert.params_to_numpy(new)
    assert np.isfinite(after["text"]["embed_tokens"]).all()
    # the vision TOWER is frozen (reference refine.py:198-207) ...
    _equal(after["vision"], before["vision"])
    # ... the CONNECTOR projection trains
    assert np.abs(after["connector"]["proj"]["kernel"]
                  - before["connector"]["proj"]["kernel"]).max() > 0
    _equal(convert.params_to_numpy(params), before)


def test_refine_kl_and_multi_prompt(policy):
    cfg, proc = policy
    params = _params(cfg, 2)
    before = convert.params_to_numpy(params)
    imgs = []
    for i in range(2):
        im = Image.new("RGB", (80, 80), "white")
        ImageDraw.Draw(im).ellipse([8 + 6 * i, 8, 70, 70], outline="black")
        imgs.append(im)
    logs = []
    new = tgrpo.refine(params, cfg, proc, imgs, _reward(policy, params),
                       gcfg=tgrpo.GRPOConfig(num_generations=2,
                                             max_new_tokens=8,
                                             learning_rate=1e-4, beta=0.04),
                       steps=2, prompts_per_step=2, log_fn=logs.append)
    assert len(logs) == 2
    assert all(np.isfinite(float(m.split("loss ")[1].split(",")[0]))
               for m in logs)
    delta = np.abs(convert.params_to_numpy(new)["text"]["embed_tokens"]
                   - before["text"]["embed_tokens"]).max()
    assert np.isfinite(delta) and delta > 0
    _equal(convert.params_to_numpy(params), before)


def test_refine_learning_gate(policy):
    """Reward mean must IMPROVE over steps on a deterministic dense-reward
    toy: a sign error in the advantage or the surrogate drives the reward
    down or flat and fails this gate. 20 steps: the port's runs reach
    0.94-1.0 by then from 0.02-0.25."""
    cfg, proc = policy
    params = _params(cfg, 1)
    img = Image.new("RGB", (80, 80), "white")
    means = []

    def reward(images, codes):
        r = _letters(codes)
        means.append(float(r.mean()))
        return r

    tgrpo.refine(params, cfg, proc, [img], reward,
                 gcfg=tgrpo.GRPOConfig(num_generations=8, max_new_tokens=8,
                                       learning_rate=3e-3),
                 steps=20, log_fn=lambda m: None)
    assert len(means) == 20
    early, late = np.mean(means[:3]), np.mean(means[-3:])
    assert late > early + 0.3, \
        f"no learning: early {early:.3f} -> late {late:.3f} ({means})"


def test_refine_multi_update_old_logprobs(policy):
    """updates_per_batch > 1 pins old_logprobs to the rollout policy, so
    the epochs after the first optimize a real ratio != 1."""
    cfg, proc = policy
    params = _params(cfg, 3)
    before = convert.params_to_numpy(params)
    img = Image.new("RGB", (80, 80), "white")

    def reward(images, codes):
        return _letters(codes)

    logs = []
    new = tgrpo.refine(params, cfg, proc, [img], reward,
                       gcfg=tgrpo.GRPOConfig(num_generations=4,
                                             max_new_tokens=8,
                                             learning_rate=3e-3,
                                             updates_per_batch=3),
                       steps=2, log_fn=logs.append)
    assert len(logs) == 2
    ratios = [float(m.split("ratio ")[1]) for m in logs]
    assert all(np.isfinite(r) for r in ratios)
    assert any(abs(r - 1.0) > 1e-4 for r in ratios)
    delta = np.abs(convert.params_to_numpy(new)["text"]["embed_tokens"]
                   - before["text"]["embed_tokens"]).max()
    assert np.isfinite(delta) and delta > 0
