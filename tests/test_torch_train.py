"""The port's training core against the JAX package, on the CPU in fp32.

One ``detikzify.init(PRNGKey(0), tiny_test_config(vocab_size=512))`` tree
is carried to the port with ``params_from_numpy``; inputs are made from a
numpy seed and go through both packages. Mirrors ``tests/test_train.py``
(all but ``test_checkpoint_restore_across_mesh_shapes``, which needs a
device mesh). Tolerances: data and augmentation bit for bit; K1's gradients
1e-5; loss 1e-5 and gradients 1e-4 of each leaf's largest (+1e-6); the
optimizers in isolation 1e-6 on the parameters, their 8-bit moments and
bf16 moments bit for bit; whole steps 1e-4 (``_steps_close``); remat 1e-6.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from PIL import Image, ImageDraw

from detikzify_tpu.config import tiny_test_config
from detikzify_tpu.data import augment as jaug
from detikzify_tpu.dataset.synthetic import generate_corpus as jcorpus
from detikzify_tpu.models import detikzify as jdet
from detikzify_tpu.ops.flash import flash_attention as jflash
from detikzify_tpu.processing import ByteTokenizer as JTok
from detikzify_tpu.processing import DetikzifyProcessor as JProc
from detikzify_tpu.train import checkpoint as jckpt
from detikzify_tpu.train import data as jdata
from detikzify_tpu.train import step as jstep
from detikzify_torch.config import tiny_test_config as t_tiny_test_config
from detikzify_torch.data import augment as taug
from detikzify_torch.dataset.synthetic import generate_corpus as tcorpus
from detikzify_torch.models import convert
from detikzify_torch.models.load import _overlay_projector
from detikzify_torch.ops import flash as tflash
from detikzify_torch.processing import ByteTokenizer as TTok
from detikzify_torch.processing import DetikzifyProcessor as TProc
from detikzify_torch.train import checkpoint as tckpt
from detikzify_torch.train import data as tdata
from detikzify_torch.train import step as tstep
from detikzify_torch.train import (TrainConfig, Trainer, get_last_checkpoint,
                                   pretrain)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_test_config(vocab_size=512)
    jparams = jdet.init(jax.random.PRNGKey(0), cfg)
    tree = jax.tree.map(np.asarray, jparams._asdict())
    tcfg = t_tiny_test_config(vocab_size=512)
    kw = dict(vocab_size=512, image_token_id=cfg.image_token_id,
              bos_token_id=cfg.bos_token_id, eos_token_id=cfg.eos_token_id,
              model_max_length=64)
    return (cfg, jparams, tree, tcfg, JProc(JTok(**kw), cfg),
            TProc(TTok(**kw), tcfg))


def _port_params(setup):
    """A fresh copy of the JAX weights in the port, every leaf trainable."""
    _, _, tree, tcfg, _, _ = setup
    params = convert.params_from_numpy(tree, tcfg, device="cpu")
    return params, tstep.trainable_mask(params, "all")


def _figure(seed=0):
    img = Image.new("RGB", (96, 64), "white")
    d = ImageDraw.Draw(img)
    d.rectangle([5 + seed, 5, 90, 58], outline="black", width=2)
    d.line([10, 50 - seed, 80, 10 + seed], fill=(200, 30, 30), width=3)
    return img


def _pixels(img):
    return np.asarray(img, np.uint8)


def _batch(cfg, b, text_len, seed, pad_row=True):
    """input_ids / labels / attention_mask / pixel_values as numpy; the
    last row padded on the right when ``pad_row``."""
    rng = np.random.default_rng(seed)
    s = cfg.image_seq_len + text_len
    ids = np.full((b, s), cfg.image_token_id, np.int32)
    ids[:, cfg.image_seq_len:] = rng.integers(0, 256, (b, text_len))
    mask = np.ones((b, s), bool)
    if pad_row:
        mask[-1, s - text_len // 2:] = False
        ids[-1, s - text_len // 2:] = 0
    labels = np.where((ids == cfg.image_token_id) | ~mask, -100, ids)
    size = cfg.vision.image_size
    pixels = rng.standard_normal((b, size, size, 3)).astype(np.float32)
    return {"input_ids": ids, "labels": labels.astype(np.int32),
            "attention_mask": mask, "pixel_values": pixels}


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _leaves_close(got_tree, want_tree, rtol_of_max=0.0, atol=0.0):
    """Every leaf within ``rtol_of_max`` times its largest magnitude plus
    ``atol``."""
    got = jax.tree_util.tree_leaves_with_path(got_tree)
    want = dict(jax.tree_util.tree_leaves_with_path(want_tree))
    assert len(got) == len(want)
    for path, g in got:
        w = np.asarray(want[path], np.float32)
        err = float(np.abs(np.asarray(g, np.float32) - w).max())
        tol = rtol_of_max * float(np.abs(w).max()) + atol
        assert err <= tol, (jax.tree_util.keystr(path), err, tol)


#: gradients agree within 1e-4 of their leaf's largest (+1e-6); an element
#: whose gradient is within ten times that of zero has no sign or size the
#: two packages agree on, and Adam, which divides it by its own size,
#: turns it into a step of any direction up to the learning rate
NOISE_FLOOR = 1e-3


def _name(path) -> str:
    """A tree path as the port's leaf path (``text/layers/attn/q/kernel``)."""
    return "/".join(str(getattr(k, "key", getattr(k, "name", k)))
                    for k in path)


def _named(tree, is_leaf=None) -> dict:
    return {_name(p): v for p, v in jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=is_leaf)}


def _noise_elements(grads, free=None):
    """Per leaf, the elements whose gradient is at the noise floor (or
    already were, in ``free``)."""
    out = {}
    for name, g in _named(grads).items():
        g = np.abs(np.asarray(g, np.float32))
        small = g <= NOISE_FLOOR * g.max() + 1e-5
        out[name] = small | free[name] if free is not None else small
    return out


def _moment_flips(jstate, tstate, free):
    """quant8: the elements whose stored e4m3 moment differs between the
    packages (added to ``free``), and the count of those not yet free (at
    the gradients' noise floor or flipped before). Gradients that agree to
    rounding can fall on either side of an e4m3 rounding boundary (3
    mantissa bits), and the stored moment then moves by one e4m3 step."""
    inner = _find_quant_state(jstate.opt_state)
    jm = _named(inner["m"], is_leaf=lambda x: isinstance(x, dict)
                and "mq" in x)
    flips = 0
    for name, st in tstate.opt_state["moments"].items():
        n = free[name].size
        diff = np.zeros(n, bool)
        for f in ("mq", "vq"):
            a = np.asarray(jm[name][f]).view(np.uint8).reshape(-1)[:n]
            b = st[f].view(torch.uint8).numpy().reshape(-1)[:n]
            diff |= a != b
        diff = diff.reshape(free[name].shape)
        flips += int((diff & ~free[name]).sum())
        free[name] = free[name] | diff
    return flips


def _find_quant_state(node):
    if isinstance(node, dict):
        if "m" in node and "count" in node:
            return node
        children = node.values()
    elif isinstance(node, (tuple, list)) or hasattr(node, "_fields"):
        children = tuple(node)
    else:
        return None
    for child in children:
        got = _find_quant_state(child)
        if got is not None:
            return got
    return None


def _steps_close(got_tree, want_tree, free, atol, lr_sum):
    """Parameters after Adam steps: within ``atol``, but elements in
    ``free`` within the learning rates' sum ``lr_sum`` (Adam's largest
    total move)."""
    want = _named(want_tree)
    got = _named(got_tree)
    assert set(got) == set(want) == set(free)
    for name, g in got.items():
        err = np.abs(np.asarray(g, np.float32) - want[name])
        assert (err[~free[name]] <= atol).all(), (name, err.max())
        assert (err <= lr_sum * 1.01 + atol).all(), (name, err.max())


# ---------------------------------------------------------------- data


def test_tokenize_batch_and_collate_equal_jax(setup):
    cfg, _, _, _, jproc, tproc = setup
    texts, images = ["abc", "defgh"], [_figure(), _figure(1)]
    want = jdata.tokenize_batch(jproc, texts, images)
    got = tdata.tokenize_batch(tproc, texts, images)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype
    assert (got["labels"][got["input_ids"] == cfg.image_token_id]
            == -100).all()
    items = [{"image": _figure(i), "text": f"code {i};"} for i in range(3)]
    want = jdata._collate(jproc, items, 40)
    got = tdata._collate(tproc, items, 40)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert got["input_ids"].shape[1] == 40


def test_fits_in_context_equal_jax(setup):
    _, _, _, _, jproc, tproc = setup
    for text, n in (("short", 64), ("x" * 100, 64), ("x" * 50, 64),
                    ("y" * 51, 64)):
        assert tdata.fits_in_context(tproc, text, n) == \
            jdata.fits_in_context(jproc, text, n)
    assert tdata.fits_in_context(tproc, "short", 64)
    assert not tdata.fits_in_context(tproc, "x" * 100, 64)


@pytest.mark.parametrize("seed", [0, 3])
def test_sketch_augment_pixels_equal_jax(seed):
    got = taug.SketchAugment(seed=seed)(_figure())
    want = jaug.SketchAugment(seed=seed)(_figure())
    np.testing.assert_array_equal(_pixels(got), _pixels(want))
    assert got.size == _figure().size
    assert not np.array_equal(_pixels(got), _pixels(_figure()))


def test_edit_augments_equal_jax():
    img, other = _figure(), _figure(5)
    assert taug.FullErase()(img).getextrema() == ((255, 255),) * 3
    np.testing.assert_array_equal(_pixels(taug.FullErase()(img)),
                                  _pixels(jaug.FullErase()(img)))
    for name in ("EditCutOut", "EditMixUp", "EditCutMix"):
        for seed in (0, 7):
            args = (img,) if name == "EditCutOut" else (img, other)
            got = getattr(taug, name)(seed=seed)(*args)
            want = getattr(jaug, name)(seed=seed)(*args)
            np.testing.assert_array_equal(_pixels(got), _pixels(want))


def test_sketch_dataset_epoch_swap_equal_jax():
    items = [{"image": _figure(i), "text": f"t{i}"} for i in range(4)]
    for ratio in (1.0, 0.5):
        jds = jdata.SketchDataset(items, sketch_ratio=ratio, seed=0)
        tds = tdata.SketchDataset(items, sketch_ratio=ratio, seed=0)
        for epoch in (0, 1):
            jds.set_epoch(epoch)
            tds.set_epoch(epoch)
            for i in range(len(items)):
                np.testing.assert_array_equal(_pixels(tds[i]["image"]),
                                              _pixels(jds[i]["image"]))
    tds = tdata.SketchDataset(items[:1], sketch_ratio=1.0, seed=0)
    tds.set_epoch(0)
    a = _pixels(tds[0]["image"])
    tds.set_epoch(1)
    b = _pixels(tds[0]["image"])
    assert not np.array_equal(a, _pixels(items[0]["image"]))   # augmented
    assert not np.array_equal(a, b)                    # per-epoch differs


def test_batches_order_equal_jax(setup):
    _, _, _, _, jproc, tproc = setup
    items = [{"image": _figure(i % 4), "text": f"code{i};"}
             for i in range(7)]
    for seed, epoch in ((0, 0), (0, 1), (5, 0)):
        want = list(jdata.batches(items, jproc, 2, max_length=36,
                                  shuffle_seed=seed, epoch=epoch))
        got = list(tdata.batches(items, tproc, 2, max_length=36,
                                 shuffle_seed=seed, epoch=epoch))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])


def test_generate_corpus_equal_jax():
    assert tcorpus(40, seed=0) == jcorpus(40, seed=0)
    assert tcorpus(25, seed=3) == jcorpus(25, seed=3)
    assert tcorpus(5, seed=0) != tcorpus(5, seed=1)


# ---------------------------------------------------------- K1's Function


K1_CASES = {
    "causal_mask": dict(b=2, s=6, t=9, nh=4, nkv=4, hd=16),
    "offsets_limits": dict(b=3, s=5, t=12, nh=4, nkv=4, hd=16),
    "gqa_causal": dict(b=2, s=8, t=8, nh=6, nkv=2, hd=8),
}


def _k1_inputs(name):
    c = K1_CASES[name]
    rng = np.random.default_rng(len(name))
    q = rng.standard_normal((c["b"], c["s"], c["nh"], c["hd"]), np.float32)
    k = rng.standard_normal((c["b"], c["t"], c["nkv"], c["hd"]), np.float32)
    v = rng.standard_normal((c["b"], c["t"], c["nkv"], c["hd"]), np.float32)
    w = rng.standard_normal((c["b"], c["s"], c["nh"], c["hd"]), np.float32)
    kw = {}
    if name == "causal_mask":
        mask = np.ones((c["b"], c["t"]), bool)
        mask[1, 6:] = False
        kw = dict(causal=True, kv_mask=mask)
    elif name == "offsets_limits":
        kw = dict(q_offsets=np.array([0, 3, 7], np.int32),
                  kv_limits=np.array([5, 8, 12], np.int32))
    else:
        kw = dict(causal=True)
    return q, k, v, w, kw


@pytest.mark.parametrize("name", sorted(K1_CASES))
def test_flash_attention_grads_match_jax(name):
    q, k, v, w, kw = _k1_inputs(name)
    jkw = {key: (jnp.asarray(x) if isinstance(x, np.ndarray) else x)
           for key, x in kw.items()}

    def jloss(q, k, v):
        return jnp.sum(jflash(q, k, v, interpret=True, **jkw) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    tkw = {key: (torch.from_numpy(x) if isinstance(x, np.ndarray) else x)
           for key, x in kw.items()}
    out = tflash.flash_attention(*leaves, **tkw)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), leaves)
    for g, wg in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), rtol=0,
                                   atol=1e-5)


def test_flash_attention_goes_through_its_function():
    q, k, v, _, kw = _k1_inputs("causal_mask")
    out = tflash.flash_attention(torch.from_numpy(q).requires_grad_(),
                                 torch.from_numpy(k), torch.from_numpy(v),
                                 causal=True,
                                 kv_mask=torch.from_numpy(kw["kv_mask"]))
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    calls = []
    orig = tflash.attend_plain

    def spy(*args, **kwargs):
        calls.append(torch.is_grad_enabled())
        return orig(*args, **kwargs)

    tflash.attend_plain = spy
    try:
        out = tflash.flash_attention(torch.from_numpy(q).requires_grad_(),
                                     torch.from_numpy(k), torch.from_numpy(v),
                                     causal=True)
        out.sum().backward()
    finally:
        tflash.attend_plain = orig
    # the forward runs without a graph, the backward recomputes with one
    assert calls == [False, True]


# ------------------------------------------------------- loss and gradients


def test_loss_and_grads_match_jax(setup):
    cfg, jparams, _, tcfg, _, _ = setup
    batch = _batch(cfg, 2, 9, seed=11)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jstep.label_smoothing_free_loss(
            p, cfg, jb, attn_impl="xla")))(jparams)
    params, _ = _port_params(setup)
    loss = tstep.label_smoothing_free_loss(params, tcfg,
                                           _torch_batch(batch))
    trained = list(params.parameters())
    grads = torch.autograd.grad(loss, trained, allow_unused=True)
    got = convert.params_to_numpy(params, {
        p: torch.zeros_like(p) if g is None else g
        for p, g in zip(trained, grads)})
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5
    # the key bias's gradient is zero but for rounding (softmax does not
    # see a shift shared by all keys): an absolute floor of 1e-6 holds it
    _leaves_close(got, jax.tree.map(np.asarray, jg._asdict()),
                  rtol_of_max=1e-4, atol=1e-6)


# ------------------------------------------------------------- optimizers


OPT_SHAPES = {"w": (16, 24), "stack": (3, 5, 7), "v": (300,), "e": (512,)}


def _opt_inputs(clip: bool):
    """Parameters and 5 rounds of gradients; with ``clip`` their global
    norm is far above 1 so the clip acts, else below it."""
    rng = np.random.default_rng(21 + clip)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in OPT_SHAPES.items()}
    lo, hi = (-3, 1) if clip else (-5, -2)
    grads = [{k: (rng.standard_normal(s) * 10 ** rng.uniform(lo, hi, s)
                  ).astype(np.float32) for k, s in OPT_SHAPES.items()}
             for _ in range(5)]
    return params, grads


def _jax_moments(state, mode):
    """The scaler's state inside make_optimizer's chain."""
    return state[1][0]


@pytest.mark.parametrize("clip", [False, True], ids=["unclipped", "clipped"])
@pytest.mark.parametrize("mode", ["fp32", "bf16", "quant8"])
def test_optimizer_matches_optax(mode, clip):
    jmode = {"fp32": None, "bf16": jnp.bfloat16, "quant8": "quant8"}[mode]
    tmode = {"fp32": None, "bf16": torch.bfloat16, "quant8": "quant8"}[mode]
    kw = dict(total_steps=10, warmup_ratio=0.2, weight_decay=0.01,
              grad_clip=1.0)
    params, grads = _opt_inputs(clip)
    jopt = jstep.make_optimizer(1e-2, moment_dtype=jmode, **kw)
    topt = tstep.make_optimizer(1e-2, moment_dtype=tmode, **kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    update = jax.jit(jopt.update)
    for g in grads:
        u, js = update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, u)
        ts = topt.update(tp, {tp[k]: torch.from_numpy(v)
                              for k, v in g.items()}, ts)
    assert ts["count"] == 5
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=1e-6)
    jm = _jax_moments(js, mode)
    if mode == "bf16":
        for k in params:
            for f in ("mu", "nu"):
                got = ts["moments"][k][f][0]
                assert got.dtype == torch.bfloat16
                np.testing.assert_array_equal(
                    got.float().numpy(), np.asarray(jm[f][k], np.float32))
    if mode == "quant8":
        for k in params:
            st = ts["moments"][k]
            for f in ("mq", "vq"):
                assert st[f].dtype == torch.float8_e4m3fn
                got = st[f].view(torch.uint8).numpy()
                want = np.asarray(jm["m"][k][f]).view(np.uint8)
                np.testing.assert_array_equal(got, want)
            for f in ("ms", "vs"):
                want = np.asarray(jm["m"][k][f])
                if clip:
                    # the clip divides by the global norm, an fp32 sum
                    # taken in another order than XLA's: the scales agree
                    # to a few units in the last place
                    np.testing.assert_allclose(st[f].numpy(), want,
                                               rtol=1e-6, atol=0)
                else:
                    np.testing.assert_array_equal(st[f].numpy(), want)


def test_schedule_matches_optax():
    for total, warm, peak in ((10, 0.2, 1e-2), (37, 0.03, 5e-5),
                              (2, 0.03, 1e-3)):
        warmup = max(int(total * warm), 1)
        want = optax.warmup_cosine_decay_schedule(
            init_value=0.0, peak_value=peak, warmup_steps=warmup,
            decay_steps=total, end_value=0.0)
        got = tstep.warmup_cosine_decay_schedule(0.0, peak, warmup, total)
        for c in range(total + 3):
            # optax evaluates in fp32 (1 + cos near -1 cancels there), the
            # port in fp64: equal up to optax's rounding, 1e-6 of the peak
            assert got(c) == pytest.approx(float(want(c)), rel=0,
                                           abs=1e-6 * peak)
        assert got(0) == 0.0
    with pytest.raises(ValueError):
        tstep.warmup_cosine_decay_schedule(0.0, 1.0, 1, 1)


# ------------------------------------------------------------ whole steps


@pytest.fixture(scope="module")
def step_batch(setup):
    return _batch(setup[0], 2, 8, seed=5)


@pytest.mark.parametrize("mode", ["fp32", "bf16", "quant8"])
def test_train_step_matches_jax(setup, step_batch, mode):
    cfg, jparams, _, tcfg, _, _ = setup
    jmode = {"fp32": None, "bf16": jnp.bfloat16, "quant8": "quant8"}[mode]
    tmode = {"fp32": None, "bf16": torch.bfloat16, "quant8": "quant8"}[mode]
    kw = dict(total_steps=6, warmup_ratio=0.2, weight_decay=0.01)
    jopt = jstep.make_optimizer(5e-3, trainable=jstep.trainable_mask(
        jparams, "all"), moment_dtype=jmode, **kw)
    jfn = jax.jit(jstep.make_train_step(cfg, jopt, attn_impl="xla"))
    jstate = jstep.init_state(jparams, jopt)
    params, mask = _port_params(setup)
    topt = tstep.make_optimizer(5e-3, trainable=mask, moment_dtype=tmode,
                                **kw)
    tfn = tstep.make_train_step(tcfg, topt)
    tstate = tstep.init_state(params, topt)
    tb = _torch_batch(step_batch)
    jgrad = jax.jit(jax.grad(lambda p: jstep.label_smoothing_free_loss(
        p, cfg, {k: jnp.asarray(v) for k, v in step_batch.items()},
        attn_impl="xla")))
    free, flips = None, 0
    for _ in range(3):
        free = _noise_elements(jgrad(jstate.params)._asdict(), free)
        jstate, jm = jfn(jstate, step_batch)
        tstate, tm = tfn(tstate, tb)
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-4
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-4)
        if mode == "quant8":
            flips += _moment_flips(jstate, tstate, free)
    assert tstate.step == 3
    # the 8-bit moments agree but at rounding boundaries (a systematic
    # fault in the quantization would flip most of them)
    n = sum(f.size for f in free.values())
    assert flips <= 1e-2 * n, (flips, n)
    # (the vision key biases' gradients are all noise: softmax does not
    # see a shift shared by all keys)
    lr_sum = sum(topt.schedule(c) for c in range(3))
    _steps_close(convert.params_to_numpy(tstate.params),
                 jax.tree.map(np.asarray, jstate.params._asdict()), free,
                 1e-4, lr_sum)
    # the step moved the weights (the first update runs at lr 0)
    moved = convert.params_to_numpy(tstate.params)["text"]["embed_tokens"]
    assert np.abs(moved - np.asarray(jparams.text["embed_tokens"])).max() > 0


def test_grad_accum_matches_one_batch(setup):
    """grad_accum 2 (the micro-batches' mean) and 2 with an fp32 carry give
    the loss of grad_accum 1 over the whole batch, and the JAX step's."""
    cfg, jparams, _, tcfg, _, _ = setup
    batch = _batch(cfg, 4, 6, seed=9, pad_row=False)
    losses = {}
    for ga, accum in ((1, None), (2, None), (2, torch.float32)):
        params, mask = _port_params(setup)
        opt = tstep.make_optimizer(1e-3, total_steps=4, warmup_ratio=0.0,
                                   trainable=mask, moment_dtype="quant8")
        step = tstep.make_train_step(tcfg, opt, grad_accum=ga,
                                     accum_dtype=accum)
        state, metrics = step(tstep.init_state(params, opt),
                              _torch_batch(batch))
        losses[(ga, accum)] = float(metrics["loss"])
        assert state.opt_state["count"] == 1
    jopt = jstep.make_optimizer(1e-3, total_steps=4, warmup_ratio=0.0,
                                trainable=jstep.trainable_mask(jparams,
                                                               "all"),
                                moment_dtype="quant8")
    _, jm = jax.jit(jstep.make_train_step(cfg, jopt, grad_accum=2,
                                          attn_impl="xla"))(
        jstep.init_state(jparams, jopt), batch)
    base = losses[(1, None)]
    for val in losses.values():
        assert abs(val - base) < 5e-3 * max(1.0, abs(base)), losses
    assert abs(losses[(2, None)] - float(jm["loss"])) <= 1e-5


def test_projector_freeze_matches_jax(setup, step_batch):
    """Only the connector moves; the clip's norm is over the connector's
    gradient alone, as in JAX's ``multi_transform``; the update equals
    JAX's. JAX's ``grad_norm`` metric also counts the frozen leaves'
    gradients, which the port does not compute: the port's equals the
    connector's part of it."""
    cfg, jparams, _, tcfg, _, _ = setup
    jmask = jstep.trainable_mask(jparams, "projector")
    jopt = jstep.make_optimizer(1e-2, total_steps=4, trainable=jmask)
    jfn = jax.jit(jstep.make_train_step(cfg, jopt, attn_impl="xla"))
    params = convert.params_from_numpy(setup[2], tcfg, device="cpu")
    mask = tstep.trainable_mask(params, "projector")
    assert {p for p, m in mask.items() if m == "train"} == {
        "connector/proj/kernel"} | ({"connector/proj/bias"}
                                    if cfg.projector_bias else set())
    assert {p.requires_grad for p in params.text.parameters()} == {False}
    topt = tstep.make_optimizer(1e-2, total_steps=4, trainable=mask)
    tfn = tstep.make_train_step(tcfg, topt)
    jstate, tstate = jstep.init_state(jparams, jopt), tstep.init_state(
        params, topt)
    assert set(tstate.opt_state["moments"]) == {
        p for p, m in mask.items() if m == "train"}
    tb = _torch_batch(step_batch)
    jb = {k: jnp.asarray(v) for k, v in step_batch.items()}
    jgrad = jax.jit(jax.grad(lambda p: jstep.label_smoothing_free_loss(
        p, cfg, jb, attn_impl="xla")))
    free = None
    for _ in range(2):       # the first update runs at lr 0 (warmup)
        jg = jgrad(jstate.params)
        free = _noise_elements(jg._asdict(), free)
        jstate, jm = jfn(jstate, step_batch)
        tstate, tm = tfn(tstate, tb)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(optax.global_norm(jg.connector)), rel=1e-4)
        assert float(jm["grad_norm"]) > float(tm["grad_norm"])
    got = convert.params_to_numpy(tstate.params)
    want = jax.tree.map(np.asarray, jstate.params._asdict())
    _steps_close(got, want, free, 1e-4,
                 sum(topt.schedule(c) for c in range(2)))
    delta = np.abs(got["connector"]["proj"]["kernel"] - np.asarray(
        jparams.connector["proj"]["kernel"])).max()
    assert delta > 0
    np.testing.assert_array_equal(got["text"]["embed_tokens"], np.asarray(
        jparams.text["embed_tokens"]))
    np.testing.assert_array_equal(
        got["vision"]["layers"]["attn"]["q"]["kernel"],
        np.asarray(jparams.vision["layers"]["attn"]["q"]["kernel"]))


# ------------------------------------------------------------------ remat


@pytest.mark.parametrize("remat", [True, "dots"], ids=["full", "dots"])
def test_remat_gives_the_grads_of_no_remat(setup, step_batch, remat):
    _, _, _, tcfg, _, _ = setup
    params, _ = _port_params(setup)
    tb = _torch_batch(step_batch)
    trained = list(params.parameters())
    out = {}
    for r in (False, remat):
        loss = tstep.label_smoothing_free_loss(params, tcfg, tb, remat=r)
        out[r] = (float(loss.detach()), torch.autograd.grad(loss, trained,
                                                   allow_unused=True))
    assert abs(out[remat][0] - out[False][0]) <= 1e-6
    for a, b in zip(out[remat][1], out[False][1]):
        assert (a is None) == (b is None)
        if a is not None:
            assert float((a - b).abs().max()) <= 1e-6


# ------------------------------------------------ checkpoints, entry points


def _dataset(n=16):
    return [{"image": _figure(i % 3), "text": f"code{i % 3};"}
            for i in range(n)]


def test_trainer_loss_decreases_and_resumes(setup, tmp_path):
    _, _, _, tcfg, _, tproc = setup
    tc = TrainConfig(
        output_dir=str(tmp_path / "run"), learning_rate=2e-3, epochs=2,
        micro_batch_size=4, grad_accum=2, max_length=32,
        save_epoch_fraction=0.5, logging_steps=1, trainable="all")
    logs = []
    params = convert.params_from_numpy(setup[2], tcfg, device="cpu")
    trainer = Trainer(params, tcfg, tproc, _dataset(), tc, device="cpu",
                      log_fn=logs.append)
    state = trainer.train()
    assert state.step == trainer.total_steps == 4
    losses = [float(m.split(" loss ")[1].split()[0]) for m in logs]
    assert len(losses) == 4 and losses[-1] < losses[0], losses
    assert get_last_checkpoint(str(tmp_path / "run")) is not None
    # resume: a new trainer starts at the saved step, with its weights
    params2 = convert.params_from_numpy(setup[2], tcfg, device="cpu")
    trainer2 = Trainer(params2, tcfg, tproc, _dataset(), tc, device="cpu",
                       log_fn=lambda m: None)
    assert trainer2._resume() == trainer.total_steps
    for a, b in zip(params2.parameters(), params.parameters()):
        assert torch.equal(a, b)
    assert trainer2.state.opt_state["count"] == 4


def test_trainer_resumes_mid_epoch(setup, tmp_path):
    """A run stopped after 1 step of a 2-step epoch and resumed ends where
    the run without a stop ends: the resumed epoch skips the batch it
    trained, the shuffle and the augmentation are seeded."""
    _, _, _, tcfg, _, tproc = setup

    def trainer(out):
        # each run makes its dataset, as a new process would
        data = tdata.SketchDataset(_dataset(8), sketch_ratio=0.5, seed=0)
        tc = TrainConfig(output_dir=str(tmp_path / out), learning_rate=2e-3,
                         epochs=1, micro_batch_size=2, grad_accum=2,
                         max_length=32, logging_steps=1,
                         save_epoch_fraction=1.0)
        params = convert.params_from_numpy(setup[2], tcfg, device="cpu")
        return Trainer(params, tcfg, tproc, data, tc, device="cpu",
                       log_fn=lambda m: None)

    whole = trainer("whole").train()
    stopped = trainer("parts")
    assert stopped.train(max_steps=1).step == 1
    resumed = trainer("parts")
    assert resumed._resume() == 1
    end = resumed.train()
    assert end.step == whole.step == 2
    for a, b in zip(end.params.parameters(), whole.params.parameters()):
        assert torch.equal(a, b)


def test_checkpointer_keeps_the_newest(setup, tmp_path):
    _, _, _, tcfg, _, _ = setup
    params, _ = _port_params(setup)
    opt = tstep.make_optimizer(1e-3, total_steps=10, moment_dtype="quant8")
    state = tstep.init_state(params, opt)
    ck = tckpt.Checkpointer(str(tmp_path / "ck"), max_to_keep=2)
    for step in (1, 2, 3, 4):
        ck.save(step, state._replace(step=step), {"epoch": 0})
    kept = sorted(os.listdir(tmp_path / "ck"))
    assert kept == ["checkpoint-3", "checkpoint-4"]
    assert get_last_checkpoint(str(tmp_path / "ck")).endswith(
        "checkpoint-4")
    # an unfinished save (no meta.json) is not resumed from
    os.makedirs(tmp_path / "ck" / "checkpoint-9")
    assert get_last_checkpoint(str(tmp_path / "ck")).endswith(
        "checkpoint-4")
    restored, meta = ck.restore_latest(state)
    assert meta == {"step": 4, "epoch": 0} and restored.step == 4
    first = next(iter(restored.opt_state["moments"].values()))
    assert first["mq"].dtype == torch.float8_e4m3fn


def test_save_params_npz_matches_jax(setup, tmp_path):
    _, jparams, _, tcfg, _, _ = setup
    params, _ = _port_params(setup)
    for only in ("connector", None):
        jckpt.save_params_npz(str(tmp_path / "j.npz"), jparams, only=only)
        tckpt.save_params_npz(str(tmp_path / "t.npz"), params, only=only)
        want = jckpt.load_params_npz(str(tmp_path / "j.npz"))
        got = tckpt.load_params_npz(str(tmp_path / "t.npz"))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    jckpt.save_params_npz(str(tmp_path / "p.npz"), jparams, only="connector")
    assert "proj/kernel" in tckpt.load_params_npz(str(tmp_path / "p.npz"))


def test_pretrain_end_to_end(setup, tmp_path):
    """pretrain() moves only the connector, writes modality_projector.npz
    under the JAX keys, and the port's loader overlays it."""
    _, _, tree, tcfg, _, tproc = setup
    params = convert.params_from_numpy(tree, tcfg, device="cpu")
    data = [{"image": _figure(i), "text": f"a figure {i}"}
            for i in range(4)]
    out, _ = pretrain(str(tmp_path / "pre"), params, tcfg, tproc, data,
                      batch_size=2, micro_batch_size=1, learning_rate=1e-2,
                      epochs=1, max_length=32, device="cpu",
                      log_fn=lambda m: None)
    got = convert.params_to_numpy(out)
    assert np.abs(got["connector"]["proj"]["kernel"]
                  - tree["connector"]["proj"]["kernel"]).max() > 0
    for part in ("text", "vision"):
        for (_, a), (_, b) in zip(
                jax.tree_util.tree_leaves_with_path(got[part]),
                jax.tree_util.tree_leaves_with_path(tree[part])):
            np.testing.assert_array_equal(a, np.asarray(b))
    npz = str(tmp_path / "pre" / "modality_projector.npz")
    assert "proj/kernel" in tckpt.load_params_npz(npz)
    fresh = convert.params_from_numpy(tree, tcfg, device="cpu")
    _overlay_projector(fresh, npz, torch.float32)
    assert torch.equal(fresh.connector.proj.weight,
                       out.connector.proj.weight)


def test_params_to_numpy_round_trip(setup):
    _, jparams, tree, tcfg, _, _ = setup
    params, _ = _port_params(setup)
    got = convert.params_to_numpy(params)
    want = jax.tree.map(np.asarray, jparams._asdict())
    assert jax.tree.structure(got) == jax.tree.structure(want)
    _leaves_close(got, want, atol=0.0)
    back = convert.params_from_numpy(got, tcfg, device="cpu")
    for (n, a), (_, b) in zip(back.state_dict().items(),
                              params.state_dict().items()):
        assert torch.equal(a, b), n
    # bf16 weights come back bit for bit too
    bf = params.to(torch.bfloat16)
    back = convert.params_from_numpy(convert.params_to_numpy(bf), tcfg,
                                     device="cpu", dtype=torch.bfloat16)
    for a, b in zip(back.parameters(), bf.parameters()):
        assert torch.equal(a, b)
    # stacked leaves hold one tensor a layer, dense kernels transposed
    leaf = {lf.path: lf for lf in convert.leaves(params)}[
        "text/layers/attn/q/kernel"]
    assert leaf.stacked and leaf.transposed
    assert len(leaf.tensors) == tcfg.text.num_hidden_layers
