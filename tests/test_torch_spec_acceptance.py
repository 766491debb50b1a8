"""The port's BPE speculation measurement against the JAX package, on the
CPU.

  * the committed ``spec_bpe_300.json`` equals a fresh
    ``train_bpe_tokenizer`` run on ``generate_corpus(300, seed=0)``, and
    the port's byte-level BPE gives ``tokenizers``' ids on every corpus
    program (and on text with Unicode, digits, contractions and runs of
    whitespace);
  * the port's first 20 ``overfit`` losses, from JAX's initial weights on
    JAX's batches, are within 1e-4 relative of JAX's (an ``optax.adam``
    loop, ``overfit``'s own);
  * JAX's overfit weights converted into the port give greedy speculative
    rates, with and without hints, exactly equal to JAX's;
  * the counterpart of ``test_speculative.py::
    test_bpe_acceptance_hints_beat_unhinted``, overfit on the port.

The spec model is JAX's exactly (4 heads of 32, fp32).
"""
import random

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from detikzify_tpu.dataset.synthetic import generate_corpus as jcorpus
from detikzify_tpu.evaluate import spec_acceptance as jspec
from detikzify_tpu.models import detikzify as jdet
from detikzify_torch.dataset.synthetic import generate_corpus
from detikzify_torch.evaluate import spec_acceptance as tspec
from detikzify_torch.evaluate.bpe import ByteLevelBPE
from detikzify_torch.models import convert

torch.set_num_threads(1)


def test_committed_bpe_equals_a_fresh_training_and_tokenizers_ids():
    pytest.importorskip("tokenizers")
    corpus = generate_corpus(300, seed=0)
    assert corpus == jcorpus(300, seed=0)
    committed = ByteLevelBPE.from_file()
    fresh = tspec.train_bpe_tokenizer(corpus)
    assert committed.vocab == fresh.vocab
    assert committed.merges == fresh.merges
    ref = jspec.train_bpe_tokenizer(corpus)          # tokenizers + HF fast
    assert len(committed) == len(ref)
    for program in corpus:
        ids = committed.encode(program)
        assert ids == ref.encode(program, add_special_tokens=False)
        assert committed.decode(ids) == program
    rng = random.Random(0)
    text = "".join(rng.choice(" \n\t  abcXYZ019'sre'll\\{}()[],.;:-!é€½")
                   for _ in range(3000))
    assert committed.encode(text) == ref.encode(text,
                                                add_special_tokens=False)
    assert (committed.bos_token_id, committed.eos_token_id,
            committed.pad_token_id) == (1, 2, 0)


@pytest.fixture(scope="module")
def spec():
    tok = ByteLevelBPE.from_file()
    corpus = generate_corpus(120, seed=0)
    rows = [tok.encode(c) for c in corpus]
    jcfg = jspec.spec_model_config(len(tok))
    tcfg = tspec.spec_model_config(len(tok))
    prompts = [[tcfg.bos_token_id] + r[:8] for r in rows[:8]]
    conts = [r[8:] for r in rows[:8]]
    return tok, rows, jcfg, tcfg, prompts, conts


def _jax_losses(cfg, rows, steps, lr=3e-3, batch=8, width=128, seed=0):
    """``jspec.overfit``'s loop, returning every step's loss."""
    params = jdet.init(jax.random.PRNGKey(seed), cfg, dtype=jnp.float32)
    flat = []
    for row in rows:
        flat.extend([cfg.bos_token_id] + row + [cfg.eos_token_id])
    data = np.asarray(flat, np.int32)
    opt = optax.adam(lr)
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state, ids):
        def loss_fn(p):
            _, loss = jdet.forward(p, cfg, ids, None, labels=ids,
                                   attn_impl="xla")
            return loss
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    rng = np.random.default_rng(seed)
    n = len(data) - width - 1
    losses = []
    for _ in range(steps):
        offs = rng.integers(0, n, (batch,))
        ids = np.stack([data[o:o + width] for o in offs])
        params, opt_state, loss = step(params, opt_state, jnp.asarray(ids))
        losses.append(float(loss))
    return losses


def test_overfit_losses_and_hints_beat_unhinted(spec):
    """The port's overfit from JAX's initial weights tracks JAX's loss
    curve (first 20 steps within 1e-4 relative), overfits (loss < 1.5
    after 120 steps, where JAX's test trains 200: the loss is below 1.5
    well before) and, as JAX's test holds, hinted drafts beat unhinted
    n-gram lookup by more than 0.3 tokens a step."""
    tok, rows, jcfg, tcfg, prompts, conts = spec
    want = _jax_losses(jcfg, rows, 20)
    init = jdet.init(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    params = convert.params_from_numpy(
        jax.tree.map(np.asarray, init._asdict()), tcfg, device="cpu")
    got = []
    params, loss = tspec.overfit(
        tcfg, rows, steps=120, params=params,
        on_loss=lambda i, v: got.append(float(v)) if i < 20 else None)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert loss < 1.5
    plain = tspec.measure_spec_rate(params, tcfg, prompts, conts,
                                    temperature=0.0, max_new=32,
                                    num_slots=4)
    hinted = tspec.measure_spec_rate(params, tcfg, prompts, conts,
                                     temperature=0.0, max_new=32,
                                     num_slots=4, use_hints=True)
    assert plain > 1.0
    assert hinted > plain + 0.3, (plain, hinted)


def test_jax_overfit_weights_give_jax_greedy_rates(spec):
    """Both packages measure on the same weights: JAX's ``overfit`` output
    converted into the port gives JAX's greedy rates exactly, with and
    without hints."""
    tok, rows, jcfg, tcfg, prompts, conts = spec
    jparams, _ = jspec.overfit(jcfg, rows, steps=120)
    tparams = convert.params_from_numpy(
        jax.tree.map(np.asarray, jparams._asdict()), tcfg, device="cpu")
    for hints in (False, True):
        kw = dict(temperature=0.0, max_new=32, num_slots=4,
                  use_hints=hints)
        want = jspec.measure_spec_rate(jparams, jcfg, prompts, conts, **kw)
        got = tspec.measure_spec_rate(tparams, tcfg, prompts, conts, **kw)
        assert got == want, (hints, got, want)
        assert got > 1.0
