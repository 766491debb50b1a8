"""The port's speculative decoding against the JAX package, on the CPU.

Mirrors ``tests/test_speculative.py`` at ``tiny-test`` (vocab 512, fp32
weights carried over with ``params_from_numpy``, fp32 page pools):

  * greedy speculative streams equal the port's plain greedy streams AND
    the JAX speculative engine's, token for token, with the same draft
    accounting (``spec_steps``/``spec_tokens``), for fresh,
    prefix-restored, batched, hinted and wrong-hinted rollouts; the port
    verifies zero-copy through the page table (K4's plain version here),
    the JAX engine through its default gather views;
  * ``speculative_accept`` is exact on greedy rows (also against JAX) and
    preserves the warped distribution on sampled rows (frequencies within
    4 sigma);
  * EOS truncation, budgets, per-class gating with recoverable bail-out,
    the plain->spec history resync and mixed sampling with abort;
  * greedy ``simulate()`` on a speculative pipeline with the FakeBackend
    compiler gives the JAX package's solution stream and tree, at
    parallelism 1 and 8, with draft hints reaching child rollouts.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import random
import torch
from PIL import Image, ImageDraw

from detikzify_tpu.config import tiny_test_config
from detikzify_tpu.engine import DecodeEngine as JEngine
from detikzify_tpu.infer import DetikzifyPipeline as JPipeline
from detikzify_tpu.infer import FakeBackend as JFake
from detikzify_tpu.infer import set_backend as j_set_backend
from detikzify_tpu.infer.generator import DetikzifyGenerator as JGenerator
from detikzify_tpu.models import detikzify as jdet
from detikzify_tpu.ops import sampling as jsampling
from detikzify_tpu.processing import ByteTokenizer as JTok
from detikzify_tpu.processing import DetikzifyProcessor as JProc
from detikzify_torch.config import tiny_test_config as t_tiny_test_config
from detikzify_torch.engine import DecodeEngine as TEngine
from detikzify_torch.infer import DetikzifyGenerator as TGenerator
from detikzify_torch.infer import DetikzifyPipeline as TPipeline
from detikzify_torch.infer import FakeBackend as TFake
from detikzify_torch.infer import set_backend as t_set_backend
from detikzify_torch.models import convert
from detikzify_torch.ops import sampling as tsampling
from detikzify_torch.processing import ByteTokenizer as TTok
from detikzify_torch.processing import DetikzifyProcessor as TProc

torch.set_num_threads(1)

GREEDY = dict(num_slots=2, max_len=128, decode_block=4)


@pytest.fixture(scope="module")
def model():
    cfg = tiny_test_config(vocab_size=512)
    jparams = jdet.init(jax.random.PRNGKey(0), cfg)
    tcfg = t_tiny_test_config(vocab_size=512)
    tparams = convert.params_from_numpy(
        jax.tree.map(np.asarray, jparams._asdict()), tcfg, device="cpu")
    prompt = [cfg.image_token_id] * cfg.image_seq_len + [cfg.bos_token_id]
    return cfg, jparams, tcfg, tparams, prompt


def _port(model, temperature=0.0, **kw):
    args = dict(GREEDY, cache_dtype=torch.float32, device="cpu",
                sampling=tsampling.SamplingParams(temperature=temperature))
    args.update(kw)
    return TEngine(model[3], model[2], **args)


def _jax(model, **kw):
    args = dict(GREEDY, cache_dtype=jnp.float32,
                sampling=jsampling.SamplingParams(temperature=0.0))
    args.update(kw)
    return JEngine(model[1], model[0], **args)


def _embeds(model, jax_side: bool):
    cfg = model[0]
    shape = (1, cfg.image_seq_len, cfg.text.hidden_size)
    return jnp.zeros(shape, jnp.float32) if jax_side else torch.zeros(shape)


def _greedy_rollout(engine, prompt, embeds, max_new, **kw):
    ro = engine.start(list(prompt), image_embeds=embeds,
                      max_new_tokens=max_new, **kw)
    while not ro.finished:
        engine.step()
    ids = list(ro.token_ids)
    engine.release(ro)
    return ids


def _spec_counts(eng):
    return {k: eng.counters[k] for k in ("spec_steps", "spec_tokens",
                                         "spec_steps_hint",
                                         "spec_tokens_hint")}


@pytest.fixture(scope="module")
def plain_stream(model):
    """The port's plain greedy stream of 48 new tokens."""
    return _greedy_rollout(_port(model), model[4], _embeds(model, False), 48)


def test_greedy_spec_matches_plain_and_jax(model, plain_stream):
    """Speculative greedy decode is token-identical to plain greedy decode
    and to the JAX speculative engine, fresh and from a stored prefix (the
    restore path fills the history too)."""
    prompt = model[4]

    def run(eng, emb):
        out = [_greedy_rollout(eng, prompt, emb, 48)]
        ro = eng.start(list(prompt), image_embeds=emb, max_new_tokens=4)
        while not ro.finished:
            eng.step()
        pf = eng.store_prefix("root", ro, length=len(prompt))
        eng.release(ro)
        out.append(_greedy_rollout(eng, prompt, emb, 48, prefix=pf))
        return out, _spec_counts(eng)

    got, tcounts = run(_port(model, speculate=3), _embeds(model, False))
    want, jcounts = run(_jax(model, speculate=3), _embeds(model, True))
    assert got == want == [plain_stream, plain_stream]
    assert tcounts == jcounts and tcounts["spec_steps"] > 0


def test_greedy_spec_matches_plain_batch(model):
    """Several concurrent slots (continuous batching) with speculation:
    the port's spec engine == its plain engine == the JAX spec engine."""
    prompt = model[4]
    prompts = [prompt, prompt + [7], prompt + [7, 11]]

    def run_all(engine, emb):
        ros = [engine.start(list(p), image_embeds=emb, max_new_tokens=32,
                            lazy=True) for p in prompts]
        while not all(r.finished for r in ros):
            engine.step()
        out = [list(r.token_ids) for r in ros]
        for r in ros:
            engine.release(r)
        return out

    spec = _port(model, num_slots=4, speculate=4)
    got = run_all(spec, _embeds(model, False))
    assert got == run_all(_port(model, num_slots=4), _embeds(model, False))
    jspec = _jax(model, num_slots=4, speculate=4)
    assert got == run_all(jspec, _embeds(model, True))
    assert _spec_counts(spec) == _spec_counts(jspec)
    assert spec.counters["decode_tokens"] > 0


def _chain_logits(b, k, v):
    logits = np.full((b, k + 1, v), -5.0, np.float32)
    for row in range(b):
        for i, t in enumerate([3, 4, 5, 6]):
            logits[row, i, t] = 5.0
    return logits


def test_speculative_accept_greedy_and_rejection():
    """Greedy rows accept exactly the argmax chain; a rejected position
    emits the argmax and stops -- the same rows and counts as JAX."""
    logits = _chain_logits(2, 3, 16)
    drafts = np.asarray([[3, 4, 5], [3, 9, 9]], np.int32)
    emitted, counts = tsampling.speculative_accept(
        torch.from_numpy(logits), torch.from_numpy(drafts),
        torch.Generator().manual_seed(0), temperature=0.0, top_p=0.95,
        top_k=0)
    assert emitted.dtype == counts.dtype == torch.int32
    emitted, counts = emitted.numpy(), counts.numpy()
    assert counts[0] == 4 and list(emitted[0]) == [3, 4, 5, 6]
    assert counts[1] == 2 and list(emitted[1][:2]) == [3, 4]
    je, jc = jsampling.speculative_accept(
        jnp.asarray(logits), jnp.asarray(drafts), jax.random.PRNGKey(0),
        temperature=0.0, top_p=0.95, top_k=0)
    np.testing.assert_array_equal(counts, np.asarray(jc))
    for row, n in enumerate(counts):
        np.testing.assert_array_equal(emitted[row, :n],
                                      np.asarray(je)[row, :n])


def test_speculative_accept_greedy_matches_jax_random():
    """Random verify logits, drafts that partly follow the argmax chain,
    invalid (-1) drafts and a banned token: greedy rows emit what JAX
    emits."""
    rng = np.random.default_rng(4)
    b, k, v = 6, 4, 64
    logits = (rng.standard_normal((b, k + 1, v)) * 3).astype(np.float32)
    drafts = logits[:, :k].argmax(-1).astype(np.int32)
    drafts[1, 2] = (drafts[1, 2] + 1) % v        # rejected mid-run
    drafts[2, 0] = -1                            # no draft at all
    drafts[3] = rng.integers(0, v, k)            # random drafts
    banned = (int(logits[4, 0].argmax()),)       # the first argmax banned
    kw = dict(temperature=0.0, top_p=0.9, top_k=0, banned_tokens=banned)
    te, tc = tsampling.speculative_accept(
        torch.from_numpy(logits), torch.from_numpy(drafts),
        torch.Generator().manual_seed(1), **kw)
    je, jc = jsampling.speculative_accept(
        jnp.asarray(logits), jnp.asarray(drafts), jax.random.PRNGKey(1),
        **kw)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    for row, n in enumerate(tc.numpy()):
        np.testing.assert_array_equal(te.numpy()[row, :n],
                                      np.asarray(je)[row, :n])
    assert banned[0] not in te.numpy()[4, :tc.numpy()[4]]


@pytest.mark.parametrize("draft_tok", [0, 3, 7])
def test_speculative_accept_preserves_distribution(draft_tok):
    """The first emitted token follows plain warped sampling whatever was
    drafted (a high-probability, a middling and a filtered-out draft):
    frequencies over 4000 rows within 4 sigma of the warped distribution,
    as the JAX test holds them."""
    v, k, n = 8, 2, 4000
    row = np.asarray([2.0, 1.5, 1.0, 0.5, 0.0, -0.5, -1.0, -8.0], np.float32)
    temperature, top_p = 0.8, 0.95
    scaled = row / temperature
    p = np.exp(scaled - scaled.max())
    p /= p.sum()
    order = np.argsort(-scaled)
    cum = np.cumsum(p[order])
    keep = (cum - p[order]) < top_p
    expect = np.zeros(v)
    expect[order] = np.where(keep, p[order], 0)
    expect /= expect.sum()
    logits = torch.from_numpy(np.broadcast_to(row, (n, k + 1, v)).copy())
    drafts = torch.full((n, k), draft_tok, dtype=torch.int32)
    emitted, _ = tsampling.speculative_accept(
        logits, drafts, torch.Generator().manual_seed(123),
        temperature=temperature, top_p=top_p, top_k=0)
    freq = np.bincount(emitted[:, 0].numpy(), minlength=v) / n
    assert np.abs(freq - expect).max() < 4 * np.sqrt(0.25 / n), (freq,
                                                                 expect)


def test_spec_eos_truncation_and_budget(model):
    """An EOS drafted and accepted mid-run is reported in full by the op
    (truncation is the engine's job); budgets and slot reuse hold with
    speculation on."""
    eos = 9
    logits = np.full((1, 4, 64), -5.0, np.float32)
    for i, t in enumerate([3, eos, 5, 6]):
        logits[0, i, t] = 5.0
    emitted, counts = tsampling.speculative_accept(
        torch.from_numpy(logits), torch.tensor([[3, eos, 5]],
                                               dtype=torch.int32),
        torch.Generator().manual_seed(0), temperature=0.0, top_p=1.0,
        top_k=0)
    assert int(counts[0]) == 4 and emitted[0, :2].tolist() == [3, eos]

    prompt, emb = model[4], _embeds(model, False)
    eng = _port(model, speculate=3)
    for budget in (5, 3):
        ro = eng.start(list(prompt), image_embeds=emb, max_new_tokens=budget)
        while not ro.finished:
            eng.step()
        assert ro.new_tokens <= budget
        assert ro.finish_reason in ("eos", "length")
        eng.release(ro)


def test_spec_engine_truncates_at_eos(model, plain_stream):
    """A speculative step whose accepted run holds EOS emits up to EOS and
    freezes the slot: with EOS set to a token of the greedy stream, the
    rollout ends right after its first occurrence, as plain decoding
    does."""
    prompt, emb = model[4], _embeds(model, False)
    cont = plain_stream[len(prompt):]
    eos = cont[6]
    first = cont.index(eos)
    want = _greedy_rollout(_port(model, eos_token_id=eos), prompt, emb, 48)
    eng = _port(model, speculate=3, spec_min_rate=0.0, eos_token_id=eos)
    got = _greedy_rollout(eng, prompt, emb, 48, hint=cont)
    assert got == want == list(prompt) + cont[:first + 1]


def test_sampled_spec_runs_and_is_plausible(model):
    """Sampled speculative decoding produces well-formed rollouts: no
    banned token, EOS-terminated or budget-bounded."""
    cfg, prompt, emb = model[0], model[4], _embeds(model, False)
    eng = _port(model, temperature=0.9, max_len=160, speculate=4)
    for _ in range(2):
        ro = eng.start(list(prompt), image_embeds=emb, max_new_tokens=40)
        while not ro.finished:
            eng.step()
        gen = ro.token_ids[len(prompt):]
        assert 1 <= len(gen) <= 40
        assert cfg.image_token_id not in gen
        if ro.finish_reason == "eos":
            assert gen[-1] == cfg.eos_token_id
        eng.release(ro)


def test_spec_bailout_per_class_and_recoverable(model):
    """Draft classes gate independently (2k unhinted slot-steps at ~1.1
    tok/step do not disable hinted drafts) and bail-outs are recoverable
    probes with exponential backoff."""
    eng = _port(model, speculate=2)
    hint, plain = eng._spec_cls["hint"], eng._spec_cls["plain"]
    assert eng._spec_on and hint["on"] and plain["on"]
    plain["win"] = [1024, 1024]           # one cold-start bad window
    eng._update_spec_gating()
    assert plain["on"] and plain["bad"] == 1
    plain["win"] = [1024, 2048]           # rate 2.0: streak resets
    eng._update_spec_gating()
    assert plain["on"] and plain["bad"] == 0
    for _ in range(2):
        plain["win"] = [1024, 1126]
        eng._update_spec_gating()
    assert not plain["on"]
    assert hint["on"] and hint["bad"] == 0 and eng._spec_on
    hint["win"] = [512, 512]              # partial windows never decide
    eng._update_spec_gating()
    assert hint["on"] and hint["win"] == [512, 512]
    assert plain["backoff"] == 4096
    plain["cool"] = plain["backoff"]      # recovery: a probe
    eng._update_spec_gating()
    assert plain["on"] and plain["probe"] and plain["bad"] == 1
    plain["win"] = [1024, 1100]           # a bad probe doubles the backoff
    eng._update_spec_gating()
    assert not plain["on"] and plain["backoff"] == 8192
    plain["cool"] = plain["backoff"]
    eng._update_spec_gating()
    plain["win"] = [1024, 2048]           # a good probe resets everything
    eng._update_spec_gating()
    assert (plain["on"] and plain["bad"] == 0
            and plain["backoff"] == 4096 and not plain["probe"])


def test_spec_ridealong_window_reenables_and_probe_is_fresh(model):
    """A disabled class riding along is judged on its own completed
    windows: a winning one re-enables it with a clean slate, a losing one
    is discarded, and a probe starts from an empty window."""
    eng = _port(model, speculate=2)
    plain = eng._spec_cls["plain"]
    plain.update(on=False, bad=2, cool=0, backoff=4096, probe=False)
    plain["win"] = [50000, 57500]                  # 1.15 tok/step
    eng._update_spec_gating()
    assert not plain["on"] and plain["win"] == [0, 0]
    assert plain["backoff"] == 4096
    plain["win"] = [1024, 2048]                    # 2.0 tok/step
    eng._update_spec_gating()
    assert plain["on"] and plain["bad"] == 0 and plain["backoff"] == 4096
    assert not plain["probe"] and plain["win"] == [0, 0]
    plain.update(on=False, bad=2, cool=4096, backoff=4096)
    plain["win"] = [900, 990]
    eng._update_spec_gating()
    assert plain["on"] and plain["probe"] and plain["win"] == [0, 0]
    assert plain["bad"] == 1


def test_spec_dispatch_follows_active_classes(model):
    """With the unhinted class bailed out, unhinted traffic runs the PLAIN
    block; a hinted rollout joining flips the batch to the speculative
    block, and the riding-along unhinted slot keeps its window measured
    and its recovery clock ticking."""
    prompt, emb = model[4], _embeds(model, False)
    eng = _port(model, speculate=2)
    eng._spec_cls["plain"]["on"] = False
    ro = eng.start(list(prompt), image_embeds=emb, max_new_tokens=8)
    while not ro.finished:
        eng.step()
    assert eng.counters["spec_steps"] == 0
    eng.release(ro)
    before = eng.counters["decode_tokens"]
    ro1 = eng.start(list(prompt), image_embeds=emb, max_new_tokens=8,
                    hint=[5, 6, 7, 8], lazy=True)
    ro2 = eng.start(list(prompt), image_embeds=emb, max_new_tokens=8,
                    lazy=True)
    assert ro1.hinted and not ro2.hinted
    while not (ro1.finished and ro2.finished):
        eng.step()
    assert eng.counters["spec_steps"] > 0
    assert eng.counters["spec_steps_hint"] > 0
    assert eng._spec_cls["plain"]["win"][0] > 0
    assert eng._spec_cls["plain"]["cool"] > 0
    assert eng.counters["decode_tokens"] > before
    eng.release(ro1)
    eng.release(ro2)


def test_plain_to_spec_transition_resyncs_history(model):
    """A rollout alive across a plain->spec transition drafts from a FRESH
    device history: the engine re-uploads the host's accepted tokens
    before the next speculative block."""
    prompt, emb = model[4], _embeds(model, False)
    want = _greedy_rollout(_port(model), prompt, emb, 32)
    eng = _port(model, speculate=2)
    eng._spec_cls["plain"]["on"] = False
    eng._spec_cls["hint"]["on"] = False
    ro = eng.start(list(prompt), image_embeds=emb, max_new_tokens=32)
    for _ in range(3):
        if not ro.finished:
            eng.step()                       # plain blocks: no history
    assert not ro.finished, "shorten the plain phase"
    assert eng.counters["spec_steps"] == 0
    assert eng._buf_stale[ro.slot]
    mid = list(ro.token_ids)
    assert len(mid) > len(prompt)
    eng._spec_cls["plain"]["on"] = True      # probe re-enable
    eng.step()                               # spec block: resync first
    assert eng.counters["buf_resyncs"] == 1
    assert not eng._buf_stale[ro.slot]
    assert eng._buf_dev[ro.slot, :len(mid)].tolist() == mid
    while not ro.finished:
        eng.step()
    assert list(ro.token_ids) == want
    eng.release(ro)


@pytest.mark.parametrize("hinted", ["true", "wrong"])
def test_hint_drafts_full_acceptance_and_parity(model, plain_stream, hinted):
    """A hint equal to the greedy continuation drives near-full acceptance
    (rate > 2), a wrong hint costs nothing: both emit the plain greedy
    stream, with the JAX engine's streams and draft accounting."""
    prompt = model[4]
    cont = plain_stream[len(prompt):]
    hint = cont if hinted == "true" else [(t + 7) % 400 for t in cont]
    spec = _port(model, speculate=4, spec_min_rate=0.0)
    got = _greedy_rollout(spec, prompt, _embeds(model, False), 48, hint=hint)
    jspec = _jax(model, speculate=4, spec_min_rate=0.0)
    want = _greedy_rollout(jspec, prompt, _embeds(model, True), 48,
                           hint=hint)
    assert got == want == plain_stream
    assert _spec_counts(spec) == _spec_counts(jspec)
    if hinted == "true":
        assert spec.spec_rate > 2.0, spec.spec_rate


def test_spec_port_matches_jax_spec_engine(model, plain_stream):
    """The port's zero-copy speculative engine against the JAX speculative
    engine: fresh, prefix-restored from a mid-page node and hinted
    rollouts give the same streams and the same draft accounting."""
    prompt = model[4]

    def run(eng, emb):
        out = [_greedy_rollout(eng, prompt, emb, 24)]
        ro = eng.start(list(prompt), image_embeds=emb, max_new_tokens=24)
        while not ro.finished:
            eng.step()
        eng.store_prefix("n", ro, length=len(prompt) + 5)
        eng.release(ro)
        _, sp = eng.best_prefix(out[0][:len(prompt) + 5])
        out.append(_greedy_rollout(eng, out[0][:len(prompt) + 5], emb, 8,
                                   prefix=sp))
        out.append(_greedy_rollout(eng, prompt, emb, 16,
                                   hint=out[0][len(prompt):]))
        return out, _spec_counts(eng)

    kw = dict(speculate=3, spec_min_rate=0.0)
    got, tcounts = run(_port(model, **kw), _embeds(model, False))
    want, jcounts = run(_jax(model, **kw), _embeds(model, True))
    assert got == want
    assert got[0] == plain_stream[:len(prompt) + 24]
    assert tcounts == jcounts and tcounts["spec_steps_hint"] > 0


def test_spec_mixed_sampling_and_abort(model):
    """One speculative batch mixes greedy and sampled slots; the greedy
    slot still matches plain greedy exactly, and aborting a speculative
    rollout frees its slot cleanly."""
    prompt, emb = model[4], _embeds(model, False)
    want = _greedy_rollout(_port(model), prompt, emb, 24)
    spec = _port(model, temperature=0.9, num_slots=4, speculate=3)
    greedy_ro = spec.start(list(prompt), image_embeds=emb, max_new_tokens=24,
                           lazy=True,
                           sampling=tsampling.SamplingParams(temperature=0.0))
    sampled_ro = spec.start(list(prompt), image_embeds=emb,
                            max_new_tokens=24, lazy=True)
    abort_ro = spec.start(list(prompt), image_embeds=emb, max_new_tokens=60,
                          lazy=True)
    spec.abort(abort_ro)
    while not (greedy_ro.finished and sampled_ro.finished
               and abort_ro.finished):
        spec.step()
    assert list(greedy_ro.token_ids) == want
    assert 1 <= sampled_ro.new_tokens <= 24
    assert abort_ro.finish_reason == "abort"
    for ro in (greedy_ro, sampled_ro, abort_ro):
        spec.release(ro)
    assert len(spec._free_slots) == 4
    assert _greedy_rollout(_port(model, speculate=3), prompt, emb, 24) == want


# ---------------------------------------------------------------------------
# MCTS with a speculative engine
# ---------------------------------------------------------------------------

def _tok(cls, cfg):
    return cls(vocab_size=512, image_token_id=cfg.image_token_id,
               bos_token_id=cfg.bos_token_id, eos_token_id=cfg.eos_token_id,
               model_max_length=96)


def _figure():
    img = Image.new("RGB", (120, 120), "white")
    ImageDraw.Draw(img).ellipse([10, 10, 110, 110], outline="black")
    return img


@pytest.fixture
def fake_compilers():
    j_set_backend(JFake())
    t_set_backend(TFake())
    yield
    j_set_backend(None)
    t_set_backend(None)


def test_mcts_hints_flow(model, fake_compilers, monkeypatch):
    """MCTS on a speculative pipeline threads parent-rollout hints into
    child rollouts and yields well-formed documents."""
    tcfg, tparams = model[2], model[3]
    seen = {"calls": 0, "hints": 0}
    orig = TGenerator._hint_for

    def spy(self, node):
        h = orig(self, node)
        seen["calls"] += 1
        seen["hints"] += h is not None
        return h

    monkeypatch.setattr(TGenerator, "_hint_for", spy)
    proc = TProc(_tok(TTok, tcfg), tcfg)
    # random weights rarely emit a newline: cut a line at every third id so
    # rollouts are cut into nodes whose children get hints
    proc.tokenizer._detikzify_newline_table = {
        i: (1, True) for i in range(0, 512, 3)}
    pipe = TPipeline(tparams, tcfg, proc, metric="fast", num_slots=4,
                     max_len=96, speculate=3, device="cpu")
    try:
        docs = list(pipe.simulate(image=_figure(), expansions=8))
    finally:
        pipe.close()
    assert len(docs) == 8
    assert seen["hints"] > 0, seen


def _tree(node):
    return (len(node.token_ids), node.is_widen_node, node.visits,
            tuple(_tree(c) for c in node.children))


@pytest.mark.parametrize("parallelism", [1, 8])
def test_simulate_speculative_matches_jax(model, fake_compilers,
                                          parallelism):
    """Greedy simulate(speculate=3) with the FakeBackend compiler: the same
    solution stream, tree, prefix reuse and draft accounting as the JAX
    package, with hints reaching child rollouts."""
    cfg, jparams, tcfg, tparams, _ = model
    jproc, tproc = JProc(_tok(JTok, cfg), cfg), TProc(_tok(TTok, tcfg), tcfg)
    # cut a line at every third token id in both packages, so the search
    # grows a deep tree and child rollouts get hints
    for proc in (jproc, tproc):
        proc.tokenizer._detikzify_newline_table = {
            i: (1, True) for i in range(0, 512, 3)}
    kw = dict(metric="fast", num_slots=8, max_len=96, temperature=0.0,
              speculate=3)
    jpipe = JPipeline(jparams, cfg, jproc, **kw)
    tpipe = TPipeline(tparams, tcfg, tproc, device="cpu", **kw)
    runs = []
    try:
        for pipe, hint_for in ((jpipe, JGenerator._hint_for),
                               (tpipe, TGenerator._hint_for)):
            hints = {"n": 0}
            random.seed(0)                  # UCT ties break at random
            gen = pipe.generator(image=_figure(), max_new_tokens=24)

            def spy(node, gen=gen, hint_for=hint_for, hints=hints):
                h = hint_for(gen, node)
                hints["n"] += h is not None
                return h

            gen._hint_for = spy
            try:
                out = list(gen.simulate(12, parallelism=parallelism))
                runs.append(([d.code for _, d in out], [s for s, _ in out],
                             _tree(gen.root), gen.stats["prefix_hits"],
                             hints["n"], _spec_counts(pipe.engine)))
            finally:
                gen.close()
    finally:
        tpipe.close()
    (jcodes, jscores, jtree, jhits, jhints, jcounts), \
        (tcodes, tscores, ttree, thits, thints, tcounts) = runs
    assert len(tcodes) == 12 and tcodes == jcodes and tscores == jscores
    assert ttree == jtree and thits == jhits
    assert thints == jhints and thints > 0
    assert tcounts == jcounts and tcounts["spec_steps_hint"] > 0


def test_spec_rollout_to_the_last_rows_matches_jax(model):
    """Speculative rollouts that run into the end of the engine's rows: the
    verify window reaches the trash rows (writes divert to the trash page)
    and the history update clamps at the end of its row, as in JAX. Greedy
    streams and draft accounting equal the JAX engine's and the plain
    stream; a second slot restored from a deep prefix shares the batch."""
    prompt = model[4]
    deep = list(prompt) + [int(t) for t in
                           np.random.default_rng(3).integers(1, 400, 100)]

    def run(eng, emb):
        ros = [eng.start(deep, image_embeds=emb, max_new_tokens=60,
                         lazy=True),
               eng.start(list(prompt), image_embeds=emb, max_new_tokens=60,
                         lazy=True)]
        while not all(r.finished for r in ros):
            eng.step()
        out = [list(r.token_ids) for r in ros]
        for r in ros:
            eng.release(r)
        return out, eng.max_len

    kw = dict(page_size=64, max_len=120, speculate=3, spec_min_rate=0.0)
    got, t_len = run(_port(model, **kw), _embeds(model, False))
    want, j_len = run(_jax(model, **kw), _embeds(model, True))
    assert t_len == j_len == 128
    assert got == want
    assert len(got[0]) == t_len - 1 - 3     # ran to the trash rows
    # the plain engine keeps one trash row, not spec + 1: it runs 3 longer
    plain, _ = run(_port(model, page_size=64, max_len=120),
                   _embeds(model, False))
    assert [p[:len(g)] for p, g in zip(plain, got)] == got
