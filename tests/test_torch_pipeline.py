"""The port's DetikzifyPipeline against the JAX pipeline, on the CPU.

At temperature 0 with the hermetic ``FakeBackend`` compiler, ``sample()``
and ``sample_batch()`` must return the same ``TikzDocument.code`` as the
JAX package from the same weights, and MCTS ``simulate()`` scored by
SelfSim the same solution stream and search tree, on the fp32 tree and on
the int8 + fused tree. The MCTS behaviour tests mirror
``tests/test_pipeline.py``. Also: the port and ``chip_smoke.py`` import
neither JAX nor ``detikzify_tpu``, and ``chip_smoke.py`` rehearses its
phases on the CPU and refuses to run without a card.
"""
import concurrent.futures as cf
import json
import os
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import pytest
import torch
from PIL import Image, ImageDraw

from detikzify_tpu.config import tiny_test_config
from detikzify_tpu.evaluate.imagesim import ImageSim as JImageSim
from detikzify_tpu.infer import DetikzifyPipeline as JPipeline
from detikzify_tpu.infer import FakeBackend as JFake
from detikzify_tpu.infer import set_backend as j_set_backend
from detikzify_tpu.models import detikzify as jdet
from detikzify_tpu.ops import quant as jquant
from detikzify_tpu.processing import ByteTokenizer as JTok
from detikzify_tpu.processing import DetikzifyProcessor as JProc
from detikzify_torch.config import tiny_test_config as t_tiny_test_config
from detikzify_torch.evaluate import ImageSim as TImageSim
from detikzify_torch.infer import DetikzifyGenerator as TGenerator
from detikzify_torch.infer import DetikzifyPipeline as TPipeline
from detikzify_torch.infer import FakeBackend as TFake
from detikzify_torch.infer import CompileService as TCompileService
from detikzify_torch.infer import TikzDocument as TDoc
from detikzify_torch.infer import set_backend as t_set_backend
from detikzify_torch.models import convert
from detikzify_torch.processing import ByteTokenizer as TTok
from detikzify_torch.processing import DetikzifyProcessor as TProc

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


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


@pytest.fixture(scope="module")
def pipelines():
    cfg = tiny_test_config(vocab_size=512)
    jparams = jdet.init(jax.random.PRNGKey(7), cfg)
    tcfg = t_tiny_test_config(vocab_size=512)
    tparams = convert.params_from_numpy(
        jax.tree.map(np.asarray, jparams._asdict()), tcfg, device="cpu")
    kw = dict(metric="fast", num_slots=4, max_len=96, temperature=0.0)
    jpipe = JPipeline(jparams, cfg, JProc(_tok(JTok, cfg), cfg), **kw)
    tpipe = TPipeline(tparams, tcfg, TProc(_tok(TTok, tcfg), tcfg),
                      device="cpu", **kw)
    yield jpipe, tpipe
    tpipe.close()


def _figures():
    figs = []
    for i in range(3):
        img = Image.new("RGB", (180 + 20 * i, 120), "white")
        d = ImageDraw.Draw(img)
        d.rectangle([10, 10, 170, 110 - 10 * i], outline="black", width=2)
        d.ellipse([40, 30, 140 - 15 * i, 90], outline="red", width=2)
        figs.append(img)
    return figs


def test_sample_code_matches_jax(pipelines):
    jpipe, tpipe = pipelines
    for fig in _figures()[:2]:
        want = jpipe.sample(image=fig, max_new_tokens=24)
        got = tpipe.sample(image=fig, max_new_tokens=24)
        assert got.code == want.code
        assert got.compiled_with_errors == want.compiled_with_errors
    eng = tpipe.engine
    assert eng.num_active == 0 and eng.num_free_slots == eng.num_slots
    # the generator's close() dropped its stored prefixes
    assert eng.prefix_pages_used == 0
    assert eng.num_free_pages == eng._page_refs.shape[0] - 1


def test_sample_batch_code_matches_jax(pipelines):
    jpipe, tpipe = pipelines
    figs = _figures()
    want = [d.code for d in jpipe.sample_batch(figs, max_new_tokens=16)]
    got = [d.code for d in tpipe.sample_batch(figs, max_new_tokens=16)]
    assert got == want
    assert any(got), "the tiny model should emit some byte tokens"
    # a batch gives each figure its own sample() continuation
    single = tpipe.sample(image=figs[2], max_new_tokens=16).code
    assert got[2] == single


def test_generator_rollout_matches_jax(pipelines):
    """rollout() streams the same line-boundary prefixes as the JAX
    generator; a second rollout restores the stored prompt prefix."""
    streams, hits = [], []
    for pipe in pipelines:
        gen = pipe.generator(image=_figures()[1], max_new_tokens=20)
        try:
            runs = []
            for _ in range(2):
                runs.append(list(gen.rollout(gen.root.state)))
                gen._finish_rollout([])
            assert runs[0] == runs[1] and runs[0]
            streams.append(runs[0])
            hits.append(gen.stats["prefix_hits"])
        finally:
            gen.close()
    assert streams[0] == streams[1]
    assert hits == [1, 1]


# ---------------------------------------------------------------------------
# MCTS simulate() with SelfSim (mirrors tests/test_pipeline.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def selfsim_pipe(pipelines):
    """The port's pipeline with its default metric (SelfSim) on the same
    engine as the fast-mode one."""
    _, tpipe = pipelines
    pipe = TPipeline(tpipe.engine.params, tpipe.cfg, tpipe.processor,
                     engine=tpipe.engine)
    assert isinstance(pipe.metric, TImageSim)
    yield pipe
    pipe.close()


def _walk(node):
    yield node
    for c in node.children:
        yield from _walk(c)


def _free(engine):
    return engine.num_active == 0 and engine.num_free_slots == \
        engine.num_slots


def test_simulate_yields_scored_documents(selfsim_pipe):
    results = list(selfsim_pipe.simulate(image=_figures()[0], expansions=3,
                                         max_new_tokens=20))
    assert len(results) == 3
    for score, doc in results:
        assert isinstance(doc, TDoc) and isinstance(score, (int, float))
        if doc.is_rasterizable:
            assert -1.0 <= score <= 1.0           # SelfSim cosine range
        else:
            assert score == -1
    assert _free(selfsim_pipe.engine)


def test_simulate_fast_mode(pipelines):
    """metric='fast' scores from compiler diagnostics in {-1, 0, 1}."""
    _, tpipe = pipelines
    results = list(tpipe.simulate(image=_figures()[0], expansions=2,
                                  max_new_tokens=20))
    assert len(results) == 2
    assert all(score in (-1, 0, 1) for score, _ in results)


def test_mcts_grows_tree_and_reuses_prefixes(selfsim_pipe):
    gen = selfsim_pipe.generator(image=_figures()[1],
                                 metric=selfsim_pipe.metric,
                                 max_new_tokens=20)
    try:
        for _ in gen.simulate(expansions=4):
            pass
        root = gen.root
        assert len(root.children) >= 1
        assert gen.montecarlo.stats_expansion_count == 4
        assert gen.stats["rollouts"] >= 1
        if any(not c.is_widen_node for c in root.children):
            assert gen.stats["prefix_hits"] >= 1
        assert len(gen.score.cache) >= 1          # SelfSim scored renders
    finally:
        gen.close()
    assert selfsim_pipe.engine.prefix_pages_used == 0


def test_sequential_abort_stops_search(selfsim_pipe):
    """control.abort() ends the whole sequential search."""
    gen = selfsim_pipe.generator(image=_figures()[0],
                                 metric=selfsim_pipe.metric,
                                 max_new_tokens=20)
    try:
        results = []
        for item in gen.simulate(expansions=50):
            results.append(item)
            gen.control.abort()
        assert len(results) == 1
    finally:
        gen.close()
    assert _free(selfsim_pipe.engine)


def test_simulate_respects_timeout(selfsim_pipe):
    for par in (1, 3):
        results = list(selfsim_pipe.simulate(
            image=_figures()[0], expansions=50, timeout=1e-6,
            parallelism=par, max_new_tokens=20))
        assert len(results) <= 1
    assert _free(selfsim_pipe.engine)


def test_simulate_parallel(selfsim_pipe):
    """Parallel expansions give scored results, grow the tree and free
    every slot afterwards."""
    engine = selfsim_pipe.engine
    results = list(selfsim_pipe.simulate(image=_figures()[0], expansions=6,
                                         parallelism=3, max_new_tokens=20))
    assert len(results) == 6
    for score, doc in results:
        assert isinstance(score, (int, float))
        if doc.is_rasterizable:
            assert -1.0 <= score <= 1.0
    assert _free(engine) and not engine._rollouts


def test_simulate_parallel_virtual_loss_reverted(selfsim_pipe):
    gen = selfsim_pipe.generator(image=_figures()[2],
                                 metric=selfsim_pipe.metric,
                                 max_new_tokens=20)
    try:
        results = list(gen.simulate(expansions=4, parallelism=2))
        assert len(results) == 4
        root = gen.root
        # root visits equal the real backprops: virtual loss reverted
        assert root.visits == len(root._rewards)
        assert gen.montecarlo.stats_expansion_count == 4
    finally:
        gen.close()


def test_parallel_abort_cleans_up_inflight_stages(selfsim_pipe):
    """Aborting a parallel search with expansions in every stage (decoding,
    compiling, score-dispatched) frees all slots, finishes all rollouts and
    reverts the virtual losses of expansions that never completed."""
    backend = TFake(latency=0.2)
    t_set_backend(backend)
    try:
        compiler = TCompileService(workers=3, backend=backend)
        gen = TGenerator(engine=selfsim_pipe.engine,
                         processor=selfsim_pipe.processor,
                         image=selfsim_pipe.load(_figures()[0], True),
                         metric=selfsim_pipe.metric,
                         compile_service=compiler, max_new_tokens=20)
        completed = 0
        for _ in gen.simulate(expansions=30, parallelism=3):
            completed += 1
            if completed == 2:
                gen.control.abort()
        assert completed < 30
        assert _free(selfsim_pipe.engine)
        assert not selfsim_pipe.engine._rollouts
        for node in _walk(gen.root):
            assert node.visits >= 0
        assert gen.root.visits == len(gen.root._rewards)
        gen.close()
        compiler.shutdown()
    finally:
        t_set_backend(TFake())


def test_wave_scoring_shares_score_memo_and_dedups(selfsim_pipe):
    """The batched wave scorer shares the sequential path's score memo:
    memoised renders are skipped, in-wave duplicates encode once, and the
    resolved values are written back to the memo."""
    gen = selfsim_pipe.generator(image=_figures()[0],
                                 metric=selfsim_pipe.metric)
    try:
        class _Doc:
            is_rasterizable = True
            compiled_with_errors = False

            def __init__(self, img):
                self._img = img

            def rasterize(self):
                return self._img

        def _exp(img):
            e = type("_E", (), {})()
            fut = cf.Future()
            fut.set_result(_Doc(img))
            e.future = fut
            return e

        red = Image.new("RGB", (64, 64), "red")
        blue = Image.new("RGB", (64, 64), "blue")
        exps = [_exp(red), _exp(blue), _exp(red)]   # in-wave duplicate
        pending = gen._dispatch_scores(exps)
        assert pending is not None
        assert pending[1] == 2              # red encoded once, not twice
        out = gen._resolve_scores(pending)
        assert len(out) == 3
        assert out[id(exps[0])] == out[id(exps[2])]
        memo = gen.score.cache
        assert memo[red.tobytes()] == out[id(exps[0])]
        assert blue.tobytes() in memo
        hits0 = gen.stats["score_memo_hits"]
        assert gen._dispatch_scores([_exp(red), _exp(blue)]) is None
        assert gen.stats["score_memo_hits"] == hits0 + 2
        assert gen.score(red) == out[id(exps[0])]
    finally:
        gen.close()


# ---------------------------------------------------------------------------
# simulate() parity with the JAX package
# ---------------------------------------------------------------------------

def _sync_submit_doc(doc):
    """Compile on submit and hand back a finished future."""
    doc.compile()
    fut = cf.Future()
    fut.set_result(doc)
    return fut


def _sync_compiles(pipe):
    """Compile on submit, so the parallel loop sees every compile done at
    its first check, in both packages."""
    pipe.compiler.submit_doc = _sync_submit_doc


@pytest.fixture(scope="module", params=["fp32", "int8"])
def parity_pipes(request):
    """JAX and port pipelines on the same tree (fp32, or int8 + fused),
    8 slots, temperature 0, SelfSim in EMD mode (the v2 default)."""
    cfg = tiny_test_config(vocab_size=512)
    jp = jdet.init(jax.random.PRNGKey(7), cfg)
    if request.param == "int8":
        jp = jquant.fuse_projections(jquant.quantize_params(jp))
    tcfg = t_tiny_test_config(vocab_size=512)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp._asdict()),
                                   tcfg, device="cpu")
    kw = dict(num_slots=8, max_len=96, temperature=0.0)
    jproc, tproc = JProc(_tok(JTok, cfg), cfg), TProc(_tok(TTok, tcfg), tcfg)
    # a greedy byte stream from random weights rarely holds a newline: cut
    # a line at every third token id instead, in both packages, so that the
    # search grows a deep tree and restores stored prefixes
    for proc in (jproc, tproc):
        proc.tokenizer._detikzify_newline_table = {
            i: (1, True) for i in range(0, 512, 3)}
    jsim = JImageSim.from_detikzify(jp, cfg, processor=jproc, mode="emd")
    dispatch = jsim.score_against_async

    def ready_dispatch(*a, **k):       # results ready before the next check
        dev, n = dispatch(*a, **k)
        return jax.block_until_ready(dev), n

    jsim.score_against_async = ready_dispatch
    jpipe = JPipeline(jp, cfg, jproc, metric=jsim, **kw)
    tpipe = TPipeline(tp, tcfg, tproc, device="cpu", metric=TImageSim.
                      from_detikzify(tp, tcfg, processor=tproc, mode="emd"),
                      **kw)
    for pipe in (jpipe, tpipe):
        _sync_compiles(pipe)
    yield jpipe, tpipe
    tpipe.close()


def _tree(node):
    return (len(node.token_ids), node.is_widen_node, node.visits,
            tuple(_tree(c) for c in node.children))


@pytest.mark.parametrize("parallelism", [1, 8])
def test_simulate_matches_jax(parity_pipes, parallelism):
    """Greedy simulate(): the same solution stream (codes), scores within
    1e-4, the same tree, the same prefix reuse. Twelve expansions: the
    parallel search runs a second wave from restored prefixes."""
    runs = []
    for pipe in parity_pipes:
        random.seed(0)                      # UCT ties break at random
        gen = pipe.generator(image=_figures()[1], metric=pipe.metric,
                             max_new_tokens=24)
        try:
            out = list(gen.simulate(12, parallelism=parallelism))
            runs.append(([sc for sc, _ in out], [d.code for _, d in out],
                         _tree(gen.root), gen.stats["prefix_hits"]))
        finally:
            gen.close()
    (jscores, jcodes, jtree, jhits), (tscores, tcodes, ttree, thits) = runs
    assert len(tcodes) == 12 and tcodes == jcodes
    np.testing.assert_allclose(tscores, jscores, rtol=0, atol=1e-4)
    assert ttree == jtree and thits == jhits and thits > 0
    assert any(sc > -1 for sc in tscores)   # some renders were scored
    assert _free(parity_pipes[1].engine)


@pytest.mark.parametrize("parallelism", [1, 8])
def test_on_tick_calls_match_jax(parity_pipes, parallelism):
    """The scheduler hook runs at the head of each sequential expansion and
    of each loop trip of the parallel search: as many calls as the JAX
    generator makes on the same greedy simulate()."""
    runs = []
    for pipe in parity_pipes:
        random.seed(0)
        calls = []
        gen = pipe.generator(image=_figures()[1], metric=pipe.metric,
                             max_new_tokens=24,
                             on_tick=lambda calls=calls: calls.append(1))
        try:
            n = len(list(gen.simulate(6, parallelism=parallelism)))
        finally:
            gen.close()
        runs.append((len(calls), n))
    assert runs[1] == runs[0]
    assert runs[1][1] == 6
    if parallelism == 1:
        assert runs[1][0] == 6


@pytest.mark.parametrize("parallelism", [1, 4])
def test_simulate_shared_engine_matches_jax(parity_pipes, parallelism):
    """simulate(shared_engine=True), the serving layer's timesliced search:
    the staged parallel loop even at parallelism 1, with the same solution
    stream, scores (1e-4), tree and prefix reuse as the JAX generator's,
    and STALLED on the same loop trips (JAX yields it on every trip that
    ends with nothing in flight, also between two of its own waves)."""
    from detikzify_tpu.infer import generator as jgen_mod
    from detikzify_torch.infer import generator as tgen_mod

    runs = []
    for pipe, stalled in zip(parity_pipes, (jgen_mod.STALLED,
                                            tgen_mod.STALLED)):
        random.seed(0)                      # UCT ties break at random
        gen = pipe.generator(image=_figures()[1], metric=pipe.metric,
                             max_new_tokens=24)
        try:
            stream = list(gen.simulate(12, parallelism=parallelism,
                                       shared_engine=True))
            out = [o for o in stream if o is not stalled]
            runs.append(([sc for sc, _ in out], [d.code for _, d in out],
                         _tree(gen.root), gen.stats["prefix_hits"],
                         gen.stats["max_inflight"],
                         [o is stalled for o in stream]))
        finally:
            gen.close()
    (jscores, jcodes, jtree, jhits, jin, jst), (tscores, tcodes, ttree,
                                                thits, tin, tst) = runs
    assert len(tcodes) == 12 and tcodes == jcodes
    np.testing.assert_allclose(tscores, jscores, rtol=0, atol=1e-4)
    assert ttree == jtree and thits == jhits and tin == jin
    assert tst == jst
    assert _free(parity_pipes[1].engine)


def _hold_every_slot(pipe, gen):
    """Start rollouts on every free slot of ``pipe``'s engine without
    stepping them, as a paused sibling search holds its slots."""
    eng = pipe.engine
    n = eng.num_free_slots
    return eng.start_many([list(gen.root.token_ids)] * n,
                          image_embeds=gen.image_embeds,
                          max_new_tokens=[40] * n)


def _let_go(pipe, ros):
    eng = pipe.engine
    for ro in ros:
        eng.abort(ro)
    while not all(ro.finished for ro in ros):
        eng.step()
    for ro in ros:
        eng.release(ro)


def test_shared_search_yields_stalled_while_slots_are_held(pipelines,
                                                          monkeypatch):
    """While a second generator holds every slot, a shared search yields
    STALLED (it hands control back instead of spinning), in both packages;
    once the slots are freed it completes with the JAX stream."""
    from detikzify_tpu.infer import generator as jgen_mod
    from detikzify_torch.infer import generator as tgen_mod

    runs = []
    for pipe, stalled in zip(pipelines, (jgen_mod.STALLED,
                                         tgen_mod.STALLED)):
        monkeypatch.setattr(pipe.compiler, "submit_doc",
                            _sync_submit_doc)
        holder = pipe.generator(image=_figures()[2], max_new_tokens=40)
        gen = pipe.generator(image=_figures()[0], max_new_tokens=16)
        try:
            held = _hold_every_slot(pipe, holder)
            it = gen.simulate(3, parallelism=2, shared_engine=True)
            firsts = [next(it) for _ in range(3)]
            assert all(out is stalled for out in firsts)
            assert pipe.engine.num_free_slots == 0
            _let_go(pipe, held)
            # between two of its own waves the loop may yield STALLED too
            rest = [out for out in it if out is not stalled]
            runs.append([d.code for _, d in rest])
        finally:
            gen.close()
            holder.close()
    assert len(runs[1]) == 3 and runs[1] == runs[0]
    assert _free(pipelines[1].engine)


def test_live_parallelism_bounds_decoding_rollouts(parity_pipes):
    """A mid-run change of gen.parallelism (a scheduler's rebalance) bounds
    the rollouts launched after it: at 1, every later launch is a single
    rollout on an engine with none of the search's rollouts decoding. The
    launch sequence equals the JAX generator's."""
    from detikzify_tpu.infer import generator as jgen_mod
    from detikzify_torch.infer import generator as tgen_mod

    runs = []
    for pipe, stalled in zip(parity_pipes, (jgen_mod.STALLED,
                                            tgen_mod.STALLED)):
        eng = pipe.engine
        launches = []
        start_many = eng.start_many

        def recording(prompts, *a, **kw):
            launches.append((eng.num_active, len(prompts)))
            return start_many(prompts, *a, **kw)

        eng.start_many = recording
        gen = pipe.generator(image=_figures()[1], metric=pipe.metric,
                             max_new_tokens=24)
        try:
            random.seed(0)
            it = gen.simulate(16, parallelism=4, shared_engine=True)
            first = [next(it)]
            assert gen.parallelism == 4
            n_before = len(launches)
            gen.parallelism = 1
            out = [o for o in first + list(it) if o is not stalled]
        finally:
            gen.close()
            del eng.start_many
        assert len(out) == 16
        assert launches[0] == (0, 4)
        after = launches[n_before:]
        assert after and all(n == 1 and active == 0
                             for active, n in after)
        runs.append(launches)
    assert runs[1] == runs[0]
    assert _free(parity_pipes[1].engine)


def test_port_imports_no_jax():
    """Importing every module of the port, and chip_smoke.py, leaves jax
    and detikzify_tpu out of sys.modules, optax and orbax (the port's
    training writes its own optimizer and checkpoints), and safetensors
    and transformers too: the card's machine has neither, so the port
    reads and writes checkpoints itself and imports transformers only to
    load a tokenizer."""
    code = """
import importlib, pkgutil, sys
import detikzify_torch
for m in pkgutil.walk_packages(detikzify_torch.__path__, 'detikzify_torch.'):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(n for n in sys.modules
             if n in ('jax', 'safetensors', 'transformers', 'optax',
                      'orbax')
             or n.startswith(('jax.', 'jaxlib', 'detikzify_tpu',
                              'safetensors.', 'transformers.', 'optax.',
                              'orbax.')))
print(len([n for n in sys.modules if n.startswith('detikzify_torch')]), bad)
print(' '.join(sorted(n for n in sys.modules
                      if n.startswith('detikzify_torch'))))
assert not bad, bad
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 20
    # the walk reached the evaluation suite and the native binding
    walked = set(out.stdout.splitlines()[1].split())
    assert {f"detikzify_torch.evaluate.{m}" for m in (
        "clipscore", "crystalbleu", "dist", "dreamsim", "dreamsim_vit",
        "eed", "harness", "imagesim", "kid")} <= walked
    assert "detikzify_torch.native" in walked
    # and the training core
    assert {f"detikzify_torch.train.{m}" for m in (
        "checkpoint", "data", "pretrain", "step", "train", "trainer")} | {
        "detikzify_torch.data.augment",
        "detikzify_torch.dataset.synthetic"} <= walked


def test_chip_smoke_cpu_rehearsal():
    """The smoke script's phases run end to end at tiny-test on the CPU:
    the v2 phases, the TikZero adapter's (``tikzero_sample``,
    ``tikzero_simulate``), the checkpoint round trip (``load``), the HTTP
    server (``serve``), the evaluation protocol through the port's
    ``examples.eval`` (``evaluate``), the command line (``replicas``,
    ``trace``, ``infer_cli``, ``serve_bench``), the v1
    family's phases, training (K1's backward, the training reference,
    ``train``, ``trainer``, ``mesh``, ``pretrain``), post-training (the
    adapter and GRPO references, ``grpo``, ``adapter_pretrain``,
    ``adapter_train``), the pipelined engine (``pipelined``,
    ``pipelined_spec``), the BPE
    speculation measurement (``spec_acceptance``) and the verification
    tool (``verify_real``)."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "chip_smoke.py", "--cpu-rehearsal",
                          "--max-new-tokens", "8"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert json.loads(lines[-1]) == {"ok": True, "rehearsal": "cpu"}
    kernels = json.loads(lines[-2])["kernels"]
    names = {row["kernel"] for row in kernels}
    assert names == {"flash_attention", "paged_decode", "paged_verify",
                     "decode_contig", "int8_gemv"}
    paths = {"sample", "contiguous", "spec_greedy", "tikzero_sample",
             "tikzero_simulate", "load", "simulate", "simulate_spec",
             "simulate_spec_gated", "serve", "evaluate_predict",
             "evaluate_model_mode", "evaluate_score", "replicas_single",
             "replicas_one", "replicas_two", "trace", "infer_cli_one_shot",
             "infer_cli_mcts", "serve_bench", "v1_sample", "v1_simulate",
             "train", "pretrain", "grpo", "adapter_pretrain",
             "adapter_train", "pipelined", "pipelined_spec", "verify_real",
             "spec_acceptance", "mesh"}
    assert all(set(row["launches_by_path"]) == paths for row in kernels)
    # the v1 family's kernel shapes sit beside the v2 ones
    row_names = {row["name"] for row in kernels}
    assert {"flash_attention/v1_vision", "flash_attention/v1_map_head",
            "flash_attention/v1_prefill_window",
            "paged_decode/v1"} <= row_names
    assert {f"int8_gemv/v1_{p}/rows{m}" for p in ("qkv", "o", "gateup",
                                                   "down")
            for m in (1, 8)} <= row_names
    # and the TikZero adapter's: the cross-attention and the caption model
    assert {"flash_attention/cross", "flash_attention/caption"} <= row_names
    # and post-training's: distillation's tower and cross-attention, GRPO's
    # log-prob pass
    assert {"flash_attention/distill_tower", "flash_attention/distill_cross",
            "flash_attention/grpo_logprobs"} <= row_names
    # and the command line's: serve_bench's DS-1.3b engine (K2 over 16
    # slots, K5 at its fused products at 16 rows) and eval's unfused int8
    assert {"paged_decode/ds13_16slots"} | {
        f"int8_gemv/ds13_{p}/rows16" for p in ("qkv", "o", "gateup",
                                                "down")} | {
        f"int8_gemv/unfused_{p}/rows8" for p in ("k_v", "gate_up")} \
        <= row_names
    phases, refs = {}, []
    for line in lines[:-2]:
        obj = json.loads(line)
        phases.setdefault(obj.get("phase"), obj)
        if obj.get("phase") == "reference":
            refs.append((obj["model"], obj["weights"]))
    assert refs == [("v2", "bf16"), ("v2", "int8+fused"), ("v1", "bf16"),
                    ("v1", "int8+fused"), ("tikzero", "bf16"),
                    ("clipscore", "bf16"), ("train", "bf16"),
                    ("adapter", "bf16"), ("grpo", "bf16")]
    tz = phases["tikzero_sample"]
    assert all(d["differing_entries"] == 0
               for d in tz["checkpoint"]["loaded_vs_written"].values())
    assert tz["checkpoint"]["config_round_trip"]
    assert tz["image_tokens_moved_by_caption_max_abs"] > 0
    assert len(tz["code_chars"]) == 2
    tzs = phases["tikzero_simulate"]
    assert tzs["rollouts"] == 8 and "caption" in tzs["metric"]
    assert max(tzs["selfsim_wave_sizes"]) > 1
    assert all(np.isfinite(tzs["scores"]))
    load = phases["load"]
    assert load["loaded_vs_in_place_quantized"]["differing_entries"] == 0
    assert load["loaded_vs_in_place_quantized"]["tensors"] > 0
    assert load["config_round_trip"] and load["bytes_written"] > 0
    v1 = phases["v1_sample"]
    assert v1["requests"]["figures"] == 6 and v1["feature_layer"] == 0
    assert v1["loaded_vs_written"]["differing_entries"] == 0
    assert phases["v1_simulate"]["rollouts"] == 8
    assert phases["v1_simulate"]["metric"] == "SelfSim cos"
    assert all(np.isfinite(phases["v1_simulate"]["scores"]))
    # post-training: distillation trains the adapter alone, TikZero+ a copy
    # of the decoder, GRPO a copy of the policy from distinct rewards
    ap = phases["adapter_pretrain"]
    assert len(ap["steps"]) == 2 and ap["checkpoints"] == ["checkpoint-2"]
    assert ap["adapter_moved_max_abs"] > 0
    assert ap["tower_changed_tensors"] == ap[
        "caption_model_changed_tensors"] == 0
    at = phases["adapter_train"]
    assert at["callers_text_changed_tensors"] == 0
    assert [len(r["steps"]) for r in at["runs"].values()] == [2, 2]
    grpo = phases["grpo"]
    assert len(grpo["steps"]) == 2 and grpo["distinct_rewards"] > 1
    assert grpo["callers_changed_tensors"] == 0
    assert grpo["text_moved_max_abs"] > 0
    # the temporary checkpoints are gone
    assert not list((ROOT / "build").glob("adapter_*"))
    assert not list((ROOT / "build").glob("load_*"))
    assert not list((ROOT / "build").glob("v1_*"))
    assert not list((ROOT / "build").glob("tikzero_*"))
    sim = phases["simulate"]
    assert sim["rollouts"] == 16
    assert sim["selfsim_scored_renders"] > 0
    assert max(sim["selfsim_wave_sizes"]) > 1
    assert sim["distinct_programs"] > 1
    assert all(np.isfinite(sim["scores"]))
    assert phases["main"]["requests"]["figures"] == 6
    contig = phases["contiguous"]
    assert contig["first_step_logits_vs_engine"]["min_cosine"] >= 0.9999
    spec = phases["spec_greedy"]
    assert spec["hinted"]["spec_rate"] > 2.0
    assert all(g["top1_top2_gap"] <= spec["tau"] for g in spec["divergences"])
    for path in ("simulate_spec", "simulate_spec_gated"):
        assert phases[path]["rollouts"] == 16
        assert phases[path]["spec_counters"]["spec_steps"] > 0
    # the HTTP server on the int8 + fused weights, driven over real HTTP
    serve = phases["serve"]
    assert "flash_attention/vision_fused4" in row_names
    assert serve["requests"]["failed"] == 0
    assert serve["requests"]["batched"] >= 4
    assert serve["requests"]["mcts"] == 3 and serve["requests"]["sample"] >= 10
    assert len(serve["under_mcts"]["mcts_scores"]) == 16
    assert serve["two_searches"]["first_candidates_before_other_end"]
    assert serve["stream_token_events"] > 0
    assert set(serve["latency_s"]) == {"sample", "mcts"}
    # the evaluation protocol: predict, the cache pass, model mode, score
    ev = phases["evaluate"]
    assert {"flash_attention/clip_text",
            "flash_attention/clip_vision"} <= row_names
    assert ev["cache"] == {"first_pass_hits": 0, "second_pass_hits": 4,
                           "second_pass_new_searches": 0}
    # one pool a predict pass, and no engine left holding slots or pages
    assert ev["pools_built"] == [1, 1]
    assert ev["held_after"] == {"predict": [], "cache_pass": []}
    assert ev["model_mode"]["num_programs"] == ev["model_mode"][
        "expansions"] > 1
    m = ev["metrics"]
    assert m["CompileSuccessRate"] == 1.0
    assert set(m) == {"CompileSuccessRate", "MeanTokenEfficiency",
                      "MeanSamplingThroughput", "SelfSim", "KID",
                      "CrystalBLEU", "TexEditDistance", "DreamSim",
                      "ClipScore", "SelfSim_redacted", "DreamSim_redacted",
                      "ClipScore_redacted"}
    assert all(np.isfinite(v) for v in m.values())
    assert 0 < m["ClipScore"] < 1 and -1 <= m["SelfSim"] <= 1
    assert ev["native_available"] and \
        ev["crystalbleu_shared_ngrams"] == "native"
    assert ev["dreamsim"]["round_trip_differing_entries"] == [0, 0, 0]
    assert abs(ev["dreamsim"]["self_similarity"] - 1) <= 1e-3
    clip = ev["clipscore"]["loaded_vs_written"]
    assert clip["scalars_equal"] and clip["vision"]["differing_entries"] == 0
    assert clip["text"]["differing_entries"] == 0
    assert not list((ROOT / "build").glob("eval_*"))
    assert ev["entry"] == "detikzify_torch.examples.eval"
    assert not any(ev["launches_cache_pass"].values())
    # the command line: ReplicaPool on one and on two replicas, the infer
    # REPL, serve_bench, a trace with its annotation
    rep = phases["replicas"]
    for run, n in (("one", 1), ("two", 2)):
        r = rep["runs"][run]
        assert r["replicas"] == n and r["shared_weights"]
        assert r["distinct_page_pools"] == n
        mu = r["map_until_compilable"]
        assert mu["failed"] == 0 and sum(mu["items_by_replica"]) == 2
        assert min(mu["items_by_replica"]) > 0
        assert r["map_sample"]["identical_token_share"] == 1.0
        assert r["map_sample"]["matched_positions"] > 0
    cli = phases["infer_cli"]["runs"]
    assert cli["one_shot"]["saved"] == 2 and cli["one_shot"]["tex_bytes"]
    assert cli["mcts"]["scores"] >= 2
    sb = phases["serve_bench"]["report"]
    assert sb["requests"] == 7 and sb["failed"] == 0
    assert sb["fused_fraction"] > 0
    assert phases["trace"]["found"]["prefill"]
    assert phases["trace"]["host_phases"]["prefill"]["count"] >= 1
    assert phases["trace"]["host_phases"]["sample"]["count"] == 1
    assert not list((ROOT / "build").glob("infer_*"))
    assert not list((ROOT / "build").glob("trace_*"))
    # training: K1's backward with its mutant, the gradient reference, the
    # step at two accumulations, the trainer's save and resume, pretrain
    assert "flash_attention/train_decoder" in row_names
    back = phases["k1_backward"]["rows"]
    assert [r["name"] for r in back] == [
        "flash_attention_backward/train_decoder",
        "flash_attention_backward/train_vision",
        "flash_attention_backward/distill_cross"]
    assert all(r["max_err_over_tol"] <= 1 for r in back)
    assert back[0]["no_causal_mutant_err_over_tol"] > 1
    assert back[2]["no_key_mask_mutant_err_over_tol"] > 1
    ref = [json.loads(line) for line in lines[:-2]
           if '"model": "train"' in line][0]
    assert ref["grad_rel_l2_max"] <= 5e-2 and ref["leaves"] > 0
    train = phases["train"]
    assert [r["grad_accum"] for r in train["runs"]] == [1, 2]
    assert all(len(r["steps"]) == 3 and all(
        np.isfinite(s["loss"]) for s in r["steps"]) for r in train["runs"])
    assert train["moved_max_abs"] > 0
    trainer = phases["trainer"]
    assert trainer["steps"] == trainer["resumed_step"] == 2
    assert trainer["checkpoints"] == ["checkpoint-2"]
    assert trainer["restored_vs_trained"]["differing_entries"] == 0
    pre = phases["pretrain"]
    assert pre["connector_moved_max_abs"] > 0
    assert pre["embed_tokens_moved_max_abs"] == 0
    assert pre["other_leaves_moved"] == 0 and pre["overlay_equal"]
    assert not list((ROOT / "build").glob("train_*"))
    assert not list((ROOT / "build").glob("pretrain_*"))


def test_chip_smoke_refuses_without_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
