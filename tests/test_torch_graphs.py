"""The port's decode-block program cache (``DecodeEngine._build_jit``, the
counterpart of the JAX engine's jitted ``decode_many`` and
``decode_many_spec``) against the JAX engine, on the CPU at ``tiny-test``
(vocab 512, fp32 weights carried over with ``params_from_numpy``, fp32
page pools). On the CPU a program is the block function itself over the
same static buffers a CUDA graph reads; ``tests/test_torch_gpu.py`` holds
the graphs on a card.

  * the cache is keyed as JAX keys its jits: for the same traffic the keys
    of each mode number JAX's ``_decode_many._cache_size()`` and
    ``_decode_many_spec._cache_size()``, and requests with other
    temperature, top-p and top-k add none (``test_perf_contracts.py``'s
    ``test_sampling_overrides_do_not_recompile``);
  * with the state updated in place (fixed addresses from start to end),
    greedy streams and draft counts equal the JAX engine's, plain and at
    ``speculate=3``, eager and pipelined;
  * a block's outputs are static: reading them after the next block ran
    raises; rebinding the engine's weights drops the programs;
  * the per-replay launch tally, with a stand-in kernel handle, on one
    thread and beside other threads' launches and replays.
"""
import sys
import threading
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from detikzify_tpu.config import tiny_test_config
from detikzify_tpu.engine import DecodeEngine as JEngine
from detikzify_tpu.models import detikzify as jdet
from detikzify_tpu.ops.sampling import SamplingParams as JSampling
from detikzify_torch.config import tiny_test_config as t_tiny_test_config
from detikzify_torch.engine import DecodeEngine as TEngine
from detikzify_torch.engine.decode import _Program
from detikzify_torch.models import convert
from detikzify_torch.ops import cuda as cuda_ops
from detikzify_torch.ops.sampling import SamplingParams as TSampling

torch.set_num_threads(1)

ENGINE = dict(num_slots=2, max_len=128, page_size=16, decode_block=4)


@pytest.fixture(scope="module")
def model():
    cfg = tiny_test_config(vocab_size=512)
    jparams = jdet.init(jax.random.PRNGKey(0), cfg)
    tcfg = t_tiny_test_config(vocab_size=512)
    tparams = convert.params_from_numpy(
        jax.tree.map(np.asarray, jparams._asdict()), tcfg, device="cpu")
    return cfg, jparams, tcfg, tparams


def _port(model, **kw):
    args = dict(ENGINE, cache_dtype=torch.float32, device="cpu",
                sampling=TSampling(temperature=0.0))
    args.update(kw)
    return TEngine(model[3], model[2], **args)


def _jax(model, **kw):
    args = dict(ENGINE, cache_dtype=jnp.float32,
                sampling=JSampling(temperature=0.0))
    args.update(kw)
    return JEngine(model[1], model[0], **args)


def _keys(eng, speculative: bool) -> int:
    return sum(key[0] == speculative for key in eng._programs)


def _traffic(eng, cfg, sampling):
    """Greedy rollouts that cross page buckets (16 to 64 rows), blocks of
    two sizes, then short requests under other sampling parameters."""
    streams = []
    ro = eng.start([cfg.bos_token_id, 7, 8, 9], max_new_tokens=40)
    while not ro.finished:
        eng.step()
    streams.append(list(ro.token_ids))
    eng.release(ro)
    ros = [eng.start([cfg.bos_token_id, 11 + i], max_new_tokens=12,
                     lazy=True) for i in range(2)]
    while not all(r.finished for r in ros):
        eng.step(2)
    streams += [list(r.token_ids) for r in ros]
    for r in ros:
        eng.release(r)
    for t, p, k in [(0.7, 0.9, 0), (1.3, 0.5, 5), (0.2, 0.99, 50)]:
        ro = eng.start([cfg.bos_token_id, 2], max_new_tokens=4,
                       sampling=sampling(temperature=t, top_p=p, top_k=k))
        eng.run()
        eng.release(ro)
    return streams


@pytest.mark.parametrize("spec", [0, 3])
def test_program_keys_match_jax_compiled_programs(model, spec):
    """For the same traffic the port keeps one program per key of each
    mode that JAX compiled, and the sampled requests add none."""
    cfg = model[0]
    kw = dict(speculate=spec, spec_min_rate=0.0) if spec else {}
    jeng, teng = _jax(model, **kw), _port(model, **kw)
    want = _traffic(jeng, cfg, JSampling)
    got = _traffic(teng, cfg, TSampling)
    assert got == want
    j_spec = jeng._decode_many_spec._cache_size() if spec else 0
    assert _keys(teng, True) == j_spec
    assert _keys(teng, False) == jeng._decode_many._cache_size()
    assert len(teng._programs) >= 2
    assert {key[1] for key in teng._programs} == {2, 4}
    assert all(p.graph is None for p in teng._programs.values())
    # the sampled requests alone: no new program in either package
    n_t, n_j = len(teng._programs), jeng._decode_many._cache_size()
    for t, p, k in [(0.0, 1.0, 0), (0.9, 0.3, 2)]:
        for eng, sp in ((teng, TSampling), (jeng, JSampling)):
            ro = eng.start([cfg.bos_token_id, 3], max_new_tokens=4,
                           sampling=sp(temperature=t, top_p=p, top_k=k))
            eng.run()
            eng.release(ro)
    assert len(teng._programs) == n_t
    assert jeng._decode_many._cache_size() == n_j


@pytest.mark.parametrize("spec", [0, 3])
@pytest.mark.parametrize("pipelined", [False, True])
def test_in_place_state_gives_jax_streams(model, spec, pipelined):
    """Every piece of the engine's device state keeps its address from the
    first block to the last, and the greedy streams and draft counts equal
    the JAX engine's."""
    cfg = model[0]
    kw = dict(speculate=spec, spec_min_rate=0.0) if spec else {}
    prompts = [[cfg.bos_token_id, 41, 42, 43], [cfg.bos_token_id, 5]]

    def run(eng):
        ros = [eng.start(p, max_new_tokens=30, lazy=True) for p in prompts]
        while any(not r.finished for r in ros) or eng.has_inflight:
            eng.step()
        return [list(r.token_ids) for r in ros]

    teng = _port(model, pipelined=pipelined, **kw)
    state = {name: getattr(teng, name) for name in (
        "_tok_dev", "_pos_dev", "_tab_dev", "_buf_dev", "_hint_dev",
        "_active_dev", "_samp_dev")}
    state["pool_k"], state["pool_v"] = teng.cache.k, teng.cache.v
    ptrs = {k: (None if v is None else v.data_ptr()) for k, v in state.items()}
    got = run(teng)
    jeng = _jax(model, pipelined=pipelined, **kw)
    assert got == run(jeng)
    after = dict(_tok_dev=teng._tok_dev, _pos_dev=teng._pos_dev,
                 _tab_dev=teng._tab_dev, _buf_dev=teng._buf_dev,
                 _hint_dev=teng._hint_dev, _active_dev=teng._active_dev,
                 _samp_dev=teng._samp_dev, pool_k=teng.cache.k,
                 pool_v=teng.cache.v)
    for name, t in after.items():
        assert (t is state[name]) and (
            t is None or t.data_ptr() == ptrs[name]), name
    for key in ("decode_dispatches", "decode_steps", "decode_tokens",
                "spec_steps", "spec_tokens"):
        assert teng.counters[key] == jeng.counters[key], key
    assert teng.counters["decode_dispatches"] >= 3


def test_block_outputs_are_read_before_the_next_block(model):
    """Eager stepping reads a block's tokens before it dispatches the
    next; a read after the next block ran raises instead of returning the
    later block's tokens, which now sit in the same static tensors."""
    cfg = model[0]
    eng = _port(model)
    ro = eng.start([cfg.bos_token_id, 7], max_new_tokens=40)
    eng._dispatch(4)
    first, eng._inflight = eng._inflight, None
    eng._dispatch(4)
    with pytest.raises(RuntimeError, match="overwrote"):
        first[0].numpy()
    # the second block's own fetch is intact
    toks, counts = eng._inflight[0].numpy()
    assert toks.shape == (4, 2) and counts is None
    # step() itself keeps the order: every later block reads cleanly
    eng._inflight = None
    while not ro.finished:
        eng.step()
    assert ro.new_tokens == 40


def test_rebound_weights_drop_the_programs(model):
    """A graph reads the weight tensors it was captured with: rebinding
    ``engine.params`` (GRPO samples from each new policy so) drops every
    program, and the next blocks decode the new weights."""
    cfg = model[0]
    eng = _port(model)
    prompt = [cfg.bos_token_id, 7, 8]

    def run():
        ro = eng.start(prompt, max_new_tokens=12)
        while not ro.finished:
            eng.step()
        eng.release(ro)
        return list(ro.token_ids)

    first = run()
    assert eng._programs
    eng.params = model[3]               # the same weights: kept
    assert eng._programs
    other = convert.params_from_numpy(jax.tree.map(
        np.asarray, jdet.init(jax.random.PRNGKey(1), cfg)._asdict()),
        model[2], device="cpu")
    eng.params = other
    assert not eng._programs and eng.params is other
    second = run()
    assert second != first
    assert second == _greedy(_port(model), prompt, other)


def _greedy(eng, prompt, params):
    eng.params = params
    ro = eng.start(prompt, max_new_tokens=12)
    while not ro.finished:
        eng.step()
    return list(ro.token_ids)


def test_graph_requests_where_no_graph_runs_raise(model):
    """``graphs=True`` raises on the CPU and over a model axis; by default
    neither captures."""
    with pytest.raises(ValueError, match="CUDA device"):
        _port(model, graphs=True)
    assert _port(model).graphs is False
    params = model[3]
    params.placement = types.SimpleNamespace(
        mesh=types.SimpleNamespace(shape={"data": 1, "model": 2}))
    try:
        with pytest.raises(ValueError, match="model axis"):
            _port(model, graphs=True)
        assert _port(model).graphs is False
    finally:
        del params.placement


def _stand_in(name="stand_in"):
    """A kernel handle whose C entry point is a Python function that
    returns cudaSuccess."""
    k = cuda_ops.CudaKernel(name, "stand_in.cu", "detikzify_stand_in", [])
    k._fn = lambda *a: 0
    return k


class _Graph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


@pytest.mark.parametrize("replays", [1, 5])
def test_replays_count_the_captured_launches(replays):
    """Launches inside a capture go to the thread's tally, not to the
    counter; each replay of the program adds the tally."""
    k, other = _stand_in(), _stand_in("other")
    k.launch()
    with cuda_ops.tally_launches() as tally:
        for _ in range(3):
            k.launch()
        other.launch()
    assert (k.launches, other.launches) == (1, 0)
    assert tally == {k: 3, other: 1}
    out = (torch.zeros(2),)
    prog = _Program(lambda: out, out, _Graph(), tally)
    for _ in range(replays):
        assert prog() is out
    assert prog.graph.replays == replays
    assert (k.launches, other.launches) == (1 + 3 * replays, replays)
    k.launch()                  # counted again once the capture ended
    assert k.launches == 2 + 3 * replays


def test_tally_is_per_thread():
    """One thread captures while others launch the same kernel and others
    count replays, under a short switch interval: the launching threads'
    launches count at once, the capture's only when its graph replays,
    and no update is lost."""
    k = _stand_in()
    start = threading.Barrier(7)
    tallies = []

    def capture():
        with cuda_ops.tally_launches() as tally:
            start.wait(timeout=30)
            for _ in range(50):
                k.launch()
        tallies.append(tally)

    def launch():
        start.wait(timeout=30)
        for _ in range(200):
            k.launch()

    def replay():
        start.wait(timeout=30)
        for _ in range(100):
            cuda_ops.add_launches({k: 3})

    threads = ([threading.Thread(target=capture)]
               + [threading.Thread(target=launch) for _ in range(3)]
               + [threading.Thread(target=replay) for _ in range(3)])
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert k.launches == 3 * 200 + 3 * 100 * 3 and tallies == [{k: 50}]
    for _ in range(2):
        cuda_ops.add_launches(tallies[0])
    assert k.launches == 1500 + 100


@pytest.mark.parametrize("enabled", [True, False])
def test_capture_pauses_the_collector_and_restores_it(enabled):
    """A capture's cyclic garbage collection is off inside (a dead engine's
    graphs must not be destroyed during another capture) and as it was
    after, an error raised inside included."""
    import gc

    from detikzify_torch.engine.decode import _gc_paused

    before = gc.isenabled()
    (gc.enable if enabled else gc.disable)()
    try:
        with _gc_paused():
            assert not gc.isenabled()
        assert gc.isenabled() is enabled
        with pytest.raises(RuntimeError):
            with _gc_paused():
                raise RuntimeError("inside the capture")
        assert gc.isenabled() is enabled
    finally:
        (gc.enable if before else gc.disable)()
