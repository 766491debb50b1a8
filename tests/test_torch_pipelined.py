"""The port's ``DecodeEngine(pipelined=True)`` against the JAX engine's, on
the CPU at ``tiny-test`` (vocab 512, fp32 weights carried over with
``params_from_numpy``, fp32 page pools).

  * the counterpart of ``tests/test_engine.py::test_pipelined_mode_matches_sync``:
    the port's pipelined and eager greedy streams both equal JAX's
    pipelined stream;
  * step by step, the value of each ``step()`` (the priming ``[]``, the
    finishes one block late), ``has_inflight``, ``flush_steps`` and the
    engine counters equal JAX's;
  * a ``speculate=3`` engine whose gate flips from speculative to plain
    while a speculative block is in flight (the ``_kv_limit`` slack
    follows the previous dispatch, ``_consume`` re-marks the plain
    block's slots stale): streams equal JAX's and eager plain greedy.
"""
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
from detikzify_torch.models import convert
from detikzify_torch.ops.sampling import SamplingParams as TSampling

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def model():
    cfg = tiny_test_config(vocab_size=512)
    jparams = jdet.init(jax.random.PRNGKey(0), cfg)
    tcfg = t_tiny_test_config(vocab_size=512)
    tparams = convert.params_from_numpy(
        jax.tree.map(np.asarray, jparams._asdict()), tcfg, device="cpu")
    return cfg, jparams, tcfg, tparams


def _port(model, **kw):
    return TEngine(model[3], model[2], cache_dtype=torch.float32,
                   device="cpu", sampling=TSampling(temperature=0.0), **kw)


def _jax(model, **kw):
    return JEngine(model[1], model[0], cache_dtype=jnp.float32,
                   sampling=JSampling(temperature=0.0), **kw)


def test_pipelined_mode_matches_sync_and_jax(model):
    """``test_engine.py::test_pipelined_mode_matches_sync``, held across the
    packages: the port's eager and pipelined streams equal JAX's
    pipelined stream."""
    cfg = model[0]
    prompt = [cfg.bos_token_id, 41, 42, 43]
    kw = dict(num_slots=2, max_len=96, decode_block=4)
    outs = []
    for make, pipelined in ((_port, False), (_port, True), (_jax, True)):
        eng = make(model, pipelined=pipelined, **kw)
        ro = eng.start(prompt, max_new_tokens=10)
        eng.run()
        outs.append(list(ro.token_ids))
        assert not eng.has_inflight
    assert outs[0] == outs[1] == outs[2]
    assert len(outs[0]) == len(prompt) + 10


def _trace(eng, prompts, budgets, n_steps):
    """Start rollouts lazily, then record per step what ``step()`` returns,
    ``has_inflight`` and the counters; drain with ``flush_steps``."""
    ros = [eng.start(list(p), max_new_tokens=m, lazy=True)
           for p, m in zip(prompts, budgets)]
    index = {id(r): i for i, r in enumerate(ros)}
    trace = []
    for _ in range(n_steps):
        done = eng.step()
        trace.append(([index[id(r)] for r in done], eng.has_inflight,
                      dict(eng.counters), eng.num_active))
    flushed = [index[id(r)] for r in eng.flush_steps()]
    trace.append((flushed, eng.has_inflight, dict(eng.counters),
                  eng.num_active))
    return trace, [list(r.token_ids) for r in ros]


@pytest.mark.parametrize("speculate", [0, 3])
def test_pipelined_steps_and_counters_match_jax(model, speculate):
    """Step by step: the priming ``[]``, the one-block finish lag,
    ``has_inflight``, ``flush_steps`` and every counter equal JAX's."""
    cfg = model[0]
    prompts = [[cfg.bos_token_id, 5, 6, 7], [cfg.bos_token_id, 9],
               [cfg.bos_token_id, 9, 9, 9, 12]]
    budgets = [9, 14, 5]
    kw = dict(num_slots=4, max_len=96, decode_block=4, pipelined=True,
              speculate=speculate, spec_min_rate=0.0)
    got, got_ids = _trace(_port(model, **kw), prompts, budgets, 6)
    want, want_ids = _trace(_jax(model, **kw), prompts, budgets, 6)
    assert got_ids == want_ids
    assert got == want
    assert got[0][0] == [] and got[0][1]          # primed, block in flight
    assert got[-1][1] is False                    # drained
    eager, _ = _trace(_port(model, **dict(kw, pipelined=False)), prompts,
                      budgets, 6)
    # eager stepping sees each finish one step earlier
    first_finish = next(i for i, t in enumerate(got) if t[0])
    assert next(i for i, t in enumerate(eager) if t[0]) == first_finish - 1


def _gate_flip_run(eng, prompts, hint):
    """Two rollouts (one hinted); after the priming step (a speculative
    block in flight) every draft class is switched off, so the next
    dispatch is plain while the speculative block is still in flight;
    two steps later the classes come back on."""
    ros = [eng.start(list(p), max_new_tokens=24, lazy=True,
                     hint=hint if i == 1 else None)
           for i, p in enumerate(prompts)]
    n = 0
    spec_flags = []
    while any(not r.finished for r in ros) or eng.has_inflight:
        eng.step()
        spec_flags.append(eng._last_dispatch_spec)
        n += 1
        if n == 1:
            for st in eng._spec_cls.values():
                st["on"] = False
        if n == 3:
            for st in eng._spec_cls.values():
                st["on"] = True
    return ([list(r.token_ids) for r in ros], spec_flags,
            {k: eng.counters[k] for k in ("spec_steps", "spec_tokens",
                                          "decode_tokens", "buf_resyncs",
                                          "decode_dispatches")})


def test_gate_flip_while_speculative_block_in_flight(model):
    """``speculate=3``: the gate flips spec -> plain with a speculative
    block in flight, then back. The plain block's ``_kv_limit`` keeps the
    speculative slack; its slots are re-marked stale when its tokens land
    and resynced before the next speculative block. Streams equal JAX's
    and the port's eager plain greedy streams; the counters equal JAX's."""
    cfg = model[0]
    prompts = [[cfg.bos_token_id, 5, 6, 7, 5, 6], [cfg.bos_token_id, 9, 9]]
    hint = [9, 9, 3, 4, 5, 6, 7, 8]
    kw = dict(num_slots=2, max_len=96, decode_block=4, pipelined=True,
              speculate=3, spec_min_rate=1.3)
    teng = _port(model, **kw)
    # the slack of a plain dispatch right after a speculative one
    teng._last_dispatch_spec = True
    teng._rollouts[0] = type("R", (), {"token_ids": [0] * 20})()
    teng._active[0] = True
    assert teng._kv_limit(4, False) == 64       # 20 + 4 + 4 * (3 + 1)
    teng._last_dispatch_spec = False
    assert teng._kv_limit(4, False) == 32       # 20 + 4 + 4
    del teng._rollouts[0]
    teng._active[0] = False

    got, tflags, tcounts = _gate_flip_run(teng, prompts, hint)
    want, jflags, jcounts = _gate_flip_run(_jax(model, **kw), prompts, hint)
    assert got == want
    assert tflags == jflags and tflags[:3] == [True, False, False]
    assert True in tflags[3:]
    assert tcounts == jcounts and tcounts["buf_resyncs"] >= 1
    plain = _port(model, num_slots=2, max_len=96, decode_block=4)
    ros = [plain.start(list(p), max_new_tokens=24, lazy=True)
           for p in prompts]
    plain.run()
    assert got == [list(r.token_ids) for r in ros]
