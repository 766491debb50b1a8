"""The port's DecodeEngine against the JAX DecodeEngine (``speculate=0``),
on the CPU at ``tiny-test`` in fp32 with fp32 page pools.

Greedy streams must be token-identical for fresh starts, prefix-restored
starts and ``start_many`` bursts; the port decodes zero-copy through the
page table (K2's plain version here), the JAX engine through its default
gather views. Host page accounting must stay exact: refcounts return to
zero after release, and an exhausted pool rolls a wave back cleanly
(mirrors ``tests/test_paged.py``).
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

KW = dict(num_slots=3, max_len=128, page_size=16, prefix_budget_bytes=1)


@pytest.fixture(scope="module")
def engines():
    cfg = tiny_test_config(vocab_size=512)
    jparams = jdet.init(jax.random.PRNGKey(0), cfg)
    tcfg = t_tiny_test_config(vocab_size=512)
    tparams = convert.params_from_numpy(
        jax.tree.map(np.asarray, jparams._asdict()), tcfg, device="cpu")
    jeng = JEngine(jparams, cfg, cache_dtype=jnp.float32,
                   sampling=JSampling(temperature=0.0), **KW)
    teng = TEngine(tparams, tcfg, cache_dtype=torch.float32,
                   sampling=TSampling(temperature=0.0), device="cpu", **KW)
    return cfg, jeng, teng


def _drain(eng, ro):
    while not ro.finished:
        eng.step()
    return list(ro.token_ids)


def _check_accounting(eng):
    """Every non-trash page's refcount == live slot-table references +
    stored-prefix references; the free list is exactly the zero-refcount
    pages."""
    n_pages = eng._page_refs.shape[0]
    trash = eng._trash_page
    expected = np.zeros(n_pages, np.int64)
    for slot in range(eng.num_slots):
        if eng._table_live[slot]:
            np.add.at(expected, eng._tables[slot], 1)
    for sp in eng._prefix_store.values():
        np.add.at(expected, list(sp.pages), 1)
    for pid in range(n_pages):
        if pid != trash:
            assert eng._page_refs[pid] == expected[pid], pid
    free = eng._free_pages
    assert len(free) == len(set(free)) and trash not in free
    assert set(free) == {p for p in range(n_pages)
                         if p != trash and eng._page_refs[p] == 0}


def _both(engines, fn):
    """Run fn(engine) on both engines; return (jax result, torch result)."""
    _, jeng, teng = engines
    return fn(jeng), fn(teng)


def test_engine_geometry_matches_jax(engines):
    _, jeng, teng = engines
    assert teng.max_len == jeng.max_len
    assert teng._m_cap == jeng._m_cap
    assert teng._trash_page == jeng._trash_page
    assert teng._page_refs.shape == jeng._page_refs.shape


def test_fresh_start_greedy_matches_jax(engines):
    cfg = engines[0]
    prompt = [cfg.bos_token_id, 5, 6, 7, 8]

    def run(eng):
        ro = eng.start(prompt, max_new_tokens=12)
        out = _drain(eng, ro)
        eng.release(ro)
        return out

    want, got = _both(engines, run)
    assert got == want and len(got) > len(prompt)


def test_image_prompt_greedy_matches_jax(engines):
    cfg = engines[0]
    rng = np.random.default_rng(0)
    size = cfg.vision.image_size
    pix = rng.standard_normal((1, size, size, 3)).astype(np.float32)
    prompt = [cfg.image_token_id] * cfg.image_seq_len + [cfg.bos_token_id]
    _, jeng, teng = engines
    jemb = jeng.encode_image(jnp.asarray(pix))
    temb = teng.encode_image(pix)
    np.testing.assert_allclose(temb.numpy(), np.asarray(jemb), atol=3e-4,
                               rtol=3e-4)

    def run(eng, emb):
        ro = eng.start(prompt, image_embeds=emb, max_new_tokens=10)
        out = _drain(eng, ro)
        eng.release(ro)
        return out

    assert run(teng, temb) == run(jeng, jemb)


def test_prefix_restored_start_matches_jax(engines):
    """Store a prefix off a rollout (boundary copy), release it, restore it
    into a longer prompt: same tokens as JAX and as a fresh start."""
    cfg = engines[0]
    rng = np.random.default_rng(3)
    prompt = [cfg.bos_token_id] + [int(t) for t in rng.integers(1, 200, 23)]

    def run(eng):
        ro = eng.start(prompt, max_new_tokens=4)
        first = _drain(eng, ro)
        sp = eng.store_prefix(("restore", id(eng)), ro, length=20)
        eng.release(ro)
        ids = first[:20] + [11, 12, 13]
        ro2 = eng.start(ids, prefix=sp, max_new_tokens=8)
        restored = _drain(eng, ro2)
        eng.release(ro2)
        ro3 = eng.start(ids, max_new_tokens=8)
        fresh = _drain(eng, ro3)
        eng.release(ro3)
        eng.drop_prefix(("restore", id(eng)))
        return first, restored, fresh, eng.counters["prefix_starts"]

    (jf, jr, jfr, _), (tf, tr, tfr, tstarts) = _both(engines, run)
    assert (tf, tr) == (jf, jr)
    assert tr == tfr
    assert tstarts >= 1


def test_start_many_burst_matches_jax(engines):
    cfg = engines[0]
    prompts = [[cfg.bos_token_id, 71, 72],
               [cfg.bos_token_id, 71, 73, 74],
               [cfg.bos_token_id, 75]]

    def run(eng):
        ros = eng.start_many(prompts, max_new_tokens=8)
        out = [_drain(eng, ro) for ro in ros]
        for ro in ros:
            eng.release(ro)
        return out

    want, got = _both(engines, run)
    assert got == want
    # a burst equals individual starts
    teng = engines[2]
    for p, g in zip(prompts, got):
        ro = teng.start(p, max_new_tokens=8)
        assert _drain(teng, ro) == g
        teng.release(ro)


def test_refcounts_return_to_zero_after_release(engines):
    teng = engines[2]
    cfg = engines[0]
    rng = np.random.default_rng(5)
    ros = []
    for n in (5, 30, 17):
        ros.append(teng.start([cfg.bos_token_id] + [int(t) for t in
                                                    rng.integers(1, 200, n)],
                              max_new_tokens=5, lazy=True))
    sp = teng.store_prefix("k", ros[1], length=18)
    assert sp is not None
    teng.run()
    _check_accounting(teng)
    for ro in ros:
        teng.release(ro)
    teng.drop_prefix("k")
    _check_accounting(teng)
    assert teng.num_free_pages == teng._page_refs.shape[0] - 1
    assert all(int(r) == 0 for r in teng._page_refs)


def test_pool_exhaustion_rolls_back_cleanly(engines):
    cfg, _, _ = engines
    tparams = engines[2].params
    eng = TEngine(tparams, t_tiny_test_config(vocab_size=512),
                  cache_dtype=torch.float32,
                  sampling=TSampling(temperature=0.0), device="cpu", **KW)
    real_alloc = eng._alloc_pages
    calls = {"n": 0}

    def flaky(n):
        calls["n"] += 1
        return None if calls["n"] in (1, 4) else real_alloc(n)

    eng._alloc_pages = flaky
    free_slots, free_pages = eng.num_free_slots, eng.num_free_pages
    prompt = [cfg.bos_token_id] + [7] * 9
    with pytest.raises(RuntimeError, match="exhausted"):
        eng.start(prompt, max_new_tokens=2)
    assert (eng.num_free_slots, eng.num_free_pages) == (free_slots,
                                                        free_pages)
    _check_accounting(eng)
    # burst: chunk 1 (2 rows) launches, chunk 2's allocation fails
    with pytest.raises(RuntimeError, match="exhausted"):
        eng.start_many([prompt, prompt, prompt], max_new_tokens=2)
    assert eng.num_free_slots == 1
    launched = list(eng._rollouts.values())
    assert len(launched) == 2
    eng._alloc_pages = real_alloc
    for ro in launched:
        _drain(eng, ro)
        eng.release(ro)
    _check_accounting(eng)
    ro = eng.start(prompt, max_new_tokens=2)
    _drain(eng, ro)


def test_engine_requires_cuda_by_default(engines):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TEngine(engines[2].params, t_tiny_test_config(vocab_size=512))


# ---------------------------------------------------------------------------
# engine invariants, mirrored from tests/test_engine.py and test_paged.py
# ---------------------------------------------------------------------------

def _port_engine(engines, **kw):
    args = dict(KW, cache_dtype=torch.float32,
                sampling=TSampling(temperature=0.0), device="cpu")
    args.update(kw)
    return TEngine(engines[2].params, t_tiny_test_config(vocab_size=512),
                   **args)


def _greedy_reference(engines, prompt, n_steps):
    """Greedy continuation by repeated full forwards of the port (no cache):
    the image token banned, EOS suppressed on the first step."""
    from detikzify_torch.models import detikzify as tdet

    cfg, _, teng = engines
    ids, out = list(prompt), []
    for step in range(n_steps):
        logits, _ = tdet.forward(teng.params, teng.cfg,
                                 torch.tensor([ids]))
        row = logits[0, -1].clone()
        row[cfg.image_token_id] = -float("inf")
        if step == 0:
            row[teng.eos_token_id] = -float("inf")
        ids.append(int(row.argmax()))
        out.append(ids[-1])
    return out


def test_engine_matches_full_forward_greedy(engines):
    cfg, _, teng = engines
    prompt = [cfg.bos_token_id, 5, 6, 7, 8]
    ro = teng.start(prompt, max_new_tokens=10)
    got = _drain(teng, ro)[len(prompt):]
    teng.release(ro)
    assert got == _greedy_reference(engines, prompt, len(got))


def test_staggered_batch_matches_jax(engines):
    """Slots joining mid-flight must not perturb each other."""
    cfg = engines[0]
    p1 = [cfg.bos_token_id, 11, 12]
    p2 = [cfg.bos_token_id, 21, 22, 23, 24, 25]

    def run(eng):
        r1 = eng.start(p1, max_new_tokens=8)
        for _ in range(3):
            eng.step(2)
        r2 = eng.start(p2, max_new_tokens=8)
        out = [_drain(eng, r1), _drain(eng, r2)]
        eng.release(r1)
        eng.release(r2)
        return out

    want, got = _both(engines, run)
    assert got == want


def test_eos_suppressed_on_first_token(engines):
    cfg = engines[0]
    eng = _port_engine(engines, num_slots=1, max_len=64,
                       eos_token_id=None)
    # make EOS the argmax of every position: its lm_head column = 5 x max
    head = eng.params.text.lm_head.weight
    saved = head[eng.eos_token_id].clone()
    head[eng.eos_token_id] = head.abs().max(0).values * 5
    try:
        ro = eng.start([cfg.bos_token_id], max_new_tokens=4)
        _drain(eng, ro)
    finally:
        head[eng.eos_token_id] = saved
    assert ro.token_ids[1] != eng.eos_token_id
    assert ro.token_ids[2] == eng.eos_token_id and ro.finish_reason == "eos"


def test_per_slot_sampling_override(engines):
    """A greedy rollout and a sampled one share a batch; the greedy slot
    still matches the full-forward argmax."""
    cfg = engines[0]
    eng = _port_engine(engines, sampling=TSampling(temperature=0.9,
                                                   top_p=0.9))
    p_greedy = [cfg.bos_token_id, 41, 42, 43]
    r_greedy = eng.start(p_greedy, max_new_tokens=8,
                         sampling=TSampling(temperature=0.0), lazy=True)
    r_sampled = eng.start([cfg.bos_token_id, 51, 52], max_new_tokens=8,
                          lazy=True)
    eng.run()
    got = r_greedy.token_ids[len(p_greedy):]
    assert got == _greedy_reference(engines, p_greedy, len(got))
    assert len(r_sampled.token_ids) > 3
    assert np.allclose(eng._samp_host[r_greedy.slot], [0.0, 0.95, 0.0])


def test_prefix_restart_with_image_tokens_in_tail(engines):
    """All-image prompt restored from a prefix covering it: the re-prefilled
    one-token tail is an image token and must get its true position's
    embedding (image_offsets)."""
    cfg = engines[0]
    eng = _port_engine(engines, num_slots=2)
    prompt = [cfg.image_token_id] * cfg.image_seq_len
    embeds = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (1, cfg.image_seq_len, cfg.text.hidden_size)).astype(np.float32)
        * 0.1)
    ro = eng.start(prompt, image_embeds=embeds, max_new_tokens=6)
    want = _drain(eng, ro)
    sp = eng.store_prefix("img-root", ro, length=len(prompt))
    eng.release(ro)
    r2 = eng.start(prompt, image_embeds=embeds, max_new_tokens=6, prefix=sp)
    assert _drain(eng, r2) == want
    eng.release(r2)
    ros = eng.start_many([prompt, prompt], image_embeds=embeds,
                         max_new_tokens=6, prefix=sp)
    for r in ros:
        assert _drain(eng, r) == want
        eng.release(r)


def test_prefix_restart_near_max_len_no_write_clamp(engines):
    cfg = engines[0]
    eng = _port_engine(engines, num_slots=2, max_len=63)
    assert eng.max_len == 64
    prompt = [cfg.bos_token_id] + list(range(1, 58))
    ro = eng.start(prompt, max_new_tokens=4)
    want = _drain(eng, ro)
    sp = eng.store_prefix("deep", ro, length=56)
    eng.release(ro)
    r2 = eng.start(prompt, max_new_tokens=4, prefix=sp)
    assert _drain(eng, r2) == want


def test_best_prefix_refreshes_lru(engines):
    cfg = engines[0]
    eng = _port_engine(engines, num_slots=2, prefix_budget_bytes=1 << 30)
    root = [cfg.bos_token_id] + list(range(1, 33))
    ro = eng.start(root, max_new_tokens=2)
    _drain(eng, ro)
    eng.store_prefix("hot", ro, length=32, namespace="ns")
    eng.release(ro)
    ro = eng.start(root + [40, 41, 42], max_new_tokens=2)
    _drain(eng, ro)
    eng.store_prefix("cold", ro, length=35, namespace="ns")
    eng.release(ro)
    found = eng.best_prefix(root + [99], namespace="ns")
    assert found is not None and found[0] == "hot"
    assert eng._prefix_lru[0] == "cold"


def test_start_many_heterogeneous_prefixes(engines):
    """A burst mixing per-prompt prefixes of different depths and a row
    without one reproduces individual starts, prefilling tails only."""
    cfg = engines[0]
    eng = _port_engine(engines, num_slots=4, prefix_budget_bytes=1 << 30)
    root = [cfg.bos_token_id] + list(range(1, 33))
    r0 = eng.start(root, max_new_tokens=4)
    _drain(eng, r0)
    sp_root = eng.store_prefix("r", r0, length=32)
    eng.release(r0)
    deep = root + [91, 92, 93] + list(range(100, 113))
    r1 = eng.start(deep, max_new_tokens=4, prefix=sp_root)
    _drain(eng, r1)
    sp_deep = eng.store_prefix("d", r1, length=48)
    eng.release(r1)
    prompts = [root + [70], deep + [71, 72], [cfg.bos_token_id, 60, 61]]
    prefixes = [sp_root, sp_deep, None]
    before = eng.counters["prefill_tokens"]
    ros = eng.start_many(prompts, max_new_tokens=6, prefixes=prefixes)
    burst = [_drain(eng, r) for r in ros]
    for r in ros:
        eng.release(r)
    assert eng.counters["prefill_tokens"] - before == 2 + 3 + 3
    for p, pf, got in zip(prompts, prefixes, burst):
        r = eng.start(p, max_new_tokens=6, prefix=pf)
        assert _drain(eng, r) == got
        eng.release(r)
    _check_accounting(eng)


@pytest.mark.parametrize("seed", [0, 7])
def test_page_pool_refcount_fuzz(engines, seed):
    """Random interleavings of fresh, restored and burst starts, stores at
    random depths, releases, drops and aborts keep the host page accounting
    exact, and tearing down returns the whole pool."""
    cfg = engines[0]
    eng = _port_engine(engines, max_len=96, prefix_budget_bytes=1 << 30)
    rng = np.random.default_rng(seed)
    live, keys = [], []
    for i in range(30):
        ops = ["start"]
        if keys:
            ops += ["restore", "drop"]
        finished = [r for r in live if r.finished]
        if finished:
            ops += ["store", "release", "release"]
        unfinished = [r for r in live if not r.finished]
        if unfinished:
            ops += ["abort", "run"]
        if eng.num_free_slots >= 2:
            ops += ["burst"]
        op = ops[rng.integers(len(ops))]
        if op == "start" and eng.num_free_slots:
            n = int(rng.integers(2, 60))
            live.append(eng.start(
                [cfg.bos_token_id] + [int(t) for t in rng.integers(1, 200, n)],
                max_new_tokens=int(rng.integers(1, 8)),
                lazy=bool(rng.integers(2))))
        elif op == "burst":
            b = int(rng.integers(2, eng.num_free_slots + 1))
            prompts, pfx = [], []
            for _ in range(b):
                sp = (eng.get_prefix(keys[rng.integers(len(keys))])
                      if keys and rng.integers(2) else None)
                base = (list(sp.token_ids) if sp is not None
                        else [cfg.bos_token_id])
                prompts.append(base + [int(t) for t in rng.integers(
                    1, 200, int(rng.integers(1, 20)))])
                pfx.append(sp)
            live.extend(eng.start_many(
                prompts, prefixes=pfx,
                max_new_tokens=int(rng.integers(1, 6))))
        elif op == "restore":
            sp = eng.get_prefix(keys[rng.integers(len(keys))])
            if sp is not None and eng.num_free_slots:
                live.append(eng.start(
                    list(sp.token_ids) + [int(t) for t in
                                          rng.integers(1, 200, 2)],
                    max_new_tokens=2, prefix=sp))
        elif op == "store" and finished:
            ro = finished[rng.integers(len(finished))]
            key = f"k{seed}-{i}"
            if eng.store_prefix(key, ro, length=int(
                    rng.integers(1, ro.length + 1))) is not None:
                keys.append(key)
        elif op == "release" and finished:
            ro = finished[rng.integers(len(finished))]
            eng.release(ro)
            live.remove(ro)
        elif op == "drop" and keys:
            eng.drop_prefix(keys.pop(rng.integers(len(keys))))
        elif op == "abort" and unfinished:
            eng.abort(unfinished[rng.integers(len(unfinished))])
            eng.run()
        elif op == "run":
            eng.run()
        _check_accounting(eng)
    eng.run()
    for ro in live:
        eng.release(ro)
    for key in keys:
        eng.drop_prefix(key)
    _check_accounting(eng)
    assert eng.num_free_pages == eng._page_refs.shape[0] - 1
