"""The port's ``parallel.ReplicaPool`` against the JAX package's, on the
CPU: one model replica and decode engine per device, one worker thread per
replica. Mirrors ``tests/test_replicas.py``'s 4 tests on
``devices=["cpu", "cpu"]`` (PyTorch has one CPU device, so the placement
test checks each replica's engine and page pool on its listed device, the
weights shared and the pools not), holds the pool's greedy streams token
for token against JAX's ``ReplicaPool`` over two CPU devices, and pins
``run``'s semantics and the kernels' launch counter under threads.
"""
import sys
import threading

import jax
import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw

from detikzify_tpu.config import tiny_test_config
from detikzify_tpu.models import detikzify as jdet
from detikzify_tpu.parallel.replicas import ReplicaPool as JPool
from detikzify_tpu.processing import ByteTokenizer as JTok
from detikzify_tpu.processing import DetikzifyProcessor as JProc
from detikzify_torch.config import tiny_test_config as t_tiny_test_config
from detikzify_torch.infer import DetikzifyPipeline, FakeBackend, set_backend
from detikzify_torch.models import convert
from detikzify_torch.ops.cuda import CudaKernel
from detikzify_torch.ops.quant import fuse_projections, quantize_params
from detikzify_torch.parallel import ReplicaPool, device_put
from detikzify_torch.processing import ByteTokenizer, DetikzifyProcessor

torch.set_num_threads(1)


def _ids_tokenizer(base):
    """The byte tokenizer decoding every id, so a program's text is its
    token ids: equal codes are equal token streams."""

    class IdTokenizer(base):
        def decode(self, token_ids, skip_special_tokens=False):
            return " ".join(str(int(t)) for t in token_ids
                            if not (skip_special_tokens
                                    and t in self.all_special_ids))

    return IdTokenizer


def _processor(tok_cls, proc_cls, cfg):
    tok = _ids_tokenizer(tok_cls)(
        vocab_size=512, image_token_id=cfg.image_token_id,
        bos_token_id=cfg.bos_token_id, eos_token_id=cfg.eos_token_id,
        model_max_length=96)
    return proc_cls(tok, cfg)


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_test_config(vocab_size=512)
    jparams = jdet.init(jax.random.PRNGKey(0), cfg)
    tcfg = t_tiny_test_config(vocab_size=512)
    tparams = convert.params_from_numpy(
        jax.tree.map(np.asarray, jparams._asdict()), tcfg, device="cpu")
    return (tcfg, tparams, _processor(ByteTokenizer, DetikzifyProcessor,
                                      tcfg),
            cfg, jparams, _processor(JTok, JProc, cfg))


def _figures(n):
    figs = []
    for i in range(n):
        img = Image.new("RGB", (64, 64), "white")
        ImageDraw.Draw(img).rectangle([4 + 2 * i, 4, 60, 60 - 3 * i],
                                      outline="black", width=2)
        figs.append(img)
    return figs


def test_replicas_live_on_their_devices(setup):
    """Two replicas on the one CPU device: each engine and page pool on
    its listed device, the weight tensors shared, the pools not."""
    cfg, params, processor = setup[:3]
    pool = ReplicaPool(params, cfg, processor, devices=["cpu", "cpu"],
                       metric="fast", num_slots=2, max_len=96)
    try:
        assert len(pool) == 2
        assert pool.devices == [torch.device("cpu")] * 2
        for pipe in pool.pipelines:
            eng = pipe.engine
            assert eng.device == torch.device("cpu")
            assert eng.cache.k.device == torch.device("cpu")
            assert eng.params is params
        a, b = (p.engine for p in pool.pipelines)
        assert a.cache.k.data_ptr() != b.cache.k.data_ptr()
        assert a.generator is not b.generator
        # sampling decorrelated across replicas: engine i seeded with i
        assert not torch.equal(a.generator.get_state(),
                               b.generator.get_state())
    finally:
        pool.close()


@pytest.mark.parametrize("weights", ["fp32", "int8+fused"])
def test_device_put_same_device_or_a_copy(setup, weights):
    """``device_put`` gives back the module itself on its own device (as
    ``jax.device_put``); elsewhere a copy whose tensors moved, the original
    untouched (``meta`` stands in for a second card)."""
    cfg, params = setup[:2]
    if weights != "fp32":
        params = fuse_projections(quantize_params(convert.init_random(
            cfg, device="cpu", dtype=torch.float32)))
    assert device_put(params, "cpu") is params
    assert device_put(params, torch.device("cpu")) is params
    moved = device_put(params, "meta")
    assert moved is not params
    assert all(t.is_meta for t in moved.parameters())
    assert all(t.is_meta for t in moved.buffers())
    assert not any(t.is_meta for t in params.parameters())
    assert [n for n, _ in moved.named_parameters()] == \
        [n for n, _ in params.named_parameters()]
    assert [(n, b.dtype) for n, b in moved.named_buffers()] == \
        [(n, b.dtype) for n, b in params.named_buffers()]


def test_no_card_and_no_devices_raises(setup):
    """``devices=None`` is every CUDA device; without one the pool refuses
    rather than fall back to the CPU."""
    cfg, params, processor = setup[:3]
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ReplicaPool(params, cfg, processor, metric="fast", num_slots=2,
                    max_len=96)


def test_pool_greedy_matches_single_pipeline(setup):
    """A replica behaves exactly like a standalone pipeline: greedy one-shot
    samples agree token for token whichever replica served them."""
    cfg, params, processor = setup[:3]
    img = _figures(1)[0]
    single = DetikzifyPipeline(params, cfg, processor, metric="fast",
                               temperature=0.0, num_slots=2, max_len=96,
                               device="cpu")
    want = single.sample(image=img).code
    single.close()
    pool = ReplicaPool(params, cfg, processor, devices=["cpu", "cpu"],
                       metric="fast", temperature=0.0, num_slots=2,
                       max_len=96)
    try:
        docs = pool.map_sample([img, img])
    finally:
        pool.close()
    assert [d.code for d in docs] == [want, want]
    assert len(want.split()) > 1


def test_pool_greedy_matches_jax_pool(setup):
    """The port's pool and JAX's, each over two devices from the same
    weights, give the same greedy token streams on three figures."""
    cfg, params, processor, jcfg, jparams, jprocessor = setup
    figs = _figures(3)
    kw = dict(metric="fast", temperature=0.0, num_slots=2, max_len=96)
    jpool = JPool(jparams, jcfg, jprocessor, devices=jax.devices()[:2], **kw)
    want = [d.code for d in jpool.map_sample(figs)]
    pool = ReplicaPool(params, cfg, processor, devices=["cpu", "cpu"], **kw)
    try:
        got = [d.code for d in pool.map_sample(figs)]
    finally:
        pool.close()
    assert got == want
    assert all(len(c.split()) > 1 for c in got)


def test_map_until_compilable_across_replicas(setup):
    """The eval per-item protocol stripes across replica threads; every
    item completes and slots are drained on every replica."""
    cfg, params, processor = setup[:3]
    set_backend(FakeBackend())
    try:
        pool = ReplicaPool(params, cfg, processor, devices=["cpu", "cpu"],
                           metric="fast", num_slots=2, max_len=96)
        results = pool.map_until_compilable(
            _figures(5), max_expansions=3, parallelism=2)
        assert len(results) == 5
        for r in results:
            assert not isinstance(r, Exception), r
            assert r.num_programs >= 1
        for pipe in pool.pipelines:
            assert not pipe.engine._rollouts
        pool.close()
    finally:
        set_backend(None)


def test_pool_speculative_greedy_parity(setup):
    """Replica engines with speculation (K4's plain version on the CPU)
    emit the same greedy streams as a plain standalone pipeline and as
    JAX's speculative pool (per-replica hint/history state isolated)."""
    cfg, params, processor, jcfg, jparams, jprocessor = setup
    img = _figures(1)[0]
    single = DetikzifyPipeline(params, cfg, processor, metric="fast",
                               temperature=0.0, num_slots=2, max_len=96,
                               device="cpu")
    want = single.sample(image=img).code
    single.close()
    kw = dict(metric="fast", temperature=0.0, num_slots=2, max_len=96,
              speculate=3)
    pool = ReplicaPool(params, cfg, processor, devices=["cpu", "cpu"], **kw)
    try:
        docs = pool.map_sample([img, img])
        steps = sum(p.engine.counters["spec_steps"] for p in pool.pipelines)
    finally:
        pool.close()
    assert [d.code for d in docs] == [want, want]
    assert steps > 0
    jpool = JPool(jparams, jcfg, jprocessor, devices=jax.devices()[:2], **kw)
    assert [d.code for d in jpool.map_sample([img, img])] == [want, want]


class _Replica:
    """A stand-in pipeline for ``ReplicaPool.run``: only its device."""

    class engine:
        device = torch.device("cpu")


def _bare_pool(n):
    pool = ReplicaPool.__new__(ReplicaPool)
    pool.pipelines = [_Replica() for _ in range(n)]
    return pool


def test_run_isolates_items_and_records_base_exceptions():
    """``run``: an item whose function raises gets the exception object as
    its result; a ``BaseException`` is recorded for its item, then stops
    its worker while the other worker finishes the queue; each worker runs
    in inference mode; no more workers than items."""
    pool = _bare_pool(2)
    seen, modes, stop = set(), [], threading.Event()

    def fn(pipe, item):
        seen.add(threading.current_thread().name)
        modes.append(torch.is_inference_mode_enabled())
        if item == "bad":
            raise ValueError(item)
        if item == "stop":
            stop.set()
            raise KeyboardInterrupt
        stop.wait(5)          # the stopping item is taken first
        return item * 2

    hook, caught = threading.excepthook, []
    threading.excepthook = lambda args: caught.append(args.exc_type)
    try:
        out = pool.run(fn, ["stop", 1, "bad", 3, 4])
    finally:
        threading.excepthook = hook
    assert isinstance(out[0], KeyboardInterrupt)
    assert caught == [KeyboardInterrupt]
    assert isinstance(out[2], ValueError)
    assert [out[1], out[3], out[4]] == [2, 6, 8]
    assert all(modes)
    assert len(seen) == 2

    seen.clear()
    assert pool.run(fn, [5]) == [10]
    assert len(seen) == 1            # min(len(items), R) workers


def test_launch_counter_exact_under_threads():
    """``CudaKernel.launch`` counts each successful launch exactly once
    when 8 threads launch one kernel 10 000 times each (the count is bumped
    under the handle's lock, as ``ReplicaPool``'s workers and the server's
    scheduler launch from their own threads)."""
    k = CudaKernel("stub", "flash_attn.cu", "stub", [])
    k._fn = lambda *args: 0          # the C entry point: cudaSuccess

    def launcher():
        for _ in range(10_000):
            k.launch()

    threads = [threading.Thread(target=launcher) for _ in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)       # interleave the threads
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        sys.setswitchinterval(interval)
    assert k.launches == 80_000

    k._fn = lambda *args: 7          # a refused launch is not counted
    k._err = lambda rc: b"stub error"
    with pytest.raises(RuntimeError, match="CUDA error 7"):
        k.launch()
    assert k.launches == 80_000
