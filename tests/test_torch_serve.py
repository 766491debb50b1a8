"""The port's HTTP serving front end (``detikzify_torch.serve``) on the CPU.

Mirrors every test of ``tests/test_serve.py`` on the port's server: a real
``ThreadingHTTPServer`` on an ephemeral port around a ``tiny-test``
pipeline (vocab 512, 96 positions, 4 slots, ``metric="fast"``, the
hermetic FakeBackend) whose weights are carried from the JAX init through
``convert.params_from_numpy``, driven by concurrent urllib clients. Then
parity with the JAX package, each server of its own: three concurrent
greedy sampling requests give, figure by figure, the code of the JAX
pipeline's ``sample(temperature=0.0)``; a greedy MCTS request gives the
JAX server's candidates, scores (1e-5) and best; ``_parse_job`` gives the
same fields, or the same exception, on a table of payloads; ``/healthz``
and ``/metrics`` carry the same keys.
"""
import base64
import concurrent.futures as cf
import io
import json
import random
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw

from detikzify_tpu import serve as jserve
from detikzify_tpu.config import tiny_test_config
from detikzify_tpu.infer import DetikzifyPipeline as JPipeline
from detikzify_tpu.infer import FakeBackend as JFake
from detikzify_tpu.infer import set_backend as j_set_backend
from detikzify_tpu.models import detikzify as jdet
from detikzify_tpu.processing import ByteTokenizer as JTok
from detikzify_tpu.processing import DetikzifyProcessor as JProc
from detikzify_torch import serve as tserve
from detikzify_torch.config import tiny_test_config as t_tiny_test_config
from detikzify_torch.infer import DetikzifyPipeline, FakeBackend, set_backend
from detikzify_torch.models import convert
from detikzify_torch.processing import ByteTokenizer, DetikzifyProcessor
from detikzify_torch.serve import _parse_job

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def fake_compiler():
    set_backend(FakeBackend())
    j_set_backend(JFake())
    yield
    set_backend(None)
    j_set_backend(None)


def _figure(seed=0):
    img = Image.new("RGB", (100, 80), "white")
    ImageDraw.Draw(img).rectangle([8 + seed, 8, 92, 72], outline="black",
                                  width=2)
    return img


def _b64(img) -> str:
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _cfgs(max_len=96):
    return (tiny_test_config(vocab_size=512).replace(
                model_max_length=max_len),
            t_tiny_test_config(vocab_size=512).replace(
                model_max_length=max_len))


def _tok(cls, cfg, max_len=96):
    return cls(vocab_size=512, image_token_id=cfg.image_token_id,
               bos_token_id=cfg.bos_token_id, eos_token_id=cfg.eos_token_id,
               model_max_length=max_len)


def _weights(seed, max_len=96):
    """(JAX cfg, JAX params, port cfg, the same weights in the port)."""
    cfg, tcfg = _cfgs(max_len)
    jp = jdet.init(jax.random.PRNGKey(seed), cfg)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp._asdict()),
                                   tcfg, device="cpu")
    return cfg, jp, tcfg, tp


def _port_pipeline(tp, tcfg, max_len=96, **kw):
    return DetikzifyPipeline(tp, tcfg,
                             DetikzifyProcessor(_tok(ByteTokenizer, tcfg,
                                                     max_len), tcfg),
                             num_slots=4, max_len=max_len, metric="fast",
                             device="cpu", **kw)


def _start(pipe, module=tserve, **kw):
    httpd, inference = module.make_server(pipe, port=0, **kw)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return f"http://127.0.0.1:{httpd.server_address[1]}", httpd, inference


def _stop(httpd, inference):
    httpd.shutdown()
    inference.stop()
    httpd.server_close()
    assert not inference._thread.is_alive()


@pytest.fixture(scope="module")
def server():
    _, _, tcfg, tp = _weights(0)
    pipe = _port_pipeline(tp, tcfg)
    base, httpd, inference = _start(pipe, batch_window_s=1.0)
    # a first request before the batching tests, as the JAX suite warms
    pipe.sample(image=_figure(), temperature=0.0)
    yield base, inference
    _stop(httpd, inference)
    pipe.close()


def _post(base, payload, timeout=300):
    req = urllib.request.Request(
        base + "/v1/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


# ---------------------------------------------------------------------------
# mirrors of tests/test_serve.py
# ---------------------------------------------------------------------------

def test_healthz_and_404(server):
    base, _ = server
    status, body = _get(base, "/healthz")
    assert status == 200 and body["status"] == "ok"
    assert body["num_slots"] == 4
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(base, "/nope")
    assert e.value.code == 404


def test_concurrent_sampling_requests_batch_into_one_wave(server):
    base, inference = server
    before = dict(inference.requests)
    payload = {"image": _b64(_figure()), "algorithm": "sampling",
               "temperature": 0.0, "max_new_tokens": 12}
    results = [None] * 3

    def call(i):
        results[i] = _post(base, dict(payload, image=_b64(_figure(i))))

    threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    for status, body in results:
        assert status == 200
        assert isinstance(body["code"], str)
        assert isinstance(body["compiled"], bool)
        assert isinstance(body["errors"], dict)
    assert inference.requests["sample"] - before["sample"] == 3
    # identical sampling params queued within the window: one fused wave
    assert inference.requests["batched"] - before["batched"] >= 2


def test_mcts_endpoint_returns_scored_candidates(server):
    base, _ = server
    status, body = _post(base, {
        "image": _b64(_figure()), "algorithm": "mcts", "expansions": 2,
        "temperature": 0.7})
    assert status == 200
    assert body["candidates"]
    for cand in body["candidates"]:
        assert set(cand) >= {"code", "compiled", "errors", "score"}
    if body["compiled"]:
        assert body["score"] == max(c["score"] for c in body["candidates"]
                                    if c["compiled"])


def test_text_conditioned_requests_run_singleton(server):
    # the tiny model has no adapter: a caption must error cleanly
    base, _ = server
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base, {"image": _b64(_figure()), "text": "a caption"})
    assert e.value.code == 500
    # the scheduler survives: the next plain request still works
    status, _ = _post(base, {"image": _b64(_figure()),
                             "temperature": 0.0, "max_new_tokens": 8})
    assert status == 200


def test_bad_requests_get_400(server):
    base, _ = server
    for payload in ({}, {"image": "!!not-base64!!"},
                    {"image": _b64(_figure()), "algorithm": "alien"}):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base, payload)
        assert e.value.code == 400


def test_metrics_shape(server):
    base, _ = server
    status, body = _get(base, "/metrics")
    assert status == 200
    assert body["num_slots"] == 4
    assert body["engine"]["decode_dispatches"] > 0
    assert body["requests"]["sample"] >= 1
    assert "prefix_pages_used" in body and "queue_depth" in body


def test_parse_job_validation():
    with pytest.raises(ValueError, match="image"):
        _parse_job({})
    with pytest.raises(ValueError, match="JSON object"):
        _parse_job([1, 2])
    job = _parse_job({"image": _b64(_figure()), "algorithm": "mcts",
                      "expansions": "3", "top_k": 5.0, "timeout": 1.5})
    assert job.kind == "mcts" and job.expansions == 3
    assert job.sampling["top_k"] == 5 and job.timeout == 1.5
    assert job.batch_key() is None            # mcts never fuses
    sample = _parse_job({"image": _b64(_figure()), "temperature": 0.1})
    assert sample.batch_key() is not None


def test_parse_job_coerces_numeric_knobs_at_parse_time():
    job = _parse_job({"image": _b64(_figure()), "temperature": "0.5",
                      "top_p": "0.9", "max_new_tokens": "7"})
    assert job.sampling == {"temperature": 0.5, "top_p": 0.9,
                            "max_new_tokens": 7}
    for bad in ({"temperature": "hot"}, {"timeout": "soon"},
                {"max_new_tokens": "many"}):
        with pytest.raises(ValueError):
            _parse_job({"image": _b64(_figure()), **bad})


def test_parse_job_rejects_unbounded_mcts():
    with pytest.raises(ValueError, match="expansions"):
        _parse_job({"image": _b64(_figure()), "algorithm": "mcts",
                    "timeout": 0})
    job = _parse_job({"image": _b64(_figure()), "algorithm": "mcts",
                      "timeout": 0, "expansions": 2})
    assert job.timeout == 0


def test_parse_job_blocks_external_image_refs(tmp_path):
    img = _figure()
    path = tmp_path / "fig.png"
    img.save(path)
    for ref in ("http://169.254.169.254/latest/meta-data", str(path)):
        with pytest.raises(ValueError, match="external"):
            _parse_job({"image": ref})
    for inline in (_b64(img), "data:image/png;base64," + _b64(img)):
        assert _parse_job({"image": inline}).image.size == img.size
    job = _parse_job({"image": str(path)}, allow_external_images=True)
    assert job.image.size == img.size


def test_mcts_result_json_serializable_when_nothing_compiles():
    # all candidates failed: the result is a COPY of the last candidate,
    # not an alias (which would make the JSON circular)
    from types import SimpleNamespace

    from detikzify_torch.serve import InferenceServer, _Job

    class Doc:
        code, is_rasterizable, errors = "x", False, {0: "boom"}

    class Pipe:
        engine = SimpleNamespace(num_slots=4)

        def simulate(self, **kw):
            yield (-1.0, Doc())
            yield (-1.0, Doc())

    srv = InferenceServer.__new__(InferenceServer)   # no scheduler thread
    srv.pipeline = Pipe()
    srv.default_mcts_timeout = 1.0
    srv.mcts_parallelism = None
    srv.sample_reserve = 0
    srv._mcts_tasks = []
    srv._lat = {"sample": [], "mcts": []}
    srv.requests = {"sample": 0, "mcts": 0, "failed": 0, "batched": 0}
    job = _Job(kind="mcts", image=SimpleNamespace(), expansions=2)
    srv._run_mcts(job)
    body = json.dumps(job.result)                     # must not raise
    assert json.loads(body)["compiled"] is False
    assert len(job.result["candidates"]) == 2


def test_take_wave_sweeps_pending_jobs():
    import queue as queue_mod
    from types import SimpleNamespace

    from detikzify_torch.serve import InferenceServer, _Job

    srv = InferenceServer.__new__(InferenceServer)
    srv.pipeline = SimpleNamespace(engine=SimpleNamespace(num_slots=4))
    srv.batch_window_s = 0.0
    srv._queue = queue_mod.Queue()
    srv._stopping = False
    mk = lambda i, t: _Job(kind="sample", image=i,  # noqa: E731
                           sampling={"temperature": t})
    b, c, d = mk(1, 0.5), mk(2, 0.5), mk(3, 0.9)
    srv._pending = [b, d, c]
    wave = srv._take_wave(window=True)
    assert wave == [b, c], "same-key pending job must fuse into the wave"
    assert srv._pending == [d]


def test_singleton_max_new_tokens_is_honored(server):
    # ByteTokenizer: 1 token == at most 1 byte of code
    base, _ = server
    status, body = _post(base, {"image": _b64(_figure()),
                                "temperature": 0.0, "max_new_tokens": 4})
    assert status == 200
    assert len(body["code"]) <= 4


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_scheduler_exit_fails_pending_jobs_and_rejects_new_ones():
    from types import SimpleNamespace

    from detikzify_torch.serve import InferenceServer, OverloadedError, _Job

    class Pipe:
        engine = SimpleNamespace(num_slots=4)

        def sample(self, **kw):
            raise SystemExit("fatal runtime error")

    srv = InferenceServer(Pipe(), batch_window_s=0.01)
    jobs = [_Job(kind="sample", image=i, sampling={"temperature": 0.1 * i})
            for i in range(1, 4)]
    for j in jobs:
        srv.submit(j)
    for j in jobs:
        assert j.done.wait(timeout=10), "job parked forever"
        assert j.error is not None
    srv._thread.join(timeout=10)
    assert not srv._thread.is_alive()
    with pytest.raises(OverloadedError):
        srv.submit(_Job(kind="sample", image=9))
    srv.stop()                                        # must not block


def _sse_events(base, payload):
    """POST /v1/stream and parse the SSE response into (kind, data)."""
    import http.client
    from urllib.parse import urlparse

    u = urlparse(base)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=300)
    conn.request("POST", "/v1/stream", body=json.dumps(payload).encode(),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200
    assert resp.getheader("Content-Type") == "text/event-stream"
    events, kind = [], None
    for raw in resp:
        line = raw.decode().rstrip("\n")
        if line.startswith("event: "):
            kind = line[len("event: "):]
        elif line.startswith("data: "):
            events.append((kind, json.loads(line[len("data: "):])))
    conn.close()
    return events


def test_stream_sampling_emits_tokens_then_result(server):
    base, _ = server
    events = _sse_events(base, {"image": _b64(_figure()),
                                "temperature": 0.0, "max_new_tokens": 8})
    kinds = [k for k, _ in events]
    assert kinds[-1] == "result" and "error" not in kinds
    tokens = [d["text"] for k, d in events if k == "token"]
    result = events[-1][1]
    assert tokens, "no token events streamed"
    # greedy: the streamed deltas reassemble the final program exactly
    assert "".join(tokens) == result["code"]
    assert len(result["code"]) <= 8


def test_stream_mcts_emits_candidates(server):
    base, _ = server
    events = _sse_events(base, {"image": _b64(_figure()),
                                "algorithm": "mcts", "expansions": 2,
                                "timeout": 0, "temperature": 0.0})
    kinds = [k for k, _ in events]
    assert kinds.count("candidate") == 2
    assert kinds[-1] == "result"
    result = events[-1][1]
    assert len(result["candidates"]) == 2
    streamed = [d for k, d in events if k == "candidate"]
    assert streamed == result["candidates"]


def test_parse_job_stream_wiring():
    from detikzify_torch.utils.generation import ExplicitAbort

    plain = _parse_job({"image": _b64(_figure())})
    assert plain.stream is None and plain.control is None
    job = _parse_job({"image": _b64(_figure())}, stream=True)
    assert job.stream is not None
    assert isinstance(job.control, ExplicitAbort)
    assert job.batch_key() is None, "streamed jobs must never fuse"
    job.finish(result={"code": ""})
    assert job.stream.get_nowait() is None


def test_stream_job_failure_wakes_the_drain():
    import queue as queue_mod
    from types import SimpleNamespace

    from detikzify_torch.serve import InferenceServer, _Job

    class Pipe:
        engine = SimpleNamespace(num_slots=4)
        processor = SimpleNamespace(decode=lambda *a, **kw: "")

        def sample(self, **kw):
            raise ValueError("boom")

    srv = InferenceServer(Pipe(), batch_window_s=0.0)
    job = _Job(kind="sample", image=object(), stream=queue_mod.Queue())
    srv.submit(job)
    assert job.done.wait(timeout=10)
    assert isinstance(job.error, ValueError)
    while True:
        if job.stream.get(timeout=5) is None:
            break
    srv.stop()


def test_parse_job_rejects_zero_expansions_and_bad_ranges():
    with pytest.raises(ValueError, match="expansions"):
        _parse_job({"image": _b64(_figure()), "algorithm": "mcts",
                    "timeout": 0, "expansions": 0})
    for bad, msg in (({"max_new_tokens": 0}, "max_new_tokens"),
                     ({"temperature": -0.1}, "temperature"),
                     ({"top_p": 1.5}, "top_p"),
                     ({"top_k": -1}, "top_k"),
                     ({"expansions": -2}, "expansions")):
        with pytest.raises(ValueError, match=msg):
            _parse_job({"image": _b64(_figure()), **bad})


def test_parse_job_accepts_wrapped_base64():
    img = _figure()
    raw = _b64(img)
    wrapped = "\n".join(raw[i:i + 76] for i in range(0, len(raw), 76)) + "\n"
    assert _parse_job({"image": wrapped}).image.size == img.size


def test_job_finish_is_first_wins():
    from detikzify_torch.serve import _Job

    job = _Job(kind="sample", image=object())
    assert job.finish(result={"code": "x"}) is True
    assert job.finish(error=RuntimeError("late")) is False
    assert job.result == {"code": "x"} and job.error is None


def test_abort_is_sticky_across_rollouts(server):
    from detikzify_torch.utils.generation import ExplicitAbort

    _, inference = server
    pipe = inference.pipeline
    control = ExplicitAbort()
    control.abort()
    docs = list(pipe.simulate(image=_figure(), expansions=5,
                              control=control))
    assert docs == [], "pre-aborted search must produce no rollouts"
    assert pipe.engine.num_free_slots == pipe.engine.num_slots


def test_oversized_body_and_decompression_bomb_rejected(server):
    import http.client
    from urllib.parse import urlparse

    base, inference = server
    u = urlparse(base)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=60)
    conn.putrequest("POST", "/v1/generate")
    conn.putheader("Content-Length", str(inference.max_body_bytes + 1))
    conn.endheaders()
    resp = conn.getresponse()
    assert resp.status == 413
    conn.close()
    bomb = Image.new("1", (9000, 9000), 1)
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base, {"image": _b64(bomb)})
    assert e.value.code == 400 and "too large" in str(e.value.read())


def test_mcts_runs_with_slot_parallelism():
    from types import SimpleNamespace

    from detikzify_torch.serve import InferenceServer, _Job

    seen = {}

    class Doc:
        code, is_rasterizable, errors = "x", True, {}

    class Pipe:
        engine = SimpleNamespace(num_slots=8)
        processor = SimpleNamespace(decode=lambda *a, **kw: "")

        def simulate(self, **kw):
            seen.update(kw)
            yield (0.5, Doc())

    srv = InferenceServer.__new__(InferenceServer)   # no scheduler thread
    srv.pipeline = Pipe()
    srv.default_mcts_timeout = 1.0
    srv.mcts_parallelism = None
    srv.sample_reserve = 2
    srv._mcts_tasks = []
    srv._lat = {"sample": [], "mcts": []}
    srv.requests = {"sample": 0, "mcts": 0, "failed": 0, "batched": 0}
    srv._run_mcts(_Job(kind="mcts", image=object(), expansions=1))
    assert seen["parallelism"] == 6, \
        "server MCTS must use every non-reserved slot"
    srv.mcts_parallelism = 2
    srv._run_mcts(_Job(kind="mcts", image=object(), expansions=1))
    assert seen["parallelism"] == 2


def test_sampling_not_blocked_behind_mcts(server):
    """A sampling request queued behind a long MCTS search is served WHILE
    the search runs, and /metrics exports per-kind latency percentiles."""
    import time as time_mod

    base, inference = server
    done = {}

    def mcts():
        done["resp"] = _post(base, {
            "image": _b64(_figure()), "algorithm": "mcts",
            "timeout": 10, "temperature": 0.7}, timeout=600)
        done["t_end"] = time_mod.monotonic()

    t = threading.Thread(target=mcts)
    t.start()
    deadline = time_mod.monotonic() + 60
    while time_mod.monotonic() < deadline:          # search actually running
        if _get(base, "/metrics")[1]["active_mcts"] > 0:
            break
        time_mod.sleep(0.02)
    else:
        raise AssertionError("MCTS search never became active")
    status, body = _post(base, {"image": _b64(_figure(3)),
                                "temperature": 0.0, "max_new_tokens": 8})
    t_sample = time_mod.monotonic()
    assert status == 200 and isinstance(body["code"], str)
    t.join(timeout=600)
    assert done["resp"][0] == 200
    assert t_sample < done["t_end"], \
        "sampling was head-of-line blocked behind the MCTS budget"
    lat = _get(base, "/metrics")[1]["latency_s"]
    assert lat["sample"]["count"] >= 1 and lat["sample"]["p50"] is not None
    assert lat["sample"]["p95"] is not None
    assert "mcts" in lat


def _sse_candidate_times(base, payload, out):
    """POST /v1/stream, recording when each candidate event arrived."""
    import http.client
    import time as time_mod
    from urllib.parse import urlparse

    u = urlparse(base)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=600)
    conn.request("POST", "/v1/stream", body=json.dumps(payload).encode(),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200
    for raw in resp:
        line = raw.decode().rstrip("\n")
        if line == "event: candidate":
            out.append(time_mod.monotonic())
    conn.close()


def test_concurrent_mcts_searches_interleave(server):
    """Two concurrent MCTS requests make interleaved progress: each emits a
    candidate before the other finishes."""
    base, _ = server
    times_a, times_b = [], []
    payload = {"image": _b64(_figure()), "algorithm": "mcts",
               "expansions": 6, "timeout": 120, "temperature": 0.7}
    ta = threading.Thread(target=_sse_candidate_times,
                          args=(base, payload, times_a))
    tb = threading.Thread(
        target=_sse_candidate_times,
        args=(base, dict(payload, image=_b64(_figure(2))), times_b))
    ta.start()
    tb.start()
    ta.join(timeout=600)
    tb.join(timeout=600)
    assert len(times_a) == 6 and len(times_b) == 6
    assert min(times_b) < max(times_a), "search B serialized behind A"
    assert min(times_a) < max(times_b), "search A serialized behind B"


def test_oversubscribed_mcts_searches_all_complete(server):
    """FOUR concurrent MCTS requests on a 4-slot engine (MCTS budget 3,
    share 1 each) all complete: shared_engine=True and STALLED keep the
    single scheduler thread from wedging."""
    base, inference = server
    results = [None] * 4

    def call(i):
        results[i] = _post(base, {
            "image": _b64(_figure(i)), "algorithm": "mcts",
            "expansions": 2, "timeout": 180, "temperature": 0.7})

    threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    for i, r in enumerate(results):
        assert r is not None, f"search {i} never returned"
        status, body = r
        assert status == 200
        assert len(body["candidates"]) == 2


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_stop_drains_inflight_compiles():
    """A sampling job whose decode finished but whose LaTeX compile is in
    flight at stop() is delivered, not failed (graceful drain)."""
    import time as time_mod
    from types import SimpleNamespace

    from detikzify_torch.serve import InferenceServer, _Job

    class Doc:
        code = "\\tikz{}"
        is_rasterizable = True
        errors = {}

    fut = cf.Future()

    class Compiler:
        def submit_doc(self, doc):
            return fut

    class Pipe:
        engine = SimpleNamespace(num_slots=4, num_free_slots=4)
        compiler = Compiler()

        def sample(self, **kw):
            return Doc()

    srv = InferenceServer(Pipe(), batch_window_s=0.01)
    job = _Job(kind="sample", image=_figure(), sampling={})
    srv.submit(job)
    deadline = time_mod.monotonic() + 10
    while not srv._compiling and time_mod.monotonic() < deadline:
        time_mod.sleep(0.01)
    assert srv._compiling, "job never reached the compile stage"
    threading.Timer(0.3, fut.set_result, args=(Doc(),)).start()
    srv.stop()
    assert job.done.wait(timeout=10)
    assert job.error is None, f"graceful stop failed the job: {job.error}"
    assert job.result["compiled"] is True


def test_submit_backpressure_counts_drained_jobs():
    from types import SimpleNamespace

    from detikzify_torch.serve import InferenceServer, OverloadedError, _Job

    class Pipe:
        engine = SimpleNamespace(num_slots=4)

    srv = InferenceServer(Pipe(), max_pending=2, batch_window_s=0.0)
    try:
        srv._pending = [_Job(kind="sample", image=object()),
                        _Job(kind="sample", image=object())]
        with pytest.raises(OverloadedError):
            srv.submit(_Job(kind="sample", image=object()))
        srv._pending = []
    finally:
        srv.stop()


def test_mcts_admission_cap_queues_excess_searches():
    from types import SimpleNamespace

    from detikzify_torch.serve import InferenceServer, _Job

    class Doc:
        code, is_rasterizable, errors = "x", False, {}

    class Pipe:
        engine = SimpleNamespace(num_slots=4)

        def simulate(self, **kw):
            yield (-1.0, Doc())

    srv = InferenceServer.__new__(InferenceServer)   # no scheduler thread
    srv.pipeline = Pipe()
    srv.default_mcts_timeout = 1.0
    srv.mcts_parallelism = None
    srv.sample_reserve = 0
    srv.max_active_mcts = 1
    srv._mcts_tasks = []
    srv._mcts_waiting = []
    srv._pending = []
    srv._lat = {"sample": [], "mcts": []}
    srv.requests = {"sample": 0, "mcts": 0, "failed": 0, "batched": 0}
    j1 = _Job(kind="mcts", image=SimpleNamespace(), expansions=1)
    j2 = _Job(kind="mcts", image=SimpleNamespace(), expansions=1)
    srv._admit(j1)
    srv._admit(j2)
    assert len(srv._mcts_tasks) == 1
    assert srv._mcts_waiting == [j2]
    srv._mcts_tasks.clear()
    srv._admit_waiting_mcts()
    assert len(srv._mcts_tasks) == 1 and not srv._mcts_waiting
    assert srv._mcts_tasks[0].job is j2


def test_graceful_stop_completes_inflight_mcts_with_best_so_far():
    from types import SimpleNamespace

    from detikzify_torch.serve import InferenceServer, _Job

    class Doc:
        code, is_rasterizable, errors = "\\tikz{}", True, {}

    resume = threading.Event()

    class Pipe:
        engine = SimpleNamespace(num_slots=4, num_free_slots=4)

        def simulate(self, **kw):
            yield (0.5, Doc())
            while True:               # unbounded search: never finishes
                resume.wait()
                yield (0.25, Doc())

    srv = InferenceServer(Pipe(), batch_window_s=0.01)
    job = _Job(kind="mcts", image=_figure(), expansions=None)
    srv.submit(job)
    import time as time_mod
    deadline = time_mod.monotonic() + 10
    while time_mod.monotonic() < deadline:
        tasks = srv._mcts_tasks
        if tasks and tasks[0].candidates:
            break
        time_mod.sleep(0.01)
    assert srv._mcts_tasks and srv._mcts_tasks[0].candidates
    resume.set()
    srv.stop()
    assert job.done.wait(timeout=10)
    assert job.error is None, f"graceful stop failed the search: {job.error}"
    assert job.result["candidates"], "best-so-far candidates were dropped"
    assert job.result["score"] == 0.5


def test_run_mcts_stall_bailout_instead_of_busy_spin():
    from types import SimpleNamespace

    from detikzify_torch.infer import generator as generator_mod
    from detikzify_torch.serve import InferenceServer, _Job

    class Doc:
        code, is_rasterizable, errors = "\\tikz{}", True, {}

    class StalledPipe:
        engine = SimpleNamespace(num_slots=4, num_free_slots=0)

        def simulate(self, **kw):
            while True:
                yield generator_mod.STALLED

    srv = InferenceServer(StalledPipe(), batch_window_s=0.01)
    try:
        job = _Job(kind="mcts", image=_figure(), expansions=None)
        srv._run_mcts(job, stall_limit_s=0.2)
        assert job.done.is_set()
        assert job.error is not None
        assert "slots unavailable" in str(job.error)
    finally:
        srv.stop()

    class OneThenStalledPipe:
        engine = SimpleNamespace(num_slots=4, num_free_slots=0)

        def simulate(self, **kw):
            yield (0.75, Doc())
            while True:
                yield generator_mod.STALLED

    srv2 = InferenceServer(OneThenStalledPipe(), batch_window_s=0.01)
    try:
        job2 = _Job(kind="mcts", image=_figure(), expansions=None)
        srv2._run_mcts(job2, stall_limit_s=0.2)
        assert job2.done.is_set()
        assert job2.error is None
        assert job2.result["score"] == 0.75
        assert job2.result["candidates"]
    finally:
        srv2.stop()


def test_sampling_wave_is_incremental():
    """A long sampling wave decodes in BOUNDED chunks (one engine decode
    block per sample_iter round); a closed wave releases its slots; a
    failure in the shared vision pass fails every job of the wave."""
    from detikzify_torch.serve import _Job, _SampleWave

    _, _, tcfg, tp = _weights(7, max_len=256)
    pipe = _port_pipeline(tp, tcfg, max_len=256)
    done, errors = [], []
    jobs = [_Job(kind="sample", image=_figure(i),
                 sampling={"temperature": 0.7, "max_new_tokens": 150})
            for i in range(2)]
    wave = _SampleWave(pipe, jobs,
                       lambda j, d: done.append((j, d)),
                       lambda j, e: errors.append((j, e)))
    assert len(wave.entries) == 2           # fused: one shared vision pass
    assert wave.advance(rounds=1) is True
    assert not done and not errors
    rounds = 1
    while wave.advance(rounds=1):
        rounds += 1
        assert rounds < 500, "wave never finished"
    assert rounds > 2                        # really was chunked
    assert len(done) == 2 and not errors
    for job, doc in done:
        assert len(doc.code) > 0
    wave2 = _SampleWave(pipe, [
        _Job(kind="sample", image=_figure(9),
             sampling={"temperature": 0.7, "max_new_tokens": 150})],
        lambda j, d: done.append((j, d)), lambda j, e: errors.append((j, e)))
    assert wave2.advance(rounds=1) is True
    wave2.close()
    assert pipe.engine.num_active == 0, "aborted wave leaked engine slots"

    orig_encode = pipe.engine.encode_image
    pipe.engine.encode_image = lambda *a, **k: (_ for _ in ()).throw(
        RuntimeError("CUDA out of memory (simulated)"))
    try:
        done3, errors3 = [], []
        jobs3 = [_Job(kind="sample", image=_figure(i),
                      sampling={"temperature": 0.7, "max_new_tokens": 8})
                 for i in range(2)]
        wave3 = _SampleWave(pipe, jobs3,
                            lambda j, d: done3.append((j, d)),
                            lambda j, e: errors3.append((j, e)))
        assert not wave3.entries            # nothing started
        assert len(errors3) == 2 and not done3
        assert all(isinstance(e, RuntimeError) for _, e in errors3)
    finally:
        pipe.engine.encode_image = orig_encode
    pipe.compiler.shutdown()


def test_mcts_progresses_during_long_sampling_wave(server):
    """An ACTIVE search keeps producing candidates while a long sampling
    wave decodes (the wave advances in bounded chunks between expansion
    turns)."""
    import time as time_mod

    base, inference = server
    done = {}

    def mcts():
        done["resp"] = _post(base, {
            "image": _b64(_figure(21)), "algorithm": "mcts",
            "timeout": 8, "temperature": 0.7}, timeout=600)
        done["t_end"] = time_mod.monotonic()

    t = threading.Thread(target=mcts)
    t.start()
    deadline = time_mod.monotonic() + 60
    while time_mod.monotonic() < deadline:
        if _get(base, "/metrics")[1]["active_mcts"] > 0:
            break
        time_mod.sleep(0.02)
    else:
        raise AssertionError("MCTS search never became active")
    sample_done = []

    def sample(i):
        status, body = _post(base, {"image": _b64(_figure(30 + i)),
                                    "temperature": 0.7,
                                    "max_new_tokens": 80}, timeout=600)
        sample_done.append((status, time_mod.monotonic()))

    threads = [threading.Thread(target=sample, args=(i,)) for i in range(4)]
    for s in threads:
        s.start()
    for s in threads:
        s.join(timeout=600)
    t.join(timeout=600)
    assert done["resp"][0] == 200
    assert len(done["resp"][1]["candidates"]) >= 1
    assert len(sample_done) == 4
    assert all(status == 200 for status, _ in sample_done)


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

def _sync_compiles(pipe):
    """Compile on submit and hand back a finished future, so a search sees
    every compile done at its first check in both packages."""
    def submit_doc(doc):
        doc.compile()
        fut = cf.Future()
        fut.set_result(doc)
        return fut

    pipe.compiler.submit_doc = submit_doc


@pytest.fixture(scope="module")
def parity():
    """A JAX server and a port server of their own on the same weights (the
    JAX init carried by ``convert``), compiles synchronous in both."""
    cfg, jp, tcfg, tp = _weights(3)
    jpipe = JPipeline(jp, cfg, JProc(_tok(JTok, cfg), cfg), num_slots=4,
                      max_len=96, metric="fast")
    tpipe = _port_pipeline(tp, tcfg)
    for pipe in (jpipe, tpipe):
        _sync_compiles(pipe)
    jbase, jhttpd, jinf = _start(jpipe, module=jserve, batch_window_s=1.0)
    tbase, thttpd, tinf = _start(tpipe, batch_window_s=1.0)
    yield dict(jpipe=jpipe, tpipe=tpipe, jbase=jbase, tbase=tbase,
               jinf=jinf, tinf=tinf)
    _stop(thttpd, tinf)
    _stop(jhttpd, jinf)
    tpipe.close()
    jpipe.compiler.shutdown()


def test_concurrent_greedy_sampling_matches_jax_pipeline(parity):
    """Three concurrent greedy requests to the port's server: each returns
    the code of the JAX pipeline's sample(temperature=0.0) on its figure,
    whether or not the three fuse into one wave."""
    figs = [_figure(5 * i) for i in range(3)]
    want = [parity["jpipe"].sample(image=f, temperature=0.0,
                                   max_new_tokens=24).code for f in figs]
    results = [None] * 3

    def call(i):
        results[i] = _post(parity["tbase"], {
            "image": _b64(figs[i]), "temperature": 0.0,
            "max_new_tokens": 24})

    threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert [r[0] for r in results] == [200] * 3
    assert [r[1]["code"] for r in results] == want
    assert any(want)
    assert parity["tinf"].requests["failed"] == 0


def test_greedy_mcts_matches_jax_server(parity):
    """The same greedy MCTS payload (4 expansions) to both servers: the same
    candidate codes in the same order, scores within 1e-5, the same best."""
    payload = {"image": _b64(_figure(11)), "algorithm": "mcts",
               "expansions": 4, "timeout": 0, "temperature": 0.0,
               "max_new_tokens": 24}
    bodies = []
    for base in (parity["jbase"], parity["tbase"]):
        random.seed(0)                      # UCT ties break at random
        status, body = _post(base, payload)
        assert status == 200
        bodies.append(body)
    jbody, tbody = bodies
    assert len(tbody["candidates"]) == 4
    assert [c["code"] for c in tbody["candidates"]] == \
        [c["code"] for c in jbody["candidates"]]
    assert [c["compiled"] for c in tbody["candidates"]] == \
        [c["compiled"] for c in jbody["candidates"]]
    np.testing.assert_allclose([c["score"] for c in tbody["candidates"]],
                               [c["score"] for c in jbody["candidates"]],
                               rtol=0, atol=1e-5)
    assert tbody["code"] == jbody["code"]
    np.testing.assert_allclose(tbody["score"], jbody["score"], rtol=0,
                               atol=1e-5)
    eng = parity["tpipe"].engine
    assert eng.num_active == 0 and eng.num_free_slots == eng.num_slots


def test_healthz_and_metrics_keys_match_jax(parity):
    for path in ("/healthz", "/metrics"):
        (js, jbody), (ts, tbody) = (_get(parity["jbase"], path),
                                    _get(parity["tbase"], path))
        assert js == ts == 200
        assert set(tbody) == set(jbody)
    jm, tm = (_get(parity["jbase"], "/metrics")[1],
              _get(parity["tbase"], "/metrics")[1])
    assert set(tm["requests"]) == set(jm["requests"])
    # the port's engine also counts its waits for the card
    assert set(tm["engine"]) == set(jm["engine"]) | {"host_syncs"}
    assert set(tm["latency_s"]) == set(jm["latency_s"])
    for kind in tm["latency_s"]:
        assert set(tm["latency_s"][kind]) == set(jm["latency_s"][kind])


def _payload(name):
    img = _figure(4)
    b64 = _b64(img)
    bomb = None
    if name == "bomb":
        bomb = _b64(Image.new("1", (9000, 9000), 1))
    raw = b64
    table = {
        "plain": {"image": b64},
        "mcts_strings": {"image": b64, "algorithm": "mcts",
                         "expansions": "3", "top_k": 5.0, "timeout": 1.5},
        "data_uri": {"image": "data:image/png;base64," + b64},
        "wrapped": {"image": "\n".join(raw[i:i + 76]
                                       for i in range(0, len(raw), 76))},
        "knobs": {"image": b64, "text": "a caption", "preprocess": False,
                  "strict": True, "top_p": "0.9", "max_new_tokens": "7",
                  "temperature": 0},
        "mcts_unlimited_ok": {"image": b64, "algorithm": "mcts",
                              "timeout": 0, "expansions": 2},
        "empty": {},
        "not_object": [1, 2],
        "not_base64": {"image": "!!not-base64!!"},
        "url": {"image": "http://169.254.169.254/latest/meta-data"},
        "alien": {"image": b64, "algorithm": "alien"},
        "negative_temperature": {"image": b64, "temperature": -0.1},
        "top_p_range": {"image": b64, "top_p": 1.5},
        "top_k_negative": {"image": b64, "top_k": -1},
        "zero_tokens": {"image": b64, "max_new_tokens": 0},
        "negative_expansions": {"image": b64, "expansions": -2},
        "unbounded_mcts": {"image": b64, "algorithm": "mcts", "timeout": 0},
        "hot": {"image": b64, "temperature": "hot"},
        "bomb": {"image": bomb},
    }
    return table[name]


def _outcome(parse, payload, **kw):
    try:
        job = parse(payload, **kw)
    except Exception as e:  # noqa: BLE001 -- compared with the JAX side
        return ("raise", type(e).__name__, str(e))
    return ("job", job.kind, job.text, job.preprocess, job.sampling,
            job.expansions, job.timeout, job.strict, job.stream is None,
            job.control is None, job.image.size, job.image.mode,
            job.image.tobytes(), job.batch_key())


@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("name", [
    "plain", "mcts_strings", "data_uri", "wrapped", "knobs",
    "mcts_unlimited_ok", "empty", "not_object", "not_base64", "url",
    "alien", "negative_temperature", "top_p_range", "top_k_negative",
    "zero_tokens", "negative_expansions", "unbounded_mcts", "hot", "bomb"])
def test_parse_job_matches_jax(name, stream):
    """The port's _parse_job gives the JAX one's fields (the decoded image
    byte for byte), or the same exception type and message."""
    payload = _payload(name)
    got = _outcome(_parse_job, payload, stream=stream)
    want = _outcome(jserve._parse_job, payload, stream=stream)
    assert got == want
    if name in ("empty", "not_base64", "url", "alien", "bomb"):
        assert got[0] == "raise"
    if name in ("plain", "knobs", "wrapped"):
        assert got[0] == "job"
