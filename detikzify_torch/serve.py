"""HTTP serving front end with dynamic request batching (counterpart of
``detikzify_tpu/serve.py``).

One shared ``DetikzifyPipeline`` (one decode engine, one page pool) sits
behind a scheduler thread that does all of the device work. Concurrently
queued one-shot requests fuse into engine waves (``_SampleWave``: one
batched vision pass, continuous-batched decode over the slots, advanced in
bounded chunks), and MCTS requests run with slot-level parallelism. Neither
kind starves the other: searches use ``num_slots - sample_reserve`` slots
and start queued sampling waves between engine steps (the generator's
``on_tick`` hook); sampling waves decode incrementally, so a long wave
hands control back to the scheduler, and the searches it timeslices, every
chunk. Concurrent searches are timesliced one expansion at a time, and
``/metrics`` exports per-kind latency percentiles.

The scheduler thread launches the kernels: it runs under
``torch.cuda.device(engine.device)``, so its current device (and with it
the stream a kernel wrapper launches on) is the engine's whatever thread
started the server. HTTP threads only parse, enqueue and wait; they create
no tensor on the card.

Endpoints (JSON over stdlib http.server, no extra dependencies):

``POST /v1/generate``
    {"image": <base64 or data-URI; URLs/server paths only with
    --allow-external-images>, "text": optional caption
    (TikZero), "algorithm": "sampling"|"mcts", "temperature"/"top_p"/
    "top_k"/"max_new_tokens": optional sampling overrides, "expansions"/
    "timeout"/"strict": MCTS knobs} ->
    {"code", "compiled", "errors", and for MCTS "score" + "candidates"}.

``POST /v1/stream``
    Same payload; responds with ``text/event-stream`` (SSE). Sampling
    emits ``token`` events ({"text": delta}) as the model decodes, then
    one ``result`` event. MCTS additionally emits a ``candidate`` event
    per rollout (token deltas reset at each rollout boundary). A client
    disconnect aborts the in-flight search (ExplicitAbort), freeing the
    engine slots.

``GET /healthz``   liveness + engine shape.
``GET /metrics``   engine dispatch/token counters, page-pool stats,
                   request counts, queue depth, latency percentiles.

Run: ``python -m detikzify_torch.serve --model detikzify-v2-8b --port 8000``
(``--device cpu`` runs the plain versions of the kernels on the host).
"""
from __future__ import annotations

import json
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

from .infer import DetikzifyPipeline
from .infer import generator as generator_mod
from .infer.tikz import TikzDocument
from .ops.cuda import device_scope
from .utils.generation import ExplicitAbort, IncrementalDecoder
from .utils.image import load as load_image

_SAMPLING_KEYS = ("temperature", "top_p", "top_k", "max_new_tokens")


@dataclass
class _Job:
    kind: str                                   # "sample" | "mcts"
    image: Any
    text: Optional[str] = None
    preprocess: bool = True
    sampling: Dict[str, Any] = field(default_factory=dict)
    expansions: Optional[int] = None
    timeout: Optional[float] = None
    strict: bool = False
    # streaming (SSE) jobs carry an event queue the HTTP thread drains and
    # an abort handle a client disconnect fires; both None for plain jobs
    stream: Optional["queue.Queue"] = None
    control: Optional[ExplicitAbort] = None
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[Dict[str, Any]] = None
    error: Optional[BaseException] = None
    t_submit: float = 0.0               # monotonic enqueue time (latency)

    def batch_key(self) -> Optional[Tuple]:
        """Jobs sharing a key can fuse into one wave. Text-conditioned and
        streaming jobs run alone (the fused path is image-only and cannot
        attribute tokens to one request)."""
        if self.kind != "sample" or self.text is not None \
                or self.stream is not None:
            return None
        return tuple(self.sampling.get(k) for k in _SAMPLING_KEYS) + (
            self.preprocess,)

    def finish(self, result=None, error=None) -> bool:
        """First finish wins (the scheduler and a racing shutdown drain may
        both try); returns whether THIS call transitioned the job."""
        if self.done.is_set():
            return False
        self.result, self.error = result, error
        self.done.set()
        if self.stream is not None:
            self.stream.put(None)               # wake the draining HTTP thread
        return True


class _TokenEmitter:
    """on_token callback: decode incrementally, emit ("token", delta)
    stream events. Runs on the scheduler thread inside the engine's decode
    loop, so its cost is bounded by a line (``IncrementalDecoder``)."""

    def __init__(self, processor, stream: "queue.Queue"):
        self._decoder = IncrementalDecoder(processor)
        self._stream = stream

    def __call__(self, token: int) -> None:
        delta = self._decoder.push(token)
        if delta:
            self._stream.put(("token", delta))

    def reset(self) -> None:
        self._decoder.reset()                   # MCTS rollout boundary


def _doc_json(doc: TikzDocument, score: Optional[float] = None) -> Dict:
    out: Dict[str, Any] = {
        "code": doc.code,
        "compiled": doc.is_rasterizable,
        "errors": {str(k): v for k, v in doc.errors.items()},
    }
    if score is not None:
        out["score"] = score
    return out


class _MctsTask:
    """One in-flight MCTS search the scheduler timeslices: its generator
    is advanced one expansion per scheduler turn, so concurrent searches
    make interleaved progress on the shared engine."""

    __slots__ = ("job", "gen", "it", "decoder", "candidates", "best",
                 "closed", "stall_t0")

    def __init__(self, job: _Job):
        self.job = job
        self.gen = None                 # DetikzifyGenerator (real pipelines)
        self.it = None                  # (score, doc) iterator
        self.decoder: Optional[_TokenEmitter] = None
        self.candidates: List[Dict] = []
        self.best: Optional[Tuple[float, TikzDocument]] = None
        self.closed = False
        self.stall_t0: Optional[float] = None   # first of a stall streak

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        if self.gen is not None:
            self.gen.close()


def _pctl(xs, q: float) -> Optional[float]:
    if not xs:
        return None
    s = sorted(xs)
    return s[min(len(s) - 1, int(round(q * (len(s) - 1))))]


class _SampleWave:
    """One fused sampling wave decoded incrementally: per-job
    ``DetikzifyGenerator.sample_iter()`` coroutines are round-robined in
    chunks of one engine decode block, so the scheduler (and the searches
    it timeslices) keeps making host-loop progress while a long wave
    decodes; the engine continuous-batches the wave's rollouts beside any
    search's. Fused image-only jobs share ONE batched vision pass (each
    generator gets its slice of the image tokens).

    ``on_done(job, doc)`` fires as each job's decode finishes (the serving
    layer submits the LaTeX compile there); jobs that raise are failed one
    by one without sinking the rest of the wave."""

    def __init__(self, pipeline, jobs: List[_Job], on_done, on_error):
        self.pipeline = pipeline
        self.on_done = on_done
        self.on_error = on_error
        self.entries: List[list] = []   # [job, gen, iter, started]
        self.fused = len(jobs) > 1
        embeds = None
        if self.fused:
            # one vision pass for the whole wave (fused jobs are image-only
            # with the same preprocess flag), on the engine's device. The
            # jobs were already popped from the scheduler's queue, so an
            # error here (card out of memory, a kernel that raises) fails
            # every job of the wave rather than leave their HTTP threads
            # waiting and kill the scheduler loop
            try:
                pil = [pipeline.load(j.image, j.preprocess) for j in jobs]
                out = pipeline.processor(images=pil)
                embeds = pipeline.engine.encode_image(out.pixel_values)
            except BaseException as e:  # noqa: BLE001 -- report to clients
                for job in jobs:
                    self.on_error(job, e)
                if not isinstance(e, Exception):
                    raise
                return
        for i, job in enumerate(jobs):
            try:
                kw = dict(job.sampling)
                if job.stream is not None:
                    kw.update(on_token=_TokenEmitter(pipeline.processor,
                                                     job.stream),
                              control=job.control)
                if embeds is not None:
                    gen = pipeline.generator(
                        image=pil[i], preprocess=False,
                        image_embeds=embeds[i:i + 1], **kw)
                else:
                    gen = pipeline.generator(
                        image=job.image, text=job.text,
                        preprocess=job.preprocess, **kw)
                # started=False: the iterator's FIRST next() claims an
                # engine slot, so it is deferred until one is free (an
                # active search may hold all but the reserve for a while)
                self.entries.append([job, gen, gen.sample_iter(), False])
            except BaseException as e:  # noqa: BLE001 -- per-job failure
                self.on_error(job, e)
                if not isinstance(e, Exception):
                    raise

    def advance(self, rounds: int = 1) -> bool:
        """Drive every live job up to ``rounds`` decode blocks; returns
        True while decode work remains. Unstarted jobs wait for a free
        engine slot (earlier wave members or search rollouts release
        them)."""
        still = []
        for entry in self.entries:
            job, gen, it, started = entry
            if not started:
                if self.pipeline.engine.num_free_slots <= 0:
                    still.append(entry)      # wait for a slot
                    continue
                entry[3] = True
            alive = True
            try:
                for _ in range(max(1, rounds)):
                    try:
                        next(it)
                    except StopIteration as stop:
                        alive = False
                        gen.close()
                        self.on_done(job, stop.value)
                        break
            except BaseException as e:  # noqa: BLE001 -- report per job
                alive = False
                try:
                    gen.close()
                except Exception:
                    pass
                self.on_error(job, e)
                if not isinstance(e, Exception):
                    raise
            if alive:
                still.append(entry)
        self.entries = still
        return bool(self.entries)

    def close(self, error: Optional[BaseException] = None) -> None:
        """Abort remaining jobs (scheduler shutdown)."""
        for job, gen, it, _started in self.entries:
            try:
                it.close()
                gen.close()
            except Exception:
                pass
            if error is not None:
                self.on_error(job, error)
        self.entries = []


class InferenceServer:
    """Scheduler owning the pipeline: all device work happens on ONE thread
    (the engine is not re-entrant); HTTP threads only enqueue and wait.

    No head-of-line blocking: MCTS searches do not monopolise the engine.
    Each search runs with ``parallelism <= num_slots - sample_reserve``
    decode slots and registers an ``on_tick`` hook with its generator;
    between the search's ``engine.step()`` calls that hook starts queued
    sampling waves on the free and reserved slots (the engine
    continuous-batches them beside the search's rollouts), so a sampling
    request queued behind a long search is served in about its idle-server
    latency. Concurrent searches are timesliced one expansion at a time
    over a shared slot split. Per-kind request latencies (p50/p95) are
    exported through ``/metrics``."""

    def __init__(self, pipeline: DetikzifyPipeline, *,
                 max_pending: int = 64,
                 batch_window_s: float = 0.02,
                 default_mcts_timeout: float = 60.0,
                 allow_external_images: bool = False,
                 mcts_parallelism: Optional[int] = None,
                 sample_reserve: Optional[int] = None,
                 max_body_bytes: int = 32 << 20,
                 max_image_pixels: int = 32_000_000,
                 max_active_mcts: int = 4):
        self.pipeline = pipeline
        self.batch_window_s = batch_window_s
        self.default_mcts_timeout = default_mcts_timeout
        # when False (default), requests may only carry inline image bytes
        # (base64 / data-URI); URLs and server-side paths are rejected at
        # parse time (SSRF / local-file-probe hardening)
        self.allow_external_images = allow_external_images
        # MCTS expansions decode concurrently over the engine's slots;
        # None = num_slots - sample_reserve, split across active searches
        self.mcts_parallelism = mcts_parallelism
        # decode slots MCTS never occupies, so interleaved sampling waves
        # always find room without waiting for a search rollout to finish
        self.sample_reserve = (max(1, pipeline.engine.num_slots // 4)
                               if sample_reserve is None else sample_reserve)
        # request-size guards: cap the JSON body before it is buffered and
        # the decoded image's pixel count before PIL decompresses it
        # (decompression-bomb / out-of-memory hardening)
        self.max_body_bytes = max_body_bytes
        self.max_image_pixels = max_image_pixels
        # admission caps: the scheduler drains the bounded queue eagerly
        # (so _engine_tick can interleave arrivals), which would otherwise
        # defeat queue.Queue(max_pending) as the overload guard; submit()
        # therefore checks the COMBINED depth (queue + drained pending +
        # waiting searches) and refuses past max_pending. max_active_mcts
        # bounds how many searches are timesliced at once (each gets 1/N
        # of the MCTS slot budget); excess searches wait their turn and
        # start their budget clock only when admitted.
        self.max_pending = max_pending
        self.max_active_mcts = max(1, max_active_mcts)
        self._closed = False
        self._stopping = False
        # serialises the shutdown drain: submit() threads racing the
        # scheduler's exit must not double-fail jobs or double-count
        self._fail_lock = threading.Lock()
        self._queue: "queue.Queue[Optional[_Job]]" = queue.Queue(max_pending)
        # scheduler-internal state (only the scheduler thread touches it):
        # sampling jobs awaiting engine slots, timesliced MCTS tasks, and
        # (job, future) pairs whose LaTeX compile runs in the async pool
        self._pending: List[_Job] = []
        self._mcts_tasks: List[_MctsTask] = []
        self._mcts_waiting: List[_Job] = []
        self._compiling: List[Tuple[_Job, Any]] = []
        self._wave: Optional[_SampleWave] = None
        self._rr = 0
        self.requests = {"sample": 0, "mcts": 0, "failed": 0, "batched": 0,
                         "mcts_stalls": 0}
        # per-kind end-to-end latencies (bounded ring) for /metrics p50/p95;
        # appended on the scheduler thread, snapshotted by /metrics HTTP
        # threads (iterating a deque during a racing append raises
        # RuntimeError, hence the lock)
        self._lat = {"sample": deque(maxlen=512), "mcts": deque(maxlen=512)}
        self._lat_lock = threading.Lock()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="detikzify-scheduler")
        self._thread.start()

    # -- submission (HTTP threads) ----------------------------------------
    def submit(self, job: _Job) -> _Job:
        if self._closed:
            raise OverloadedError("scheduler stopped")
        # combined-depth overload guard (approximate under races: a bound,
        # not an exact count)
        if self.queue_depth >= self.max_pending:
            raise OverloadedError(
                f"request queue full ({self.max_pending} pending)")
        job.t_submit = time.monotonic()
        try:
            self._queue.put_nowait(job)
        except queue.Full:
            raise OverloadedError(
                f"request queue full ({self._queue.maxsize} pending)")
        if self._closed:
            # lost the race against the scheduler's exit: make sure THIS
            # job is failed rather than parked forever (the drain may have
            # run before our put landed)
            self._fail_pending(RuntimeError("scheduler stopped"))
        return job

    def stop(self) -> None:
        while self._thread.is_alive():
            try:
                self._queue.put(None, timeout=1)
                break
            except queue.Full:     # scheduler draining or already dead
                continue
        self._thread.join(timeout=30)

    @property
    def queue_depth(self) -> int:
        return (self._queue.qsize() + len(self._pending)
                + len(self._mcts_waiting))

    # -- job completion (scheduler thread) ---------------------------------
    def _complete(self, job: _Job, result=None, error=None) -> bool:
        """Finish a job, recording failure count + end-to-end latency."""
        if not job.finish(result=result, error=error):
            return False
        if error is not None:
            self.requests["failed"] += 1
        if job.t_submit:
            with self._lat_lock:
                self._lat[job.kind].append(time.monotonic() - job.t_submit)
        return True

    def _client_gone(self, job: _Job) -> bool:
        """A streaming client that disconnected while its job was queued
        already fired the abort: skip the device work entirely."""
        if job.control is not None and job.control.should_stop:
            self._complete(job, error=RuntimeError("client disconnected"))
            return True
        return False

    # -- scheduling (the one device thread) --------------------------------
    def _drain(self, block: bool) -> None:
        """Move queued jobs into the scheduler's internal structures;
        detects the shutdown sentinel (sets ``_stopping``)."""
        first = block
        while not self._stopping:
            try:
                job = self._queue.get() if first else \
                    self._queue.get_nowait()
            except queue.Empty:
                return
            first = False
            if job is None:
                self._stopping = True
                return
            self._admit(job)

    def _admit(self, job: _Job) -> None:
        if job.kind != "mcts":
            self._pending.append(job)
            return
        if len(self._mcts_tasks) >= self.max_active_mcts:
            # timeslicing beyond the cap makes every search crawl against
            # its wall-clock budget; excess searches wait here and start
            # their generator (and budget clock) when admitted
            self._mcts_waiting.append(job)
            return
        self._start_mcts(job)

    def _start_mcts(self, job: _Job) -> None:
        if self._client_gone(job):
            return
        try:
            self._mcts_tasks.append(self._make_mcts_task(job))
        except BaseException as e:  # noqa: BLE001 -- report to client
            self._complete(job, error=e)
            if not isinstance(e, Exception):
                raise

    def _admit_waiting_mcts(self) -> None:
        while self._mcts_waiting and \
                len(self._mcts_tasks) < self.max_active_mcts:
            self._start_mcts(self._mcts_waiting.pop(0))

    def _mcts_par(self, n_tasks: int) -> int:
        """Decode-slot share per concurrent MCTS search."""
        total = self.mcts_parallelism or max(
            1, self.pipeline.engine.num_slots - self.sample_reserve)
        return max(1, total // max(1, n_tasks))

    def _rebalance(self) -> None:
        """Split the MCTS slot budget across the active searches; the
        generators re-read ``parallelism`` on every loop trip, so shares
        grow and shrink as searches come and go."""
        par = self._mcts_par(len(self._mcts_tasks))
        for t in self._mcts_tasks:
            if t.gen is not None:
                t.gen.parallelism = par

    def _make_mcts_task(self, job: _Job) -> _MctsTask:
        task = _MctsTask(job)
        kw = dict(job.sampling)
        kw.pop("max_new_tokens", None)
        if job.stream is not None:
            task.decoder = _TokenEmitter(self.pipeline.processor, job.stream)
            kw.update(on_token=task.decoder, control=job.control)
        # timeout=0 means unlimited (as the web UI's budget slider)
        timeout = (self.default_mcts_timeout if job.timeout is None
                   else job.timeout) or None
        par = self._mcts_par(len(self._mcts_tasks) + 1)
        if hasattr(self.pipeline, "generator"):
            task.gen = self.pipeline.generator(
                image=job.image, text=job.text, preprocess=job.preprocess,
                metric=self.pipeline.metric, mcts_timeout=timeout,
                strict=job.strict, on_tick=self._engine_tick, **kw)
            # shared_engine: always the staged parallel loop (its launch
            # guards tolerate sibling searches holding slots, and it
            # re-reads gen.parallelism live for _rebalance), which may
            # yield generator.STALLED when paused siblings hold every
            # slot: _advance_mcts then moves on so THEIR turns release them
            task.it = task.gen.simulate(job.expansions or None,
                                        parallelism=par,
                                        shared_engine=True)
        else:
            # duck-typed pipelines (tests): no shared-engine scheduling
            task.it = self.pipeline.simulate(
                image=job.image, text=job.text, preprocess=job.preprocess,
                expansions=job.expansions, parallelism=par,
                timeout=timeout, strict=job.strict, **kw)
        return task

    def _engine_tick(self) -> None:
        """Generator loop hook (runs on the scheduler thread INSIDE an
        active search's iteration): admit newly queued jobs, deliver
        finished compiles, and start pending sampling waves on free engine
        slots; the search's own ``engine.step()`` calls then advance the
        sampling rollouts beside its own."""
        self._drain(block=False)
        self._finish_compiled(block=False)
        if (self._wave is None and self._pending
                and self.pipeline.engine.num_free_slots > 0):
            self._start_wave(self._take_wave(window=False))
        # one bounded chunk only: the hook runs inside a search's loop
        # trip, so a long wave must not freeze that search's host loop
        self._advance_wave(rounds=1)

    def _take_wave(self, window: bool) -> List[_Job]:
        """Pop the oldest pending sampling job plus every same-key pending
        job (one fused engine wave); with ``window`` also wait up to
        ``batch_window_s`` for stragglers (idle-path batching)."""
        first = self._pending.pop(0)
        wave = [first]
        key, limit = first.batch_key(), self.pipeline.engine.num_slots
        if key is None:
            return wave
        keep: List[_Job] = []
        for j in self._pending:
            if len(wave) < limit and j.batch_key() == key:
                wave.append(j)
            else:
                keep.append(j)
        self._pending = keep
        deadline = time.monotonic() + self.batch_window_s
        while window and len(wave) < limit and not self._stopping:
            try:
                nxt = self._queue.get(
                    timeout=max(0.0, deadline - time.monotonic()))
            except queue.Empty:
                break
            if nxt is None:                      # shutdown: handle after wave
                self._stopping = True
                break
            if nxt.kind == "sample" and nxt.batch_key() == key:
                wave.append(nxt)
            else:
                self._admit(nxt)
        return wave

    def _loop(self) -> None:
        # the scheduler launches the kernels: the engine's device is this
        # thread's current device (current device and stream are per thread)
        with device_scope(getattr(self.pipeline.engine, "device", None)):
            try:
                while True:
                    busy = bool(self._mcts_tasks or self._mcts_waiting
                                or self._pending or self._compiling
                                or self._wave)
                    self._drain(block=not busy)
                    if self._stopping:
                        return
                    self._finish_compiled(block=False)
                    self._admit_waiting_mcts()
                    # an in-flight sampling wave advances a bounded chunk
                    # per scheduler turn, interleaved with one MCTS
                    # expansion per turn: neither kind starves the other
                    self._advance_wave(rounds=2)
                    if self._mcts_tasks:
                        # one expansion for the next search (round-robin);
                        # its on_tick hook interleaves sampling arrivals
                        self._rebalance()
                        self._rr += 1
                        task = self._mcts_tasks[
                            self._rr % len(self._mcts_tasks)]
                        if not self._advance_mcts(task):
                            self._mcts_tasks.remove(task)
                    elif self._wave is None and self._pending:
                        self._start_wave(self._take_wave(window=True))
                    elif self._wave is None and self._compiling:
                        self._finish_compiled(block=True)
            finally:
                # scheduler exiting (shutdown or fatal BaseException): fail
                # every parked job so no HTTP thread waits forever
                self._closed = True
                self._shutdown()

    def _shutdown(self) -> None:
        err = RuntimeError("scheduler stopped")
        for task in self._mcts_tasks:
            try:
                task.it.close()    # generator finally: aborts + releases
            except Exception:
                pass
            # graceful stop(): a mid-flight search that already produced
            # candidates completes with its best-so-far (the timeout
            # endgame's shape), so a client active at stop() gets no 500
            # for work that succeeded. A fatal scheduler exit (not
            # _stopping) still fails everything.
            if self._stopping and task.candidates:
                try:
                    self._finish_mcts(task)
                    continue
                except Exception:
                    pass
            task.close()
            self._complete(task.job, error=err)
        self._mcts_tasks = []
        if self._wave is not None and self._stopping:
            # graceful stop(): jobs mid-decode finish their bounded
            # remaining tokens; fatal exits skip this
            deadline = time.monotonic() + 10.0
            try:
                while (self._wave is not None
                       and time.monotonic() < deadline):
                    self._advance_wave(rounds=4)
            except Exception:
                pass
        if self._wave is not None:
            # abort + fail whatever remains (their engine slots release
            # through the iterators' GeneratorExit path)
            self._wave.close(error=err)
            self._wave = None
        # jobs in _compiling DECODED successfully; only their LaTeX compile
        # is outstanding. Grace-drain them (bounded) before failing the
        # rest: a graceful stop() must not 500 a finished sample
        if self._compiling:
            import concurrent.futures as _cf

            try:
                _cf.wait([f for _, f in self._compiling], timeout=5.0)
                self._finish_compiled(block=False)
            except Exception:
                pass
        for job, _ in self._compiling:
            self._complete(job, error=err)
        self._compiling = []
        self._fail_pending(err)

    def _fail_pending(self, err: BaseException) -> None:
        with self._fail_lock:
            pending, self._pending = list(self._pending), []
            pending += self._mcts_waiting
            self._mcts_waiting = []
            while True:
                try:
                    pending.append(self._queue.get_nowait())
                except queue.Empty:
                    break
            for j in pending:
                if j is not None:
                    self._complete(j, error=err)

    # -- sampling ----------------------------------------------------------
    def _start_wave(self, wave: List[_Job]) -> None:
        """Begin one fused sampling wave. Decode is incremental: the wave
        is advanced in bounded chunks by the scheduler loop and by active
        searches' on_tick hooks (``_advance_wave``); as each job's decode
        finishes, its LaTeX compile goes to the async pool
        (``_finish_compiled`` completes the jobs), so neither a long wave
        nor a slow compile stalls the scheduler."""
        wave = [j for j in wave if not self._client_gone(j)]
        if not wave:
            return
        # duck-typed pipelines (tests) have no generator(): the blocking
        # one-shot path
        if not hasattr(self.pipeline, "generator"):
            try:
                docs = [self.pipeline.sample(
                    image=j.image, text=j.text, preprocess=j.preprocess,
                    **j.sampling) for j in wave]
            except BaseException as e:  # noqa: BLE001 -- report to client
                for j in wave:
                    self._complete(j, error=e)
                if not isinstance(e, Exception):
                    raise
                return
            for j, doc in zip(wave, docs):
                self._on_sample_decoded(j, doc)
            return
        if len(wave) > 1:
            self.requests["batched"] += len(wave)
        self._wave = _SampleWave(self.pipeline, wave,
                                 self._on_sample_decoded,
                                 self._on_sample_error)
        if not self._wave.entries:
            self._wave = None

    def _advance_wave(self, rounds: int) -> None:
        if self._wave is None:
            return
        if not self._wave.advance(rounds):
            self._wave = None

    def _on_sample_decoded(self, job: _Job, doc) -> None:
        self.requests["sample"] += 1
        self._compiling.append(
            (job, self.pipeline.compiler.submit_doc(doc)))

    def _on_sample_error(self, job: _Job, error: BaseException) -> None:
        self._complete(job, error=error)

    def _finish_compiled(self, block: bool) -> None:
        """Complete sampling jobs whose async compile resolved; with
        ``block`` wait briefly on the oldest future (idle endgame)."""
        if block and self._compiling:
            try:
                self._compiling[0][1].result(timeout=0.1)
            except Exception:
                pass                      # surfaced via the future below
        still: List[Tuple[_Job, Any]] = []
        for job, fut in self._compiling:
            if not fut.done():
                still.append((job, fut))
                continue
            try:
                self._complete(job, result=_doc_json(fut.result()))
            except Exception as e:
                self._complete(job, error=e)
        self._compiling = still

    # -- MCTS --------------------------------------------------------------
    def _advance_mcts(self, task: _MctsTask) -> bool:
        """Advance one search by one expansion; False once it finished."""
        try:
            out = next(task.it)
            if out is generator_mod.STALLED:
                # every slot is held by paused sibling tasks: no progress
                # possible on THIS task until their turns release slots.
                # Counted, so /metrics shows the contention
                self.requests["mcts_stalls"] += 1
                if task.stall_t0 is None:
                    task.stall_t0 = time.monotonic()
                return True
            task.stall_t0 = None
            score, doc = out
        except StopIteration:
            self._finish_mcts(task)
            return False
        except BaseException as e:  # noqa: BLE001 -- report to client
            task.close()
            self._complete(task.job, error=e)
            if not isinstance(e, Exception):
                raise
            return False
        if task.decoder is not None:
            task.decoder.reset()     # next tokens belong to the next rollout
            task.job.stream.put(("candidate", _doc_json(doc, score)))
        task.candidates.append(_doc_json(doc, score))
        if doc.is_rasterizable and (task.best is None
                                    or score > task.best[0]):
            task.best = (score, doc)
        return True

    def _finish_mcts(self, task: _MctsTask) -> None:
        task.close()
        self.requests["mcts"] += 1
        if task.best is None:
            # the reference's evaluation keeps the last rollout as the
            # answer even when nothing compiled; a copy, since aliasing
            # candidates[-1] would make the JSON circular
            result = dict(task.candidates[-1]) if task.candidates else {
                "code": "", "compiled": False, "errors": {}}
        else:
            result = _doc_json(task.best[1], task.best[0])
        result["candidates"] = task.candidates
        self._complete(task.job, result=result)

    def _run_mcts(self, job: _Job, stall_limit_s: float = 10.0) -> None:
        """Run one MCTS job to completion (synchronous surface; the
        scheduler loop itself timeslices through ``_advance_mcts``).

        There are no sibling turns here to release engine slots, so an
        uninterrupted ``STALLED`` streak could never resolve: bail out
        after ``stall_limit_s`` of continuous stall, returning the best so
        far if anything completed."""
        if self._client_gone(job):
            return
        task = self._make_mcts_task(job)
        while self._advance_mcts(task):
            if task.stall_t0 is not None:
                # a stall streak: a few ms between polls leave the core to
                # the HTTP threads and to whoever holds the slots
                time.sleep(0.01)
            if (task.stall_t0 is not None
                    and time.monotonic() - task.stall_t0 > stall_limit_s):
                try:
                    task.it.close()   # generator finally: aborts + releases
                except Exception:
                    pass
                if task.candidates:
                    self._finish_mcts(task)
                else:
                    task.close()
                    self._complete(task.job, error=RuntimeError(
                        f"engine slots unavailable for "
                        f"{stall_limit_s:.0f}s (held by another engine "
                        f"user); search made no progress"))
                return

    # -- introspection ------------------------------------------------------
    def metrics(self) -> Dict[str, Any]:
        eng = self.pipeline.engine
        return {
            "engine": dict(eng.counters),
            "spec_rate": eng.spec_rate,
            "num_slots": eng.num_slots,
            "num_free_slots": eng.num_free_slots,
            "prefix_pages_used": eng.prefix_pages_used,
            "requests": dict(self.requests),
            "queue_depth": self.queue_depth,
            "active_mcts": len(self._mcts_tasks),
            "waiting_mcts": len(self._mcts_waiting),
            "compiling": len(self._compiling),
            # per-kind end-to-end request latency percentiles: sampling
            # blocked behind MCTS budgets would show here
            "latency_s": self._latency_snapshot(),
        }

    def _latency_snapshot(self) -> Dict[str, Dict[str, Any]]:
        with self._lat_lock:
            snap = {kind: list(v) for kind, v in self._lat.items()}
        return {kind: {"p50": _pctl(v, 0.50), "p95": _pctl(v, 0.95),
                       "count": len(v)}
                for kind, v in snap.items()}


class OverloadedError(RuntimeError):
    pass


_COERCE = {"temperature": float, "top_p": float, "top_k": int,
           "max_new_tokens": int}


def _check_pixels(width: int, height: int, max_pixels: int) -> None:
    if width * height > max_pixels:
        raise ValueError(f"image too large: {width}x{height} exceeds the "
                         f"{max_pixels}-pixel limit")


def _parse_job(payload: Dict[str, Any],
               allow_external_images: bool = False,
               stream: bool = False,
               max_image_pixels: int = 32_000_000) -> _Job:
    """A request body to a ``_Job`` (on the HTTP thread: PIL only, no
    tensor). Raises ``ValueError`` for what the client sent wrong."""
    if not isinstance(payload, dict):
        raise ValueError("request body must be a JSON object")
    image = payload.get("image")
    if image is None:
        raise ValueError("missing required field 'image'")
    if isinstance(image, str) and not allow_external_images:
        # decode inline payloads HERE and hand the loader raw bytes, so the
        # string never reaches its URL-fetch / filesystem-path branches
        # (SSRF / local-file-probe hardening). Whitespace is stripped
        # first: standard encoders (MIME, the base64 CLI) wrap at 76
        # columns, and stripping cannot launder a URL or path into base64.
        import base64
        import binascii
        import io

        from PIL import Image as PILImage
        inline = "".join(image.split(",", 1)[-1].split())
        try:
            raw = base64.b64decode(inline, validate=True)
        except (binascii.Error, ValueError):
            raise ValueError("'image' must be inline base64 or a data-URI "
                             "(external URLs/paths are disabled)")
        # header-only probe BEFORE the full decode: a small compressed
        # payload can claim a huge bitmap (decompression bomb)
        with PILImage.open(io.BytesIO(raw)) as probe:
            _check_pixels(*probe.size, max_image_pixels)
        image = load_image(raw)
    else:
        image = load_image(image)             # base64 / data-URI / URL / path
        _check_pixels(*image.size, max_image_pixels)
    algorithm = payload.get("algorithm", "sampling")
    if algorithm not in ("sampling", "mcts"):
        raise ValueError(f"unknown algorithm {algorithm!r}")
    # coerce + range-check every numeric knob HERE, so a bad value is a 400
    # at parse time, not a 500 from the scheduler thread
    sampling = {k: _COERCE[k](payload[k])
                for k in _SAMPLING_KEYS if k in payload}
    if sampling.get("temperature", 0.0) < 0:
        raise ValueError("temperature must be >= 0")
    if not 0.0 <= sampling.get("top_p", 1.0) <= 1.0:
        raise ValueError("top_p must be in [0, 1]")
    if sampling.get("top_k", 0) < 0:
        raise ValueError("top_k must be >= 0 (0 disables)")
    if sampling.get("max_new_tokens", 1) < 1:
        raise ValueError("max_new_tokens must be >= 1")
    expansions = payload.get("expansions")
    if expansions is not None and int(expansions) < 1:
        raise ValueError("expansions must be >= 1")
    timeout = payload.get("timeout")
    timeout = float(timeout) if timeout is not None else None
    if algorithm == "mcts" and timeout == 0 and not expansions:
        # timeout=0 means unlimited; without a positive expansion budget
        # the single scheduler thread would search forever
        raise ValueError("timeout=0 (unlimited) requires 'expansions'")
    return _Job(
        kind="mcts" if algorithm == "mcts" else "sample",
        image=image,
        text=payload.get("text") or None,
        preprocess=bool(payload.get("preprocess", True)),
        sampling=sampling,
        expansions=int(expansions) if expansions is not None else None,
        timeout=timeout,
        strict=bool(payload.get("strict", False)),
        stream=queue.Queue() if stream else None,
        control=ExplicitAbort() if stream else None,
    )


class _Handler(BaseHTTPRequestHandler):
    server_version = "detikzify-torch"
    # set by make_server:
    inference: InferenceServer

    def _reply(self, status: int, obj: Dict) -> None:
        body = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):          # quiet by default
        pass

    def do_GET(self):  # noqa: N802 -- BaseHTTPRequestHandler API
        inf = self.inference
        if self.path == "/healthz":
            self._reply(200, {"status": "ok",
                              "num_slots": inf.pipeline.engine.num_slots,
                              "queue_depth": inf.queue_depth})
        elif self.path == "/metrics":
            self._reply(200, inf.metrics())
        else:
            self._reply(404, {"error": f"no such path {self.path!r}"})

    def do_POST(self):  # noqa: N802
        stream = self.path == "/v1/stream"
        if self.path != "/v1/generate" and not stream:
            self._reply(404, {"error": f"no such path {self.path!r}"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            if length > self.inference.max_body_bytes:
                self._reply(413, {"error": f"request body {length} bytes "
                                  f"exceeds the "
                                  f"{self.inference.max_body_bytes} limit"})
                return
            payload = json.loads(self.rfile.read(length) or b"{}")
            job = _parse_job(
                payload,
                allow_external_images=self.inference.allow_external_images,
                stream=stream,
                max_image_pixels=self.inference.max_image_pixels)
        except Exception as e:  # noqa: BLE001 -- malformed request payload
            self._reply(400, {"error": f"{type(e).__name__}: {e}"})
            return
        try:
            self.inference.submit(job)
        except OverloadedError as e:
            self._reply(503, {"error": str(e)})
            return
        if stream:
            self._stream_reply(job)
            return
        job.done.wait()
        if job.error is not None:
            self._reply(500, {"error": f"{type(job.error).__name__}: "
                                       f"{job.error}"})
        else:
            self._reply(200, job.result)

    def _write_event(self, kind: str, data) -> None:
        if kind == "token":
            data = {"text": data}
        self.wfile.write(
            f"event: {kind}\ndata: {json.dumps(data)}\n\n".encode())
        self.wfile.flush()

    def _stream_reply(self, job: _Job) -> None:
        """Drain the job's event queue into an SSE response. HTTP/1.0 +
        connection close, so no Content-Length or chunking is needed."""
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.end_headers()
        try:
            while True:
                event = job.stream.get()
                if event is None:               # finish() sentinel
                    break
                self._write_event(*event)
            if job.error is not None:
                self._write_event("error", {
                    "error": f"{type(job.error).__name__}: {job.error}"})
            else:
                self._write_event("result", job.result)
        except (BrokenPipeError, ConnectionResetError):
            # client went away mid-stream: cancel the in-flight search so
            # the engine slots free up instead of decoding into the void
            if job.control is not None:
                job.control.abort()


def make_server(pipeline: DetikzifyPipeline, host: str = "127.0.0.1",
                port: int = 8000, **kw) -> Tuple[ThreadingHTTPServer,
                                                 InferenceServer]:
    """Build (http_server, inference_server); caller runs serve_forever()."""
    inference = InferenceServer(pipeline, **kw)
    handler = type("Handler", (_Handler,), {"inference": inference})
    httpd = ThreadingHTTPServer((host, port), handler)
    return httpd, inference


def main(argv: Optional[List[str]] = None) -> None:
    import argparse

    from .webui.strings import MODELS
    from .webui.webui import cached_load

    parser = argparse.ArgumentParser(
        description="DeTikZify inference server (PyTorch/CUDA)")
    parser.add_argument("--model", default=next(iter(MODELS)))
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--device", default="cuda",
                        help="device of the weights and the engine "
                             "('cpu' runs the kernels' plain versions)")
    parser.add_argument("--speculate", type=int, default=0)
    parser.add_argument("--max-pending", type=int, default=64)
    parser.add_argument("--mcts-timeout", type=float, default=60.0)
    parser.add_argument("--max-active-mcts", type=int, default=4,
                        help="searches timesliced concurrently; excess "
                             "searches queue (budget clock starts when "
                             "admitted)")
    parser.add_argument("--mcts-parallelism", type=int, default=0,
                        help="total concurrent MCTS expansions, split "
                             "across active searches (0 = every "
                             "non-reserved engine slot)")
    parser.add_argument("--sample-reserve", type=int, default=-1,
                        help="decode slots MCTS never occupies, kept for "
                             "interleaved one-shot sampling "
                             "(-1 = num_slots/4)")
    parser.add_argument("--max-body-mb", type=int, default=32,
                        help="reject request bodies larger than this")
    parser.add_argument("--allow-external-images", action="store_true",
                        help="let requests reference URLs/server paths "
                             "(trusted networks only: SSRF risk)")
    args = parser.parse_args(argv)

    pipeline = cached_load(MODELS.get(args.model, args.model),
                           speculate=args.speculate, device=args.device)
    httpd, inference = make_server(
        pipeline, args.host, args.port, max_pending=args.max_pending,
        default_mcts_timeout=args.mcts_timeout,
        max_active_mcts=args.max_active_mcts,
        mcts_parallelism=args.mcts_parallelism or None,
        sample_reserve=(None if args.sample_reserve < 0
                        else args.sample_reserve),
        max_body_bytes=args.max_body_mb << 20,
        allow_external_images=args.allow_external_images)
    print(f"serving {args.model} on http://{args.host}:{args.port}",
          flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        inference.stop()
        httpd.server_close()


if __name__ == "__main__":
    main()
