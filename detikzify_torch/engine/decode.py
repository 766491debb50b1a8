"""Continuous-batching decode engine with tree-prefix KV reuse
(counterpart of ``detikzify_tpu/engine/decode.py``).

  * a fixed pool of **slots** over a PAGED KV cache: one shared page pool
    read through per-slot page tables; rollouts join and leave mid-flight
    and all slots advance together;
  * **block decoding**: ``decode_block`` zero-copy decode steps per
    ``step()``; slots that hit EOS mid-block freeze (their writes divert to
    the trash page, they re-emit EOS, their position stops);
  * **fused start**: prefix restore + bucketed paged prefill + first-token
    sampling per wave; starts are **lazy** (first tokens are fetched at the
    next ``step()``/``flush()``);
  * **O(1) prefix store**: storing a prefix pins the slot's pool pages (+ at
    most one boundary-page copy); restoring splices them into the new slot's
    table (+ at most one copy-on-write boundary page);
  * sampling on the device;
  * **speculative decoding** (``speculate=K``): each step drafts K tokens
    by n-gram lookup in the slot's own history and in a reference hint,
    verifies them in one K+1-token forward that reads the pool zero-copy
    (kernel K4), and emits 1..K+1 tokens by distribution-preserving
    acceptance; draft classes (hinted, unhinted) are gated by their
    measured tokens per step.

Per-slot token/position state lives on the device, at fixed addresses,
updated only in place; the host keeps plain-int mirrors updated from
fetched results. The host-side page accounting and the speculative gating
are the JAX engine's, line for line. As JAX compiles ``decode_many`` once
per set of static arguments, the engine keeps one program per ``(mode, k,
kv_pages, banned, suppress)`` (``_build_jit``): on a card a CUDA graph,
captured at the key's first call and replayed after it, so a block of k
steps over all slots is one dispatch. With ``pipelined=True`` block N+1 is
launched before block N's tokens are read: no dispatch waits on the device
(host arrays go up from pinned memory, and each block's tokens come down
into pinned memory behind an event recorded when it is launched). While
a profiler runs, each start (``engine.start``), its prefill
(``engine.prefill``), each ``step()`` (``engine.step``) and each tower
pass (``tower``) is a span of ``utils.profiling``; ``counters
["host_syncs"]`` counts the host's waits for the device. Not
ported here: the gather/scatter decode and verify views and the
attention-backend pin (see ROADMAP).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import itertools
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import DetikzifyConfig
from ..models import detikzify, llama
from ..models.detikzify import Params
from ..ops import cuda as cuda_ops
from ..ops.sampling import SamplingParams, sample, speculative_accept
from ..utils import profiling

BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048)
# one CUDA graph capture at a time in the process (PyTorch's rule); other
# threads go on launching meanwhile (``capture_error_mode="thread_local"``)
_CAPTURE_LOCK = threading.Lock()
# serial request ids, unique in the process: a rollout's spans carry its id
_RIDS = itertools.count()


@contextlib.contextmanager
def _gc_paused():
    """No cyclic garbage collection inside: a dead graph engine lives on in
    its reference cycles, and a collection during a capture would destroy
    its graphs there, which invalidates the capture."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def _bucket(n: int, max_len: int) -> int:
    for b in BUCKETS:
        if n <= b and b <= max_len:
            return b
    return max_len


@dataclasses.dataclass
class StoredPrefix:
    """Page-table prefix: KV lives in the engine's shared page pool.

    ``pages[i]`` holds cache rows [i*page, (i+1)*page); pages are immutable
    once written (copy-on-write), so a child prefix REUSES its ancestor's
    full pages and only the tail beyond the shared page boundary is copied."""

    pages: Tuple[int, ...]     # page-pool ids, in order
    length: int                # valid tokens
    token_ids: tuple           # full token prefix (host copy, exact match)
    namespace: object = None   # scope (e.g. per-image); prevents cross-matches
    dropped: bool = False      # set on eviction: pages may be recycled


@dataclasses.dataclass
class Rollout:
    """Host-side state of one active generation."""

    slot: int
    prompt_len: int                      # tokens already in cache at start
    token_ids: List[int]                 # full sequence incl. prompt
    max_new_tokens: int
    on_token: Optional[Callable[[int], None]] = None
    new_tokens: int = 0
    finished: bool = False
    finish_reason: Optional[str] = None  # "eos" | "length" | "abort"
    aborted: bool = False
    hinted: bool = False                 # draft class for spec gating
    rid: int = -1                        # serial request id (its spans')

    @property
    def length(self) -> int:
        return len(self.token_ids)


class _Fetch:
    """Device tensors on their way to the host. ``pinned`` (pipelined
    stepping): on a card the copy goes into pinned memory, issued with the
    launch that produced them, and an event marks its end, so reading
    waits for that event only, never for work launched after it; on the
    CPU they are copied at once. Otherwise the first read copies them
    (eager stepping: a wait for all the work launched).

    A decode block's outputs are its program's static tensors, which the
    next block overwrites: ``overwritten`` (a callable) says whether that
    has happened, and reading after it raises instead of returning the
    later block's tokens.

    The first read blocks the host on the device (the copy, or the wait
    for the event) and counts one ``counters["host_syncs"]``; on the CPU
    too, so that counts are the card's."""

    def __init__(self, *tensors: Optional[torch.Tensor],
                 pinned: bool = False,
                 overwritten: Optional[Callable[[], bool]] = None,
                 counters: dict):
        self._tensors, self._host, self._event = tensors, None, None
        self._overwritten = overwritten
        self._counters = counters
        self._waited = False
        dev = next((t.device for t in tensors if t is not None), None)
        if pinned and dev is not None and dev.type == "cuda":
            self._host = []
            for t in tensors:
                if t is None:
                    self._host.append(None)
                    continue
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                self._host.append(h)
            # on the stream the copies went to: the tensors' device's,
            # whichever device is current
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(dev))
        elif pinned and dev is not None:
            self._host = [None if t is None else t.clone() for t in tensors]

    def numpy(self) -> List[Optional[np.ndarray]]:
        if self._host is None:
            if self._overwritten is not None and self._overwritten():
                raise RuntimeError(
                    "a decode block's tokens were read after the next "
                    "block overwrote its program's outputs")
            self._host = [None if t is None else t.cpu()
                          for t in self._tensors]
        elif self._event is not None:
            self._event.synchronize()
        if not self._waited:
            self._waited = True
            self._counters["host_syncs"] += 1
        return [None if h is None else h.numpy() for h in self._host]


class _Program:
    """One decode block at one static key: the counterpart of one program
    that the JAX engine's ``jax.jit`` compiled. With ``graph`` a CUDA
    graph, each call one replay, its kernels' launches counted from the
    capture's ``tally``; else (the CPU, an engine built with
    ``graphs=False``, a model axis) the block function, run eagerly.
    Either way each call's outputs land in the same static tensors."""

    def __init__(self, fn: Callable[[], tuple],
                 outputs: Optional[tuple] = None, graph=None,
                 tally: Optional[dict] = None):
        self.fn, self.outputs, self.graph, self.tally = (fn, outputs, graph,
                                                         tally)

    def __call__(self) -> tuple:
        if self.graph is not None:
            self.graph.replay()
            cuda_ops.add_launches(self.tally)
            return self.outputs
        out = self.fn()
        if self.outputs is None:
            self.outputs = tuple(torch.empty_like(t) for t in out)
        for dst, src in zip(self.outputs, out):
            dst.copy_(src)
        return self.outputs


class DecodeEngine:
    def __init__(
        self,
        params: Params,
        cfg: DetikzifyConfig,
        *,
        num_slots: int = 8,
        max_len: Optional[int] = None,
        cache_dtype=torch.bfloat16,
        sampling: SamplingParams = SamplingParams(),
        eos_token_id: Optional[int] = None,
        prefix_budget_bytes: int = 2 << 30,
        decode_block: int = 16,
        pipelined: bool = False,
        page_size: int = 128,
        speculate: int = 0,
        spec_min_rate: float = 1.3,
        device="cuda",
        seed: int = 0,
        graphs: Optional[bool] = None,
    ):
        """All engine state (page pool, page tables, per-slot tokens and
        positions, the sampling generator seeded with ``seed``) lives on
        ``device``; ``params`` must already be there.

        ``speculate=K > 0`` turns on n-gram prompt-lookup speculative
        decoding: each step drafts K tokens from the slot's own token
        history (and from its reference ``hint``, e.g. the parent rollout's
        continuation in MCTS), verifies them in ONE K+1-token forward over
        the page pool, and emits 1..K+1 tokens via distribution-preserving
        acceptance (``ops.sampling.speculative_accept``). Greedy slots emit
        the plain greedy stream given identical logits; on the card the
        verify forward and the plain step use different kernels, so a bf16
        near-tie can flip an argmax. Sampled slots draw from the same
        warped distribution.

        ``spec_min_rate``: measured tokens-per-step floor below which a
        DRAFT CLASS (hinted vs unhinted slots, gated independently) falls
        back to plain decoding, with a recoverable exponential-backoff
        probe (``_update_spec_gating``); 0 disables the bail-out. The 1.3
        default is the JAX package's measured break-even of the verify
        forward on the TPU, kept as it is. On an NVIDIA H100 80GB HBM3
        at 700 W a verify step cost 1.11-1.27x a plain one at v2-8b int8
        with 8 slots (``chip_smoke.py``'s ``pipelined`` phase) and
        1.04-1.49x on the small spec model (its ``spec_acceptance``
        phase).

        ``pipelined=True``: ``step()`` launches block N+1 before it reads
        block N's tokens, so the host's token handling overlaps the
        device; finishes are seen one block later (see ``step``).

        ``graphs``: whether each decode block runs as a CUDA graph
        (``_build_jit``). By default it does on a card and does not on the
        CPU or over a model axis (its collectives run over gloo, which a
        graph cannot capture); ``graphs=False`` keeps a card's blocks
        eager, for an A/B; ``graphs=True`` where no graph can run
        raises."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("DecodeEngine: no CUDA device; pass "
                               "device='cpu' to run the plain versions")
        if params.device.type != self.device.type:
            raise ValueError(f"params live on {params.device}, the engine "
                             f"on {self.device}")
        self.params = params
        self.cfg = cfg
        self.num_slots = num_slots
        self.decode_block = decode_block
        self.pipelined = pipelined
        self.page = page_size
        self.spec = int(speculate)
        self.spec_min_rate = spec_min_rate
        # per-CLASS speculation gating: hinted drafts (MCTS parent
        # continuations) and unhinted own-history drafts each keep a
        # sliding window, a bad streak and a recoverable cooldown
        self._spec_cls = {
            c: {"on": self.spec > 0, "win": [0, 0], "bad": 0,
                "cool": 0, "backoff": 4096, "probe": False}
            for c in ("hint", "plain")}
        # the last spec+1 cache rows are trash rows for frozen/inactive
        # slots' writes (one row when speculation is off); rows are padded
        # to a whole number of pages
        want = (max_len or cfg.model_max_length) + 1 + self.spec
        self.max_len = -(-want // page_size) * page_size
        self._trash_start = self.max_len - 1 - self.spec
        self._m_cap = self.max_len // page_size   # pages per full slot
        self.sampling = sampling
        self.eos_token_id = (cfg.eos_token_id if eos_token_id is None
                             else eos_token_id)
        # --- paged KV: ONE page pool; slots and stored prefixes both hold
        # pool pages through page tables. The last pool page is a shared
        # TRASH page: rows at/beyond ``_trash_start`` write there, never
        # through a (possibly stale) table.
        # over a model axis (``parallel.mesh.place_params``) the pool holds
        # this rank's KV heads, and every rank runs this same schedule
        tcfg = cfg.text
        placement = getattr(params, "placement", None)
        if placement is not None and placement.mesh.shape["data"] > 1:
            raise ValueError(
                f"DecodeEngine over a {placement.mesh.shape} mesh: a data "
                "axis would repeat the same work on each row; place the "
                "weights on a (data=1, model=m) mesh, or run one engine a "
                "device with parallel.ReplicaPool")
        if graphs is None:
            graphs = self.device.type == "cuda" and placement is None
        elif graphs and placement is not None:
            raise ValueError(
                "DecodeEngine(graphs=True) over a model axis: its "
                "collectives run over gloo, which a CUDA graph cannot "
                "capture; build it with graphs=False")
        elif graphs and self.device.type != "cuda":
            raise ValueError("DecodeEngine(graphs=True): CUDA graphs need a "
                             f"CUDA device, not {self.device}")
        self.graphs = bool(graphs)
        kv_heads = llama.kv_heads(params.text)
        page_bytes = (2 * tcfg.num_hidden_layers * page_size
                      * kv_heads * tcfg.head_dim
                      * torch.finfo(cache_dtype).bits // 8)
        budget_pages = int(min(max(prefix_budget_bytes // page_bytes, 2),
                               4096))
        n_pages = num_slots * self._m_cap + budget_pages + 1
        self._trash_page = n_pages - 1
        dev = self.device
        self.cache = llama.init_paged_cache(cfg.text, n_pages, page_size,
                                            cache_dtype, device=dev,
                                            kv_heads=kv_heads)
        self.generator = torch.Generator(device=dev).manual_seed(seed)
        self._tab_dev = torch.full((num_slots, self._m_cap),
                                   self._trash_page, dtype=torch.int32,
                                   device=dev)
        # host-side page accounting
        self._page_refs = np.zeros((n_pages,), np.int32)
        self._free_pages: List[int] = list(range(n_pages - 1))
        self._tables = np.full((num_slots, self._m_cap), self._trash_page,
                               np.int32)
        self._table_live = np.zeros((num_slots,), bool)
        self._shared_n = np.zeros((num_slots,), np.int32)  # immutable-page
                                                           # count per table
        self._rollouts: Dict[int, Rollout] = {}
        self._free_slots = list(range(num_slots))
        # device-resident per-slot state
        self._tok_dev = torch.zeros((num_slots,), dtype=torch.int32,
                                    device=dev)
        self._pos_dev = torch.zeros((num_slots,), dtype=torch.int32,
                                    device=dev)
        # a block's inputs: which slots decode, and their (temperature,
        # top_p, top_k), copied in place before each dispatch
        self._active_dev = torch.zeros((num_slots,), dtype=torch.bool,
                                       device=dev)
        self._samp_dev = torch.zeros((num_slots, 3), dtype=torch.float32,
                                     device=dev)
        # speculative decoding: device-side token history per slot (wider
        # than the cache so K+1-token writes at the last position never
        # clamp; -1 = empty, never matches a token id) and per-slot
        # REFERENCE text (the hint) searched before the slot's own history
        self._buf_dev = self._hint_dev = None
        if self.spec > 0:
            self._buf_dev = torch.full(
                (num_slots, self.max_len + self.spec + 1), -1,
                dtype=torch.int32, device=dev)
            self._hint_dev = torch.full((num_slots, self.max_len), -1,
                                        dtype=torch.int32, device=dev)
        # pipelined stepping: the block dispatched last step (its token
        # fetch, counts or None, k, {slot: rollout} snapshot)
        self._inflight = None
        # whether the last dispatched block speculated (the pipelined
        # ``_kv_limit`` slack reads it) and its page count (the
        # ``engine.step`` span's ``kv_pages``), and which slots' device
        # histories went stale through plain blocks (resynced before the
        # next speculative block)
        self._last_dispatch_spec = False
        self._last_kv_pages = 0
        self._buf_stale = np.zeros((num_slots,), bool)
        self._active = np.zeros((num_slots,), bool)       # host-controlled
        # per-slot (temperature, top_p, top_k), uploaded per dispatch
        self._samp_host = np.tile(
            np.asarray([sampling.temperature, sampling.top_p,
                        float(sampling.top_k)], np.float32),
            (num_slots, 1))
        # slot -> (fetch of its start wave's first tokens, row in the wave)
        self._first_pending: Dict[int, Tuple[_Fetch, int]] = {}
        self._prefix_store: Dict[object, StoredPrefix] = {}
        self._prefix_lru: List[object] = []
        # O(1)-ish longest-prefix lookup: (namespace, length, hash(ids))
        # -> store key, plus the stored lengths per namespace
        self._prefix_index: Dict[tuple, object] = {}
        self._ns_lengths: Dict[object, Dict[int, int]] = {}

        self.counters = {"starts": 0, "start_dispatches": 0,
                         "prefix_starts": 0,
                         "decode_dispatches": 0, "decode_steps": 0,
                         "decode_tokens": 0,
                         "spec_steps": 0, "spec_tokens": 0,
                         "spec_steps_hint": 0, "spec_tokens_hint": 0,
                         "prefix_saves": 0, "prefill_tokens": 0,
                         "prefill_tokens_saved": 0,
                         # pool WRITE rows per start (copy-on-write boundary
                         # + tail) and boundary rows copied on store
                         "restore_cow_rows": 0, "prefix_copy_rows": 0,
                         # plain->speculative history re-uploads
                         "buf_resyncs": 0,
                         # waits of the host for the device: pageable
                         # uploads, token fetches, the tower's pixels
                         "host_syncs": 0}
        self._build_jit()

    # ------------------------------------------------------------------
    # device programs
    # ------------------------------------------------------------------

    @property
    def params(self) -> Params:
        return self._params

    @params.setter
    def params(self, params: Params) -> None:
        """The weights every block reads (GRPO rebinds them to the current
        policy). A graph reads the tensors it was captured with, so other
        weights drop the programs; the JAX engine passes them to every
        jitted call."""
        if getattr(self, "_params", params) is not params:
            self._programs.clear()
        self._params = params

    def _build_jit(self) -> None:
        """The program cache, the counterpart of the JAX engine's jitted
        ``decode_many`` and ``decode_many_spec``: one program a key,
        ``(speculative, k, kv_pages, banned, suppress)``, JAX's static
        arguments and the mode; sampling parameters are device data and
        add none. With ``graphs`` a key's first call runs its block
        eagerly on the engine's capture stream (real work, and the
        warm-up of everything built at first use: the kernels' libraries,
        cuBLAS, K5's plan), then captures it as a CUDA graph into the
        engine's one memory pool, where every allocation of the block
        lives (the kernels' scratch and outputs too), with the sampling
        generator registered: a graph engine draws what an eager one with
        the same ``seed`` draws. Every later call is one replay. A failed
        capture or replay raises. Start waves, ``_copy_page``,
        ``_resync_buf`` and ``encode_image`` stay eager: a start wave's
        prefill of >= 300 rows a rollout keeps the card busy, and its
        shapes change with every wave."""
        self._programs: Dict[tuple, _Program] = {}
        self._block_calls = 0          # blocks run, for _Fetch's check
        self._pool = self._stream = None
        if self.graphs:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)
        self.graph_stats = {"captures": 0, "capture_s": 0.0, "replays": 0}

    def _block(self, speculative: bool, k: int, kv_pages: int) -> tuple:
        """Run one decode block through its key's program; returns its
        outputs: the program's static tensors (on a graph engine the
        key's first call, run eagerly, returns its own)."""
        key = (speculative, k, kv_pages, self._banned(),
               None if speculative else self._suppress())
        self._block_calls += 1
        prog = self._programs.get(key)
        if prog is not None:
            self.graph_stats["replays"] += prog.graph is not None
            return prog()
        fn = functools.partial(self._decode_many_spec if speculative
                               else self._decode_many, k, kv_pages)
        if not self.graphs:
            prog = self._programs[key] = _Program(fn)
            return prog()
        cur = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            out = fn()
        cur.wait_stream(self._stream)
        self._programs[key] = self._capture(fn)
        return out

    def _capture(self, fn: Callable[[], tuple]) -> _Program:
        """Capture ``fn`` (a block, already run once) as a CUDA graph on
        the engine's capture stream, the cyclic garbage collector paused.
        Nothing runs: the engine's state is what it was before."""
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        with torch.cuda.stream(self._stream), _CAPTURE_LOCK, \
                cuda_ops.tally_launches() as tally, _gc_paused():
            graph.capture_begin(pool=self._pool,
                                capture_error_mode="thread_local")
            try:
                static = fn()
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass          # the error raised below broke it
                raise
            graph.capture_end()
        self.graph_stats["captures"] += 1
        self.graph_stats["capture_s"] += time.perf_counter() - t0
        return _Program(fn, static, graph, tally)

    def graph_pool_bytes(self) -> int:
        """Card bytes held by the engine's graph memory pool (0 without
        graphs)."""
        if self._pool is None:
            return 0
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg["segment_pool_id"]) == tuple(self._pool))

    def _upload(self, dst: torch.Tensor, x) -> None:
        """Host array -> the device tensor ``dst``, in place (a graph
        reads a block's inputs at fixed addresses). Pipelined on a card it
        goes from pinned memory without blocking the host: a copy from
        pageable memory would wait for the block in flight. The pinned
        buffer comes from PyTorch's caching host allocator, which reuses
        it only once the copy has ended. Eager, the copy waits for the
        stream: one ``counters["host_syncs"]`` (on the CPU too)."""
        src = torch.from_numpy(np.ascontiguousarray(x)).to(dst.dtype)
        if not self.pipelined:
            self.counters["host_syncs"] += 1
        if self.pipelined and self.device.type == "cuda":
            dst.copy_(src.pin_memory(), non_blocking=True)
        else:
            dst.copy_(src)

    def _put(self, x, dtype=torch.int32) -> torch.Tensor:
        """Host array -> a new tensor on the engine's device."""
        x = np.asarray(x)
        out = torch.empty(x.shape, dtype=dtype, device=self.device)
        self._upload(out, x)
        return out

    def _samp_cols(self, samp: torch.Tensor):
        return dict(temperature=samp[:, 0], top_p=samp[:, 1],
                    top_k=samp[:, 2].to(torch.int32))

    @torch.inference_mode()
    def _start_wave(self, slots, ids, image_embeds, starts, seq_lens,
                    img_offsets, read_tab, write_tab, cow, samp):
        """Fused start for B rollouts: install the wave's page tables,
        paged prefill (gathered prefix + tail/COW write-back into pool
        pages), and first-token sampling. The pool is updated in place."""
        b = slots.shape[0]
        self._tab_dev[slots.long()] = write_tab
        logits, _ = detikzify.prefill_paged(
            self.params, self.cfg, ids, image_embeds, starts, seq_lens,
            self.cache, read_tab, write_tab, cow, image_offsets=img_offsets,
            trash_row=self._trash_start, trash_page=self._trash_page)
        firsts = sample(logits, self.generator, **self._samp_cols(samp),
                        banned_tokens=self._banned(),
                        suppress_begin_tokens=self._suppress(),
                        is_first=torch.ones((b,), dtype=torch.bool,
                                            device=self.device))
        self._tok_dev[slots.long()] = firsts
        self._pos_dev[slots.long()] = starts + seq_lens
        return firsts

    @torch.inference_mode()
    def _decode_many(self, k: int, kv_pages: int) -> Tuple[torch.Tensor]:
        """k zero-copy decode steps for all slots; returns (tokens [k, S],).
        Slots that emit EOS freeze: their writes divert to the trash page
        (position max_len - 1), they re-emit EOS and stop advancing. Reads
        ``_active_dev`` and ``_samp_dev``; tokens and positions end in
        place."""
        eos, max_len = self.eos_token_id, self.max_len
        tokens, positions = self._tok_dev, self._pos_dev
        done = ~self._active_dev | (tokens == eos)
        cols = self._samp_cols(self._samp_dev)
        out = []
        for _ in range(k):
            write_pos = torch.where(done, torch.full_like(positions,
                                                          max_len - 1),
                                    positions.clamp(max=max_len - 1))
            logits, _ = detikzify.decode_step_paged(
                self.params, self.cfg, tokens, write_pos, self.cache,
                self._tab_dev, kv_pages=kv_pages,
                trash_row=self._trash_start, trash_page=self._trash_page)
            nxt = sample(logits, self.generator, **cols,
                         banned_tokens=self._banned(),
                         suppress_begin_tokens=self._suppress(),
                         is_first=None)
            nxt = torch.where(done, torch.full_like(nxt, eos), nxt)
            positions = torch.where(done, positions, positions + 1)
            done = done | (nxt == eos)
            tokens = nxt
            out.append(nxt)
        self._tok_dev.copy_(tokens)
        self._pos_dev.copy_(positions)
        return (torch.stack(out),)

    @torch.inference_mode()
    def _start_wave_spec(self, slots, ids, image_embeds, starts, seq_lens,
                         img_offsets, read_tab, write_tab, cow, samp,
                         full_ids, hint_rows):
        """``_start_wave`` plus the slots' token-history rows (the full
        prompt and the first token) and reference-hint rows."""
        firsts = self._start_wave(slots, ids, image_embeds, starts, seq_lens,
                                  img_offsets, read_tab, write_tab, cow,
                                  samp)
        rows = slots.long()
        self._buf_dev[rows] = full_ids
        self._buf_dev[rows, (starts + seq_lens).long()] = firsts
        self._hint_dev[rows] = hint_rows
        return firsts

    @staticmethod
    def _lookup(hay: torch.Tensor, t_prev2, t_prev, tokens, tri_ok):
        """n-gram matches of the two newest tokens in ``hay`` [S, W]:
        ``match[:, i]`` iff hay[i:i+2] == (t_prev, token), ``match3[:, i]``
        iff also hay[i-1] == t_prev2 (and ``tri_ok``). Both [S, W-1]."""
        match = ((hay[:, :-1] == t_prev[:, None])
                 & (hay[:, 1:] == tokens[:, None]))
        match3 = match.clone()
        match3[:, 1:] &= hay[:, :-2] == t_prev2[:, None]
        match3[:, 0] = False
        return match, match3 & tri_ok

    @staticmethod
    def _last(mask: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """Most recent True column of mask [S, W] (-1 when none): the JAX
        ``where(mask, idx, -1).max(axis=1)``."""
        return torch.where(mask, idx, torch.full_like(idx, -1)).amax(dim=1)

    @torch.inference_mode()
    def _decode_many_spec(self, k: int, kv_pages: int):
        """k speculative steps for all slots, zero-copy.

        Per step and slot: draft ``spec`` tokens by n-gram lookup over the
        slot's token history and its reference hint, verify them in ONE
        K+1-token forward whose K/V rows write through the page table and
        whose attention reads the pool (K4), and emit 1..spec+1 tokens via
        distribution-preserving acceptance. Frozen slots write to the trash
        page and re-emit EOS. Returns token blocks [k, S, spec+1] and emit
        counts [k, S]; state as ``_decode_many``, the histories in place
        too."""
        spec, k1, eos = self.spec, self.spec + 1, self.eos_token_id
        trash = self._trash_start
        dev = self.device
        buf, hint = self._buf_dev, self._hint_dev
        tokens, positions = self._tok_dev, self._pos_dev
        done = ~self._active_dev | (tokens == eos)
        cols = self._samp_cols(self._samp_dev)
        w, hw = buf.shape[1], hint.shape[1]
        iidx = torch.arange(w - 1, device=dev)[None, :]
        hidx = torch.arange(hw - 1, device=dev)[None, :]
        ar_spec = torch.arange(spec, device=dev)[None, :]
        ar_k1 = torch.arange(k1, device=dev)[None, :]
        # hint matches whose continuation starts with a REAL token
        good = torch.cat([hint[:, 2:] != -1,
                          torch.zeros((hint.shape[0], 1), dtype=torch.bool,
                                      device=dev)], dim=1)
        out_toks, out_counts = [], []
        for _ in range(k):
            # --- draft: prefer (1) the most recent TRIGRAM match with a
            # full continuation in history, then (2) the most recent
            # full-continuation bigram match, then (3) the most recent
            # bigram match of any kind
            pos_l = positions.long()
            t_prev = buf.gather(1, (pos_l - 1).clamp(min=0)[:, None])[:, 0]
            t_prev2 = buf.gather(1, (pos_l - 2).clamp(min=0)[:, None])[:, 0]
            # trigram context only meaningful with >= 2 tokens back
            tri_ok = (positions >= 2)[:, None]
            match, match3 = self._lookup(buf, t_prev2, t_prev, tokens,
                                         tri_ok)
            earlier = match & (iidx + 1 < pos_l[:, None])
            in_full = iidx + 1 + spec <= pos_l[:, None]
            j_tri = self._last(match3 & earlier & in_full, iidx)
            j_full = self._last(earlier & in_full, iidx)
            j_any = self._last(earlier, iidx)
            jstar = torch.where(j_tri >= 0, j_tri,
                                torch.where(j_full >= 0, j_full, j_any))
            src = (jstar + 2).clamp(0, w - spec)
            idx = src[:, None] + ar_spec
            in_hist = (jstar >= 0)[:, None] & (idx <= pos_l[:, None])
            drafts = torch.where(in_hist, buf.gather(1, idx),
                                 torch.full_like(buf[:, :spec], -1))
            # --- reference-hint lookup: a hint trigram match outranks the
            # slot's own history; only matches whose continuation starts
            # with a real token may displace an own-history draft
            hmatch, hmatch3 = self._lookup(hint, t_prev2, t_prev, tokens,
                                           tri_ok)
            jh3 = self._last(hmatch3 & good, hidx)
            jh2 = self._last(hmatch & good, hidx)
            jh_any = self._last(hmatch, hidx)
            jh = torch.where(jh3 >= 0, jh3,
                             torch.where(jh2 >= 0, jh2, jh_any))
            use_hint = ((jh3 >= 0) | ((j_tri < 0) & (jh2 >= 0))
                        | ((jstar < 0) & (jh_any >= 0)))
            hsrc = (jh + 2).clamp(0, hw - spec)
            drafts = torch.where(use_hint[:, None],
                                 hint.gather(1, hsrc[:, None] + ar_spec),
                                 drafts)
            # --- verify forward over [last, d_1..d_spec]: dead slots clamp
            # start to 0 (cheap attention, outputs discarded) and divert
            # their writes to the trash page
            block = torch.cat([tokens[:, None], drafts.clamp(min=0)], dim=1)
            start_abs = torch.where(done, torch.zeros_like(positions),
                                    positions.clamp(max=trash))
            logits, _ = detikzify.decode_verify_step_paged_zerocopy(
                self.params, self.cfg, block, start_abs, self.cache,
                self._tab_dev, dead=done, kv_pages=kv_pages,
                trash_row=trash, trash_page=self._trash_page)
            emitted, counts = speculative_accept(
                logits, drafts, self.generator, **cols,
                banned_tokens=self._banned())
            # --- EOS truncation + frozen-slot forcing
            hit = (emitted == eos) & (ar_k1 < counts[:, None])
            has_eos = hit.any(dim=1)
            first_eos = hit.to(torch.int32).argmax(dim=1).to(torch.int32)
            counts = torch.where(has_eos, first_eos + 1, counts)
            emitted = torch.where(
                done[:, None],
                torch.where(ar_k1 == 0, torch.full_like(emitted, eos),
                            torch.zeros_like(emitted)), emitted)
            counts = torch.where(done, torch.ones_like(counts), counts)
            adv = torch.where(done, torch.zeros_like(counts), counts)
            # --- token history update at positions + 1, the start clamped
            # into the row as jax.lax.dynamic_update_slice clamps it
            # (entries beyond the accepted count are masked by positions)
            at = (pos_l + 1).clamp(0, w - k1)[:, None] + ar_k1
            buf.scatter_(1, at, emitted)
            tokens = emitted.gather(
                1, (counts.long() - 1).clamp(min=0)[:, None])[:, 0]
            positions = positions + adv
            done = done | has_eos
            out_toks.append(emitted)
            out_counts.append(adv)
        self._tok_dev.copy_(tokens)
        self._pos_dev.copy_(positions)
        return torch.stack(out_toks), torch.stack(out_counts)

    @torch.inference_mode()
    def _copy_page(self, dst: int, src: int) -> None:
        """Snapshot one pool page (copy-on-write boundary for
        store_prefix): the slot keeps writing into its private boundary
        page, so the stored prefix gets its own copy."""
        self.cache.k[:, dst] = self.cache.k[:, src]
        self.cache.v[:, dst] = self.cache.v[:, src]

    # ------------------------------------------------------------------
    # prefix store
    # ------------------------------------------------------------------

    def _incref(self, pid: int) -> None:
        self._page_refs[pid] += 1

    def _decref(self, pid: int) -> None:
        self._page_refs[pid] -= 1
        if self._page_refs[pid] == 0:
            self._free_pages.append(int(pid))

    def _alloc_pages(self, n: int) -> Optional[List[int]]:
        """Pop n free pages (refcount 1), LRU-evicting stored prefixes as
        needed. Pages shared with live slots survive eviction."""
        while len(self._free_pages) < n and len(self._prefix_lru) > 0:
            self._drop_key(self._prefix_lru[0])
        if len(self._free_pages) < n:
            return None
        out = [self._free_pages.pop() for _ in range(n)]
        for pid in out:
            self._page_refs[pid] = 1
        return out

    def _drop_key(self, key) -> None:
        sp = self._prefix_store.pop(key, None)
        if key in self._prefix_lru:
            self._prefix_lru.remove(key)
        if sp is None:
            return
        sp.dropped = True   # external handles must not restore from it
        ikey = (sp.namespace, sp.length, hash(sp.token_ids))
        if self._prefix_index.get(ikey) == key:
            del self._prefix_index[ikey]
        lens = self._ns_lengths.get(sp.namespace)
        if lens is not None:
            lens[sp.length] -= 1
            if lens[sp.length] == 0:
                del lens[sp.length]
            if not lens:
                del self._ns_lengths[sp.namespace]
        for pid in sp.pages:
            self._decref(pid)

    @property
    def prefix_pages_used(self) -> int:
        """Distinct pages held by the store (shared pages count once)."""
        used = set()
        for sp in self._prefix_store.values():
            used.update(int(p) for p in sp.pages)
        return len(used)

    @property
    def num_free_pages(self) -> int:
        return len(self._free_pages)

    def store_prefix(self, key, rollout: Rollout,
                     length: Optional[int] = None,
                     namespace: object = None) -> Optional[StoredPrefix]:
        """Save rollout's first ``length`` tokens of KV under ``key``: pin
        the slot's pages covering the prefix and snapshot at most one
        non-aligned boundary page. Returns None when the pool cannot hold
        the boundary copy."""
        length = rollout.length if length is None else length
        if key in self._prefix_store:
            return self._prefix_store[key]
        ids = tuple(rollout.token_ids[:length])
        slot = rollout.slot
        assert self._table_live[slot], "rollout's slot has no live table"
        table = self._tables[slot]
        k_full = length // self.page
        pages = [int(p) for p in table[:k_full]]
        for pid in pages:       # pin before any allocation can evict
            self._incref(pid)
        if length % self.page:
            boundary = int(table[k_full])
            if k_full < self._shared_n[slot]:
                # a SHARED ancestor page is immutable: reference it directly
                self._incref(boundary)
                pages.append(boundary)
            else:
                new = self._alloc_pages(1)
                if new is None:
                    for pid in pages:
                        self._decref(pid)
                    return None
                self._copy_page(new[0], boundary)
                self.counters["prefix_copy_rows"] += length % self.page
                pages.append(new[0])
        self.counters["prefix_saves"] += 1
        sp = StoredPrefix(pages=tuple(pages), length=length,
                          token_ids=ids, namespace=namespace)
        self._prefix_store[key] = sp
        self._prefix_lru.append(key)
        self._prefix_index[(namespace, length, hash(ids))] = key
        self._ns_lengths.setdefault(namespace, {})
        self._ns_lengths[namespace][length] = \
            self._ns_lengths[namespace].get(length, 0) + 1
        return sp

    def get_prefix(self, key) -> Optional[StoredPrefix]:
        sp = self._prefix_store.get(key)
        if sp is not None and key in self._prefix_lru:
            self._prefix_lru.remove(key)
            self._prefix_lru.append(key)
        return sp

    def best_prefix(self, token_ids: Sequence[int], namespace: object = None
                    ) -> Optional[Tuple[object, StoredPrefix]]:
        """Longest stored prefix in ``namespace`` matching ``token_ids``; a
        hit refreshes its LRU position. Indexed by (namespace, length,
        hash): deepest stored length first, one hash probe each."""
        best = None
        ids = tuple(token_ids)
        lens = self._ns_lengths.get(namespace)
        if lens:
            for length in sorted(lens, reverse=True):
                if length > len(ids):
                    continue
                head = ids[:length]
                key = self._prefix_index.get((namespace, length, hash(head)))
                if key is not None:
                    sp = self._prefix_store[key]
                    if sp.token_ids == head:
                        best = (key, sp)
                        break
        if best is not None and best[0] in self._prefix_lru:
            self._prefix_lru.remove(best[0])
            self._prefix_lru.append(best[0])
        return best

    def has_prefix(self, key) -> bool:
        return key in self._prefix_store

    def drop_prefix(self, key) -> None:
        """Evict one stored prefix (frees its unshared pages)."""
        self._drop_key(key)

    def drop_namespace(self, namespace: object) -> None:
        """Evict all prefixes belonging to one generator/image."""
        for key in [k for k, sp in self._prefix_store.items()
                    if sp.namespace == namespace]:
            self._drop_key(key)

    # ------------------------------------------------------------------
    # rollout lifecycle
    # ------------------------------------------------------------------

    def _launch_group(self, rollouts: List[Rollout],
                      prefixes: List[Optional[StoredPrefix]],
                      image_embeds: Optional[torch.Tensor],
                      hints: Optional[List[Optional[Sequence[int]]]],
                      span) -> None:
        """Run ONE fused start for these rollouts. Each row may carry its
        own stored prefix (or none) and, on a speculative engine, its own
        draft hint; first tokens arrive lazily. ``span`` is the caller's
        ``engine.start`` span; the prefill launches and the first tokens'
        draw are an ``engine.prefill`` span inside it."""
        b = len(rollouts)
        page, m_cap = self.page, self._m_cap
        starts_l: List[int] = []
        tails: List[List[int]] = []
        for ro, pf in zip(rollouts, prefixes):
            start_pos = 0
            if pf is not None:
                start_pos = min(pf.length, len(ro.token_ids) - 1)
                self.counters["prefix_starts"] += 1
            starts_l.append(start_pos)
            tails.append(ro.token_ids[start_pos:])
        bucket = _bucket(max(len(t) for t in tails), self.max_len)
        for i, ro in enumerate(rollouts):
            # keep every written row inside [0, max_len): rows beyond would
            # divert to the trash page and lose real content. Re-prefill a
            # bit more of the (matching) prefix instead.
            if starts_l[i] + bucket > self.max_len:
                starts_l[i] = self.max_len - bucket
                tails[i] = ro.token_ids[starts_l[i]:]

        # --- page tables: shared stored pages for the restored prefix,
        # fresh private pages for everything else. Pin EVERY page the wave
        # READS (full pages that join the slot table AND the non-aligned
        # boundary page the COW gather copies from) before any allocation:
        # allocating may LRU-evict a stored prefix a row of this very wave
        # is restoring from.
        shared_rows: List[List[int]] = []
        boundary_pins: List[int] = []
        for i, (ro, pf) in enumerate(zip(rollouts, prefixes)):
            k_full = starts_l[i] // page
            shared = ([int(p) for p in pf.pages[:k_full]]
                      if pf is not None else [])
            for pid in shared:
                self._incref(pid)
            if pf is not None:
                n_read = -(-starts_l[i] // page)
                for pid in pf.pages[k_full:n_read]:
                    self._incref(int(pid))
                    boundary_pins.append(int(pid))
            shared_rows.append(shared)

        read_need = max((-(-s // page) for s in starts_l), default=0)
        pb = 0
        while pb < read_need:        # power-of-two page-count buckets
            pb = max(1, pb * 2)
        pb = min(pb, m_cap)
        read_tab = np.full((b, pb), self._trash_page, np.int32)
        write_tab = np.zeros((b, m_cap), np.int32)
        cow = np.zeros((b,), np.int32)
        installed: List[int] = []     # rows whose tables are already live
        for i, (ro, pf) in enumerate(zip(rollouts, prefixes)):
            slot, shared = ro.slot, shared_rows[i]
            assert not self._table_live[slot], "slot table leak"
            priv = self._alloc_pages(m_cap - len(shared))
            if priv is None:
                # roll back EVERYTHING this call did: wave pins, and the
                # tables already installed for earlier rows
                for j in installed:
                    s = rollouts[j].slot
                    for pid in self._tables[s]:
                        self._decref(int(pid))
                    self._table_live[s] = False
                for j, row in enumerate(shared_rows):
                    if j in installed:
                        continue      # already dropped via the table above
                    for pid in row:
                        self._decref(pid)
                for pid in boundary_pins:
                    self._decref(pid)
                raise RuntimeError("page pool exhausted")
            installed.append(i)
            table = shared + priv
            self._tables[slot] = table
            self._table_live[slot] = True
            self._shared_n[slot] = len(shared)
            write_tab[i] = table
            cow[i] = len(shared) * page
            self.counters["restore_cow_rows"] += starts_l[i] - int(cow[i])
            if pf is not None:
                n_read = -(-starts_l[i] // page)
                for j in range(pb):
                    read_tab[i, j] = (pf.pages[j] if j < n_read
                                      else table[j])
            else:
                read_tab[i, :] = table[:pb]

        # image tokens already in the restored cache before each block: a
        # re-prefilled image token must receive its TRUE position's embedding
        image_tok = self.cfg.image_token_id
        img_offsets = [ro.token_ids[:s].count(image_tok)
                       for ro, s in zip(rollouts, starts_l)]
        ids = np.zeros((b, bucket), np.int32)
        for i, t in enumerate(tails):
            ids[i, :len(t)] = t
        if image_embeds is None:
            image_embeds = torch.zeros(
                (1, self.cfg.image_seq_len, self.cfg.text.hidden_size),
                dtype=self.params.dtype, device=self.device)
        if image_embeds.shape[0] == 1 and b > 1:
            image_embeds = image_embeds.expand(b, *image_embeds.shape[1:])

        slots = [ro.slot for ro in rollouts]
        self.counters["starts"] += b
        self.counters["start_dispatches"] += 1
        rows = sum(len(t) for t in tails)
        self.counters["prefill_tokens"] += rows
        span.set(rows=rows)
        self.counters["prefill_tokens_saved"] += sum(starts_l)
        put = self._put
        args = (put(slots), put(ids), image_embeds, put(starts_l),
                put([len(t) for t in tails]), put(img_offsets), put(read_tab),
                put(write_tab), put(cow),
                put(self._samp_host[slots], torch.float32))
        if self.spec > 0:
            full_ids = np.full((b, self._buf_dev.shape[1]), -1, np.int32)
            hint_rows = np.full((b, self._hint_dev.shape[1]), -1, np.int32)
            for i, ro in enumerate(rollouts):
                full_ids[i, :len(ro.token_ids)] = ro.token_ids
                h = hints[i] if hints is not None else None
                if h:
                    n = min(len(h), hint_rows.shape[1])
                    hint_rows[i, :n] = list(h)[:n]
                    ro.hinted = True
            args += (put(full_ids), put(hint_rows))
        ids_attr = ({"rid": rollouts[0].rid} if b == 1
                    else {"rids": [ro.rid for ro in rollouts]})
        wave = self._start_wave_spec if self.spec > 0 else self._start_wave
        with profiling.span("engine.prefill", bucket=bucket, **ids_attr):
            firsts = wave(*args)
        if self.spec > 0:
            # the start wave rewrote these slots' history rows in full
            self._buf_stale[np.asarray(slots)] = False
        fetch = _Fetch(firsts, pinned=self.pipelined, counters=self.counters)
        for i, ro in enumerate(rollouts):
            self._rollouts[ro.slot] = ro
            self._active[ro.slot] = True
            self._first_pending[ro.slot] = (fetch, i)
        # boundary pages were only read by the wave just enqueued; anything
        # that recycles them writes in a LATER launch on the same stream
        for pid in boundary_pins:
            self._decref(pid)

    def _make_rollout(self, token_ids: Sequence[int], max_new_tokens: int,
                      sampling: Optional[SamplingParams],
                      on_token) -> Rollout:
        slot = self._free_slots.pop()
        sp = sampling if sampling is not None else self.sampling
        self._samp_host[slot] = (sp.temperature, sp.top_p, float(sp.top_k))
        return Rollout(slot=slot, prompt_len=len(token_ids),
                       token_ids=list(token_ids),
                       max_new_tokens=max(
                           min(max_new_tokens,
                               self._trash_start - len(token_ids)), 1),
                       on_token=on_token, rid=next(_RIDS))

    @staticmethod
    def _check_prefix(token_ids: Sequence[int],
                      prefix: Optional[StoredPrefix]
                      ) -> Optional[StoredPrefix]:
        if prefix is None or prefix.dropped:
            return None     # evicted: its pages may have been recycled
        assert tuple(token_ids[:prefix.length]) == prefix.token_ids, \
            "prefix mismatch"
        return prefix

    def start(
        self,
        token_ids: Sequence[int],
        image_embeds: Optional[torch.Tensor] = None,
        *,
        max_new_tokens: int = 1024,
        on_token: Optional[Callable[[int], None]] = None,
        prefix: Optional[StoredPrefix] = None,
        lazy: bool = False,
        sampling: Optional[SamplingParams] = None,
        hint: Optional[Sequence[int]] = None,
    ) -> Rollout:
        """Begin generating after ``token_ids``; returns a Rollout handle.
        With ``lazy=True`` the first token is fetched at the next
        ``step()``/``flush()``. ``hint`` (speculative engines only) is
        reference text for draft lookup -- e.g. the parent rollout's
        continuation in MCTS."""
        if not self._free_slots:
            raise RuntimeError("no free slots")
        with profiling.span("engine.start") as span:
            token_ids = list(token_ids)
            prefix = self._check_prefix(token_ids, prefix)
            ro = self._make_rollout(token_ids, max_new_tokens, sampling,
                                    on_token)
            span.set(rid=ro.rid, slot=ro.slot)
            try:
                self._launch_group([ro], [prefix], image_embeds, [hint],
                                   span)
            except BaseException:
                self._free_slots.append(ro.slot)   # never launched: return it
                raise
            if not lazy:
                self.flush()
        return ro

    def start_many(
        self,
        prompts: Sequence[Sequence[int]],
        image_embeds: Optional[torch.Tensor] = None,  # [B,seq,H] or [1,..]
        *,
        max_new_tokens=1024,                          # int or per-prompt seq
        prefix: Optional[StoredPrefix] = None,        # shared by all
        prefixes: Optional[Sequence[Optional[StoredPrefix]]] = None,
        sampling: Optional[SamplingParams] = None,
        on_token: Optional[Callable[[int], None]] = None,
        hints: Optional[Sequence[Optional[Sequence[int]]]] = None,
    ) -> List[Rollout]:
        """Start a BURST of rollouts, chunked into power-of-two groups (one
        fused start each), with per-prompt draft ``hints`` on a speculative
        engine. Starts are lazy."""
        b = len(prompts)
        assert b >= 1
        if b > len(self._free_slots):
            raise RuntimeError("no free slots")
        if prefixes is None:
            prefixes = [prefix] * b
        assert len(prefixes) == b
        pfs = [self._check_prefix(p, pf)
               for p, pf in zip(prompts, prefixes)]
        mnt = (list(max_new_tokens)
               if isinstance(max_new_tokens, (list, tuple))
               else [max_new_tokens] * b)
        assert len(mnt) == b
        rollouts = [self._make_rollout(list(p), m, sampling, on_token)
                    for p, m in zip(prompts, mnt)]
        if (image_embeds is not None and image_embeds.shape[0] == 1
                and b > 1):
            image_embeds = image_embeds.expand(b, *image_embeds.shape[1:])
        # pin every restored prefix's pages for the WHOLE burst: an early
        # chunk's allocation may LRU-evict a prefix a later chunk restores
        burst_pins = [int(p) for pf in pfs if pf is not None
                      for p in pf.pages]
        for pid in burst_pins:
            self._incref(pid)
        i = 0
        try:
            while i < b:
                n = 1
                while n * 2 <= b - i:  # largest power of two that fits
                    n *= 2
                emb = (None if image_embeds is None
                       else image_embeds[i:i + n])
                group = rollouts[i:i + n]
                with profiling.span("engine.start",
                                    rids=[ro.rid for ro in group],
                                    slots=[ro.slot for ro in group]) as span:
                    self._launch_group(
                        group, pfs[i:i + n], emb,
                        None if hints is None else list(hints[i:i + n]),
                        span)
                i += n
        except BaseException:
            for ro in rollouts[i:]:    # never launched: return their slots
                self._free_slots.append(ro.slot)
            raise
        finally:
            for pid in burst_pins:
                self._decref(pid)
        return rollouts

    def _fetch_firsts(self) -> List[Tuple[int, int]]:
        out = [(slot, int(fetch.numpy()[0][i]))
               for slot, (fetch, i) in self._first_pending.items()]
        self._first_pending.clear()
        return out

    def flush(self) -> List[Rollout]:
        """Fetch pending first tokens to the host; returns rollouts that
        finished as a result (eos/abort/budget)."""
        finished = []
        for slot, tok in self._fetch_firsts():
            ro = self._rollouts.get(slot)
            if ro is None:
                continue
            self._accept_token(ro, int(tok))
            if ro.finished:
                finished.append(ro)
        return finished

    def _banned(self) -> tuple:
        return (self.cfg.image_token_id,)

    def _suppress(self) -> tuple:
        return (self.eos_token_id,)

    def _accept_token(self, ro: Rollout, tok: int) -> None:
        ro.token_ids.append(tok)
        ro.new_tokens += 1
        if ro.on_token is not None:
            ro.on_token(tok)
        if tok == self.eos_token_id:
            ro.finished, ro.finish_reason = True, "eos"
        elif ro.new_tokens >= ro.max_new_tokens:
            ro.finished, ro.finish_reason = True, "length"
        elif ro.aborted:
            ro.finished, ro.finish_reason = True, "abort"
        if ro.finished:
            self._active[ro.slot] = False

    def abort(self, ro: Rollout) -> None:
        ro.aborted = True

    def release(self, ro: Rollout) -> None:
        if ro.slot in self._rollouts and self._rollouts[ro.slot] is ro:
            del self._rollouts[ro.slot]
            self._active[ro.slot] = False
            self._first_pending.pop(ro.slot, None)
            self._free_slots.append(ro.slot)
            if self._table_live[ro.slot]:
                # drop the slot's page references; pages pinned by stored
                # prefixes survive. Stale device-table entries are safe:
                # released slots only ever write through the trash page.
                for pid in self._tables[ro.slot]:
                    self._decref(int(pid))
                self._table_live[ro.slot] = False

    @property
    def num_active(self) -> int:
        return int(self._active.sum())

    @property
    def num_free_slots(self) -> int:
        """Slots available for ``start``/``start_many`` right now."""
        return len(self._free_slots)

    # ------------------------------------------------------------------
    # stepping
    # ------------------------------------------------------------------

    def _kv_limit(self, k: int, speculative: bool) -> int:
        """Smallest bucket covering every live slot's rows after k more
        steps (+ slack for pipelined dispatch: the block in flight advances
        up to decode_block tokens -- times spec+1 when IT speculated --
        beyond the host's stale lengths; the slack therefore follows the
        PREVIOUS dispatch's mode too, not just this one's: per-class gating
        can flip spec->plain while a speculative block is in flight)."""
        live = [len(ro.token_ids) for slot, ro in self._rollouts.items()
                if self._active[slot]]
        if not live:
            return self.max_len
        slack = 1 + (self.spec if (speculative or self._last_dispatch_spec)
                     else 0)
        need = max(live) + k + (self.decode_block * slack
                                if self.pipelined else 0)
        for b in BUCKETS:
            if need <= b <= self.max_len:
                return b
        return self.max_len

    def _kv_pages(self, k: int, speculative: bool) -> int:
        """Attended-page bound for a k-step block: the bucketed token limit
        in pages. Speculative blocks advance up to spec+1 tokens a step and
        also need the verify window's spec+1 rows clear of the bound."""
        per_step = 1 + (self.spec if speculative else 0)
        return -(-self._kv_limit(k * per_step + per_step, speculative)
                 // self.page)

    @property
    def _spec_on(self) -> bool:
        """Whether ANY draft class currently speculates."""
        return self.spec > 0 and any(st["on"]
                                     for st in self._spec_cls.values())

    def _use_spec(self) -> bool:
        """Dispatch decision: run the speculative block iff some ACTIVE
        slot's draft class is enabled. The verify forward's cost is per
        dispatch, not per slot, so once one slot justifies it, slots of a
        disabled class draft too -- their accepted tokens are free upside
        and keep their class's window measured (how a recovered class
        re-enables without an explicit probe)."""
        if self.spec <= 0:
            return False
        return any(self._spec_cls["hint" if ro.hinted else "plain"]["on"]
                   for slot, ro in self._rollouts.items()
                   if self._active[slot])

    def _resync_buf(self) -> None:
        """Re-upload the device token-history rows of slots whose history
        went stale: plain blocks (dispatched while every class was bailed
        out) advance positions without writing ``_buf_dev``, so a later
        speculative block would draft against holes. The host's accepted
        ``token_ids`` are the truth for live slots. Under ``pipelined=True``
        the host lags the block in flight by up to one block, so rows the
        in-flight PLAIN block advanced past stay -1 for this dispatch -- a
        bounded acceptance dent, never a correctness fault (the n-gram
        search finds no match there). ``_consume`` re-marks those slots
        stale when that plain block's tokens land, so the NEXT resync heals
        the hole from the then-complete host ids."""
        stale = [s for s in np.flatnonzero(self._buf_stale)
                 if self._active[s] and s in self._rollouts]
        if not stale:
            return
        width = self._buf_dev.shape[1]
        rows = np.full((len(stale), width), -1, np.int32)
        for i, s in enumerate(stale):
            ids = self._rollouts[s].token_ids[:width]
            rows[i, :len(ids)] = ids
        self._buf_dev[self._put(stale).long()] = self._put(rows)
        self._buf_stale[np.asarray(stale)] = False
        self.counters["buf_resyncs"] += 1

    def _dispatch(self, k: int) -> None:
        """Launch one decode block (speculative or plain), start the fetch
        of its tokens and snapshot which rollout owned each slot, as
        ``_inflight``; the block's page count is ``_last_kv_pages``.
        Pipelined, nothing here waits on the device; eager, the two
        uploads do."""
        self.counters["decode_dispatches"] += 1
        self.counters["decode_steps"] += k
        use_spec = self._use_spec()
        self._upload(self._active_dev, self._active)
        self._upload(self._samp_dev, self._samp_host)
        kv_pages = self._kv_pages(k, use_spec)
        if use_spec:
            self._resync_buf()
            toks_dev, counts_dev = self._block(True, k, kv_pages)
        else:
            counts_dev = None
            (toks_dev,) = self._block(False, k, kv_pages)
            if self.spec > 0:
                # positions advanced without history writes: these rows
                # must be resynced before the next speculative block
                self._buf_stale[self._active] = True
        self._last_dispatch_spec = use_spec
        self._last_kv_pages = kv_pages
        owners = {slot: ro for slot, ro in self._rollouts.items()
                  if self._active[slot]}
        calls = self._block_calls
        self._inflight = (_Fetch(toks_dev, counts_dev, pinned=self.pipelined,
                                 overwritten=lambda: self._block_calls
                                 != calls, counters=self.counters),
                          k, owners)

    def _consume(self, inflight) -> List[Rollout]:
        """Wait for a dispatched block's tokens (and any pending first
        tokens) and deliver them to their rollouts."""
        firsts = self._fetch_firsts()
        spec_run = False
        if inflight is None:
            toks, counts, k, owners = None, None, 0, {}
        else:
            fetch, k, owners = inflight
            toks, counts = fetch.numpy()         # [k, S] or [k, S, spec+1]
            if counts is None:                   # plain: 1 token a step
                toks = toks[:, :, None]
                counts = np.ones(toks.shape[:2], np.int32)
            else:
                spec_run = True

        finished = []
        for slot, tok in firsts:
            ro = self._rollouts.get(slot)
            if ro is None:
                continue
            self._accept_token(ro, int(tok))
            if ro.finished:
                finished.append(ro)
        for slot, ro in owners.items():
            # skip slots whose rollout was replaced/finished since dispatch
            if self._rollouts.get(slot) is not ro or ro.finished:
                continue
            cls = self._spec_cls["hint" if ro.hinted else "plain"] \
                if self.spec > 0 else None
            for i in range(k):
                if spec_run:
                    # acceptance accounting uses the DEVICE counts, not the
                    # host-truncated token loop below: budget cutoffs would
                    # otherwise report rate 1.0 for high-acceptance slots
                    n = int(counts[i, slot])
                    self.counters["spec_steps"] += 1
                    self.counters["spec_tokens"] += n
                    if ro.hinted:
                        self.counters["spec_steps_hint"] += 1
                        self.counters["spec_tokens_hint"] += n
                    cls["win"][0] += 1
                    cls["win"][1] += n
                    if not cls["on"]:
                        # ride-along slot-step while bailed out: the
                        # recovery clock ticks on ANY slot-step
                        cls["cool"] += 1
                elif cls is not None and not cls["on"]:
                    # plain slot-step while this class is bailed out
                    cls["cool"] += 1
                for j in range(int(counts[i, slot])):
                    self.counters["decode_tokens"] += 1
                    self._accept_token(ro, int(toks[i, slot, j]))
                    if ro.finished:
                        finished.append(ro)
                        break
                if ro.finished:
                    break
        if inflight is not None and not spec_run and self.spec > 0:
            # a PLAIN block's tokens just landed in the host's token_ids,
            # but the device history never saw them (plain blocks do not
            # write it). Re-mark the block's slots stale: under
            # ``pipelined=True`` a speculative dispatch may have resynced
            # and cleared them from the host's INCOMPLETE ids while this
            # block was in flight, which would leave a lasting -1 hole.
            # Eager stepping marked them at dispatch: a no-op there.
            for slot in owners:
                self._buf_stale[slot] = True
        self._update_spec_gating()
        return finished

    @property
    def spec_rate(self) -> float:
        """Measured speculative tokens per step (1 = no draft ever
        accepted, spec+1 = every draft accepted)."""
        steps = self.counters["spec_steps"]
        return self.counters["spec_tokens"] / steps if steps else 0.0

    def _update_spec_gating(self) -> None:
        """Per-class draft gating on SLIDING windows of 1024 slot-steps.

        A class falls back to plain decoding after TWO consecutive
        below-``spec_min_rate`` windows (a single cold-start window must
        not bail a class out), and each class decides alone. Bail-outs are
        RECOVERABLE: after ``backoff`` plain slot-steps the class
        re-enables for a probe; one bad probe window re-disables it and
        doubles the backoff (capped), a good window resets both streak and
        backoff."""
        if self.spec <= 0 or self.spec_min_rate <= 0:
            return
        for st in self._spec_cls.values():
            if not st["on"]:
                steps, toks = st["win"]
                if steps >= 1024:
                    # ride-along window (this class's slots kept drafting
                    # because ANOTHER class held _use_spec() true): a
                    # clearing rate re-enables with a clean slate; a failing
                    # one is DISCARDED, and the class stays off
                    st["win"] = [0, 0]
                    if toks / steps >= self.spec_min_rate:
                        st["on"], st["cool"], st["bad"] = True, 0, 0
                        st["backoff"], st["probe"] = 4096, False
                        continue
                if st["cool"] >= st["backoff"]:
                    # probe re-enable: bad=1 so a single failing window
                    # re-disables; the window starts EMPTY so the probe is
                    # judged on fresh data
                    st["on"], st["cool"], st["bad"] = True, 0, 1
                    st["probe"], st["win"] = True, [0, 0]
                continue
            steps, toks = st["win"]
            if steps < 1024:
                continue
            st["win"] = [0, 0]
            if toks / steps < self.spec_min_rate:
                st["bad"] += 1
                if st["bad"] >= 2:
                    st["on"] = False
                    st["cool"] = 0
                    if st["probe"]:     # failed probe: wait longer next time
                        st["backoff"] = min(st["backoff"] * 2, 65536)
            else:
                st["bad"] = 0
                st["backoff"] = 4096
                st["probe"] = False

    def step(self, k: Optional[int] = None) -> List[Rollout]:
        """Advance decoding by one block of k steps (default
        ``decode_block``). Returns rollouts that finished.

        Eager by default: launch a block, wait for its tokens. With
        ``pipelined=True`` block N+1 launches BEFORE block N's tokens are
        read -- the device runs while the host handles tokens, and finishes
        are seen one block later (the first call after a start only primes
        the pipeline and returns ``[]``).

        One ``engine.step`` span: dispatch, uploads, the wait for the
        block's tokens and their delivery; ``captured`` says whether this
        call captured a graph."""
        k = self.decode_block if k is None else k
        with profiling.span("engine.step", k=k) as span:
            captures = self.graph_stats["captures"]
            prev = None
            if self.pipelined:
                prev, self._inflight = self._inflight, None
            if self._active.any():
                self._dispatch(k)
                span.set(kv_pages=self._last_kv_pages,
                         active=len(self._inflight[2]))
            if not self.pipelined:
                prev, self._inflight = self._inflight, None
                out = self._consume(prev)
            elif prev is None and self._inflight is not None \
                    and not self._first_pending:
                out = []                 # pipeline primed; tokens next call
            else:
                out = self._consume(prev)
            span.set(captured=self.graph_stats["captures"] > captures)
        return out

    @property
    def has_inflight(self) -> bool:
        return self._inflight is not None

    def flush_steps(self) -> List[Rollout]:
        """Drain the block in flight without dispatching a new one."""
        with profiling.span("engine.step", k=0, captured=False):
            prev, self._inflight = self._inflight, None
            return self._consume(prev)

    def run(self, max_steps: Optional[int] = None) -> List[Rollout]:
        """Step until every rollout finishes; returns them all."""
        done: List[Rollout] = []
        steps = 0
        while (self._active.any() or self._first_pending
               or self._inflight is not None):
            done.extend(self.step())
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return done

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def encode_image(self, pixel_values, adapter_inputs=None) -> torch.Tensor:
        """[B,H,W,C] (numpy or tensor) -> projected image tokens (vision
        runs once per image). With ``adapter_inputs`` (a
        ``siglip.AdapterInputs``) the tower is caption-conditioned through
        the TikZero cross-attention blocks. One ``tower`` span; pixels
        from the host go up as a pageable copy, which waits for the
        device: one ``counters["host_syncs"]`` (on the CPU too)."""
        with profiling.span("tower", images=len(pixel_values)):
            if (not torch.is_tensor(pixel_values)
                    or pixel_values.device.type == "cpu"):
                self.counters["host_syncs"] += 1
            pv = torch.as_tensor(np.asarray(pixel_values)
                                 if not torch.is_tensor(pixel_values)
                                 else pixel_values, device=self.device)
            return detikzify.encode_image(self.params, self.cfg, pv,
                                          adapter=adapter_inputs)
