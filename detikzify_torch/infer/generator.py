"""MCTS-driven TikZ generation against the decode engine (counterpart of
``detikzify_tpu/infer/generator.py``).

Search semantics are the reference's (progressive widening, line-boundary
segmentation, failed-rollout caching, error-line-bounded expansion, dynamic
score normalisation), executed the JAX package's way:

  * rollouts run on ``DecodeEngine`` slots with tree-prefix KV reuse: a
    child rollout restores its deepest stored ancestor's pages and
    prefills only the tail;
  * LaTeX compiles run through the ``CompileService`` worker pool;
  * SelfSim scores a whole completion wave in one batched encoder pass
    (``evaluate.imagesim``), enqueued on the card while decode goes on.

``simulate(parallelism=1)`` keeps the reference's sequential order;
``parallelism > 1`` runs that many expansions at once over the engine's
slots, with virtual loss to spread the selections. On a speculative engine
each child rollout drafts from the continuation of the rollout its node was
cut from (``_hint_for``). With a caption (``text``) and the TikZero
adapter's ``AdapterBundle`` the vision tower is caption-conditioned; a
caption alone generates from the adapter's learnable blank image.
``simulate(shared_engine=True)`` serves a timesliced scheduler
(``serve.InferenceServer``) that shares the engine between searches and
sampling waves: it re-reads ``parallelism`` on every loop trip and yields
``STALLED`` on a trip that ends with nothing in flight (other users may
hold every slot).
"""
from __future__ import annotations

import concurrent.futures as _cf
import dataclasses
import inspect
import itertools
import time
from collections import deque
from math import sqrt
from typing import Dict, Generator, List, Optional, Tuple

import numpy as np
import torch

from ..engine import DecodeEngine
from ..mcts import MonteCarlo, Node, Normalizer
from ..ops.sampling import make_newline_table
from ..processing import DetikzifyProcessor
from ..utils import profiling
from ..utils.functools import cache_cast
from ..utils.generation import ExplicitAbort
from .tikz import CompileService, TikzDocument

Numeric = float

#: Yielded by ``simulate(..., shared_engine=True)`` on a loop trip that
#: ends with nothing in flight: OTHER users of the shared engine (paused
#: sibling searches in a timesliced scheduler) may hold every slot, and
#: only their turns release them, so the scheduler must advance its other
#: tasks. As in the JAX loop, a trip between two of the search's own waves
#: yields it too. Never yielded from an exclusively owned engine.
STALLED = object()


@dataclasses.dataclass(frozen=True)
class NodeState:
    token_ids: Tuple[int, ...]
    num_lines: int = 0

    def __eq__(self, other):
        return (isinstance(other, NodeState)
                and self.token_ids == other.token_ids)

    def __hash__(self):
        return hash(self.token_ids)


class WideNode(Node):
    """Node with progressive widening: every real node carries a paired
    widen-node child meaning "sample a fresh rollout from this state"
    (reference ``WideNode``, generate.py:49-82)."""

    def __init__(self, state: NodeState, exploration: float = 0.6,
                 is_widen_node: bool = False):
        super().__init__(state, exploration)
        self.is_widen_node = is_widen_node
        # full token sequence of the rollout this node was cut from: the
        # suffix beyond the node's own prefix is REFERENCE TEXT for
        # speculative draft lookup in child rollouts (engine hints)
        self.rollout_tokens: Optional[Tuple[int, ...]] = None
        self.update_policy_value(1.0)
        if not is_widen_node:
            self.add_child(WideNode(state, exploration, is_widen_node=True))

    def add_child(self, child: "Node") -> None:
        self.expanded = self.expanded or not child.is_widen_node
        super().add_child(child)

    @property
    def token_ids(self) -> Tuple[int, ...]:
        return self.state.token_ids

    @property
    def num_lines(self) -> int:
        return self.state.num_lines


_gen_counter = itertools.count()


def _takes(fn, name: str) -> bool:
    """Whether ``fn`` accepts the keyword ``name``, by name or through
    ``**kwargs``."""
    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False
    return name in params or any(
        p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values())


class DetikzifyGenerator:
    """One image/text -> TikZ session: one-shot sampling or MCTS search."""

    def __init__(
        self,
        engine: DecodeEngine,
        processor: DetikzifyProcessor,
        image=None,                     # preprocessed PIL image or None
        text: Optional[str] = None,
        metric=None,                    # ImageSim-like or None (fast mode)
        compile_timeout: float = 60.0,
        mcts_timeout: Optional[float] = None,
        exploration: float = 0.6,
        strict: bool = False,
        control: Optional[ExplicitAbort] = None,
        compile_service: Optional[CompileService] = None,
        max_length: Optional[int] = None,
        max_new_tokens: Optional[int] = None,
        on_token=None,                  # per-token streaming callback
        adapter=None,                   # AdapterBundle for text conditioning
        sampling=None,                  # SamplingParams override (per-call)
        on_tick=None,                   # per-iteration scheduler hook
        image_embeds=None,              # precomputed [1, N, D] image tokens
    ):
        if text is not None and adapter is None:
            raise ValueError("textual inputs require an adapter bundle")
        self.engine = engine
        self.processor = processor
        self.image = image
        self.text = text
        self.metric = metric
        self.compile_timeout = compile_timeout
        self.mcts_timeout = mcts_timeout
        self.exploration = exploration
        self.strict = strict
        self.control = control or ExplicitAbort()
        self.compiler = compile_service or CompileService(
            timeout=compile_timeout)
        self._own_compiler = compile_service is None
        self.on_token = on_token
        self.sampling = sampling        # None -> engine defaults
        # host-side scheduler hook, called at the head of each sequential
        # expansion and of each loop trip of the parallel search, as the
        # JAX generator calls it; an exception it raises ends the search
        self.on_tick = on_tick
        # batched wave scoring needs score_against_async, and a
        # text-conditioned search its ``text`` keyword too; other metrics
        # keep the per-render score() path
        self._wave_scoring_ok = hasattr(metric, "score_against_async")
        if self._wave_scoring_ok and text is not None:
            try:
                sig = inspect.signature(metric.score_against_async)
                self._wave_scoring_ok = "text" in sig.parameters
            except (TypeError, ValueError):
                self._wave_scoring_ok = False
        # per-render score(): the caption keyword where the metric takes
        # it, decided once here so an error inside the metric propagates
        self._score_takes_text = (hasattr(metric, "score")
                                  and _takes(metric.score, "text2"))
        # live concurrency target of _simulate_parallel, re-read on every
        # loop trip: a scheduler sharing the engine between searches grows
        # or shrinks each search's slot share mid-run
        self.parallelism = 1
        self.namespace = ("gen", next(_gen_counter))

        # root prompt mirrors reference generate.py:178-186: image tokens
        # only (no BOS); TikZero+ (model_expects_text) appends the caption
        # and a BOS separator
        expects_text = getattr(processor, "model_expects_text", False)
        prompt_text = text if (text is not None and expects_text) else None
        out = processor(images=image,
                        text=prompt_text if image is not None
                        else (prompt_text or ""),
                        add_bos_token=prompt_text is not None,
                        skip_pixels=image_embeds is not None)
        root_ids = tuple(int(t) for t in out.input_ids[0])
        self.max_length = min(max_length or processor.model_max_length,
                              engine.max_len - 1)
        self.adapter = adapter

        pixel_values = out.pixel_values
        if text is not None and pixel_values is None:
            # a caption alone, and a processor that laid out no image (an
            # AdapterProcessor puts DUMMY_IMAGE and its tokens in place
            # itself): image tokens for the adapter's learnable blank image
            from ..models.adapter import dummy_pixels

            pixel_values = dummy_pixels(adapter.adapter_params, 1)
            root_ids = tuple(
                [processor.image_token_id] * processor.image_seq_len
                + list(root_ids))
        if max_new_tokens is not None:
            # reference generate() semantics: cap NEW tokens past the final
            # root prompt (a caption alone prepends image tokens above)
            self.max_length = min(self.max_length,
                                  len(root_ids) + max_new_tokens)

        self.image_embeds = image_embeds
        if self.image_embeds is None and pixel_values is not None:
            self.image_embeds = engine.encode_image(
                pixel_values, adapter_inputs=None if text is None
                else adapter.adapter_inputs([text]))

        self.solution: deque = deque(maxlen=1)
        self.failed_rollouts: Dict[NodeState, List[WideNode]] = {}
        self.norm = Normalizer()
        self.montecarlo = MonteCarlo(
            WideNode(NodeState(root_ids, 0), exploration=exploration))
        self.montecarlo.child_finder = self.child_finder

        self._newline = self._build_newline_table()
        self._pending_rollout = None    # engine Rollout awaiting prefix save

        self.decode = cache_cast(lambda ids: tuple(ids))(self.decode)
        self.score = cache_cast(lambda img: img.tobytes())(self.score)

        # the search's phases are spans (``utils.profiling``): mcts.launch,
        # .step, .resolve, .complete, .dispatch, .wait, .score, .compile
        self.stats = {"rollouts": 0, "rollout_tokens": 0, "prefix_hits": 0,
                      "prefix_tokens_saved": 0,
                      # selections that landed on a terminal state, and
                      # wave renders whose score was already memoised
                      "terminal_revisits": 0, "score_memo_hits": 0,
                      # iterations that decoded while compile or score work
                      # was pending, and the most expansions in flight
                      "overlap_ticks": 0, "max_inflight": 0}

    def close(self) -> None:
        self.engine.drop_namespace(self.namespace)
        if self._own_compiler:
            self.compiler.shutdown()

    # ------------------------------------------------------------------

    def _build_newline_table(self):
        tok = self.processor.tokenizer
        cached = getattr(tok, "_detikzify_newline_table", None)
        if cached is not None:
            return cached
        vocab_size = getattr(tok, "vocab_size", None) or len(tok.get_vocab())
        counts, ends = make_newline_table(tok, vocab_size)
        table = {i: (int(counts[i]), bool(ends[i]))
                 for i in np.nonzero(counts)[0]}
        try:
            tok._detikzify_newline_table = table  # one scan per tokenizer
        except AttributeError:
            pass
        return table

    @property
    def root(self) -> WideNode:
        return self.montecarlo.root_node  # type: ignore[return-value]

    def _start(self, ids: List[int], hint=None):
        found = self.engine.best_prefix(ids, namespace=self.namespace)
        prefix = found[1] if found else None
        if prefix is not None:
            self.stats["prefix_hits"] += 1
            self.stats["prefix_tokens_saved"] += prefix.length
        # pass `hint` only when set: duck-typed engine doubles predate it
        hint_kw = {} if hint is None else {"hint": hint}
        ro = self.engine.start(
            ids, image_embeds=self.image_embeds,
            max_new_tokens=self.max_length - len(ids),
            prefix=prefix, on_token=self.on_token, lazy=True,
            sampling=self.sampling, **hint_kw)
        self._pending_rollout = ro
        return ro

    # ------------------------------------------------------------------
    # rollout: stream tokens from the engine, yield line-boundary prefixes
    # ------------------------------------------------------------------

    @staticmethod
    def _record_rollout_tokens(new_nodes, origin=None) -> None:
        """Record the full rollout on each node cut from it AND on the node
        it was rolled out from (``origin``, e.g. the root, which is never
        itself cut from a rollout): the suffix beyond a node's prefix
        becomes the speculative draft hint for its future child rollouts
        (the sequential and parallel paths share this)."""
        if not new_nodes:
            return
        full = new_nodes[-1].token_ids
        for n in new_nodes:
            if n.rollout_tokens is None:
                n.rollout_tokens = full
        if origin is not None:
            o = origin.parent if origin.is_widen_node else origin
            if o is not None and o.rollout_tokens is None:
                o.rollout_tokens = full

    def _hint_for(self, node) -> Optional[Tuple[int, ...]]:
        """Reference text for speculative draft lookup: the suffix of the
        rollout this node was cut from (child rollouts re-generate much of
        the parent's continuation). None when the engine is not
        speculative or no source rollout is recorded."""
        # duck-typed engines (test doubles) may not expose `spec`
        if getattr(self.engine, "spec", 0) <= 0 or node is None:
            return None
        n = node.parent if getattr(node, "is_widen_node", False) else node
        full = getattr(n, "rollout_tokens", None)
        ids = n.token_ids
        if full and len(full) > len(ids) and full[:len(ids)] == tuple(ids):
            return full[len(ids):]
        return None

    def rollout(self, state: NodeState, hint=None
                ) -> Generator[Tuple[Tuple[int, ...], int], None, None]:
        ids = list(state.token_ids)
        eos = self.engine.eos_token_id
        if (ids and ids[-1] == eos) or len(ids) >= self.max_length:
            return  # terminal state: nothing to extend
        if self.control.should_stop:
            return  # aborted before this rollout started: leave the engine

        ro = self._start(ids, hint)
        boundary: List[int] = list(ids)   # cumulative prefix at last boundary
        line: List[int] = []
        num_lines, continuation = state.num_lines, False
        processed = len(ids)
        try:
            while True:
                for tok in ro.token_ids[processed:]:
                    line.append(tok)
                    info = self._newline.get(tok)
                    if info:
                        n, trailing = info
                        num_lines += n - continuation
                        continuation = not trailing
                        boundary = boundary + line
                        line = []
                        yield tuple(boundary), num_lines
                processed = len(ro.token_ids)
                if ro.finished:
                    break
                if self.control.should_stop:
                    self.engine.abort(ro)
                self.engine.step()
            if line:
                yield tuple(boundary + line), num_lines - continuation
        except GeneratorExit:
            self.control.abort()
            self.engine.abort(ro)
            while not ro.finished:
                self.engine.step()
            raise
        finally:
            self.stats["rollouts"] += 1
            self.stats["rollout_tokens"] += ro.new_tokens

    # ------------------------------------------------------------------

    def decode(self, token_ids) -> TikzDocument:
        code = self.processor.decode(
            list(token_ids)[len(self.root.token_ids):],
            skip_special_tokens=True)
        return TikzDocument(code, timeout=self.compile_timeout,
                            backend=self.compiler.backend)

    def sample(self) -> TikzDocument:
        """One-shot sampling (no tree search)."""
        it = self.sample_iter()
        while True:
            try:
                next(it)
            except StopIteration as stop:
                return stop.value

    def sample_iter(self) -> Generator[None, None, TikzDocument]:
        """Incremental ``sample()``: yields after every engine step and
        returns the finished TikzDocument as the StopIteration value;
        ``close()``-ing it mid-decode aborts the rollout."""
        ids = list(self.root.token_ids)
        eos = self.engine.eos_token_id
        if ((ids and ids[-1] == eos) or len(ids) >= self.max_length
                or self.control.should_stop):
            return self.decode(tuple(ids))      # nothing to extend

        ro = self._start(ids)
        try:
            while not ro.finished:
                if self.control.should_stop:
                    self.engine.abort(ro)
                self.engine.step()
                yield
        except GeneratorExit:
            self.control.abort()
            self.engine.abort(ro)
            while not ro.finished:
                self.engine.step()
            self._finish_rollout([])     # release the aborted slot
            raise
        finally:
            self.stats["rollouts"] += 1
            self.stats["rollout_tokens"] += ro.new_tokens
        doc = self.decode(tuple(ro.token_ids))
        self._finish_rollout([])
        return doc

    def score(self, image) -> Numeric:
        assert self.metric is not None
        with profiling.span("mcts.score"):
            if self._score_takes_text:
                return float(self.metric.score(img1=image, img2=self.image,
                                               text2=self.text))
            # custom metrics without text support
            return float(self.metric.score(image, self.image))

    def _store_prefixes_for(self, ro, nodes: List[WideNode]) -> List[tuple]:
        """Store KV prefixes (rollout prompt + candidate tree nodes) from a
        live slot, so later rollouts from this image re-prefill only tails.
        Returns the candidate-node keys newly stored by this call."""
        prompt_ids = tuple(ro.token_ids[:ro.prompt_len])
        self.engine.store_prefix((self.namespace, prompt_ids), ro,
                                 length=ro.prompt_len,
                                 namespace=self.namespace)
        new_keys = []
        for new_node in nodes:
            n = len(new_node.token_ids)
            if (n <= ro.length
                    and tuple(ro.token_ids[:n]) == new_node.token_ids):
                key = (self.namespace, new_node.state)
                if self.engine.has_prefix(key):
                    continue    # stored by an earlier rollout: not ours
                if self.engine.store_prefix(key, ro, length=n,
                                            namespace=self.namespace):
                    new_keys.append((key, new_node.state))
        return new_keys

    def _finish_rollout(self, attached: List[WideNode]) -> None:
        ro = self._pending_rollout
        self._pending_rollout = None
        if ro is None:
            return
        self._store_prefixes_for(ro, attached)
        self.engine.release(ro)

    # ------------------------------------------------------------------
    # MCTS expansion policy (semantics: reference generate.py:305-353)
    # ------------------------------------------------------------------

    def child_finder(self, node: WideNode, montecarlo: MonteCarlo) -> None:
        new_nodes: List[WideNode] = []
        rollout_gen = self.rollout(node.state, hint=self._hint_for(node))
        for token_ids, num_lines in rollout_gen:
            new_node = WideNode(NodeState(token_ids, num_lines),
                                exploration=self.exploration)
            if new_node.state in self.failed_rollouts:
                # replay a known-failing suffix instead of regenerating
                new_nodes.extend(self.failed_rollouts[new_node.state])
                rollout_gen.close()
                break
            new_nodes.append(new_node)
        if not new_nodes and self.control.should_stop:
            # aborted before producing anything: do not compile and score
            # the parent as if it were a fresh rollout
            return
        self._record_rollout_tokens(new_nodes, origin=node)

        if node.is_widen_node:
            node.visits += 1
            node, new_nodes = self._merge(node.parent, new_nodes)

        with profiling.span("mcts.compile"):
            tikz = self.decode((new_nodes or [node])[-1].token_ids)
            tikz.compile()

        attached = self._attach(node, new_nodes, tikz)
        self._finish_rollout(attached)
        self._score_and_backprop(attached[-1] if attached else node, tikz)

    def _attach(self, node: WideNode, new_nodes: List[WideNode],
                tikz: TikzDocument) -> List[WideNode]:
        """Attach rollout prefixes to the tree given the compile outcome
        (reference generate.py:320-335). Returns the attached chain."""
        skip_idx = round(sqrt(len(new_nodes)))
        scorable = tikz.is_rasterizable and not (
            self.strict and tikz.compiled_with_errors)
        attached: List[WideNode] = []
        if scorable:
            for new_node in new_nodes[:skip_idx]:
                node.add_child(new_node)
                node = new_node
                attached.append(new_node)
        else:
            errorln = min(tikz.errors or [0])
            if errorln:
                # attach only prefixes strictly before the error line; cache
                # the failing suffix once a node lies beyond it (the
                # reference's effective semantics, as in the JAX package)
                for idx, new_node in enumerate(new_nodes):
                    if new_node.num_lines < errorln and idx < skip_idx:
                        node.add_child(new_node)
                        node = new_node
                        attached.append(new_node)
                    elif new_node.num_lines > errorln:
                        self.failed_rollouts[new_node.state] = new_nodes[idx:]
                        break
        return attached

    def _score_and_backprop(self, node: WideNode, tikz: TikzDocument,
                            precomputed: Optional[float] = None) -> Numeric:
        scorable = tikz.is_rasterizable and not (
            self.strict and tikz.compiled_with_errors)
        if self.metric is not None:
            if scorable:
                score = (precomputed if precomputed is not None
                         else self.score(tikz.rasterize()))
            else:
                score = -1
            node.update_win_value(self.norm(score) if scorable else score)
        else:
            # fast mode: compiler diagnostics in {-1, 0, 1}
            score = int(scorable) - int(tikz.compiled_with_errors)
            node.update_win_value(score)
        self.solution.append((score, tikz))
        return score

    def _merge(self, node: WideNode, nodes_to_merge: List[WideNode]
               ) -> Tuple[WideNode, List[WideNode]]:
        """Fold a widen-node rollout into existing children where states
        already exist (reference generate.py:345-353)."""
        for merge_node in nodes_to_merge:
            for child in node.children:
                if child.state == merge_node.state:
                    node, nodes_to_merge = child, nodes_to_merge[1:]
                    break
            else:
                break
        return node, nodes_to_merge

    # ------------------------------------------------------------------

    def simulate(self, expansions: Optional[float] = 1,
                 parallelism: int = 1, *, shared_engine: bool = False
                 ) -> Generator[Tuple[Numeric, TikzDocument], None, None]:
        """Run MCTS expansions, yielding every rollout's (score, document).

        ``parallelism > 1`` runs that many expansions concurrently on the
        engine's slots (virtual loss spreads the selections; LaTeX compiles
        and SelfSim waves overlap decode); ``parallelism=1`` keeps the
        reference's strictly sequential order.

        ``shared_engine=True`` (timesliced schedulers: ``serve.py``) always
        takes the staged parallel loop, even at parallelism 1: its launch
        guards tolerate sibling searches holding slots (the sequential
        path's ``engine.start`` raises on a full engine), and it re-reads
        ``self.parallelism`` on every trip, so a scheduler can rebalance
        the slot shares. It yields ``STALLED`` instead of a result on a
        trip that ends with nothing in flight (paused siblings may hold
        every slot); the scheduler must then advance its other tasks."""
        if shared_engine:
            return self._simulate_parallel(expansions, parallelism,
                                           shared=True)
        if parallelism > 1:
            return self._simulate_parallel(expansions, parallelism)
        return self._simulate_sequential(expansions)

    __call__ = simulate

    def _simulate_sequential(self, expansions: Optional[float]
                             ) -> Generator[Tuple[Numeric, TikzDocument],
                                            None, None]:
        start = time.time()
        budget = expansions
        while budget is None or (budget := budget - 1) >= 0:
            if self.on_tick is not None:
                self.on_tick()
            self.montecarlo.simulate()
            if self.solution:
                yield self.solution.pop()
            if self.control.should_stop:
                # the whole search stops, not just the in-flight rollout;
                # the flag is sticky, so an abort between rollouts holds
                return
            if (self.mcts_timeout is not None
                    and time.time() - start > self.mcts_timeout):
                return

    # ------------------------------------------------------------------
    # parallel MCTS: K concurrent expansions over engine slots
    # ------------------------------------------------------------------

    class _Expansion:
        __slots__ = ("node", "path", "ro", "boundary", "line", "num_lines",
                     "continuation", "processed", "new_nodes", "stopped",
                     "future", "prompt", "prefix", "stored_keys", "hint")

        def __init__(self, node, path):
            self.node = node
            self.path = path
            self.ro = None
            self.new_nodes: List = []
            self.stopped = False
            self.future = None
            self.prompt = None      # token ids to roll out from (None: leaf)
            self.prefix = None      # StoredPrefix to restore, if any
            self.hint = None        # speculative draft reference text
            self.stored_keys: List = []   # speculative prefix stores

    def _select_leaf(self) -> WideNode:
        node = self.montecarlo.root_node
        while node.expanded:
            node = node.get_preferred_child(self.montecarlo.root_node)
        return node  # type: ignore[return-value]

    def _virtual_loss(self, node) -> list:
        """Inflate visit counts along the path so concurrent selections
        diversify; reverted before the real backprop."""
        path = []
        n = node
        while n is not None:
            n.visits += 1
            path.append(n)
            n = n.parent
        return path

    def _prepare_expansion(self) -> "_Expansion":
        """Select a leaf (with virtual loss) and resolve its rollout prompt
        and stored prefix, without starting it: a wave of prepared
        expansions starts together through ``engine.start_many``."""
        node = self._select_leaf()
        exp = self._Expansion(node, self._virtual_loss(node))
        ids = list(node.state.token_ids)
        eos = self.engine.eos_token_id
        if (ids and ids[-1] == eos) or len(ids) >= self.max_length:
            return exp  # terminal: no rollout, straight to compile
        found = self.engine.best_prefix(ids, namespace=self.namespace)
        prefix = found[1] if found else None
        if prefix is not None:
            self.stats["prefix_hits"] += 1
            self.stats["prefix_tokens_saved"] += prefix.length
        exp.prompt = ids
        exp.prefix = prefix
        exp.hint = self._hint_for(node)
        return exp

    def _launch_wave(self, wave: List["_Expansion"]) -> None:
        """Start a wave of prepared expansions as fused starts."""
        hints = [exp.hint for exp in wave]
        hint_kw = {} if all(h is None for h in hints) else {"hints": hints}
        ros = self.engine.start_many(
            [exp.prompt for exp in wave],
            image_embeds=self.image_embeds,
            max_new_tokens=[self.max_length - len(exp.prompt)
                            for exp in wave],
            prefixes=[exp.prefix for exp in wave],
            sampling=self.sampling, on_token=self.on_token, **hint_kw)
        for exp, ro in zip(wave, ros):
            exp.ro = ro
            exp.boundary = list(exp.prompt)
            exp.line = []
            exp.num_lines = exp.node.state.num_lines
            exp.continuation = False
            exp.processed = len(exp.prompt)

    def _advance_segmentation(self, exp: "_Expansion") -> None:
        """Consume newly decoded tokens, cutting nodes at line boundaries
        (the semantics of ``rollout``) and replaying failed suffixes."""
        ro = exp.ro
        for tok in ro.token_ids[exp.processed:]:
            exp.processed += 1
            if exp.stopped:
                continue
            exp.line.append(tok)
            info = self._newline.get(tok)
            if not info:
                continue
            n, trailing = info
            exp.num_lines += n - exp.continuation
            exp.continuation = not trailing
            exp.boundary = exp.boundary + exp.line
            exp.line = []
            new_node = WideNode(
                NodeState(tuple(exp.boundary), exp.num_lines),
                exploration=self.exploration)
            if new_node.state in self.failed_rollouts:
                exp.new_nodes.extend(self.failed_rollouts[new_node.state])
                exp.stopped = True
                self.engine.abort(ro)
            else:
                exp.new_nodes.append(new_node)

    def _finalize_rollout(self, exp: "_Expansion") -> None:
        """Rollout finished: cut the trailing segment, store candidate KV
        prefixes, free the slot, submit the compile."""
        ro = exp.ro
        if not exp.stopped and exp.line:
            exp.new_nodes.append(WideNode(
                NodeState(tuple(exp.boundary + exp.line),
                          exp.num_lines - exp.continuation),
                exploration=self.exploration))
        self.stats["rollouts"] += 1
        self.stats["rollout_tokens"] += ro.new_tokens
        self._record_rollout_tokens(exp.new_nodes, origin=exp.node)
        # only the first sqrt(n) nodes can be attached. They are stored
        # before the compile resolves (the slot must be freed first);
        # _complete_expansion drops whatever ends up unattached
        skip_idx = round(sqrt(len(exp.new_nodes)))
        exp.stored_keys = self._store_prefixes_for(
            ro, exp.new_nodes[:skip_idx])
        self.engine.release(ro)
        tikz = self.decode((exp.new_nodes or [exp.node])[-1].token_ids)
        exp.future = self.compiler.submit_doc(tikz)

    def _complete_expansion(self, exp: "_Expansion",
                            precomputed: Optional[float] = None
                            ) -> Tuple[Numeric, TikzDocument]:
        tikz = exp.future.result()
        for n in exp.path:
            n.visits -= 1           # revert virtual loss
        node, new_nodes = exp.node, exp.new_nodes
        if node.is_widen_node:
            node.visits += 1
            node, new_nodes = self._merge(node.parent, new_nodes)
        attached = self._attach(node, new_nodes, tikz)
        # drop the stored prefixes of candidates that were not attached
        # (the sequential path stores attached nodes only)
        attached_states = {n.state for n in attached}
        for key, state in exp.stored_keys:
            if state not in attached_states:
                self.engine.drop_prefix(key)
        if exp.node.children:
            exp.node.expanded = True
        # MonteCarlo.expand's bookkeeping (sequential path)
        self.montecarlo.stats_expansion_count += 1
        if not exp.node.children:
            self.montecarlo.stats_failed_expansion_count += 1
        if self.montecarlo.on_expansion is not None:
            self.montecarlo.on_expansion(exp.node)
        score = self._score_and_backprop(
            attached[-1] if attached else node, tikz,
            precomputed=precomputed)
        if self.solution:
            self.solution.pop()
        return score, tikz

    def _dispatch_scores(self, exps: list):
        """Rasterize one completion wave's scorable renders and enqueue ONE
        batched SelfSim pass over them. Renders whose bytes are already in
        the ``score`` memo are skipped (completion falls back to the memo);
        duplicate renders in the wave encode once. Returns a pending handle
        for ``_resolve_scores`` (the scores on the device, their count, the
        bookkeeping, and a CUDA event that marks them ready), or None when
        the wave has nothing to score."""
        if self.metric is None or not exps or not self._wave_scoring_ok:
            return None
        memo = getattr(self.score, "cache", None)
        imgs, keys, img_bytes = [], [], []
        seen: Dict[bytes, List[int]] = {}   # in-wave dedup: bytes -> exps
        for exp in exps:
            doc = exp.future.result()
            if doc.is_rasterizable and not (self.strict
                                            and doc.compiled_with_errors):
                img = doc.rasterize()
                if img is not None:
                    b = img.tobytes()
                    if memo is not None and b in memo:
                        self.stats["score_memo_hits"] += 1
                        continue
                    if b in seen:
                        seen[b].append(id(exp))
                        continue
                    seen[b] = [id(exp)]
                    imgs.append(img)
                    keys.append(id(exp))
                    img_bytes.append(b)
        if not imgs:
            return None
        with profiling.span("mcts.score", images=len(imgs)):
            # only the reference features carry the caption (renders are
            # never conditioned, as in score()); the metric's LRU keeps them
            if self.text is not None:
                dev, k = self.metric.score_against_async(imgs, self.image,
                                                         text=self.text)
            else:
                dev, k = self.metric.score_against_async(imgs, self.image)
            ready = None
            if isinstance(dev, torch.Tensor) and dev.is_cuda:
                ready = torch.cuda.Event()
                ready.record()
        return dev, k, keys, img_bytes, seen, ready

    def _resolve_scores(self, pending) -> dict:
        """Fetch the batched wave scores dispatched by _dispatch_scores and
        write them into the ``score`` memo."""
        if pending is None:
            return {}
        dev, k, keys, img_bytes, seen, _ = pending
        with profiling.span("mcts.score"):
            vals = (dev[:k].float().cpu().numpy()
                    if isinstance(dev, torch.Tensor) else np.asarray(dev)[:k])
        memo = getattr(self.score, "cache", None)
        out = {}
        for key, b, v in zip(keys, img_bytes, vals):
            v = float(v)
            if memo is not None:
                memo[b] = v         # later revisits hit the memo
            for dup_key in seen[b]:
                out[dup_key] = v    # in-wave duplicates share the value
        return out

    def _simulate_parallel(self, expansions: Optional[float],
                           parallelism: int, shared: bool = False
                           ) -> Generator[Tuple[Numeric, TikzDocument],
                                          None, None]:
        start = time.time()
        target = expansions
        self.parallelism = max(1, min(parallelism, self.engine.num_slots))
        launched = completed = 0
        decoding: List = []
        compiling: List = []
        scoring: List = []      # [(exps, pending)] score-dispatched waves

        def timed_out() -> bool:
            return (self.mcts_timeout is not None
                    and time.time() - start > self.mcts_timeout)

        try:
            while target is None or completed < target:
                if self.on_tick is not None:
                    self.on_tick()
                # live re-read: a scheduler may rebalance the slot shares
                parallelism = max(1, min(self.parallelism,
                                         self.engine.num_slots))
                wave: List = []
                # ``parallelism`` bounds concurrent DECODING rollouts;
                # expansions in the compile or score stage hold no slot, so
                # new rollouts refill the engine while LaTeX runs. All
                # in-flight expansions are capped at 2x parallelism to
                # bound virtual-loss staleness.
                n_scoring = sum(len(e) for e, _ in scoring)
                with profiling.span("mcts.launch"):
                    while ((target is None or launched < target)
                           and len(decoding) + len(wave) < parallelism
                           and len(decoding) + len(compiling) + n_scoring
                           + len(wave) < 2 * parallelism
                           and self.engine.num_active + len(wave)
                           < self.engine.num_slots
                           and len(wave) < self.engine.num_free_slots
                           and not timed_out()
                           and not self.control.should_stop):
                        exp = self._prepare_expansion()
                        launched += 1
                        if exp.prompt is None:      # terminal state
                            self.stats["terminal_revisits"] += 1
                            doc = self.decode(exp.node.token_ids)
                            if "output" in doc.__dict__:
                                # an already-compiled program (decode
                                # memo): skip the compile pool
                                fut: _cf.Future = _cf.Future()
                                fut.set_result(doc)
                                exp.future = fut
                            else:
                                exp.future = self.compiler.submit_doc(doc)
                            compiling.append(exp)
                        else:
                            wave.append(exp)
                    if wave:
                        self._launch_wave(wave)
                        decoding.extend(wave)
                self.stats["max_inflight"] = max(
                    self.stats["max_inflight"],
                    len(decoding) + len(compiling) + n_scoring)

                if decoding:
                    if compiling or scoring:
                        self.stats["overlap_ticks"] += 1
                    with profiling.span("mcts.step"):
                        self.engine.step()
                        for exp in list(decoding):
                            self._advance_segmentation(exp)
                            if exp.ro.finished:
                                self._finalize_rollout(exp)
                                decoding.remove(exp)
                                compiling.append(exp)

                # resolve score waves dispatched on an EARLIER iteration;
                # while decode or compile work remains, only those whose
                # device work has already finished
                while scoring:
                    exps_w, pending = scoring[0]
                    if (decoding or compiling) and pending is not None:
                        ready = pending[-1]
                        if ready is not None and not ready.query():
                            break
                    with profiling.span("mcts.resolve"):
                        wave_scores = self._resolve_scores(pending)
                    while exps_w:
                        exp = exps_w.pop(0)
                        completed += 1
                        with profiling.span("mcts.complete"):
                            out = self._complete_expansion(
                                exp, precomputed=wave_scores.get(id(exp)))
                        yield out
                    scoring.pop(0)

                ready = [exp for exp in compiling if exp.future.done()]
                if ready:
                    with profiling.span("mcts.dispatch"):
                        for exp in ready:
                            compiling.remove(exp)
                        pending = self._dispatch_scores(ready)
                    if pending is None:
                        # nothing to batch (no metric / nothing
                        # rasterizable / all memoised): complete in place
                        for exp in ready:
                            completed += 1
                            with profiling.span("mcts.complete"):
                                out = self._complete_expansion(exp)
                            yield out
                    else:
                        scoring.append((ready, pending))

                if timed_out() or self.control.should_stop:
                    break
                if (not decoding and not compiling and not scoring
                        and target is not None and launched >= target):
                    break
                if not decoding and not compiling and not scoring:
                    # nothing launched and nothing in flight: every slot
                    # is held by another user of the engine. Under a
                    # timesliced scheduler those are paused siblings whose
                    # slots free only on THEIR turns, so spinning here would
                    # wedge the scheduler thread: hand control back
                    time.sleep(0.001)
                    if shared:
                        yield STALLED
                    continue
                if not decoding and compiling:
                    # nothing to decode: wait briefly for ANY compile
                    with profiling.span("mcts.wait"):
                        _cf.wait([e.future for e in compiling], timeout=0.05,
                                 return_when=_cf.FIRST_COMPLETED)
        finally:
            for exp in decoding:
                self.engine.abort(exp.ro)
            while any(not exp.ro.finished for exp in decoding):
                self.engine.step()
            for exp in decoding:
                self.engine.release(exp.ro)
                for n in exp.path:
                    n.visits -= 1
            for exp in compiling:
                for n in exp.path:
                    n.visits -= 1
            for exps_w, _ in scoring:
                for exp in exps_w:     # dispatched but never completed
                    for n in exp.path:
                        n.visits -= 1
