"""TikZ generation session against the decode engine (counterpart of
``detikzify_tpu/infer/generator.py``).

This slice ports one-shot sampling: the constructor (root prompt, vision
pass, search tree root), ``rollout`` (line-boundary prefixes streamed from
an engine rollout), ``decode``, ``sample`` / ``sample_iter`` and the
prefix store/release on finish. MCTS ``simulate()`` and its wave machinery
come with SelfSim in the next slice (ROADMAP queue 1).
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Dict, Generator, List, Optional, Tuple

import numpy as np

from ..engine import DecodeEngine
from ..mcts import MonteCarlo, Node, Normalizer
from ..ops.sampling import make_newline_table
from ..processing import DetikzifyProcessor
from ..utils.functools import cache_cast
from ..utils.generation import ExplicitAbort
from .tikz import CompileService, TikzDocument

Numeric = float


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


class DetikzifyGenerator:
    """One image -> TikZ sampling session."""

    def __init__(
        self,
        engine: DecodeEngine,
        processor: DetikzifyProcessor,
        image=None,                     # preprocessed PIL image or None
        text: Optional[str] = None,
        metric=None,
        compile_timeout: float = 60.0,
        mcts_timeout: Optional[float] = None,
        exploration: float = 0.6,
        strict: bool = False,
        control: Optional[ExplicitAbort] = None,
        compile_service: Optional[CompileService] = None,
        max_length: Optional[int] = None,
        max_new_tokens: Optional[int] = None,
        on_token=None,                  # per-token streaming callback
        sampling=None,                  # SamplingParams override (per-call)
        image_embeds=None,              # precomputed [1, N, D] image tokens
    ):
        if text is not None:
            raise NotImplementedError(
                "text conditioning needs the TikZero adapter, which is not "
                "ported yet (ROADMAP queue 1, TikZero adapter)")
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
        self.namespace = ("gen", next(_gen_counter))

        # root prompt mirrors reference generate.py:178-186: image tokens
        # only (no BOS)
        out = processor(images=image, text=None if image is not None else "",
                        skip_pixels=image_embeds is not None)
        root_ids = tuple(int(t) for t in out.input_ids[0])
        self.max_length = min(max_length or processor.model_max_length,
                              engine.max_len - 1)
        if max_new_tokens is not None:
            # reference generate() semantics: cap NEW tokens past the prompt
            self.max_length = min(self.max_length,
                                  len(root_ids) + max_new_tokens)

        self.image_embeds = image_embeds
        if self.image_embeds is None and out.pixel_values is not None:
            self.image_embeds = engine.encode_image(out.pixel_values)

        self.solution: deque = deque(maxlen=1)
        self.failed_rollouts: Dict[NodeState, List[WideNode]] = {}
        self.norm = Normalizer()
        self.montecarlo = MonteCarlo(
            WideNode(NodeState(root_ids, 0), exploration=exploration))

        self._newline = self._build_newline_table()
        self._pending_rollout = None    # engine Rollout awaiting prefix save

        self.decode = cache_cast(lambda ids: tuple(ids))(self.decode)

        self.stats = {"rollouts": 0, "rollout_tokens": 0,
                      "rollout_time": 0.0, "prefix_hits": 0,
                      "prefix_tokens_saved": 0}

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

    def _start(self, ids: List[int]):
        found = self.engine.best_prefix(ids, namespace=self.namespace)
        prefix = found[1] if found else None
        if prefix is not None:
            self.stats["prefix_hits"] += 1
            self.stats["prefix_tokens_saved"] += prefix.length
        ro = self.engine.start(
            ids, image_embeds=self.image_embeds,
            max_new_tokens=self.max_length - len(ids),
            prefix=prefix, on_token=self.on_token, lazy=True,
            sampling=self.sampling)
        self._pending_rollout = ro
        return ro

    # ------------------------------------------------------------------
    # rollout: stream tokens from the engine, yield line-boundary prefixes
    # ------------------------------------------------------------------

    def rollout(self, state: NodeState
                ) -> Generator[Tuple[Tuple[int, ...], int], None, None]:
        ids = list(state.token_ids)
        eos = self.engine.eos_token_id
        if (ids and ids[-1] == eos) or len(ids) >= self.max_length:
            return  # terminal state: nothing to extend
        if self.control.should_stop:
            return  # aborted before this rollout started: leave the engine

        t0 = time.time()
        ro = self._start(ids)
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
            self.stats["rollout_time"] += time.time() - t0

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

        t0 = time.time()
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
            self.stats["rollout_time"] += time.time() - t0
        doc = self.decode(tuple(ro.token_ids))
        self._finish_rollout([])
        return doc

    def simulate(self, *args, **kw):
        raise NotImplementedError(
            "MCTS simulate() comes with SelfSim (ROADMAP queue 1, item "
            "'SelfSim, generator.simulate() and MCTS')")

    # ------------------------------------------------------------------

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
