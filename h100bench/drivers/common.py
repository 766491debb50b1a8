"""What the drivers share: building the system, the traced sub-window,
and the bookkeeping of the work a traced window holds."""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

from .. import port
from ..trace import Spans, Window
from ..work import Log


class Base:
    """A cell's run: ``setup()``, ``window()``, ``evidence()``, ``close()``.

    With ``trace``, the profiler covers the sub-window from a quarter of
    ``seconds`` in, for ``trace_s`` seconds (at most half the window),
    opened and closed between decode blocks with the device drained, and
    the work log counts what it holds."""

    trace_s = 10.0

    def __init__(self, cfg: dict, mix: dict, seed: int, seconds: float,
                 trace: bool, device: str):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.seconds, self.trace = float(seconds), trace
        self.device = torch.device(device)
        self.spans = Spans()
        self.log = Log()
        self.tracer: Optional[Window] = None
        self.trace_counters: Dict[str, int] = {}
        self.window_counters: Dict[str, int] = {}
        self._t0 = 0.0
        self._tracing = False
        self._rollouts: List = []          # every rollout the window started
        self._snap: Dict[int, int] = {}
        self.stages: Dict[str, float] = {}

    # ---- building the system ------------------------------------------

    def build(self, num_slots: int, max_len: int):
        from detikzify_torch.engine import DecodeEngine
        from detikzify_torch.ops.sampling import SamplingParams

        t0 = time.perf_counter()
        self.pcfg = port.port_config(self.cfg)
        self.params = port.port_params(self.cfg, self.pcfg, self.seed,
                                       self.device)
        self.sync()
        self.stages["weights_s"] = time.perf_counter() - t0
        self.processor = port.processor(self.cfg, self.pcfg)
        mix = self.mix
        self.sampling = SamplingParams(temperature=mix["temperature"],
                                       top_p=mix["top_p"],
                                       top_k=mix["top_k"],
                                       candidates=mix["candidates"])
        self.greedy = SamplingParams(temperature=0.0, top_p=1.0, top_k=0)
        # where eos ends no request (``"eos_ends_request": false``), the
        # engine's end token is the image token, which it never emits:
        # every request then decodes the length it asked for
        end = (None if mix.get("eos_ends_request", True)
               else self.cfg["image_token_id"])
        self.engine = DecodeEngine(
            self.params, self.pcfg, num_slots=num_slots, max_len=max_len,
            decode_block=mix["decode_block"], page_size=mix["page_size"],
            sampling=self.sampling, device=self.device, seed=self.seed,
            eos_token_id=end)
        self.log.slots = num_slots

    def warm_contexts(self, low: int, high: int) -> None:
        """One decode block alone at each context from ``low`` to ``high``
        in steps of a page: every attended-page bound the traffic reaches
        gets its program (a CUDA graph on the card) before the window."""
        eng, cfg = self.engine, self.cfg
        filler = 65
        emb = torch.zeros((1, self.pcfg.image_seq_len,
                           cfg["hidden_size"]), dtype=torch.bfloat16,
                          device=self.device)
        image = [cfg["image_token_id"]] * self.pcfg.image_seq_len
        for length in range(low, high + self.mix["page_size"],
                            self.mix["page_size"]):
            length = min(length, high)
            ids = image + [cfg["bos_token_id"]] + [filler] * max(
                0, length - len(image) - 1)
            ro = eng.start(ids, image_embeds=emb, max_new_tokens=2,
                           lazy=True, sampling=self.greedy)
            while not ro.finished:
                eng.step()
            eng.release(ro)
        self.sync()
        self.stages["graph_captures"] = eng.graph_stats["captures"]
        self.stages["capture_s"] = eng.graph_stats["capture_s"]

    def warm_profiler(self) -> None:
        """Start and stop the profiler once in set-up, so that the traced
        run's window does not pay its first start."""
        if self.trace and self.device.type == "cuda":
            win = Window(torch, Spans())
            win.start()
            torch.zeros(1, device=self.device).add_(1)
            win.stop()
            win.summary()

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- the traced sub-window ------------------------------------------

    def trace_bounds(self):
        lo = self.seconds / 4
        return lo, lo + min(self.trace_s, self.seconds / 2)

    def register(self, rollout, start: int) -> None:
        """A rollout the window started; ``start`` is the first row its
        prefill wrote."""
        self._rollouts.append(rollout)
        if self._tracing:
            self.log.prefills.append((start, rollout.prompt_len))

    def maybe_trace(self, now: float) -> None:
        """Called between blocks (the last one's tokens consumed): opens
        and closes the traced sub-window."""
        if not self.trace:
            return
        lo, hi = self.trace_bounds()
        t = now - self._t0
        if not self._tracing and self.tracer is None and t >= lo:
            self._snap = {id(r): len(r.token_ids) for r in self._rollouts}
            self._c0 = dict(self.engine.counters)
            self.tracer = Window(torch, self.spans)
            if self.device.type == "cuda":
                self.tracer.start()
            self._tracing = True
        elif self._tracing and t >= hi:
            if self.device.type == "cuda":
                self.tracer.stop()
            self._tracing = False
            self._close_log()

    def _close_log(self) -> None:
        for r in self._rollouts:
            a = max(self._snap.get(id(r), r.prompt_len), r.prompt_len + 1)
            self.log.decode_contexts.extend(range(a, len(r.token_ids)))
        c1 = self.engine.counters
        self.trace_counters = {k: c1[k] - self._c0.get(k, 0) for k in c1}
        self.log.steps = self.trace_counters["decode_steps"]

    def finish_trace(self) -> None:
        """A window that ended inside its traced part closes it."""
        if self._tracing:
            self.sync()
            if self.device.type == "cuda":
                self.tracer.stop()
            self._tracing = False
            self._close_log()

    def summary(self):
        return None if self.tracer is None else self.tracer.summary()

    def close(self) -> None:
        for name in ("engine", "params"):
            if hasattr(self, name):
                delattr(self, name)
        self._rollouts = []
