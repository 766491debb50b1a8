"""Closed-loop batched sampling (``kind: "sample"``).

``slots`` figures are in flight at all times: whenever requests finish,
as many new ones are handed over together. A request runs the port's
preprocessing and processor on its figure (trim, square, resize,
normalise), the tower and
connector (``DecodeEngine.encode_image``, one pass for the figures handed
over together), then ``DecodeEngine.start(lazy=True, on_token=...)``;
``step()`` advances every slot by one block and ``release()`` frees a
finished request's slot: the continuous batching of the server's
sampling waves and of evaluation's predictions. The prompt is the
figure's image tokens and bos.

Set-up hands the first ``slots`` requests over and runs one block, so the
window opens on a full loop; with ``"stagger": true`` those first
requests ask for evenly spread shares of their length
(``traffic.staggered``), so that a loop of equal lengths opens as it runs
once it has turned over rather than in lockstep. Measured: tokens
delivered to the consumers over the window, and each request's time from
handing its figure to the processor to its first token at the consumer
(a request with none by the window's end counts at its wait so far).
Where no greedy request finished in the window, those still decoding run
on to their end (at most ``drain_s``), so that the comparison has one to
judge.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from .. import traffic
from .common import Base


class Run(Base):
    drain_s = 90.0

    def setup(self) -> None:
        mix = self.mix
        self.build(mix["slots"], mix["max_len"])
        self.warm_profiler()
        self.figures = traffic.figures(mix["figures"], self.seed,
                                       mix["figure_size"])
        prompt = self.pcfg.image_seq_len + 1
        self.stream = traffic.requests(mix, self.seed, prompt)
        self.warm_contexts(prompt, prompt + traffic.longest(mix, prompt))
        # warm-up of a hand-over of every slot at once, from another
        # stream and cut short
        warm = traffic.requests(mix, self.seed + 1, prompt)
        started = self._submit_many(
            [dataclasses.replace(next(warm), max_new_tokens=2)
             for _ in range(mix["slots"])], time.perf_counter())
        while any(not ro.finished for ro, _ in started):
            self.engine.step()
        for ro, _ in started:
            self.engine.release(ro)
        # the loop's first hand-over: the window opens on every slot busy
        first = self._take(mix["slots"])
        if mix.get("stagger"):
            first = traffic.staggered(first)
        self.live = self._submit_many(first, time.perf_counter())
        self.engine.step()
        self.sync()

    def _take(self, n: int):
        return [next(self.stream) for _ in range(n)]

    def _submit_many(self, reqs, t_submit: float):
        from detikzify_torch.utils.image import expand, load

        eng, sp = self.engine, self.spans
        with sp.span("processor"):
            figs = [load(self.figures[r.figure]) for r in reqs]
            out = self.processor(
                images=[expand(f, max(f.size), do_trim=True) for f in figs],
                add_bos_token=True)
        with sp.span("encode_image"):
            embeds = eng.encode_image(out.pixel_values)
        self.log.prompt_images += len(reqs) if self._tracing else 0
        started = []
        for i, r in enumerate(reqs):
            rec = {"request": r, "submit": t_submit, "first": None,
                   "tokens": 0}

            def on_token(tok, rec=rec):
                if rec["first"] is None:
                    rec["first"] = time.perf_counter()
                rec["tokens"] += 1
            with sp.span("engine.start"):
                ro = eng.start([int(t) for t in out.input_ids[i]],
                               image_embeds=embeds[i:i + 1],
                               max_new_tokens=r.max_new_tokens,
                               lazy=True, on_token=on_token,
                               sampling=self.greedy if r.greedy else None)
            started.append((ro, rec))
        return started

    def window(self) -> dict:
        eng, sp = self.engine, self.spans
        records, live = [], list(self.live)
        for ro, rec in live:          # handed over before the window
            self.register(ro, 0)
            rec["tokens"] = 0
        self.window_counters = dict(eng.counters)
        captures = eng.graph_stats["captures"]
        self._t0 = t0 = time.perf_counter()
        deadline = t0 + self.seconds
        self.maybe_trace(t0)
        while True:
            now = time.perf_counter()
            if now >= deadline:
                break
            free = eng.num_free_slots
            if free:
                for ro, rec in self._submit_many(self._take(free), now):
                    self.register(ro, 0)
                    records.append(rec)
                    live.append((ro, rec))
            with sp.span("engine.step"):
                eng.step()
            self._release(live)
            self.maybe_trace(time.perf_counter())
        self.finish_trace()
        t_end = time.perf_counter()
        self.sync()
        c1 = eng.counters
        self.window_counters = {k: c1[k] - self.window_counters[k]
                                for k in c1}
        tokens = sum(rec["tokens"] for _, rec in self.live) \
            + sum(r["tokens"] for r in records)
        waits = [(r["first"] if r["first"] is not None else t_end)
                 - r["submit"] for r in records]
        self.records = records + [rec for _, rec in self.live]
        self.window_captures = eng.graph_stats["captures"] - captures
        # with no greedy request finished, those still decoding finish,
        # for the comparison
        drain_end = t_end + self.drain_s
        while not self._done(greedy=True) \
                and any(rec["request"].greedy for _, rec in live) \
                and time.perf_counter() < drain_end:
            eng.step()
            self._release(live)
        span = t_end - t0
        return {"attempted": len(records), "failed": 0,
                "metrics": {"tokens_per_s": tokens / span,
                            "ttft_p95_s": float(np.percentile(waits, 95))},
                "window_s": span, "finished": sum(
                    "rollout" in r for r in records),
                "window_captures": self.window_captures,
                "drain_s": time.perf_counter() - t_end}

    def _release(self, live) -> None:
        for ro, rec in list(live):
            if ro.finished:
                rec["rollout"] = ro
                with self.spans.span("engine.release"):
                    self.engine.release(ro)
                live.remove((ro, rec))

    def _done(self, greedy: bool):
        return [r for r in self.records
                if "rollout" in r and r["request"].greedy == greedy]

    def _pick(self, done, rng: np.random.Generator, n: int):
        """The longest of ``done`` and ``n`` - 1 more drawn from the seed."""
        if not done:
            return []
        done = sorted(done, key=lambda r: -len(r["rollout"].token_ids))
        rest = rng.choice(np.arange(1, len(done)),
                          size=min(n - 1, len(done) - 1), replace=False)
        return [done[0]] + [done[i] for i in sorted(rest)]

    def evidence(self, rng: np.random.Generator, n: int) -> dict:
        """Finished requests for the comparison: ``n`` greedy and ``n``
        sampled ones, each set the longest and more drawn from the
        seed."""
        def seqs(picked):
            return [{"figure": self.figures[r["request"].figure],
                     "token_ids": list(r["rollout"].token_ids),
                     "prompt_len": r["rollout"].prompt_len} for r in picked]
        return {"sequences": seqs(self._pick(self._done(True), rng, n)),
                "sampled": seqs(self._pick(self._done(False), rng, n))}
