"""Streaming and cancellation primitives for cross-thread generation
(counterparts of the JAX package's ``utils/generation.py``). The engine
streams through a rollout's ``on_token`` hook, which calls ``put(token)``:

  * ``ExplicitAbort``        -- cooperative cross-thread cancel flag
  * ``TokenStreamer``        -- blocking queue of raw token ids with error
                                propagation into the consumer thread
  * ``IncrementalDecoder``   -- token ids to text deltas, bounded cost
  * ``TextIteratorStreamer`` -- like TokenStreamer but yields decoded text
                                deltas (web UI streaming pane)
  * ``StreamerList``         -- fan-out to several streamers
  * ``unwrap_processor``     -- peel AdapterProcessor wrappers
"""
from __future__ import annotations

import queue
from typing import Iterator, List, Optional


class ExplicitAbort:
    """Cooperative cancellation: generation loops poll ``should_stop``."""

    def __init__(self):
        self.should_stop = False

    def reset(self) -> "ExplicitAbort":
        self.should_stop = False
        return self

    def abort(self) -> None:
        self.should_stop = True


class _BaseStreamer:
    _END = object()

    def __init__(self, timeout: Optional[float] = None):
        self._queue: "queue.Queue" = queue.Queue()
        self._timeout = timeout
        self._error: Optional[BaseException] = None

    def end(self) -> None:
        self._queue.put(self._END)

    def propagate_error(self, err: BaseException) -> None:
        """Deliver a producer-side exception to the consumer thread."""
        self._error = err
        self.end()

    def _drain(self):
        while True:
            item = self._queue.get(timeout=self._timeout)
            if item is self._END:
                if self._error is not None:
                    raise self._error
                return
            yield item


class TokenStreamer(_BaseStreamer):
    """Queue of raw token ids."""

    def put(self, token: int) -> None:
        self._queue.put(int(token))

    def __iter__(self) -> Iterator[int]:
        return self._drain()


class IncrementalDecoder:
    """Decode a token stream to text deltas. Holds tokens back until they
    decode cleanly (a multi-byte character may be split across byte-level
    tokens) and restarts the decode context after each newline, so the
    cost of a token is bounded by the line's length, not the stream's."""

    def __init__(self, processor, skip_special_tokens: bool = True):
        self.processor = processor
        self.skip_special_tokens = skip_special_tokens
        self.reset()

    def reset(self) -> None:
        """Start a fresh decode context (e.g. an MCTS rollout boundary)."""
        self._tokens: List[int] = []
        self._emitted = ""

    def push(self, token: int) -> str:
        """Feed one token id; returns the newly decoded text ('' while the
        token is held back mid-character)."""
        self._tokens.append(int(token))
        text = self.processor.decode(
            self._tokens, skip_special_tokens=self.skip_special_tokens)
        if text.endswith("�"):
            return ""  # mid-character; wait for the rest
        delta = text[len(self._emitted):]
        self._emitted = text
        if text.endswith("\n"):
            self.reset()
        return delta


class TextIteratorStreamer(_BaseStreamer):
    """Yields decoded text deltas; buffers tokens until they decode
    cleanly."""

    def __init__(self, processor, skip_special_tokens: bool = True,
                 timeout: Optional[float] = None):
        super().__init__(timeout)
        self._decoder = IncrementalDecoder(processor, skip_special_tokens)

    def put(self, token: int) -> None:
        self._queue.put(int(token))

    def __iter__(self) -> Iterator[str]:
        for token in self._drain():
            delta = self._decoder.push(token)
            if delta:
                yield delta


class StreamerList(list):
    """Fan a token stream out to several streamers."""

    def put(self, token: int) -> None:
        for streamer in self:
            streamer.put(token)

    def end(self) -> None:
        for streamer in self:
            streamer.end()

    def propagate_error(self, err: BaseException) -> None:
        for streamer in self:
            streamer.propagate_error(err)


def unwrap_processor(processor):
    """Peel adapter wrappers down to the base DetikzifyProcessor."""
    while hasattr(processor, "processor"):
        processor = processor.processor
    return processor
