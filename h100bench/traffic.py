"""The one traffic generator: a mix file's parameters and ``--seed`` ->
figures and requests.

Every seed gets the same sizes in the same order and differs only in its
figures (and the weights), so two seeds put the same work into a window.
A mix's ``max_new_tokens`` is ``"context"`` (each request may decode to
the end of the context, ``max_len`` - 1 - the prompt, as the system's
one-shot sampling does by default), a fixed number, or a distribution
drawn by strata (each run of ``strata``
requests holds one length from each of ``strata`` equal-probability
slices, in an order fixed once for all seeds). Every
``greedy_every``-th request decodes greedily (the requests whose tokens
the comparison with the reference can judge one by one).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterator, List

import numpy as np
from PIL import Image, ImageDraw


def figures(n: int, seed: int, size: int) -> List[Image.Image]:
    """``n`` line-art figures of ``size`` x ``size`` drawn from ``seed``."""
    rng = np.random.default_rng([abs(int(seed)), 7])
    out = []
    for _ in range(n):
        img = Image.new("RGB", (size, size), "white")
        draw = ImageDraw.Draw(img)
        for _ in range(int(rng.integers(3, 9))):
            x0, x1 = sorted(int(x) for x in rng.integers(0, size, 2))
            y0, y1 = sorted(int(y) for y in rng.integers(0, size, 2))
            color = tuple(int(c) for c in rng.integers(0, 200, 3))
            kind = int(rng.integers(3))
            if kind == 0:
                draw.rectangle([x0, y0, x1, y1], outline=color, width=2)
            elif kind == 1:
                draw.ellipse([x0, y0, x1, y1], outline=color, width=2)
            else:
                draw.line([x0, y0, x1, y1], fill=color, width=2)
        out.append(img)
    return out


def staggered(reqs: List[Request]) -> List[Request]:
    """The first hand-over of a closed loop whose requests all ask for
    one length: request i of n asks for (i + 1) / n of it, so that the
    loop runs as it does once it has turned over (one request in flight
    at each n-th of its decode) from the first block on."""
    n = len(reqs)
    return [dataclasses.replace(r, max_new_tokens=max(
        1, r.max_new_tokens * (i + 1) // n)) for i, r in enumerate(reqs)]


def length_strata(dist: dict) -> List[int]:
    """The ``strata`` lengths, one at the middle of each slice."""
    lo, hi, n = dist["low"], dist["high"], dist["strata"]
    qs = [(j + 0.5) / n for j in range(n)]
    if dist["dist"] == "loguniform":
        return [int(round(lo * math.exp(q * math.log(hi / lo)))) for q in qs]
    if dist["dist"] == "uniform":
        return [int(round(lo + q * (hi - lo))) for q in qs]
    raise ValueError(f"unknown length distribution {dist['dist']!r}")


@dataclasses.dataclass(frozen=True)
class Request:
    index: int
    figure: int              # index into the run's figure pool
    max_new_tokens: int
    greedy: bool


def longest(mix: dict, prompt_len: int) -> int:
    """The most new tokens a request of the mix asks for."""
    n = mix["max_new_tokens"]
    if n == "context":
        return mix["max_len"] - 1 - prompt_len
    return n if isinstance(n, int) else max(length_strata(n))


def requests(mix: dict, seed: int, prompt_len: int) -> Iterator[Request]:
    """The endless request stream of a closed loop."""
    rng = np.random.default_rng([abs(int(seed)), 11])
    fixed = np.random.default_rng(11)
    n = mix["max_new_tokens"]
    strata = (length_strata(n) if isinstance(n, dict)
              else [longest(mix, prompt_len)])
    pool = mix["figures"]
    order: List[int] = []
    lengths: List[int] = []
    i = 0
    while True:
        if not lengths:
            lengths = [strata[j] for j in fixed.permutation(len(strata))]
        if not order:
            order = [int(j) for j in rng.permutation(pool)]
        yield Request(i, order.pop(), lengths.pop(),
                      i % mix["greedy_every"] == mix["greedy_every"] - 1)
        i += 1
