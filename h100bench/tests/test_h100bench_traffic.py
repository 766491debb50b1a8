"""Traffic, figures and weights come from ``--seed`` alone, and every seed
gets the same sizes in another order."""
from __future__ import annotations

import itertools
import json

import numpy as np
import torch

from conftest import BENCH, TINY
from h100bench import traffic, weights


PROMPT = 244      # 243 image tokens and bos


def _mix(name="sample-56"):
    with open(BENCH / "traffic" / f"{name}.json") as f:
        return json.load(f)


def test_requests_repeat_for_a_seed_and_differ_across_seeds():
    mix = _mix()
    a = list(itertools.islice(traffic.requests(mix, 2**31 + 5, PROMPT), 64))
    b = list(itertools.islice(traffic.requests(mix, 2**31 + 5, PROMPT), 64))
    c = list(itertools.islice(traffic.requests(mix, 7, PROMPT), 64))
    assert a == b and a != c


def test_context_lengths_and_the_staggered_first_hand_over():
    """Every request may decode to the end of its context; the first
    hand-over spreads its requests evenly over that length."""
    mix = _mix()
    n = mix["slots"]
    reqs = list(itertools.islice(traffic.requests(mix, 3, PROMPT), n))
    assert {r.max_new_tokens for r in reqs} == {2048 - 1 - PROMPT}
    assert traffic.longest(mix, PROMPT) == 1803
    first = traffic.staggered(reqs)
    lengths = [r.max_new_tokens for r in first]
    assert lengths == sorted(lengths) and lengths[-1] == 1803
    assert abs(lengths[0] - 1803 / n) < 1
    assert [r.figure for r in first] == [r.figure for r in reqs]


def test_every_seed_gets_the_same_lengths_and_greedy_share():
    mix = dict(_mix(), max_new_tokens={"dist": "loguniform", "low": 256,
                                       "high": 1536, "strata": 16})
    n = mix["max_new_tokens"]["strata"]
    for seed in (0, 1, 2**40):
        reqs = list(itertools.islice(traffic.requests(mix, seed, PROMPT),
                                     4 * n))
        for k in range(4):
            chunk = sorted(r.max_new_tokens for r in reqs[k * n:(k + 1) * n])
            assert chunk == sorted(traffic.length_strata(
                mix["max_new_tokens"]))
        assert sum(r.greedy for r in reqs) == 4 * n // mix["greedy_every"]
    strata = traffic.length_strata(mix["max_new_tokens"])
    assert 256 <= min(strata) and max(strata) <= 1536
    assert traffic.longest(mix, PROMPT) == max(strata)


def test_figures_repeat_for_a_seed():
    a = traffic.figures(3, 11, 384)
    b = traffic.figures(3, 11, 384)
    c = traffic.figures(3, 12, 384)
    assert [f.tobytes() for f in a] == [f.tobytes() for f in b]
    assert a[0].tobytes() != c[0].tobytes()
    assert a[0].size == (384, 384)


def test_weights_repeat_per_unit_and_seed():
    with open(TINY / "tiny-int8.json") as f:
        cfg = json.load(f)
    one = weights.draw(cfg, 2**33 + 1, "text.layers.1", "cpu")
    two = weights.draw(cfg, 2**33 + 1, "text.layers.1", "cpu")
    other = weights.draw(cfg, 2**33 + 2, "text.layers.1", "cpu")
    assert all(torch.equal(one[k], two[k]) for k in one)
    assert not torch.equal(one["text.layers.1.attn.q.weight"],
                           other["text.layers.1.attn.q.weight"])
    assert one["text.layers.1.attn.q.weight"].dtype == torch.bfloat16
    w = one["text.layers.1.mlp.down.weight"].float()
    assert abs(float(w.std()) - 128 ** -0.5) < 0.01
    assert weights.unit_seed(-3, 0) >= 0 and weights.unit_seed(2**70, 5) \
        < 2**63
    total = weights.parameter_count(cfg)
    assert total == sum(t.numel() for u, _ in weights.units(cfg)
                        for t in weights.draw(cfg, 0, u, "cpu").values())
    assert np.isfinite(total)
