"""MCTS tree node with UCT scoring and deferred score normalization.

Fresh implementation of the search-tree layer (capability parity with the
vendored ImparaAI library the reference uses, ``detikzify/mcts/node.py:5-86``,
plus the generator's ``DynMinMaxNorm`` at ``infer/generate.py:85-142``),
designed around one observation: because MCTS rewards here are *perceptual
similarity scores whose range drifts as the search discovers better/worse
programs*, backpropagated values must be re-normalized every time they are
read. We therefore store raw reward entries on each node and min-max
normalize lazily against the global score set at UCT-evaluation time.
"""
from __future__ import annotations

import json
import math
import random
from typing import Callable, List, Optional, Union

Numeric = Union[int, float]


class Normalizer:
    """Dynamic min-max normalization over every score seen so far."""

    def __init__(self, default_value: float = 0.0):
        self.scores: set = set()
        self.default_value = default_value

    def add(self, score: Numeric) -> "NormScore":
        self.scores.add(score)
        return NormScore(score, self)

    __call__ = add

    def normalize(self, score: Numeric) -> float:
        lo, hi = min(self.scores), max(self.scores)
        if hi == lo:
            return self.default_value
        return (score - lo) / (hi - lo)


class NormScore:
    """A reward whose normalized value tracks the evolving score range."""

    __slots__ = ("raw", "norm")

    def __init__(self, raw: Numeric, norm: Normalizer):
        self.raw = raw
        self.norm = norm

    @property
    def value(self) -> float:
        return self.norm.normalize(self.raw)


def _value(entry) -> float:
    return entry.value if isinstance(entry, NormScore) else float(entry)


class Node:
    """Single-player UCT node.

    UCT(child) = mean(win values) + exploration * policy *
                 sqrt(log(parent.visits) / child.visits)
    Widen nodes (progressive widening) contribute no win term, acting as a
    standing "explore a fresh rollout from here" arm.
    """

    def __init__(self, state, exploration: float = 0.35):
        self.state = state
        self.exploration = exploration
        self.policy_value: Optional[float] = None
        self.visits = 0
        self.parent: Optional["Node"] = None
        self.children: List["Node"] = []
        self.expanded = False
        self.is_widen_node = False
        self._rewards: List = []

    # -- tree construction ------------------------------------------------

    def add_child(self, child: "Node") -> None:
        self.children.append(child)
        child.parent = self

    def add_children(self, children) -> None:
        for child in children:
            self.add_child(child)

    # -- value backprop ---------------------------------------------------

    def update_win_value(self, value) -> None:
        self._rewards.append(value)
        self.visits += 1
        if self.parent is not None:
            self.parent.update_win_value(value)

    def update_policy_value(self, value: float) -> None:
        self.policy_value = value

    @property
    def win_value(self) -> float:
        return sum(_value(v) for v in self._rewards)

    # -- selection ----------------------------------------------------------

    def get_score(self, root_node: "Node") -> float:
        assert self.parent is not None
        discovery = (self.exploration * (self.policy_value or 1.0)
                     * math.sqrt(math.log(max(self.parent.visits, 1))
                                 / (self.visits or 1)))
        if self.is_widen_node:
            win = 0.0
        else:
            win = self.win_value / (self.visits or 1)
        return win + discovery

    def get_preferred_child(self, root_node: "Node") -> "Node":
        best: List[Node] = []
        best_score = -math.inf
        for child in self.children:
            score = child.get_score(root_node)
            if score > best_score:
                best, best_score = [child], score
            elif score == best_score:
                best.append(child)
        return random.choice(best)

    def is_scorable(self) -> bool:
        return bool(self.visits) or self.policy_value is not None

    @property
    def depth(self) -> int:
        depth, node = 0, self
        while node.parent is not None:
            depth, node = depth + 1, node.parent
        return depth

    # -- diagnostics --------------------------------------------------------

    def to_dot(self, f, indent: int = 0, tag: str = "a",
               label_fn: Optional[Callable] = None) -> None:
        """Write this subtree in graphviz dot format (tree introspection,
        parity with reference ``print_node``)."""
        label = label_fn(self) if label_fn else repr(self.state)
        esc = json.dumps(str(label)).strip('"')
        shape = "ellipse" if self.is_widen_node else "box"
        f.write(f"{' ' * indent}{tag} [label=\"{esc}\",shape={shape}]\n")
        for i, child in enumerate(self.children):
            child_tag = f"{tag}_{i}"
            child.to_dot(f, indent + 2, child_tag, label_fn)
            f.write(f"{' ' * indent}{tag} -- {child_tag}\n")
