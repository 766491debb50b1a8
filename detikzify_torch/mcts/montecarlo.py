"""Monte Carlo tree search driver.

Fresh implementation with the same capabilities as the vendored library the
reference uses (``detikzify/mcts/montecarlo.py:5-102``): selection descends
expanded nodes by UCT, expansion delegates to a user ``child_finder``, with
expansion statistics, optional wall-clock timeout, and visit-based final
choice. Extended with an ``on_expansion`` hook used by the pipeline for
profiling (SURVEY §5 tracing).
"""
from __future__ import annotations

import random
import time
from typing import Callable, Optional

from .node import Node


class MonteCarlo:
    def __init__(self, root_node: Node, mins_timeout: Optional[float] = None):
        self.root_node = root_node
        self.solution = None
        self.child_finder: Optional[Callable[[Node, "MonteCarlo"], None]] = None
        self.node_evaluator: Callable = lambda child, montecarlo: None
        self.stats_expansion_count = 0
        self.stats_failed_expansion_count = 0
        self.mins_timeout = mins_timeout
        self.on_expansion: Optional[Callable[[Node], None]] = None

    # -- final move selection ------------------------------------------------

    def make_choice(self) -> Node:
        """Most-visited root child (ties broken randomly)."""
        most = max(child.visits for child in self.root_node.children)
        return random.choice(
            [c for c in self.root_node.children if c.visits == most])

    def make_exploratory_choice(self) -> Node:
        """Root child sampled proportionally to visit counts."""
        weights = [child.visits for child in self.root_node.children]
        return random.choices(self.root_node.children, weights=weights)[0]

    # -- search ----------------------------------------------------------------

    def simulate(self, expansion_count: Optional[int] = 1) -> None:
        deadline = (time.time() + self.mins_timeout * 60
                    if self.mins_timeout is not None else None)
        i = 0
        while expansion_count is None or i < expansion_count:
            i += 1
            if self.solution is not None:
                return
            if deadline is not None and time.time() > deadline:
                return
            node = self.root_node
            while node.expanded:
                node = node.get_preferred_child(self.root_node)
            self.expand(node)

    def expand(self, node: Node) -> None:
        assert self.child_finder is not None, "child_finder not set"
        self.stats_expansion_count += 1
        self.child_finder(node, self)
        for child in node.children:
            value = self.node_evaluator(child, self)
            if value is not None:
                child.update_win_value(value)
            if not child.is_scorable():
                self.random_rollout(child)
                child.children = []
        if node.children:
            node.expanded = True
        else:
            self.stats_failed_expansion_count += 1
        if self.on_expansion is not None:
            self.on_expansion(node)

    def random_rollout(self, node: Node) -> None:
        """Fallback playout for nodes without a policy/visit signal."""
        assert self.child_finder is not None
        self.child_finder(node, self)
        child = random.choice(node.children)
        node.children = []
        node.add_child(child)
        value = self.node_evaluator(child, self)
        if value is not None:
            node.update_win_value(value)
        else:
            self.random_rollout(child)

    # -- diagnostics -------------------------------------------------------------

    def print_tree(self, f, label_fn=None) -> None:
        f.write("graph\n{\n")
        self.root_node.to_dot(f, 0, "a", label_fn)
        f.write("}\n")
