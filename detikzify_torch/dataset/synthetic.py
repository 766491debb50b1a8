"""Deterministic synthetic TikZ corpus generator (a copy of
``detikzify_tpu/dataset/synthetic.py``: Python's ``random`` with the same
seed gives the same programs).

No network, no TeX: programs are assembled from realistic TikZ/pgfplots
idioms (geometric figures, flowcharts, axis plots, grids) with the
line-level repetition real TikZ exhibits -- the statistic that matters for
n-gram speculative decoding and for tokenizer training. The training
phases of ``chip_smoke.py`` take their programs from it.
"""
from __future__ import annotations

import random
from typing import List

COLORS = ["red", "blue", "black", "green!60!black", "orange", "purple",
          "gray", "teal"]
STYLES = ["thick", "dashed", "dotted", "very thick", "->", "<->", "fill=gray!20"]


def _coord(rng) -> str:
    return f"({rng.randint(0, 9)},{rng.randint(0, 9)})"


def _fig_geometric(rng) -> str:
    lines = ["\\begin{tikzpicture}"]
    for _ in range(rng.randint(3, 9)):
        kind = rng.randrange(4)
        color = rng.choice(COLORS)
        style = rng.choice(STYLES)
        if kind == 0:
            lines.append(f"\\draw[{color},{style}] {_coord(rng)} -- "
                         f"{_coord(rng)};")
        elif kind == 1:
            lines.append(f"\\draw[{color}] {_coord(rng)} circle "
                         f"({rng.randint(1, 3)});")
        elif kind == 2:
            lines.append(f"\\draw[{style}] {_coord(rng)} rectangle "
                         f"{_coord(rng)};")
        else:
            lines.append(f"\\node at {_coord(rng)} "
                         f"{{$x_{rng.randint(0, 9)}$}};")
    lines.append("\\end{tikzpicture}")
    return "\n".join(lines)


def _fig_flowchart(rng) -> str:
    n = rng.randint(3, 6)
    lines = ["\\begin{tikzpicture}[node distance=2cm]"]
    names = [f"n{i}" for i in range(n)]
    lines.append(f"\\node[draw,rectangle] ({names[0]}) {{Start}};")
    for i in range(1, n):
        shape = rng.choice(["rectangle", "ellipse", "diamond"])
        lines.append(f"\\node[draw,{shape},below of={names[i-1]}] "
                     f"({names[i]}) {{Step {i}}};")
    for i in range(1, n):
        lines.append(f"\\draw[->] ({names[i-1]}) -- ({names[i]});")
    lines.append("\\end{tikzpicture}")
    return "\n".join(lines)


def _fig_axis(rng) -> str:
    lines = ["\\begin{tikzpicture}",
             "\\begin{axis}[",
             f"    xlabel={{$x$}}, ylabel={{$f(x)$}},",
             f"    xmin=0, xmax={rng.randint(5, 10)}, ymin=0,",
             "    grid=major,",
             "]"]
    for _ in range(rng.randint(1, 3)):
        color = rng.choice(COLORS)
        mark = rng.choice(["o", "square", "triangle", "none"])
        coords = " ".join(f"({i},{rng.randint(0, 20)})"
                          for i in range(rng.randint(4, 8)))
        lines.append(f"\\addplot[{color},mark={mark}] coordinates "
                     f"{{{coords}}};")
    lines += ["\\end{axis}", "\\end{tikzpicture}"]
    return "\n".join(lines)


def _fig_grid(rng) -> str:
    w, h = rng.randint(2, 5), rng.randint(2, 5)
    lines = ["\\begin{tikzpicture}",
             f"\\draw[step=1cm,gray,very thin] (0,0) grid ({w},{h});"]
    for i in range(rng.randint(2, 6)):
        lines.append(f"\\fill[{rng.choice(COLORS)}] "
                     f"({rng.randint(0, w)},{rng.randint(0, h)}) "
                     f"circle (2pt);")
    lines.append("\\end{tikzpicture}")
    return "\n".join(lines)


GENERATORS = [_fig_geometric, _fig_flowchart, _fig_axis, _fig_grid]


def generate_corpus(n: int = 300, seed: int = 0) -> List[str]:
    """n deterministic TikZ programs with realistic idiom mix."""
    rng = random.Random(seed)
    return [rng.choice(GENERATORS)(rng) for _ in range(n)]
