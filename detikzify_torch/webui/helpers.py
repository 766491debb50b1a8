"""Web UI helpers (counterpart of the JAX package's ``webui/helpers.py``;
reference ``detikzify/webui/helpers.py:12-116``)."""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple


def to_svg(doc) -> Optional[str]:
    """TikzDocument -> SVG string via PyMuPDF when available
    (reference :12-28); None when no PDF or pymupdf missing."""
    if doc.output.pdf is None:
        return None
    try:
        import fitz
    except ImportError:
        return None
    pdf = fitz.open(stream=doc.output.pdf, filetype="pdf")
    return pdf[-1].get_svg_image()


def make_light(stylable):
    """Force light-mode colors (reference helpers.py:70-85): on a theme,
    overwrite every *_dark color with its light counterpart; on a Blocks
    app, strip the .dark class client-side at load."""
    import gradio as gr

    if isinstance(stylable, gr.themes.Base):
        from inspect import signature

        params = signature(stylable.set).parameters
        light = {name: getattr(stylable, name.removesuffix("_dark"))
                 for name in dir(stylable)
                 if name.endswith("_dark") and name in params}
        return stylable.set(**light)
    if isinstance(stylable, gr.Blocks):
        stylable.load(fn=None, js="() => document.querySelectorAll('.dark')"
                                  ".forEach(el => el.classList.remove('dark'))")
        return stylable
    raise ValueError(f"cannot light-patch {type(stylable)!r}")


class MctsOutputs:
    """Deduplicated, score-sorted MCTS outputs (reference :39-68)."""

    def __init__(self):
        self._seen: Dict[str, Tuple[float, object]] = {}

    def add(self, score: float, doc) -> None:
        if not doc.is_rasterizable:
            return
        prev = self._seen.get(doc.code)
        if prev is None or score > prev[0]:
            self._seen[doc.code] = (score, doc)

    @property
    def programs(self) -> List[str]:
        return [code for code, _ in self._sorted()]

    @property
    def images(self) -> List:
        return [doc.rasterize() for _, (_, doc) in self._sorted_items()]

    @property
    def scored(self) -> List[Tuple[float, object]]:
        return [v for _, v in self._sorted_items()]

    def _sorted_items(self):
        return sorted(self._seen.items(), key=lambda kv: -kv[1][0])

    def _sorted(self):
        return [(k, v[0]) for k, v in self._sorted_items()]

    def __len__(self):
        return len(self._seen)


class GeneratorLock:
    """Serialize generator runs (reference :96-115 works around gradio
    cancel re-entrancy): acquiring while locked aborts the previous run."""

    def __init__(self, control=None):
        self._lock = threading.Lock()
        self.control = control

    def __enter__(self):
        if self.control is not None and self._lock.locked():
            self.control.abort()
        self._lock.acquire()
        return self

    def __exit__(self, *exc):
        self._lock.release()
        return False

    def wrap(self, gen):
        def inner(*args, **kwargs):
            with self:
                yield from gen(*args, **kwargs)

        return inner
