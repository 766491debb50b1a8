from .generator import DetikzifyGenerator, ExplicitAbort, NodeState, WideNode
from .pipeline import DetikzifyPipeline
from .tikz import (CompileService, FakeBackend, LatexmkBackend, TikzDocument,
                   parse_errors, set_backend)

__all__ = [
    "DetikzifyGenerator", "ExplicitAbort", "NodeState", "WideNode",
    "DetikzifyPipeline",
    "CompileService", "FakeBackend", "LatexmkBackend", "TikzDocument",
    "parse_errors", "set_backend",
]
