"""TikZ compile/render runtime.

Host-side service replacing reference ``detikzify/infer/tikz.py:21-168``
(behavior-compatible ``TikzDocument``) re-architected for the batched decode pipeline:
compilation runs in an **async worker pool** (`CompileService`) so LaTeX
never blocks the device decode loop — the reference compiles inline inside
the MCTS expansion (``infer/generate.py:319``), serializing rollouts.

Pluggable backends:
  * ``LatexmkBackend`` -- real toolchain: latexmk engine chain
    [pdflatex, lualatex, xelatex], keep the attempt whose first error is
    latest (reference tikz.py:89-131); rasterize via pdftoppm/pymupdf.
  * ``FakeBackend``    -- deterministic hermetic stub mapping
    code -> (status, error lines, rendered image). Makes MCTS testable
    and benchmarkable without TeX Live (SURVEY §4 "fake LaTeX compiler").

Select via ``set_backend()`` or env ``DETIKZIFY_TPU_COMPILER=fake|latexmk``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import io
import os
import re
import shutil
import subprocess
import tempfile
from concurrent.futures import Future, ThreadPoolExecutor
from functools import cached_property
from typing import Dict, Optional

from PIL import Image, ImageDraw

from ..utils.image import expand
from ..utils.subprocess import run as run_killpg

DEFAULT_TIMEOUT = 60  # seconds, reference infer/generate.py:153


@dataclasses.dataclass
class CompileResult:
    status: int                      # 0 ok, 1 recoverable errors, 2 fatal
    log: str = ""
    pdf: Optional[bytes] = None
    image: Optional[Image.Image] = None   # fake backend renders directly

    @property
    def compiled(self) -> bool:
        return self.pdf is not None or self.image is not None


# ---------------------------------------------------------------------------
# error-log parsing
# ---------------------------------------------------------------------------

#: reference tikz.py:61: the root file is the first line-initial ``(path``
_ROOTFILE = re.compile(r"^\((.+)$", re.M)
_FILE_LINE_ERR = re.compile(r"^(.+):(\d+):(.+)$", re.M)

#: reference tikz.py:73 -- emitted when a failed compile's log has no
#: parseable ``file:line:msg`` at all
FATAL_ERROR_MSG = "Fatal error occurred, no output PDF file produced!"


def parse_errors(log: str, rootfile: Optional[str] = None) -> Dict[int, str]:
    """latexmk/pdflatex ``-file-line-error`` log -> {line: message}.

    Reference-identical semantics (reference tikz.py:54-73, verified by the
    differential test in ``tests/test_tikz_reference_diff.py``):

      * ``rootfile`` defaults to the first line-initial ``(path`` in the
        log (how TeX echoes opening the main file);
      * ``file:line:msg`` lines in the root file map to ``{line: msg}``,
        later messages for the same line OVERWRITE earlier ones;
      * errors in any other file collapse onto line 0 (unlocatable);
      * no rootfile found -> every error is unlocatable (line 0).

    The ``{0: FATAL_ERROR_MSG}`` fallback for failed compiles with no
    parseable error lives in ``TikzDocument.errors`` (like the reference's
    ``errors`` property, which only fires on ``compiled_with_errors``).
    """
    if not rootfile and (match := _ROOTFILE.search(log)):
        rootfile = match.group(1)
    errors: Dict[int, str] = {}
    for file, line, error in _FILE_LINE_ERR.findall(log):
        if file == rootfile:
            errors[int(line)] = error.strip()
        else:
            errors[0] = error.strip()
    return errors


def first_error_line(log: str, rootfile: Optional[str] = None
                     ) -> Optional[int]:
    errs = parse_errors(log, rootfile)
    return min(errs) if errs else None


def select_best_attempt(attempts, rootfile: Optional[str] = None
                        ) -> Optional[int]:
    """Index of the engine attempt the reference chain would keep.

    Direct transcription of reference tikz.py:111-131: the first attempt
    with returncode 0 wins outright; otherwise keep the attempt whose
    FIRST root-file ``file:line:`` error in the log (in log order, not
    minimum line) has the largest line number; attempts with no such error
    rank as line 0; earlier engines win ties. ``attempts`` is a sequence
    of ``(returncode, log)``.
    """
    errorln, best = -1, None
    for i, (returncode, log) in enumerate(attempts):
        if returncode == 0:
            return i
        match = (re.search(rf"^{re.escape(rootfile)}:(\d+):.+$", log, re.M)
                 if rootfile else None)
        linenr = int(match.group(1)) if match else 0
        if linenr > errorln:
            errorln, best = linenr, i
    return best


# ---------------------------------------------------------------------------
# PDF margin cropping
# ---------------------------------------------------------------------------

#: pdfCropMargins is invoked with ``-p 0 -a -1`` in the reference
#: (infer/tikz.py:134-137): crop to the tight ink bbox, then shave one more
#: point off each side.
PT_SHAVE = 1.0


def _pixmap_ink_bbox(samples: bytes, width: int, height: int, n: int
                     ) -> Optional[tuple]:
    """Tight (l, t, r, b) pixel bbox of non-white ink in raw RGB(A) samples."""
    import numpy as np

    arr = np.frombuffer(samples, np.uint8).reshape(height, width, n)[..., :3]
    mask = (arr != 255).any(axis=2)
    rows = np.flatnonzero(mask.any(axis=1))
    cols = np.flatnonzero(mask.any(axis=0))
    if rows.size == 0:
        return None
    return int(cols[0]), int(rows[0]), int(cols[-1]) + 1, int(rows[-1]) + 1


def crop_pdf_margins(pdf: bytes, dpi: float = 144.0) -> bytes:
    """PDF-space margin crop: set each page's CropBox to its tight ink
    bounding box shaved by ``PT_SHAVE`` points per side.

    Equivalent to the reference's pdfCropMargins+ghostscript pass
    (``infer/tikz.py:134-137`` with ``-gsf -p 0 -a -1``): the ink bbox is
    measured by rendering (like gs's bbox device), the crop happens in PDF
    space so downstream rasterization at any size sees identical geometry.
    Gated on pymupdf; returns the input unchanged when unavailable (the
    raster-side fallback in ``LatexmkBackend.rasterize`` then emulates the
    same geometry at render resolution).
    """
    try:
        import fitz
    except ImportError:
        return pdf
    try:
        doc = fitz.open(stream=pdf, filetype="pdf")
        changed = False
        for page in doc:
            zoom = dpi / 72.0
            pix = page.get_pixmap(matrix=fitz.Matrix(zoom, zoom), alpha=False)
            bbox = _pixmap_ink_bbox(pix.samples, pix.width, pix.height, pix.n)
            if bbox is None:
                continue
            l, t, r, b = (v / zoom for v in bbox)
            rect = fitz.Rect(l + PT_SHAVE, t + PT_SHAVE,
                             r - PT_SHAVE, b - PT_SHAVE)
            # page.rect is cropbox-relative; translate into mediabox space
            rect = fitz.Rect(rect.x0 + page.cropbox.x0,
                             rect.y0 + page.cropbox.y0,
                             rect.x1 + page.cropbox.x0,
                             rect.y1 + page.cropbox.y0)
            rect &= page.mediabox
            if rect.is_empty or rect.is_infinite:
                continue
            page.set_cropbox(rect)
            changed = True
        return doc.tobytes() if changed else pdf
    except Exception:
        return pdf   # malformed PDF: reference swallows crop errors too


def raster_crop_margins(img: Image.Image, dpi: float) -> Image.Image:
    """Raster-space emulation of ``crop_pdf_margins`` for toolchains
    without pymupdf: crop to the ink bbox inset by PT_SHAVE's pixel
    equivalent at ``dpi``."""
    import numpy as np

    arr = np.asarray(img.convert("RGB"))
    mask = (arr != 255).any(axis=2)
    rows = np.flatnonzero(mask.any(axis=1))
    cols = np.flatnonzero(mask.any(axis=0))
    if rows.size == 0:
        return img
    shave = int(round(PT_SHAVE * dpi / 72.0))
    l, t = int(cols[0]) + shave, int(rows[0]) + shave
    r, b = int(cols[-1]) + 1 - shave, int(rows[-1]) + 1 - shave
    if r <= l or b <= t:
        return img.crop((int(cols[0]), int(rows[0]),
                         int(cols[-1]) + 1, int(rows[-1]) + 1))
    return img.crop((l, t, r, b))


# ---------------------------------------------------------------------------
# backends
# ---------------------------------------------------------------------------

class LatexmkBackend:
    """Real LaTeX toolchain driver.

    Engine chain with best-attempt selection like reference tikz.py:89-131:
    run each engine, keep the attempt whose first error appears latest in
    the source (more of the program compiled). ``\\thispagestyle{empty}``
    is injected to suppress page numbers (tikz.py:94-95).
    """

    ENGINES = ("pdflatex", "lualatex", "xelatex")

    @staticmethod
    def available() -> bool:
        return shutil.which("latexmk") is not None

    def compile(self, code: str, timeout: float = DEFAULT_TIMEOUT) -> CompileResult:
        doc = self._prepare(code)
        with tempfile.TemporaryDirectory() as tmp:
            tex = os.path.join(tmp, "doc.tex")
            with open(tex, "w") as f:
                f.write(doc)
            # one shared build dir across the engine chain, like the
            # reference (tikz.py:92-131): a later engine may salvage a PDF
            # an earlier engine already produced
            attempts = []
            for engine in self.ENGINES:
                rc, log, pdf = self._run_engine(tex, tmp, engine, timeout)
                if rc == 0:
                    # reference tikz.py:128-131: first clean engine wins
                    if pdf is not None:
                        pdf = crop_pdf_margins(pdf)
                    return CompileResult(status=0, log=log, pdf=pdf)
                attempts.append((rc, log, pdf))
            if not attempts:
                return CompileResult(status=2, log="no engine available")
            best = select_best_attempt(
                [(rc, log) for rc, log, _ in attempts], rootfile=tex)
            _, log, pdf = attempts[best]
            if pdf is not None:
                pdf = crop_pdf_margins(pdf)
            return CompileResult(status=1 if pdf else 2, log=log, pdf=pdf)

    def _prepare(self, code: str) -> str:
        if "\\documentclass" not in code:
            # prepend ON THE SAME LINE: log line numbers must keep
            # indexing the caller's code lines (MCTS error-line-bounded
            # attach maps doc.errors keys to node line counts)
            code = "\\documentclass[tikz]{standalone}" + code
        if "\\thispagestyle{empty}" not in code and "\\begin{document}" in code:
            code = code.replace("\\begin{document}",
                                "\\begin{document}\\thispagestyle{empty}", 1)
        return code

    def _run_engine(self, tex: str, tmp: str, engine: str, timeout: float):
        """One latexmk attempt -> (returncode, log, pdf-bytes-or-None)."""
        cmd = ["latexmk", "-f", "-nobibtex", "-norc", "-file-line-error",
               "-interaction=nonstopmode", f"-{engine}",
               "-output-directory=" + tmp, tex]
        timed_out = False
        log = ""
        # the build dir is shared across the engine chain: a stale log from
        # a previous engine must not be attributed to this attempt (PDFs
        # stay -- last-page salvage reads whatever the dir holds, like the
        # reference's try_save_last_page)
        stale = os.path.join(tmp, "doc.log")
        if os.path.exists(stale):
            os.remove(stale)
        try:
            # max_print_line keeps file:line errors unwrapped in the log
            # (reference tikz.py:118)
            proc = run_killpg(cmd, timeout=timeout, cwd=tmp,
                              env={**os.environ, "max_print_line": "1000"})
            rc = proc.returncode
            log = (proc.stdout + proc.stderr).decode("utf-8", "ignore")
        except subprocess.TimeoutExpired:
            rc, timed_out = -1, True
        logfile = os.path.join(tmp, "doc.log")
        if os.path.exists(logfile):
            with open(logfile, "rb") as f:
                log = f.read().decode("utf-8", "ignore")
        elif timed_out:
            log = "timeout"
        pdf_path = os.path.join(tmp, "doc.pdf")
        pdf = None
        if os.path.exists(pdf_path):
            with open(pdf_path, "rb") as f:
                pdf = f.read()
        return rc, log, pdf

    def rasterize(self, pdf: bytes, size: int = 420) -> Optional[Image.Image]:
        """PDF -> square PIL image (last page wins, matching the reference's
        salvage-last-page behavior, tikz.py:103-109).

        The page arrives margin-cropped from ``crop_pdf_margins``; the
        reference then scales the longest side to ``size`` (pdf2image
        ``size=420`` == pdftoppm -scale-to) and pads square
        (tikz.py:149-156). The pdftoppm fallback emulates the PDF-space
        crop in raster space first (same geometry at render dpi)."""
        try:
            import fitz  # pymupdf

            doc = fitz.open(stream=pdf, filetype="pdf")
            page = doc[-1]
            rect = page.rect       # CropBox set by crop_pdf_margins
            zoom = size / max(rect.width, rect.height)
            pix = page.get_pixmap(matrix=fitz.Matrix(zoom, zoom), alpha=False)
            mode = "RGB" if pix.n == 3 else "RGBA"
            img = Image.frombytes(mode, (pix.width, pix.height), pix.samples)
            return expand(img, size)
        except ImportError:
            pass
        if shutil.which("pdftoppm"):
            with tempfile.TemporaryDirectory() as tmp:
                pdf_path = os.path.join(tmp, "doc.pdf")
                with open(pdf_path, "wb") as f:
                    f.write(pdf)
                dpi = 200
                run_killpg(["pdftoppm", "-png", "-r", str(dpi), "-l", "99",
                            pdf_path, os.path.join(tmp, "page")], timeout=60)
                pages = sorted(p for p in os.listdir(tmp) if p.endswith(".png"))
                if pages:
                    img = Image.open(os.path.join(tmp, pages[-1]))
                    return expand(raster_crop_margins(img, dpi), size)
        return None


class FakeBackend:
    """Deterministic hermetic compiler double (SURVEY §4).

    Semantics (stable across runs, content-addressed):
      * a line containing ``\\errorline`` fails at that 1-based line
      * unbalanced ``{``/``}`` or ``\\begin{...}`` without matching
        ``\\end{...}`` at EOF fails at the offending line
      * otherwise compiles; renders a synthetic image whose content is a
        hash-derived pattern of the code (so different programs score
        differently under perceptual metrics)
    """

    def __init__(self, size: int = 420, latency: float = 0.0):
        self.size = size
        self.latency = latency

    @staticmethod
    def available() -> bool:
        return True

    def compile(self, code: str, timeout: float = DEFAULT_TIMEOUT) -> CompileResult:
        if self.latency:
            import time

            time.sleep(min(self.latency, timeout))
        lines = code.split("\n")
        depth = 0
        env_stack = []
        for i, line in enumerate(lines, start=1):
            if "\\errorline" in line:
                return CompileResult(
                    status=2, log=f"(./doc.tex\n./doc.tex:{i}: Injected error.\n")
            depth += line.count("{") - line.count("}")
            if depth < 0:
                return CompileResult(
                    status=2, log=f"(./doc.tex\n./doc.tex:{i}: Too many }}'s.\n")
            for env in re.findall(r"\\begin\{(\w+)\}", line):
                env_stack.append((env, i))
            for env in re.findall(r"\\end\{(\w+)\}", line):
                if env_stack and env_stack[-1][0] == env:
                    env_stack.pop()
                else:
                    return CompileResult(
                        status=2,
                        log=f"(./doc.tex\n./doc.tex:{i}: \\end{{{env}}} without "
                            f"matching \\begin.\n")
        if env_stack:
            env, line = env_stack[-1]
            return CompileResult(
                status=1,
                log=f"(./doc.tex\n./doc.tex:{line}: \\begin{{{env}}} ended by "
                    f"end of file.\n",
                image=self._render(code))
        if depth != 0:
            return CompileResult(
                status=1,
                log=f"(./doc.tex\n./doc.tex:{len(lines)}: File ended while "
                    f"scanning.\n",
                image=self._render(code))
        return CompileResult(status=0, log="", image=self._render(code))

    def _render(self, code: str) -> Image.Image:
        """Hash-derived deterministic drawing: same code -> same image."""
        img = Image.new("RGB", (self.size, self.size), "white")
        draw = ImageDraw.Draw(img)
        digest = hashlib.sha256(code.encode()).digest()
        s = self.size
        for j in range(0, 24, 6):
            x0, y0, x1, y1 = (digest[j] * s // 256, digest[j + 1] * s // 256,
                              digest[j + 2] * s // 256, digest[j + 3] * s // 256)
            color = (digest[j + 4] % 200, digest[j + 5] % 200,
                     (digest[j + 4] + digest[j + 5]) % 200)
            shape = digest[j] % 3
            box = (min(x0, x1), min(y0, y1), max(x0, x1) + 8, max(y0, y1) + 8)
            if shape == 0:
                draw.rectangle(box, outline=color, width=3)
            elif shape == 1:
                draw.ellipse(box, outline=color, width=3)
            else:
                draw.line((x0, y0, x1, y1), fill=color, width=3)
        return img

    def render_redacted(self, code: str, rot13: bool = False,
                        size: int = 420) -> Image.Image:
        """Deterministic stand-in for PDF text redaction (rot13 variant):
        renders the hash pattern of the transformed code, so redacted
        metrics get a distinct-but-stable image without a PDF toolchain."""
        import codecs

        tag = "rot13:" if rot13 else "redact:"
        img = self._render(tag + codecs.encode(code, "rot13"))
        return img if img.size == (size, size) else img.resize((size, size))

    def rasterize(self, pdf, size: int = 420):  # pragma: no cover
        return None


_BACKEND = None


def get_backend():
    global _BACKEND
    if _BACKEND is None:
        choice = os.environ.get("DETIKZIFY_TPU_COMPILER", "auto")
        if choice == "fake":
            _BACKEND = FakeBackend()
        elif choice == "latexmk":
            _BACKEND = LatexmkBackend()
        else:
            _BACKEND = (LatexmkBackend() if LatexmkBackend.available()
                        else FakeBackend())
    return _BACKEND


def set_backend(backend) -> None:
    global _BACKEND
    _BACKEND = backend


# ---------------------------------------------------------------------------
# TikzDocument
# ---------------------------------------------------------------------------

class TikzDocument:
    """A TikZ program with lazy compile / error-parse / rasterize.

    Same user surface as reference ``TikzDocument`` (tikz.py:21-168):
    ``.compile()``, ``.errors``, ``.compiled_with_errors``,
    ``.is_rasterizable``, ``.has_content``, ``.rasterize()``, ``.save()``.
    """

    def __init__(self, code: str, timeout: float = DEFAULT_TIMEOUT,
                 backend=None):
        self.code = code
        self.timeout = timeout
        self.backend = backend or get_backend()

    def __eq__(self, other):
        return isinstance(other, TikzDocument) and self.code == other.code

    def __hash__(self):
        return hash(self.code)

    @cached_property
    def output(self) -> CompileResult:
        return self.backend.compile(self.code, self.timeout)

    def compile(self) -> CompileResult:
        return self.output

    @property
    def status(self) -> int:
        return self.output.status

    @property
    def log(self) -> str:
        return self.output.log

    @cached_property
    def errors(self) -> Dict[int, str]:
        """Reference tikz.py:54-73: {} on clean compiles; on failures the
        parsed {line: msg} map, or {0: FATAL_ERROR_MSG} when nothing in
        the log is parseable (timeouts, missing toolchain)."""
        if self.output.status != 0:
            return parse_errors(self.output.log) or {0: FATAL_ERROR_MSG}
        return {}

    @property
    def compiled_with_errors(self) -> bool:
        # reference tikz.py:50-52: nonzero status, whether or not a PDF
        # was salvaged -- a fatal compile IS "compiled with errors", which
        # the fast metric scores as -1 (reference generate.py:340)
        return self.output.status != 0

    @cached_property
    def _raster(self) -> Optional[Image.Image]:
        out = self.output
        if out.image is not None:
            return out.image
        if out.pdf is not None:
            return self.backend.rasterize(out.pdf)
        return None

    @property
    def is_rasterizable(self) -> bool:
        return self._raster is not None

    @property
    def has_content(self) -> bool:
        """Rendered output is not blank (reference tikz.py:79-83)."""
        img = self._raster
        if img is None:
            return False
        extrema = img.convert("L").getextrema()
        return extrema[0] != extrema[1]

    def rasterize(self, size: int = 420) -> Optional[Image.Image]:
        img = self._raster
        if img is None:
            return None
        return expand(img, size)

    def save(self, path: str) -> None:
        ext = os.path.splitext(path)[1].lower()
        if ext == ".tex":
            with open(path, "w") as f:
                f.write(self.code)
        elif ext == ".pdf":
            if self.output.pdf is None:
                raise ValueError("document did not produce a PDF")
            with open(path, "wb") as f:
                f.write(self.output.pdf)
        else:
            img = self.rasterize()
            if img is None:
                raise ValueError("document is not rasterizable")
            img.save(path)


# ---------------------------------------------------------------------------
# async compile service
# ---------------------------------------------------------------------------

class CompileService:
    """Async compile pool overlapping LaTeX with device decode.

    The reference compiles synchronously inside each MCTS expansion; here
    rollouts enqueue compiles and the tree update consumes futures, keeping
    the device busy (SURVEY §3.3 hot-spot (3), §7 stage 4).
    """

    def __init__(self, workers: int = 4, backend=None,
                 timeout: float = DEFAULT_TIMEOUT):
        self.pool = ThreadPoolExecutor(max_workers=workers,
                                       thread_name_prefix="tikz-compile")
        self.backend = backend or get_backend()
        self.timeout = timeout

    def submit(self, code: str) -> "Future[TikzDocument]":
        doc = TikzDocument(code, timeout=self.timeout, backend=self.backend)
        return self.submit_doc(doc)

    def submit_doc(self, doc: TikzDocument) -> "Future[TikzDocument]":
        def work() -> TikzDocument:
            doc.compile()   # force lazy compile in the pool
            doc.rasterize()
            return doc

        return self.pool.submit(work)

    def shutdown(self) -> None:
        self.pool.shutdown(wait=False, cancel_futures=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
