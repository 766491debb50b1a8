"""Web UI model registry and UI strings (counterpart of the JAX package's
``webui/strings.py``)."""

BANNER = """\
# DeTikZify: Synthesizing Graphics Programs for Scientific Figures \
and Sketches with TikZ

Generate TikZ programs from raster figures or hand-drawn sketches,
optionally refined with MCTS and compiler feedback.
"""

# reference strings.py:24-41: v2.5/v2 under their plain names; the timm
# (v1) family is displayed with a ``-v1-`` infix (the reference renames
# ``detikzify-ds-7b`` -> ``detikzify-v1-ds-7b`` in the dropdown, values
# stay the hub ids)
MODELS = {
    "detikzify-v2.5-8b": "nllg/detikzify-v2.5-8b",
    "detikzify-v2-8b": "nllg/detikzify-v2-8b",
} | {
    name.split("/")[1].replace("detikzify", "detikzify-v1"): name
    for name in ("nllg/detikzify-ds-7b", "nllg/detikzify-cl-7b",
                 "nllg/detikzify-ds-1.3b", "nllg/detikzify-tl-1.1b")
}

ALGORITHMS = {
    "mcts": "MCTS-based refinement (iteratively improves output quality)",
    "sampling": "One-shot sampling (fastest)",
}

CSS = """
.gallery-item { object-fit: contain !important; }
footer { visibility: hidden }
.input-image { flex-grow: 1; }
.output-code { flex-grow: 1; min-height: 250px; scrollbar-width: thin !important; }
.output-code .cm-scroller { flex-grow: 1; }
.output-image { flex-grow: 1; min-height: 250px; overflow-y: auto !important; }
.output-image .thumbnail-item img { object-fit: contain; }
"""

# Gallery previews have no close event in gradio; watch the DOM for the
# preview button disappearing and forward it to a hidden button so the app
# can restore the streaming code pane (reference strings.py:110-131 works
# around gradio-app/gradio#6697 the same way).
GALLERY_DESELECT_JS = """
<script>
  new MutationObserver((muts) => {
    for (const m of muts) {
      for (const n of m.removedNodes) {
        if (n.nodeName === "BUTTON" && n.classList &&
            n.classList.contains("preview")) {
          const btn = document.getElementById("preview-close");
          if (btn) btn.click();
        }
      }
    }
  }).observe(document.body, {childList: true, subtree: true});
</script>
"""
