"""Gradio web UI (counterpart of the JAX package's ``webui/webui.py``;
reference ``detikzify/webui/webui.py:26-341``).

Sketchpad/figure input -> streaming TikZ code pane -> score-sorted MCTS
gallery, with the caption textbox wired through to TikZero text
conditioning and the reference's advanced sampling controls (temperature /
top-p / top-k / exploration / strict) passed per call. ``inference`` runs
an MCTS search in a worker thread, and a gradio handler runs on a thread of
its own, so each device call runs under the engine's CUDA device
(``ops.cuda.device_scope``). Requires the optional ``gradio`` dependency,
imported only by ``build_ui``; everything else works without it.
"""
from __future__ import annotations

import functools
import threading
from typing import Optional

from ..infer import DetikzifyPipeline
from ..ops.cuda import device_scope
from ..utils.generation import ExplicitAbort, TextIteratorStreamer
from .helpers import GeneratorLock, MctsOutputs, make_light, to_svg
from .strings import ALGORITHMS, BANNER, CSS, GALLERY_DESELECT_JS, MODELS


def _require_gradio():
    try:
        import gradio as gr

        return gr
    except ImportError as e:
        raise ImportError(
            "the web UI requires the optional `gradio` dependency "
            "(pip install gradio); all other detikzify_torch functionality "
            "works without it") from e


@functools.lru_cache(maxsize=1)
def cached_load(model_name: str, speculate: int = 0, device="cuda"):
    """LRU(1) model load onto ``device`` (reference webui.py:63-125).
    TikZero checkpoints (with an adapter/ subdir) come back
    text-conditionable. ``speculate`` enables n-gram speculative decoding
    (distribution-preserving; auto bail-out when drafts do not pay). The
    tokenizer comes through ``transformers``, imported by
    ``load_processor`` only here."""
    from ..models.load import load

    loaded = load(model_name, device=device)
    if len(loaded) == 4:                     # (params, cfg, aproc, bundle)
        params, cfg, aproc, bundle = loaded
        return DetikzifyPipeline(params, cfg, aproc.processor,
                                 adapter=bundle, speculate=speculate,
                                 device=device)
    params, cfg, processor = loaded
    return DetikzifyPipeline(params, cfg, processor, speculate=speculate,
                             device=device)


def inference(pipeline: DetikzifyPipeline, image, *, text: Optional[str] = None,
              algorithm: str = "mcts", timeout: Optional[float] = None,
              expansions=None, control: Optional[ExplicitAbort] = None,
              temperature: Optional[float] = None,
              top_p: Optional[float] = None, top_k: Optional[int] = None,
              exploration: Optional[float] = None, strict: bool = False,
              preprocess: bool = True,
              compile_timeout: Optional[float] = None):
    """Generator yielding (partial_code, outputs) for UI streaming.

    ``text`` conditions generation through the TikZero adapter (and the
    TikZero+ prompt when the checkpoint expects it). ``timeout`` is the
    MCTS wall-clock budget in seconds; ``compile_timeout`` overrides the
    per-document LaTeX limit (reference webui.py:280 partials it in)."""
    outputs = MctsOutputs()
    streamer = TextIteratorStreamer(pipeline.processor)
    text_parts = []
    gen_kwargs = dict(temperature=temperature, top_p=top_p, top_k=top_k,
                      compile_timeout=compile_timeout)
    device = pipeline.engine.device

    if algorithm == "sampling":
        with device_scope(device):
            doc = pipeline.sample(image=image, text=text,
                                  preprocess=preprocess,
                                  on_token=streamer.put, control=control,
                                  **gen_kwargs)
        outputs.add(0.0, doc)
        yield doc.code, outputs
        return

    done = threading.Event()
    results = []

    def work():
        try:
            with device_scope(device):
                search = pipeline.simulate(
                    image=image, text=text, preprocess=preprocess,
                    timeout=timeout, expansions=expansions, control=control,
                    on_token=streamer.put, exploration=exploration,
                    strict=strict, **gen_kwargs)
                for score, doc in search:
                    results.append((score, doc))
        finally:
            streamer.end()
            done.set()

    thread = threading.Thread(target=work, daemon=True)
    thread.start()
    consumed = 0
    for delta in streamer:
        text_parts.append(delta)
        while consumed < len(results):
            outputs.add(*results[consumed])
            consumed += 1
        yield "".join(text_parts), outputs
    thread.join()
    while consumed < len(results):
        outputs.add(*results[consumed])
        consumed += 1
    yield "".join(text_parts), outputs


def build_ui(model: str = "detikzify-v2.5-8b", *, algorithm: str = "mcts",
             lock: bool = False, lock_reason: str = "",
             light: bool = False, timeout: Optional[int] = 60,
             speculate: int = 0, device="cuda"):
    """Assemble the gradio Blocks app (reference webui.py:131-341).

    ``algorithm`` preselects the inference algorithm radio;
    ``lock_reason`` explains a locked model dropdown; ``timeout`` is the
    per-document LaTeX compile limit in seconds (reference semantics --
    the MCTS wall-clock budget is the UI "Timeout" slider, in minutes);
    ``device`` is where the selected model is loaded."""
    gr = _require_gradio()
    control = ExplicitAbort()
    run_lock = GeneratorLock(control) if lock else None

    theme = gr.themes.Soft()
    if light:
        theme = make_light(theme)
    with gr.Blocks(css=CSS, theme=theme, title="DeTikZify",
                   head=GALLERY_DESELECT_JS) as demo:
        if light:
            make_light(demo)
        gr.Markdown(BANNER)
        with gr.Row():
            with gr.Column():
                sketchpad = gr.ImageEditor(
                    label="Sketchpad", type="pil",
                    elem_classes="input-image",
                    brush=gr.Brush(colors=["black", "red", "green", "blue"],
                                   default_size=1))
                caption = gr.Textbox(
                    label="Caption",
                    info="Text condition for TikZero adapters; leave empty "
                         "for image-only generation.", value="")
                with gr.Row():
                    run_btn = gr.Button("Generate", variant="primary")
                    stop_btn = gr.Button("Stop", variant="stop")
                    clear_btn = gr.ClearButton(sketchpad, variant="stop")
            with gr.Column():
                code_pane = gr.Code(label="TikZ program", language=None,
                                    elem_classes="output-code")
                gallery = gr.Gallery(label="MCTS outputs (best first)",
                                     columns=3, elem_classes="output-image")
                preview_close = gr.Button(visible=False,
                                          elem_id="preview-close")
                svg_btn = gr.DownloadButton("Download SVG", visible=False)

        is_mcts = algorithm == "mcts"
        with gr.Accordion(label="Settings", open=False):
            model_dd = gr.Dropdown(
                choices=list(MODELS), value=model, label="Model",
                interactive=not lock,
                info=lock_reason if lock else None)
            algorithm = gr.Radio(
                choices=list(ALGORITHMS), value=algorithm,
                label="Algorithm", info="; ".join(
                    f"{k}: {v}" for k, v in ALGORITHMS.items()))
            with gr.Accordion(label="Advanced"):
                temperature = gr.Slider(0.0, 2.0, value=0.8, step=0.1,
                                        label="Temperature")
                top_p = gr.Slider(0.0, 1.0, value=0.95, step=0.05,
                                  label="Top-p")
                top_k = gr.Slider(0, 100, value=0, step=5, label="Top-k")
                exploration = gr.Slider(0.0, 2.0, value=0.6, step=0.1,
                                        visible=is_mcts,
                                        label="Exploration coefficient")
                budget = gr.Slider(0, 60, value=10, step=1, label="Timeout",
                                   visible=is_mcts,
                                   info="Minutes after which MCTS stops "
                                        "(0 = unlimited).")
                strict = gr.Checkbox(value=False, label="Strict mode",
                                     visible=is_mcts,
                                     info="Treat recoverable compile errors "
                                          "as fatal when scoring rollouts.")
                preprocess = gr.Checkbox(value=True, label="Preprocess",
                                         info="Trim to content and expand "
                                              "to a square before encoding.")

        state_outputs = gr.State(None)

        def run(image_editor, text, model_name, algo, temp, tp, tk, expl,
                minutes, strict_mode, prep):
            image = (image_editor or {}).get("composite") \
                if isinstance(image_editor, dict) else image_editor
            pipe = cached_load(MODELS.get(model_name, model_name),
                               speculate=speculate, device=device)
            gen = inference(pipe, image, text=text or None, algorithm=algo,
                            timeout=minutes * 60 if minutes else None,
                            compile_timeout=timeout,
                            control=control.reset(),
                            temperature=temp, top_p=tp, top_k=int(tk),
                            exploration=expl, strict=strict_mode,
                            preprocess=prep)
            if run_lock is not None:
                gen = run_lock.wrap(lambda: gen)()
            for code, outputs in gen:
                yield code, outputs.images, outputs

        def stop():
            control.abort()

        def toggle_mcts_controls(algo):
            # reference webui.py:289-300: MCTS-only knobs hide in sampling
            vis = gr.update(visible=algo == "mcts")
            return vis, vis, vis

        algorithm.change(toggle_mcts_controls, inputs=[algorithm],
                         outputs=[exploration, budget, strict])

        run_event = run_btn.click(
            run, inputs=[sketchpad, caption, model_dd, algorithm,
                         temperature, top_p, top_k, exploration, budget,
                         strict, preprocess],
            outputs=[code_pane, gallery, state_outputs])
        stop_btn.click(stop, cancels=[run_event])
        clear_btn.add([code_pane, gallery])

        def select_program(outputs, evt: "gr.SelectData"):
            if outputs is None:
                return gr.update(), gr.update()
            _, doc = outputs.scored[evt.index]
            svg = to_svg(doc)
            if svg is None:
                return outputs.programs[evt.index], gr.update(visible=False)
            import tempfile

            with tempfile.NamedTemporaryFile("w", suffix=".svg",
                                             delete=False) as f:
                f.write(svg)
            return outputs.programs[evt.index], gr.update(visible=True,
                                                          value=f.name)

        def deselect_program():
            # preview closed: hide the download button, keep the code pane
            return gr.update(visible=False)

        gallery.select(select_program, inputs=[state_outputs],
                       outputs=[code_pane, svg_btn])
        preview_close.click(deselect_program, outputs=[svg_btn])

    return demo


def launch(model: str = "detikzify-v2.5-8b", share: bool = False, **kw):
    demo = build_ui(model, **kw)
    return demo.queue().launch(share=share)
