"""The port's web UI (``detikzify_torch.webui``), its streamers and the
serving CLI, on the CPU.

``build_ui`` runs against the structural fake gradio of
``tests/fake_gradio.py`` (gradio is installed on neither machine), as
``tests/test_webui_ui.py`` runs the JAX one: layout, event graph, the bound
callbacks driven on a ``tiny-test`` pipeline with the FakeBackend. Also
held against the JAX package: greedy ``webui.inference`` in sampling and
MCTS modes gives the same final code and outputs from the same weights,
and the streamers give the same text deltas on the same token streams, a
multi-byte UTF-8 character split across tokens included. The CLI entry
``python -m detikzify_torch.serve`` prints its help, and ``serve.main()``
serves a tiny checkpoint written by ``save_pretrained`` on the CPU.
"""
import json
import random
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw

import fake_gradio
from detikzify_tpu.config import tiny_test_config
from detikzify_tpu.infer import DetikzifyPipeline as JPipeline
from detikzify_tpu.infer import FakeBackend as JFake
from detikzify_tpu.infer import set_backend as j_set_backend
from detikzify_tpu.models import detikzify as jdet
from detikzify_tpu.processing import ByteTokenizer as JTok
from detikzify_tpu.processing import DetikzifyProcessor as JProc
from detikzify_tpu.utils import generation as jgeneration
from detikzify_tpu.webui import webui as jwebui
from detikzify_torch.config import tiny_test_config as t_tiny_test_config
from detikzify_torch.infer import DetikzifyPipeline, FakeBackend, set_backend
from detikzify_torch.infer.tikz import TikzDocument
from detikzify_torch.models import convert
from detikzify_torch.processing import ByteTokenizer, DetikzifyProcessor
from detikzify_torch.utils import (ExplicitAbort, StreamerList,
                                   TextIteratorStreamer, TokenStreamer,
                                   unwrap_processor)
from detikzify_torch.utils import generation as tgeneration
from detikzify_torch.webui import webui as webui_mod
from detikzify_torch.webui.helpers import GeneratorLock, MctsOutputs
from detikzify_torch.webui.strings import ALGORITHMS, MODELS

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def fake_compiler():
    set_backend(FakeBackend())
    j_set_backend(JFake())
    yield
    set_backend(None)
    j_set_backend(None)


def _tok(cls, cfg):
    return cls(vocab_size=512, image_token_id=cfg.image_token_id,
               bos_token_id=cfg.bos_token_id, eos_token_id=cfg.eos_token_id,
               model_max_length=96)


@pytest.fixture(scope="module")
def weights():
    """(JAX cfg, JAX params, port cfg, the same weights in the port)."""
    cfg = tiny_test_config(vocab_size=512).replace(model_max_length=96)
    jp = jdet.init(jax.random.PRNGKey(0), cfg)
    tcfg = t_tiny_test_config(vocab_size=512).replace(model_max_length=96)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp._asdict()),
                                   tcfg, device="cpu")
    return cfg, jp, tcfg, tp


@pytest.fixture(scope="module")
def pipe(weights):
    _, _, tcfg, tp = weights
    pipe = DetikzifyPipeline(tp, tcfg, DetikzifyProcessor(
        _tok(ByteTokenizer, tcfg), tcfg), num_slots=2, max_len=96,
        device="cpu")
    yield pipe
    pipe.close()


@pytest.fixture
def gr(monkeypatch, pipe):
    fake_gradio.reset()
    monkeypatch.setitem(sys.modules, "gradio", fake_gradio)
    # cached_load is lru_cached on the real registry names: swap the whole
    # loader for the tiny pipeline (the UI passes the hub name through)
    monkeypatch.setattr(webui_mod, "cached_load",
                        lambda name, speculate=0, device="cuda": pipe)
    return fake_gradio


def _figure(seed=0):
    img = Image.new("RGB", (100, 80), "white")
    ImageDraw.Draw(img).rectangle([8 + seed, 8, 92, 72], outline="black",
                                  width=2)
    return img


def _component(demo, cls, **match):
    found = [c for c in demo.components if type(c).__name__ == cls
             and all(c.kwargs.get(k) == v for k, v in match.items())]
    assert found, f"no {cls} with {match}"
    return found[0]


# ---------------------------------------------------------------------------
# mirrors of tests/test_webui_ui.py
# ---------------------------------------------------------------------------

def test_build_ui_layout_and_event_graph(gr):
    demo = webui_mod.build_ui(model="detikzify-v2-8b", algorithm="sampling",
                              lock=True, lock_reason="space is locked",
                              light=True, timeout=5, device="cpu")
    assert isinstance(demo, gr.Blocks)
    assert isinstance(demo.theme, gr.themes.Soft)
    assert (demo.theme.body_background_fill_dark
            == demo.theme.body_background_fill)
    assert any(call["js"] and ".dark" in call["js"]
               for call in demo.load_calls)
    assert demo.head and "preview-close" in demo.head

    sketchpad = _component(demo, "ImageEditor", label="Sketchpad")
    caption = _component(demo, "Textbox", label="Caption")
    code_pane = _component(demo, "Code")
    gallery = _component(demo, "Gallery")
    svg_btn = _component(demo, "DownloadButton")
    run_btn = _component(demo, "Button", variant="primary")
    assert run_btn.kwargs["value"] == "Generate"
    stop_btn = _component(demo, "Button", variant="stop")
    model_dd = _component(demo, "Dropdown")
    algorithm = _component(demo, "Radio")
    state = _component(demo, "State")

    assert model_dd.kwargs["choices"] == list(MODELS)
    assert list(MODELS) == [
        "detikzify-v2.5-8b", "detikzify-v2-8b", "detikzify-v1-ds-7b",
        "detikzify-v1-cl-7b", "detikzify-v1-ds-1.3b",
        "detikzify-v1-tl-1.1b"]
    assert MODELS["detikzify-v1-ds-7b"] == "nllg/detikzify-ds-7b"
    assert model_dd.kwargs["interactive"] is False       # lock=True
    assert model_dd.kwargs["info"] == "space is locked"
    assert algorithm.kwargs["choices"] == list(ALGORITHMS)
    assert algorithm.kwargs["value"] == "sampling"
    sliders = [c for c in demo.components if isinstance(c, gr.Slider)]
    assert {s.kwargs["label"] for s in sliders} == {
        "Temperature", "Top-p", "Top-k", "Exploration coefficient",
        "Timeout"}

    (run_ev,) = demo.events_for(run_btn, "click")
    assert run_ev.inputs[0] is sketchpad and run_ev.inputs[1] is caption
    assert len(run_ev.inputs) == 11
    assert run_ev.outputs == [code_pane, gallery, state]
    (stop_ev,) = demo.events_for(stop_btn, "click")
    assert stop_ev.cancels == [run_ev]

    clear_btn = next(c for c in demo.components
                     if isinstance(c, gr.ClearButton))
    assert clear_btn.targets == [sketchpad, code_pane, gallery]

    (sel_ev,) = demo.events_for(gallery, "select")
    assert sel_ev.inputs == [state] and sel_ev.outputs == [code_pane, svg_btn]
    preview_close = _component(demo, "Button", elem_id="preview-close")
    (close_ev,) = demo.events_for(preview_close, "click")
    assert close_ev.outputs == [svg_btn]

    expl = next(s for s in sliders
                if s.kwargs["label"] == "Exploration coefficient")
    budget = next(s for s in sliders if s.kwargs["label"] == "Timeout")
    strict = _component(demo, "Checkbox", label="Strict mode")
    for c in (expl, budget, strict):
        assert c.kwargs["visible"] is False
    (chg_ev,) = demo.events_for(algorithm, "change")
    assert chg_ev.outputs == [expl, budget, strict]
    shown = chg_ev.fn("mcts")
    assert all(u == gr.update(visible=True) for u in shown)
    hidden = chg_ev.fn("sampling")
    assert all(u == gr.update(visible=False) for u in hidden)


def test_run_handler_sampling_and_mcts(gr):
    demo = webui_mod.build_ui(model="detikzify-v2-8b", timeout=5,
                              device="cpu")
    run_btn = _component(demo, "Button", variant="primary")
    (run_ev,) = demo.events_for(run_btn, "click")

    steps = list(run_ev.fn({"composite": _figure()}, "", "detikzify-v2-8b",
                           "sampling", 0.8, 0.95, 0, 0.6, 10, False, True))
    assert steps
    code, images, outputs = steps[-1]
    assert isinstance(code, str) and code
    assert isinstance(images, list)
    assert isinstance(outputs, MctsOutputs)

    # mcts: streams incrementally (0.1 min = 6 s budget)
    steps = list(run_ev.fn({"composite": _figure()}, "", "detikzify-v2-8b",
                           "mcts", 0.8, 0.95, 0, 0.6, 0.1, False, True))
    assert len(steps) > 1
    assert steps[-1][0].startswith(steps[0][0])

    stop_btn = _component(demo, "Button", variant="stop")
    (stop_ev,) = demo.events_for(stop_btn, "click")
    stop_ev.fn()


def test_select_and_deselect_program(gr):
    demo = webui_mod.build_ui(model="detikzify-v2-8b", timeout=5,
                              device="cpu")
    gallery = _component(demo, "Gallery")
    (sel_ev,) = demo.events_for(gallery, "select")

    outputs = MctsOutputs()
    doc = TikzDocument("\\begin{tikzpicture}\n\\draw (0,0) -- (1,1);\n"
                       "\\end{tikzpicture}")
    assert doc.is_rasterizable
    outputs.add(0.7, doc)
    code, svg_update = sel_ev.fn(outputs, gr.SelectData(index=0))
    assert code == doc.code
    assert svg_update == gr.update(visible=False)   # no pymupdf: no SVG

    upd_code, upd_svg = sel_ev.fn(None, gr.SelectData(index=0))
    assert upd_code == gr.update() and upd_svg == gr.update()

    preview_close = _component(demo, "Button", elem_id="preview-close")
    (close_ev,) = demo.events_for(preview_close, "click")
    assert close_ev.fn() == gr.update(visible=False)


def test_launch_and_cli_entry(gr, monkeypatch):
    demo = webui_mod.launch(model="detikzify-v2-8b", share=False, timeout=3,
                            device="cpu")
    assert demo.queued and demo.launched == {"share": False}

    from detikzify_torch.webui import __main__ as cli

    monkeypatch.setattr(sys, "argv", [
        "detikzify_torch.webui", "--model", "detikzify-v2-8b", "--light",
        "--lock", "--timeout", "3", "--speculate", "2", "--device", "cpu"])
    cli.main()


def test_webui_build_ui_requires_gradio(monkeypatch):
    monkeypatch.setitem(sys.modules, "gradio", None)   # import fails
    with pytest.raises(ImportError, match="gradio"):
        webui_mod.build_ui()


def test_webui_inference_streams_without_gradio(pipe):
    """webui.inference is plain Python generators: drive it directly."""
    outputs = list(webui_mod.inference(pipe, _figure(), algorithm="mcts",
                                       expansions=2))
    assert outputs
    code, mcts_out = outputs[-1]
    assert isinstance(code, str)
    outputs = list(webui_mod.inference(pipe, _figure(),
                                       algorithm="sampling"))
    assert len(outputs) == 1


def test_webui_inference_text_conditioned_stream():
    """webui.inference with a caption: a TikZero text-conditioned run
    (with and without an image) streams through plain Python generators
    (mirror of tests/test_adapter.py's test of the JAX web UI)."""
    from detikzify_torch.config import AdapterConfig, TextConfig
    from detikzify_torch.models.embedding import AdapterBundle

    acfg = AdapterConfig(embedding_hidden_size=48, num_attention_heads=4)
    cfg = t_tiny_test_config(vocab_size=512).replace(adapter=acfg)
    ecfg = TextConfig(vocab_size=512, hidden_size=48, intermediate_size=96,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, max_position_embeddings=256,
                      rope_theta=10000.0)
    g = torch.Generator().manual_seed(5)
    kw = dict(device="cpu", dtype=torch.float32, generator=g)
    params = convert.init_random(cfg, **kw)
    tok = _tok(ByteTokenizer, cfg)
    bundle = AdapterBundle(convert.init_random_adapter(cfg.vision, acfg,
                                                       **kw), acfg,
                           convert.init_random_llama(ecfg, **kw), ecfg, tok,
                           max_length=32)
    pipe = DetikzifyPipeline(params, cfg, DetikzifyProcessor(tok, cfg),
                             num_slots=2, max_len=96, metric="fast",
                             adapter=bundle, device="cpu")
    try:
        outs = list(webui_mod.inference(pipe, None, text="a red square",
                                        algorithm="mcts", expansions=2))
        assert outs and isinstance(outs[-1][0], str)
        outs = list(webui_mod.inference(pipe, _figure(),
                                        text="a blue ellipse",
                                        algorithm="sampling",
                                        temperature=0.0))
        assert len(outs) == 1
    finally:
        pipe.close()


# ---------------------------------------------------------------------------
# webui.inference against the JAX web UI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def greedy_pipes(weights):
    cfg, jp, tcfg, tp = weights
    kw = dict(num_slots=2, max_len=96, metric="fast", temperature=0.0)
    jpipe = JPipeline(jp, cfg, JProc(_tok(JTok, cfg), cfg), **kw)
    tpipe = DetikzifyPipeline(tp, tcfg, DetikzifyProcessor(
        _tok(ByteTokenizer, tcfg), tcfg), device="cpu", **kw)
    yield jpipe, tpipe
    tpipe.close()
    jpipe.compiler.shutdown()


@pytest.mark.parametrize("algorithm", ["sampling", "mcts"])
def test_greedy_inference_matches_jax(greedy_pipes, algorithm):
    """Greedy webui.inference: the last yield's code and MCTS outputs (the
    programs, best first) equal the JAX web UI's on the same weights."""
    runs = []
    for mod, pipe in zip((jwebui, webui_mod), greedy_pipes):
        random.seed(0)                      # UCT ties break at random
        steps = list(mod.inference(pipe, _figure(3), algorithm=algorithm,
                                   expansions=3, temperature=0.0))
        code, outputs = steps[-1]
        runs.append((code, len(outputs), outputs.programs,
                     [s for s, _ in outputs.scored]))
    assert runs[1] == runs[0]
    assert runs[1][0]
    eng = greedy_pipes[1].engine
    assert eng.num_active == 0 and eng.num_free_slots == eng.num_slots


# ---------------------------------------------------------------------------
# streamers (mirrors of tests/test_misc.py, and against the JAX ones)
# ---------------------------------------------------------------------------

STREAM_TEXT = "a→b\n\\draw (0,0) -- (1,1); % π≈3.14\n\nend 😀\n"


def _byte_processor(tok_cls, proc_cls, cfg):
    return proc_cls(tok_cls(vocab_size=512), cfg)


def _deltas(gen_mod, tok_cls, proc_cls, cfg, tokens):
    proc = _byte_processor(tok_cls, proc_cls, cfg)
    dec = gen_mod.IncrementalDecoder(proc)
    pushed = [dec.push(t) for t in tokens]
    streamer = gen_mod.TextIteratorStreamer(proc)
    for t in tokens:
        streamer.put(t)
    streamer.end()
    return pushed, list(streamer)


@pytest.mark.parametrize("text", [STREAM_TEXT, "→", "x\n→\n"])
def test_streamer_deltas_match_jax(text):
    """IncrementalDecoder and TextIteratorStreamer give the JAX ones'
    deltas, token by token, on byte tokens that split multi-byte UTF-8
    characters (held back until complete) across newline resets."""
    tokens = list(text.encode("utf-8"))
    cfg = tiny_test_config()
    tcfg = t_tiny_test_config()
    got = _deltas(tgeneration, ByteTokenizer, DetikzifyProcessor, tcfg,
                  tokens)
    want = _deltas(jgeneration, JTok, JProc, cfg, tokens)
    assert got == want
    pushed, streamed = got
    assert "".join(pushed) == "".join(streamed) == text
    assert "" in pushed                       # a split character held back
    assert all("\ufffd" not in d for d in pushed)


def test_token_streamer_and_list_match_jax():
    """TokenStreamer and StreamerList fan the same ids out as the JAX
    ones; a producer error reaches the consumer after the ids before it."""
    results = []
    for mod in (jgeneration, tgeneration):
        a, b = mod.TokenStreamer(), mod.TokenStreamer()
        fan = mod.StreamerList([a, b])
        for t in (7, 300, 12):
            fan.put(t)
        fan.end()
        errs = mod.TokenStreamer()
        errs.put(1)
        errs.propagate_error(RuntimeError("boom"))
        it = iter(errs)
        first = next(it)
        with pytest.raises(RuntimeError, match="boom"):
            next(it)
        results.append((list(a), list(b), first))
    assert results[1] == results[0] == ([7, 300, 12], [7, 300, 12], 1)


def test_token_streamer_roundtrip():
    streamer = TokenStreamer()
    collected = []

    def consume():
        collected.extend(streamer)

    thread = threading.Thread(target=consume)
    thread.start()
    for t in [1, 2, 3]:
        streamer.put(t)
    streamer.end()
    thread.join(5)
    assert not thread.is_alive()
    assert collected == [1, 2, 3]


def test_text_iterator_streamer_multibyte():
    proc = DetikzifyProcessor(ByteTokenizer(vocab_size=512),
                              t_tiny_test_config())
    streamer = TextIteratorStreamer(proc)
    for b in "a→b".encode("utf-8"):
        streamer.put(b)
    streamer.end()
    assert "".join(streamer) == "a→b"


def test_streamer_list_fanout_and_unwrap_processor():
    a, b = TokenStreamer(), TokenStreamer()
    fan = StreamerList([a, b])
    fan.put(7)
    fan.end()
    assert list(a) == [7] and list(b) == [7]
    from detikzify_torch.processing_adapter import AdapterProcessor

    tok = ByteTokenizer(vocab_size=512)
    base = DetikzifyProcessor(tok, t_tiny_test_config())
    assert unwrap_processor(AdapterProcessor(base, tok)) is base
    assert unwrap_processor(base) is base


def test_generator_lock_aborts_previous():
    control = ExplicitAbort()
    lock = GeneratorLock(control)
    with lock:
        pass
    assert not control.should_stop
    entered, release = threading.Event(), threading.Event()

    def hold():
        with lock:
            entered.set()
            release.wait(5)

    t = threading.Thread(target=hold)
    t.start()
    entered.wait(5)
    t2 = threading.Thread(target=lambda: lock.__enter__() and lock.__exit__())
    t2.start()
    deadline = time.monotonic() + 5
    while not control.should_stop and time.monotonic() < deadline:
        time.sleep(0.01)
    assert control.should_stop     # the second acquire aborted the first
    release.set()
    t.join(5)
    t2.join(5)
    assert not t.is_alive() and not t2.is_alive()


def test_mcts_outputs_dedup_and_order():
    out = MctsOutputs()
    d1 = TikzDocument("\\draw a;", backend=FakeBackend())
    d2 = TikzDocument("\\draw b;", backend=FakeBackend())
    out.add(0.5, d1)
    out.add(0.9, d2)
    out.add(0.4, d1)          # duplicate, lower score: ignored
    assert len(out) == 2
    assert out.programs == ["\\draw b;", "\\draw a;"]


# ---------------------------------------------------------------------------
# the serving CLI
# ---------------------------------------------------------------------------

def test_serve_cli_help():
    out = subprocess.run([sys.executable, "-m", "detikzify_torch.serve",
                          "--help"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    for flag in ("--model", "--device", "--max-active-mcts",
                 "--sample-reserve", "--allow-external-images"):
        assert flag in out.stdout
    out = subprocess.run([sys.executable, "-m", "detikzify_torch.webui",
                          "--help"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--device" in out.stdout and "--algorithm" in out.stdout


def _tokenizer_dir(path, cfg):
    """A word-level HF tokenizer saved into ``path``."""
    import transformers
    from tokenizers import Tokenizer, models, pre_tokenizers

    vocab = {f"tok{i}": i for i in range(120)}
    vocab.update({"<s>": cfg.bos_token_id, "</s>": cfg.eos_token_id,
                  "<image>": cfg.image_token_id, "<pad>": 120})
    tok = Tokenizer(models.WordLevel(vocab, unk_token="tok0"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    transformers.PreTrainedTokenizerFast(
        tokenizer_object=tok, bos_token="<s>", eos_token="</s>",
        pad_token="<pad>", model_max_length=96).save_pretrained(path)


def test_serve_main_serves_a_saved_checkpoint(weights, tmp_path,
                                              monkeypatch):
    """serve.main() on the CPU: loads a tiny checkpoint written by
    save_pretrained (with a tokenizer) through cached_load, answers
    /healthz and a greedy sampling request, and stops cleanly."""
    import base64
    import io

    from detikzify_torch import serve as tserve
    from detikzify_torch.models.load import save_pretrained

    _, _, tcfg, tp = weights
    path = str(tmp_path / "ckpt")
    save_pretrained(path, tp, tcfg)
    _tokenizer_dir(path, tcfg)
    servers = []
    make_server = tserve.make_server

    def capturing(*a, **kw):
        servers.append(make_server(*a, **kw))
        return servers[-1]

    monkeypatch.setattr(tserve, "make_server", capturing)
    webui_mod.cached_load.cache_clear()
    thread = threading.Thread(target=tserve.main, args=([
        "--model", path, "--device", "cpu", "--port", "0",
        "--max-active-mcts", "2"],), daemon=True)
    thread.start()
    deadline = time.monotonic() + 120
    while not servers and thread.is_alive() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert servers, "main() never built its server"
    httpd, inference = servers[0]
    try:
        assert inference.max_active_mcts == 2
        assert inference.pipeline.engine.device.type == "cpu"
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            assert json.loads(r.read())["status"] == "ok"
        buf = io.BytesIO()
        _figure().save(buf, format="PNG")
        req = urllib.request.Request(
            base + "/v1/generate", data=json.dumps({
                "image": base64.b64encode(buf.getvalue()).decode(),
                "temperature": 0.0, "max_new_tokens": 6}).encode())
        with urllib.request.urlopen(req, timeout=300) as r:
            body = json.loads(r.read())
        assert r.status == 200 and isinstance(body["code"], str)
        assert inference.requests["failed"] == 0
    finally:
        httpd.shutdown()
        thread.join(timeout=60)
        webui_mod.cached_load.cache_clear()
    assert not thread.is_alive()
    assert not inference._thread.is_alive()
