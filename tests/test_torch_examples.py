"""The port's command-line entry points (``detikzify_torch.examples``)
against the JAX package's ``examples/`` scripts, on the CPU.

Every script answers ``--help`` through ``python -m``; ``serve_bench``
runs end to end at ``--tiny --device cpu``; ``infer`` reads image paths
from stdin over a tiny checkpoint written by the JAX ``save_pretrained``
and prints what the JAX script prints;
``eval``'s ``main`` and the JAX one score one prediction cache, seeded
with fixed programs, to the same numbers, and ``eval --distributed`` in
two gloo processes scores as one process does; ``train``, ``pretrain``,
``refine`` and the TikZero scripts run their ``main`` for 2 steps on tiny
``datasets`` folders, their outputs read back by the port's loaders, and
their first step's loss is held against the JAX script's. The model
loads of both packages' scripts are switched to fp32 for the comparisons
(the scripts load bf16). Also: importing the scripts imports neither JAX
nor ``datasets``, ``diffusers`` or ``requests``.
"""
import contextlib
import functools
import importlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw

from detikzify_tpu.config import tiny_test_config
from detikzify_tpu.models import detikzify as jdet
from detikzify_tpu.models import load as jload

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = ["infer", "pretrain", "train", "eval", "refine", "sketchify",
           "serve_bench", "tikzero.pretrain", "tikzero.train"]
LOSS_RTOL = 1e-3


@pytest.fixture(scope="module")
def helps():
    """``python -m detikzify_torch.examples.<script> --help`` of every
    script, all started at once: script -> (exit code, stdout, stderr)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = {s: subprocess.Popen(
        [sys.executable, "-m", f"detikzify_torch.examples.{s}", "--help"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT) for s in SCRIPTS}
    out = {}
    for s, p in procs.items():
        stdout, stderr = p.communicate(timeout=300)
        out[s] = (p.returncode, stdout, stderr)
    return out


@pytest.mark.parametrize("script", SCRIPTS)
def test_example_help(helps, script):
    code, stdout, stderr = helps[script]
    assert code == 0, stderr[-2000:]
    assert "usage" in stdout.lower()


def test_scripts_import_nothing_heavy():
    """Importing every script parses no argument and imports neither JAX
    nor ``datasets``, ``diffusers`` or ``requests``; the scripts that the
    card runs take ``--device``."""
    code = """
import importlib, sys
names = %r
for n in names:
    importlib.import_module('detikzify_torch.examples.' + n)
import detikzify_torch.parallel, detikzify_torch.dataset
import detikzify_torch.utils.device, detikzify_torch.utils.profiling
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'detikzify_tpu',
                                    'datasets', 'diffusers', 'requests'))
assert not bad, bad
print('ok')
""" % (SCRIPTS,)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    for name in SCRIPTS:
        if name == "sketchify":     # host only
            continue
        mod = importlib.import_module(f"detikzify_torch.examples.{name}")
        parse = getattr(mod, "parse_args", None)
        if parse is not None:
            assert "--device" in _help(mod)


def _help(mod) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit):
        mod.parse_args(["--help"])
    return out.getvalue()


def test_serve_bench_tiny_end_to_end():
    """The serving load generator runs hermetically on the CPU: fused
    waves plus a concurrent SSE client against a tiny pipeline."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-m", "detikzify_torch.examples.serve_bench",
         "--tiny", "--device", "cpu", "--requests", "6", "--clients", "3",
         "--max-new-tokens", "8"],
        capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["requests"] == 7 and result["failed"] == 0
    assert result["fused_fraction"] > 0, "no requests fused into waves"
    assert result["mcts_candidates_during_mix"] > 0


# ---------------------------------------------------------------------------
# a tiny checkpoint written by the JAX package, a tokenizer, datasets
# ---------------------------------------------------------------------------

def _tokenizer(cfg, model_max_length=96):
    transformers = pytest.importorskip("transformers")
    from tokenizers import Tokenizer, models, pre_tokenizers

    vocab = {f"tok{i}": i for i in range(120)}
    vocab.update({"</s>": cfg.eos_token_id, "<image>": cfg.image_token_id,
                  "<s>": cfg.bos_token_id})
    tok = Tokenizer(models.WordLevel(
        {k: v for k, v in vocab.items() if v < 128}, unk_token="tok0"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    return transformers.PreTrainedTokenizerFast(
        tokenizer_object=tok, bos_token="<s>", eos_token="</s>",
        model_max_length=model_max_length)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """(path, JAX cfg): tiny-test at a 128-token vocabulary, JAX weights
    from a seed, written by the JAX ``save_pretrained`` with a word-level
    tokenizer."""
    cfg = tiny_test_config(vocab_size=128)
    params = jdet.init(jax.random.PRNGKey(5), cfg)
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny")
    jload.save_pretrained(path, params, cfg)
    _tokenizer(cfg).save_pretrained(path)
    return path, cfg


def _fig(i):
    img = Image.new("RGB", (64, 64), "white")
    ImageDraw.Draw(img).rectangle([4 + i, 4, 40, 40 + i], outline="black")
    return img


def _code(i):
    return f"\\draw (0,{i}) -- (1,1);\n\\node at ({i},2) {{x}};"


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    """A 5-item ``datasets`` folder with image, code and caption."""
    datasets = pytest.importorskip("datasets")
    rows = [{"image": _fig(i), "code": _code(i),
             "caption": f"tok{3 + i} tok{9 + i} tok{20 + i}"}
            for i in range(5)]
    path = str(tmp_path_factory.mktemp("data") / "testset")
    datasets.Dataset.from_list(rows).cast_column(
        "image", datasets.Image()).save_to_disk(path)
    return path


def _fp32_load(monkeypatch, module, dtype):
    """A script module's ``load`` at fp32 (the scripts load bf16)."""
    monkeypatch.setattr(module, "load", functools.partial(module.load,
                                                          dtype=dtype))


def _jax_script(name):
    """The JAX package's ``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name.replace('/', '_')}",
        ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax_main(monkeypatch, mod, argv):
    monkeypatch.setattr(sys, "argv", [mod.__file__] + argv)
    mod.main()
    jax.effects_barrier()       # every debug callback has run


# ---------------------------------------------------------------------------
# infer
# ---------------------------------------------------------------------------

def test_infer_main_on_jax_checkpoint(ckpt, tmp_path, monkeypatch, capsys):
    """``infer.main`` reads image paths from stdin, prints each program and
    saves the last: greedy, at fp32, it prints and saves what the JAX
    ``examples/infer.py`` ``main`` does on the same stdin; ``--mcts`` prints
    a score per rollout until the first that compiles (FakeBackend)."""
    from detikzify_tpu.infer.tikz import FakeBackend as JFake
    from detikzify_tpu.infer.tikz import set_backend as j_set_backend
    from detikzify_torch.examples import infer
    from detikzify_torch.infer import FakeBackend, set_backend

    path, _ = ckpt
    pngs = []
    for i in range(2):
        pngs.append(str(tmp_path / f"fig{i}.png"))
        _fig(i).save(pngs[-1])
    jinfer = _jax_script("infer")
    _fp32_load(monkeypatch, jinfer, jnp.float32)
    jtex = tmp_path / "jax.tex"
    monkeypatch.setattr(sys, "stdin", io.StringIO("\n".join(pngs)))
    j_set_backend(JFake(latency=0.0))
    try:
        _run_jax_main(monkeypatch, jinfer, ["--model", path, "--temperature",
                                            "0", "--output", str(jtex)])
    finally:
        j_set_backend(None)
    want = capsys.readouterr().out.replace(str(jtex), "OUT")
    tex = tmp_path / "best.tex"
    set_backend(FakeBackend(latency=0.0))
    try:
        monkeypatch.setattr(sys, "stdin", io.StringIO("\n".join(pngs)))
        with monkeypatch.context() as m:
            _fp32_load(m, infer, torch.float32)
            infer.main(["--model", path, "--device", "cpu", "--temperature",
                        "0", "--output", str(tex)])
        out = capsys.readouterr().out
        assert out.count("saved to") == 2 and "no output" not in out
        assert tex.read_text() and tex.read_text() in out
        assert out.replace(str(tex), "OUT") == want
        assert tex.read_text() == jtex.read_text()
        monkeypatch.setattr(sys, "stdin", io.StringIO(pngs[0] + "\n\n"))
        infer.main(["--model", path, "--device", "cpu", "--mcts",
                    "--timeout", "30", "--parallelism", "2"])
        out = capsys.readouterr().out
        assert out.count("[score ") >= 1 and "OK" in out
    finally:
        set_backend(None)


# ---------------------------------------------------------------------------
# eval
# ---------------------------------------------------------------------------

def _eval_towers(tmp_path, cfg):
    """A tiny SigLIP two-tower (ClipScore) and DreamSim's DINO and CLIP
    backbones, as ``tests/test_examples.py`` writes them."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    clip_dir = str(tmp_path / "siglip")
    transformers.SiglipModel(transformers.SiglipConfig(
        vision_config=dict(hidden_size=32, intermediate_size=64,
                           num_hidden_layers=2, num_attention_heads=4,
                           image_size=28, patch_size=14),
        text_config=dict(hidden_size=32, intermediate_size=64,
                         num_hidden_layers=2, num_attention_heads=4,
                         vocab_size=128, max_position_embeddings=64),
    )).save_pretrained(clip_dir, safe_serialization=True)
    _tokenizer(cfg).save_pretrained(clip_dir)
    dino_dir = str(tmp_path / "dino")
    transformers.ViTModel(transformers.ViTConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=64, image_size=32, patch_size=16,
    )).save_pretrained(dino_dir, safe_serialization=True)
    clipv_dir = str(tmp_path / "clipv")
    transformers.CLIPVisionModelWithProjection(
        transformers.CLIPVisionConfig(
            hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, image_size=32, patch_size=16,
            projection_dim=16)).save_pretrained(
        clipv_dir, safe_serialization=True)
    return clip_dir, dino_dir, clipv_dir


def test_eval_main_scores_match_jax(ckpt, dataset_dir, tmp_path,
                                    monkeypatch):
    """``eval.main`` and the JAX ``examples/eval.py`` ``main`` score one
    prediction cache (fixed programs for every item, so neither searches)
    over the same 5-item ``datasets`` folder with the full suite: the
    counts, CrystalBLEU and TexEditDistance are equal, SelfSim, KID,
    ClipScore, DreamSim and the redacted variants within 1e-4 at fp32."""
    from detikzify_tpu.evaluate.harness import PredictionCache
    from detikzify_tpu.infer.tikz import FakeBackend as JFake
    from detikzify_tpu.infer.tikz import set_backend as j_set_backend
    from detikzify_torch.examples import eval as teval
    from detikzify_torch.infer import FakeBackend, set_backend

    path, cfg = ckpt
    clip_dir, dino_dir, clipv_dir = _eval_towers(tmp_path, cfg)
    cache_dir = tmp_path / "cache"
    cache_dir.mkdir()
    cache = PredictionCache(str(cache_dir / "tiny.jsonl"))
    for i in range(5):
        code = _code(i) if i != 3 else _code(4) + "\n\\draw (2,2) -- (3,3);"
        cache.put(f"tiny-{i}", {"code": code, "score": 0.5 + 0.1 * i,
                                "num_programs": 1 + i % 3,
                                "lengths": [12 + i, 9][:1 + i % 2],
                                "seconds": 1.0 + i})
    argv = ["--path", f"tiny={path}", "--testset", dataset_dir,
            "--cache_dir", str(cache_dir), "--limit", "5",
            "--parallelism", "2", "--clip", clip_dir,
            "--dreamsim_dino", dino_dir, "--dreamsim_clip", clipv_dir]
    want_path, got_path = tmp_path / "jax.json", tmp_path / "port.json"

    jeval = _jax_script("eval")
    _fp32_load(monkeypatch, jeval, jnp.float32)
    monkeypatch.setattr(jax, "local_devices",
                        lambda *a, **k: [jax.devices()[0]])
    j_set_backend(JFake(latency=0.0))
    try:
        _run_jax_main(monkeypatch, jeval, argv + ["--output",
                                                  str(want_path)])
    finally:
        j_set_backend(None)
    _fp32_load(monkeypatch, teval, torch.float32)
    set_backend(FakeBackend(latency=0.0))
    try:
        teval.main(argv + ["--output", str(got_path), "--device", "cpu"])
    finally:
        set_backend(None)
    want = json.loads(want_path.read_text())["tiny"]
    got = json.loads(got_path.read_text())["tiny"]
    assert set(got) == set(want) == {
        "CompileSuccessRate", "MeanTokenEfficiency",
        "MeanSamplingThroughput", "SelfSim", "KID", "CrystalBLEU",
        "TexEditDistance", "DreamSim", "ClipScore", "SelfSim_redacted",
        "DreamSim_redacted", "ClipScore_redacted"}
    for k in ("CompileSuccessRate", "MeanTokenEfficiency",
              "MeanSamplingThroughput", "CrystalBLEU", "TexEditDistance"):
        assert got[k] == want[k], k
    for k in ("SelfSim", "KID", "ClipScore", "DreamSim", "SelfSim_redacted",
              "DreamSim_redacted", "ClipScore_redacted"):
        assert abs(got[k] - want[k]) <= 1e-4, (k, got[k], want[k])
    assert got["CompileSuccessRate"] == 1.0
    # every item came from the cache: nothing appended
    assert len((cache_dir / "tiny.jsonl").read_text().splitlines()) == 5


# two ranks of a gloo group, each running ``eval.main --distributed``
_EVAL_WORKER = """
import sys
import torch
import torch.distributed as dist
from detikzify_torch.examples import eval as teval
from detikzify_torch.infer import FakeBackend, set_backend
torch.set_num_threads(1)
set_backend(FakeBackend(latency=0.0))
try:
    teval.main(sys.argv[1:])
finally:
    if dist.is_initialized():
        dist.destroy_process_group()
"""


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_eval_main_distributed_two_processes(ckpt, dataset_dir, tmp_path):
    """``eval.main --distributed --device cpu`` in two processes of a gloo
    group (the environment torchrun sets): items 0-2 come from the cache,
    rank 0 searches item 4 and rank 1 item 3 (the striped shards), each
    caching its own; both ranks write the same scores, and a
    single-process ``main`` over the cache they completed takes every
    item from it and scores the same."""
    from detikzify_torch.evaluate.harness import PredictionCache
    from detikzify_torch.examples import eval as teval
    from detikzify_torch.infer import FakeBackend, set_backend

    path, _ = ckpt
    cache_dir = tmp_path / "cache"
    cache_dir.mkdir()
    cache = PredictionCache(str(cache_dir / "tiny.jsonl"))
    for i in range(3):
        cache.put(f"tiny-{i}", {"code": _code(i), "score": 0.5 + 0.1 * i,
                                "num_programs": 1 + i, "lengths": [12 + i],
                                "seconds": 1.0 + i})
    argv = ["--path", f"tiny={path}", "--testset", dataset_dir,
            "--cache_dir", str(cache_dir), "--parallelism", "2",
            "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE="2")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _EVAL_WORKER, *argv, "--distributed",
         "--output", str(tmp_path / f"rank{rank}.json")], cwd=ROOT,
        env=dict(env, RANK=str(rank), LOCAL_RANK=str(rank)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(2)]
    try:
        errs = [p.communicate(timeout=300)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-2000:]
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text())["tiny"]
             for r in range(2)]
    assert ranks[0] == ranks[1]
    keys = [json.loads(line)["key"] for line in
            (cache_dir / "tiny.jsonl").read_text().splitlines()]
    assert sorted(keys[3:]) == ["tiny-3", "tiny-4"]

    set_backend(FakeBackend(latency=0.0))
    try:
        teval.main(argv + ["--output", str(tmp_path / "single.json")])
    finally:
        set_backend(None)
    single = json.loads((tmp_path / "single.json").read_text())["tiny"]
    assert len((cache_dir / "tiny.jsonl").read_text().splitlines()) == 5
    assert set(single) == set(ranks[0]) >= {
        "CompileSuccessRate", "MeanTokenEfficiency",
        "MeanSamplingThroughput", "SelfSim", "KID", "CrystalBLEU",
        "TexEditDistance"}
    for k in ("CompileSuccessRate", "MeanTokenEfficiency",
              "MeanSamplingThroughput", "CrystalBLEU", "TexEditDistance"):
        assert single[k] == ranks[0][k], k
    for k in set(single) - {"CompileSuccessRate", "MeanTokenEfficiency",
                            "MeanSamplingThroughput", "CrystalBLEU",
                            "TexEditDistance"}:
        assert abs(single[k] - ranks[0][k]) <= 1e-6, (k, single[k],
                                                      ranks[0][k])


# ---------------------------------------------------------------------------
# training scripts: 2 steps, outputs read back, the first loss against JAX
# ---------------------------------------------------------------------------

def _record_trainer_losses(monkeypatch, trainer_cls, to_float):
    """Each optimizer step's loss of every ``Trainer`` built from now on."""
    losses = []
    init = trainer_cls.__init__

    def recording_init(self, *a, **kw):
        init(self, *a, **kw)
        step = self._step_fn

        def recorded(state, batch):
            state, metrics = step(state, batch)
            losses.append(to_float(metrics["loss"]))
            return state, metrics

        self._step_fn = recorded

    monkeypatch.setattr(trainer_cls, "__init__", recording_init)
    return losses


def _record_step_factory(monkeypatch, module, name, jax_side):
    """Each step's loss of the step functions ``module.<name>`` makes (a
    ``jax.debug.callback`` inside the JAX step, which is jitted)."""
    losses = []
    make = getattr(module, name)

    def recording_make(*a, **kw):
        step = make(*a, **kw)

        def recorded(state, batch):
            state, metrics = step(state, batch)
            if jax_side:
                jax.debug.callback(lambda x: losses.append(float(x)),
                                   metrics["loss"])
            else:
                losses.append(float(metrics["loss"]))
            return state, metrics

        return recorded

    monkeypatch.setattr(module, name, recording_make)
    return losses


def _one_device_mesh(monkeypatch):
    from detikzify_tpu.parallel import mesh

    make = mesh.make_mesh
    monkeypatch.setattr(mesh, "make_mesh", lambda **kw: make(
        devices=jax.devices()[:1], **kw))


def _two_rows(tmp_path, src):
    """The first 2 rows of ``src`` as a ``datasets`` folder."""
    import datasets

    out = str(tmp_path / "two")
    datasets.load_from_disk(src).select(range(2)).save_to_disk(out)
    return out


def _assert_first_loss(got, want):
    assert len(got) == len(want) == 2, (got, want)
    assert all(np.isfinite(got))
    assert abs(got[0] - want[0]) <= LOSS_RTOL * abs(want[0]), (got, want)


def test_train_main_two_steps(ckpt, dataset_dir, tmp_path, monkeypatch):
    """``train.main``: 2 items, micro-batch 1, one epoch: 2 steps whose
    first loss equals the JAX script's (the same data order); the
    trainer's checkpoint reads back into the port's loaded weights."""
    from detikzify_tpu.train import trainer as jtrainer
    from detikzify_torch.examples import train as ttrain
    from detikzify_torch.models.load import load
    from detikzify_torch.train import trainer as ttrainer

    path, _ = ckpt
    data = _two_rows(tmp_path, dataset_dir)
    args = ["--base_model", path, "--datikz", data, "--batch_size", "1",
            "--micro_batch_size", "1", "--epochs", "1",
            "--sketch_ratio", "0"]
    jmod = _jax_script("train")
    _fp32_load(monkeypatch, jmod, jnp.float32)
    _one_device_mesh(monkeypatch)
    want = _record_trainer_losses(monkeypatch, jtrainer.Trainer,
                                  lambda x: float(jax.device_get(x)))
    _run_jax_main(monkeypatch, jmod, args + ["--output",
                                             str(tmp_path / "jax")])
    _fp32_load(monkeypatch, ttrain, torch.float32)
    got = _record_trainer_losses(monkeypatch, ttrainer.Trainer, float)
    out = tmp_path / "port"
    ttrain.main(args + ["--output", str(out), "--device", "cpu"])
    _assert_first_loss(got, want)
    saved = torch.load(out / "checkpoint-2" / "state.pt",
                       weights_only=False)
    params, _, _ = load(path, dtype=torch.float32, device="cpu")
    before = params.text.embed_tokens.clone()
    params.load_state_dict(saved["params"])
    assert saved["step"] == 2
    assert not torch.equal(params.text.embed_tokens, before)


def test_pretrain_main_two_steps(ckpt, dataset_dir, tmp_path, monkeypatch):
    """``pretrain.main``: 2 steps on the connector alone, the first loss
    equal to the JAX script's; ``modality_projector.npz`` overlays the
    base checkpoint through the port's ``load``."""
    from detikzify_tpu.train import trainer as jtrainer
    from detikzify_torch.examples import pretrain as tpretrain
    from detikzify_torch.models.load import load
    from detikzify_torch.train import trainer as ttrainer

    path, _ = ckpt
    args = ["--base_model", path, "--arxivcap", dataset_dir, "--size", "2",
            "--batch_size", "1", "--micro_batch_size", "1"]
    jmod = _jax_script("pretrain")
    _fp32_load(monkeypatch, jmod, jnp.float32)
    _one_device_mesh(monkeypatch)
    want = _record_trainer_losses(monkeypatch, jtrainer.Trainer,
                                  lambda x: float(jax.device_get(x)))
    _run_jax_main(monkeypatch, jmod, args + ["--output",
                                             str(tmp_path / "jax")])
    _fp32_load(monkeypatch, tpretrain, torch.float32)
    got = _record_trainer_losses(monkeypatch, ttrainer.Trainer, float)
    out = tmp_path / "port"
    tpretrain.main(args + ["--output", str(out), "--device", "cpu"])
    _assert_first_loss(got, want)
    base, _, _ = load(path, dtype=torch.float32, device="cpu")
    over, _, _ = load(path, dtype=torch.float32, device="cpu",
                      modality_projector=str(out / "modality_projector.npz"))
    assert not torch.equal(over.connector.proj.weight,
                           base.connector.proj.weight)
    assert torch.equal(over.text.embed_tokens, base.text.embed_tokens)


def test_refine_main_two_steps(ckpt, dataset_dir, tmp_path, monkeypatch):
    """``refine.main``: 2 GRPO steps of 2 rollouts on FakeBackend renders,
    the refined model written by ``save_pretrained`` and read back by the
    port's ``load_params``. Its losses are not held against JAX: the
    rollouts are sampled (JAX draws with threefry, the port with Philox),
    so the two runs score different programs; ``refine`` itself is held
    against JAX under greedy engines in ``test_torch_posttrain.py``."""
    from detikzify_torch.examples import refine as trefine
    from detikzify_torch.infer import FakeBackend, set_backend
    from detikzify_torch.models.load import load_params
    from detikzify_torch.train import grpo

    path, _ = ckpt
    _fp32_load(monkeypatch, trefine, torch.float32)
    logs = []
    monkeypatch.setattr(trefine, "refine", functools.partial(
        grpo.refine, log_fn=logs.append))
    out = tmp_path / "refined"
    set_backend(FakeBackend(latency=0.0))
    try:
        trefine.main(["--model", path, "--dataset", dataset_dir, "--output",
                      str(out), "--steps", "2", "--num_generations", "2",
                      "--max_new_tokens", "8", "--sketch_ratio", "0",
                      "--learning_rate", "1e-3", "--num_compile_workers",
                      "1", "--device", "cpu"])
    finally:
        set_backend(None)
    assert len(logs) == 2 and all("grpo step" in line for line in logs)
    refined, rcfg = load_params(str(out), dtype=torch.float32, device="cpu")
    base, _ = load_params(path, dtype=torch.float32, device="cpu")
    assert rcfg.text.vocab_size == 128
    moved = [n for (n, a), b in zip(refined.named_parameters(),
                                     base.parameters())
             if not torch.equal(a, b)]
    assert moved and all(n.startswith(("text", "connector")) for n in moved)


def _embedding_model(tmp_path, cfg):
    """A 2-layer, 48-wide LLaMA caption model from a JAX init, written by
    the port as a plain LLaMA checkpoint whose ``config.json`` also
    carries a ``text_config`` (which the JAX loader reads), with the
    word-level tokenizer."""
    from detikzify_tpu.config import TextConfig
    from detikzify_tpu.models import llama as jllama
    from detikzify_torch.config import TextConfig as TTextConfig
    from detikzify_torch.models import convert
    from detikzify_torch.models.load import save_embedding_model

    kw = dict(vocab_size=128, hidden_size=48, intermediate_size=96,
              num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, max_position_embeddings=256,
              rope_theta=10000.0)
    jtree = jax.tree.map(np.asarray, jllama.init(jax.random.PRNGKey(3),
                                                 TextConfig(**kw)))
    tcfg = TTextConfig(**kw)
    path = str(tmp_path / "caption_model")
    save_embedding_model(path, convert.llama_from_numpy(
        jtree, tcfg, device="cpu", dtype=torch.bfloat16), tcfg)
    with open(f"{path}/config.json") as f:
        hf = json.load(f)
    hf["text_config"] = dict(kw)
    with open(f"{path}/config.json", "w") as f:
        json.dump(hf, f)
    _tokenizer(cfg).save_pretrained(path)
    return path


@pytest.fixture(scope="module")
def tikzero(ckpt, dataset_dir, tmp_path_factory):
    """The caption model's directory; ``tikzero/pretrain``'s test adds
    the adapter it wrote, which ``tikzero/train``'s test attaches."""
    return {"embed": _embedding_model(tmp_path_factory.mktemp("embed"),
                                      ckpt[1])}


def test_tikzero_pretrain_main_two_steps(ckpt, dataset_dir, tikzero,
                                         tmp_path, monkeypatch):
    """``tikzero.pretrain.main``: 2 distillation steps of 1 figure, the
    adapter drawn as the JAX script draws it (``adapter.init`` at
    PRNGKey(0), carried across by ``convert.adapter_from_numpy``), the
    first loss equal to the JAX script's; the adapter written to
    ``<output>/adapter`` reads back through ``load_adapter_params`` equal
    to the trained one."""
    from detikzify_tpu.models import adapter as jadapter
    from detikzify_torch.examples.tikzero import pretrain as tpre_script
    from detikzify_torch.models import convert
    from detikzify_torch.models.load import load_adapter_params

    jpre = importlib.import_module("detikzify_tpu.train.adapter.pretrain")
    tpre = importlib.import_module("detikzify_torch.train.adapter.pretrain")
    path, cfg = ckpt
    args = ["--base_model", path, "--embedding_model", tikzero["embed"],
            "--dataset", _two_rows(tmp_path, dataset_dir),
            "--batch_size", "1", "--micro_batch_size", "1",
            "--epochs", "1"]
    jmod = _jax_script("tikzero/pretrain")
    monkeypatch.setattr(jload, "load", functools.partial(
        jload.load, dtype=jnp.float32))
    want = _record_step_factory(monkeypatch, jpre, "make_distill_step",
                                jax_side=True)
    _run_jax_main(monkeypatch, jmod, args + ["--output",
                                             str(tmp_path / "jax")])

    from detikzify_torch.models import load as tload

    monkeypatch.setattr(tload, "load", functools.partial(
        tload.load, dtype=torch.float32))
    trained = {}

    def jax_drawn(vcfg, acfg, device="cuda", dtype=torch.float32, **kw):
        tree = jax.tree.map(np.asarray, jadapter.init(
            jax.random.PRNGKey(0), vcfg, acfg))
        trained["adapter"] = convert.adapter_from_numpy(
            tree, vcfg, acfg, device=device, dtype=dtype)
        return trained["adapter"]

    monkeypatch.setattr(convert, "init_random_adapter", jax_drawn)
    got = _record_step_factory(monkeypatch, tpre, "make_distill_step",
                               jax_side=False)
    out = tmp_path / "port"
    tpre_script.main(args + ["--output", str(out), "--device", "cpu"])
    _assert_first_loss(got, want)
    adapter, acfg, _, _ = load_adapter_params(
        str(out / "adapter"), _port_cfg(cfg).vision, tikzero["embed"],
        dtype=torch.float32, device="cpu")
    for k, v in trained["adapter"].state_dict().items():
        assert torch.equal(adapter.state_dict()[k], v), k
    tikzero["adapter"] = str(out / "adapter")


def _port_cfg(cfg):
    from detikzify_torch.config import tiny_test_config as t_tiny

    return t_tiny(vocab_size=cfg.text.vocab_size)


def test_tikzero_train_main_two_steps(ckpt, dataset_dir, tikzero, tmp_path,
                                      monkeypatch):
    """``tikzero.train.main`` (TikZero+, ``--caption_condition``): 2 steps
    of 1 item with the adapter of ``tikzero/pretrain`` attached, the first
    loss equal to the JAX script's from the same adapter; the trained model
    written to ``<output>/<base name>`` reads back through the port's
    ``load_params``, its text tower moved and its vision tower not."""
    from detikzify_torch.examples.tikzero import train as ttrain_script
    from detikzify_torch.models import load as tload
    from detikzify_torch.models.load import load_params

    jtrain_mod = importlib.import_module("detikzify_tpu.train.adapter.train")
    ttrain_mod = importlib.import_module(
        "detikzify_torch.train.adapter.train")
    if "adapter" not in tikzero:
        pytest.skip("needs test_tikzero_pretrain_main_two_steps's adapter")
    path, _ = ckpt
    args = ["--base_model", path, "--embedding_model", tikzero["embed"],
            "--adapter_model", tikzero["adapter"],
            "--datikz", _two_rows(tmp_path, dataset_dir),
            "--caption_condition", "--batch_size", "1",
            "--micro_batch_size", "1"]
    jmod = _jax_script("tikzero/train")
    monkeypatch.setattr(jload, "load", functools.partial(
        jload.load, dtype=jnp.float32))
    monkeypatch.setattr(jload, "load_adapter", functools.partial(
        jload.load_adapter, dtype=jnp.float32))
    want = _record_step_factory(monkeypatch, jtrain_mod,
                                "make_adapter_train_step", jax_side=True)
    _run_jax_main(monkeypatch, jmod, args + ["--output",
                                             str(tmp_path / "jax")])
    monkeypatch.setattr(tload, "load", functools.partial(
        tload.load, dtype=torch.float32))
    monkeypatch.setattr(tload, "load_adapter", functools.partial(
        tload.load_adapter, dtype=torch.float32))
    got = _record_step_factory(monkeypatch, ttrain_mod,
                               "make_adapter_train_step", jax_side=False)
    out = tmp_path / "port"
    ttrain_script.main(args + ["--output", str(out), "--device", "cpu"])
    _assert_first_loss(got, want)
    trained, _ = load_params(str(out / os.path.basename(path)),
                             dtype=torch.float32, device="cpu")
    base, _ = load_params(path, dtype=torch.float32, device="cpu")
    assert not torch.equal(trained.text.embed_tokens, base.text.embed_tokens)
    for a, b in zip(trained.vision.parameters(), base.vision.parameters()):
        assert torch.equal(a, b)
