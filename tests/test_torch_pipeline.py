"""The port's DetikzifyPipeline against the JAX pipeline, on the CPU.

At temperature 0 with the hermetic ``FakeBackend`` compiler, ``sample()``
and ``sample_batch()`` must return the same ``TikzDocument.code`` as the
JAX package from the same weights. Also: the port and ``chip_smoke.py``
import neither JAX nor ``detikzify_tpu``, and ``chip_smoke.py`` rehearses
its phases on the CPU and refuses to run without a card.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import pytest
import torch
from PIL import Image, ImageDraw

from detikzify_tpu.config import tiny_test_config
from detikzify_tpu.infer import DetikzifyPipeline as JPipeline
from detikzify_tpu.infer import FakeBackend as JFake
from detikzify_tpu.infer import set_backend as j_set_backend
from detikzify_tpu.models import detikzify as jdet
from detikzify_tpu.processing import ByteTokenizer as JTok
from detikzify_tpu.processing import DetikzifyProcessor as JProc
from detikzify_torch.config import tiny_test_config as t_tiny_test_config
from detikzify_torch.infer import DetikzifyPipeline as TPipeline
from detikzify_torch.infer import FakeBackend as TFake
from detikzify_torch.infer import set_backend as t_set_backend
from detikzify_torch.models import convert
from detikzify_torch.processing import ByteTokenizer as TTok
from detikzify_torch.processing import DetikzifyProcessor as TProc

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def fake_compilers():
    j_set_backend(JFake())
    t_set_backend(TFake())
    yield
    j_set_backend(None)
    t_set_backend(None)


def _tok(cls, cfg):
    return cls(vocab_size=512, image_token_id=cfg.image_token_id,
               bos_token_id=cfg.bos_token_id, eos_token_id=cfg.eos_token_id,
               model_max_length=96)


@pytest.fixture(scope="module")
def pipelines():
    cfg = tiny_test_config(vocab_size=512)
    jparams = jdet.init(jax.random.PRNGKey(7), cfg)
    tcfg = t_tiny_test_config(vocab_size=512)
    tparams = convert.params_from_numpy(
        jax.tree.map(np.asarray, jparams._asdict()), tcfg, device="cpu")
    kw = dict(metric="fast", num_slots=4, max_len=96, temperature=0.0)
    jpipe = JPipeline(jparams, cfg, JProc(_tok(JTok, cfg), cfg), **kw)
    tpipe = TPipeline(tparams, tcfg, TProc(_tok(TTok, tcfg), tcfg),
                      device="cpu", **kw)
    yield jpipe, tpipe
    tpipe.close()


def _figures():
    figs = []
    for i in range(3):
        img = Image.new("RGB", (180 + 20 * i, 120), "white")
        d = ImageDraw.Draw(img)
        d.rectangle([10, 10, 170, 110 - 10 * i], outline="black", width=2)
        d.ellipse([40, 30, 140 - 15 * i, 90], outline="red", width=2)
        figs.append(img)
    return figs


def test_sample_code_matches_jax(pipelines):
    jpipe, tpipe = pipelines
    for fig in _figures()[:2]:
        want = jpipe.sample(image=fig, max_new_tokens=24)
        got = tpipe.sample(image=fig, max_new_tokens=24)
        assert got.code == want.code
        assert got.compiled_with_errors == want.compiled_with_errors
    eng = tpipe.engine
    assert eng.num_active == 0 and eng.num_free_slots == eng.num_slots
    # the generator's close() dropped its stored prefixes
    assert eng.prefix_pages_used == 0
    assert eng.num_free_pages == eng._page_refs.shape[0] - 1


def test_sample_batch_code_matches_jax(pipelines):
    jpipe, tpipe = pipelines
    figs = _figures()
    want = [d.code for d in jpipe.sample_batch(figs, max_new_tokens=16)]
    got = [d.code for d in tpipe.sample_batch(figs, max_new_tokens=16)]
    assert got == want
    assert any(got), "the tiny model should emit some byte tokens"
    # a batch gives each figure its own sample() continuation
    single = tpipe.sample(image=figs[2], max_new_tokens=16).code
    assert got[2] == single


def test_generator_rollout_matches_jax(pipelines):
    """rollout() streams the same line-boundary prefixes as the JAX
    generator; a second rollout restores the stored prompt prefix."""
    streams, hits = [], []
    for pipe in pipelines:
        gen = pipe.generator(image=_figures()[1], max_new_tokens=20)
        try:
            runs = []
            for _ in range(2):
                runs.append(list(gen.rollout(gen.root.state)))
                gen._finish_rollout([])
            assert runs[0] == runs[1] and runs[0]
            streams.append(runs[0])
            hits.append(gen.stats["prefix_hits"])
        finally:
            gen.close()
    assert streams[0] == streams[1]
    assert hits == [1, 1]


def test_model_metric_and_simulate_not_ported(pipelines):
    _, tpipe = pipelines
    with pytest.raises(NotImplementedError, match="SelfSim"):
        TPipeline(tpipe.engine.params, tpipe.cfg, tpipe.processor,
                  engine=tpipe.engine)           # default metric="model"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        next(iter(tpipe.simulate(image=_figures()[0])))


def test_port_imports_no_jax():
    """Importing every module of the port, and chip_smoke.py, leaves jax
    and detikzify_tpu out of sys.modules."""
    code = """
import importlib, pkgutil, sys
import detikzify_torch
for m in pkgutil.walk_packages(detikzify_torch.__path__, 'detikzify_torch.'):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(n for n in sys.modules
             if n == 'jax' or n.startswith(('jax.', 'jaxlib', 'detikzify_tpu')))
print(len([n for n in sys.modules if n.startswith('detikzify_torch')]), bad)
assert not bad, bad
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 20


def test_chip_smoke_cpu_rehearsal():
    """The smoke script's phases run end to end at tiny-test on the CPU."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "chip_smoke.py", "--cpu-rehearsal",
                          "--max-new-tokens", "8"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert json.loads(lines[-1]) == {"ok": True, "rehearsal": "cpu"}
    kernels = json.loads(lines[-2])["kernels"]
    names = {row["kernel"] for row in kernels}
    assert names == {"flash_attention", "paged_decode"}
    main = json.loads(lines[-3])
    assert main["phase"] == "main" and main["requests"]["figures"] == 6


def test_chip_smoke_refuses_without_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
