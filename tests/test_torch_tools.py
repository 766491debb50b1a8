"""The port's tools, on the CPU.

  * ``detikzify_torch.tools.convert_dreamsim`` on the JAX test's synthetic
    LoRA-merged ensemble (``tests/test_dreamsim.py``'s ViT-B/16 state dicts
    at the real shape, the dreamsim package's naming) writes the arrays and
    sha256s that ``tools/convert_dreamsim.py`` writes, and the port's
    ``load_ensemble`` reads them back;
  * ``detikzify_torch.tools.verify_real --make-tiny --device cpu`` (a tiny
    checkpoint written by the port's ``save_pretrained``) reports ``ok``
    for its five port steps and ``not_run`` for the three steps that need
    the reference package, and serves the fp32 tree with an fp32 cache as
    the JAX runbook does; its serve rule (``serve_plan``) is the JAX
    runbook's, read from ``tools/verify_real.py``;
  * ``ImageSim`` takes per-channel statistics, as a loaded checkpoint's
    processor gives them (the fault ``eval_smoke`` found).
"""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from detikzify_torch.config import tiny_test_config
from detikzify_torch.evaluate import dreamsim_vit
from detikzify_torch.evaluate.imagesim import ImageSim
from detikzify_torch.models import convert
from detikzify_torch.tools import convert_dreamsim, verify_real

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _timm_b16_state(seed, *, norm_pre=False):
    """``tests/test_dreamsim.py::_timm_b16_state``: a ViT-B/16 timm state
    dict at the published shape, drawn from ``seed``."""
    g = torch.Generator().manual_seed(seed)

    def t(*shape, scale=0.02):
        return torch.randn(*shape, generator=g) * scale

    d, inter, layers, patch, npatch = 768, 3072, 12, 16, 196
    sd = {
        "cls_token": t(1, 1, d),
        "pos_embed": t(1, npatch + 1, d),
        "patch_embed.proj.weight": t(d, 3, patch, patch),
        "patch_embed.proj.bias": t(d),
        "norm.weight": torch.ones(d) + t(d),
        "norm.bias": t(d),
    }
    if norm_pre:
        sd["norm_pre.weight"] = torch.ones(d) + t(d)
        sd["norm_pre.bias"] = t(d)
    for i in range(layers):
        b = f"blocks.{i}"
        sd.update({
            f"{b}.norm1.weight": torch.ones(d) + t(d),
            f"{b}.norm1.bias": t(d),
            f"{b}.attn.qkv.weight": t(3 * d, d),
            f"{b}.attn.qkv.bias": t(3 * d),
            f"{b}.attn.proj.weight": t(d, d),
            f"{b}.attn.proj.bias": t(d),
            f"{b}.norm2.weight": torch.ones(d) + t(d),
            f"{b}.norm2.bias": t(d),
            f"{b}.mlp.fc1.weight": t(inter, d),
            f"{b}.mlp.fc1.bias": t(inter),
            f"{b}.mlp.fc2.weight": t(d, inter),
            f"{b}.mlp.fc2.bias": t(d),
        })
    return sd


def test_convert_dreamsim_writes_the_jax_tools_arrays(tmp_path):
    src = tmp_path / "dreamsim_ck"
    src.mkdir()
    torch.save(_timm_b16_state(0),
               src / "dino_vitb16_pretrain_lora_merged.pth")
    torch.save({"model": _timm_b16_state(1, norm_pre=True),
                "proj": torch.randn(768, 512, generator=torch.Generator()
                                    .manual_seed(2)) * 0.02},
               src / "clip_vitb16_pretrain_lora_merged.pth")
    oclip = _timm_b16_state(3, norm_pre=True)
    oclip["proj"] = torch.randn(
        768, 512, generator=torch.Generator().manual_seed(4)) * 0.02
    torch.save(oclip, src / "open_clip_vitb16_pretrain_lora_merged.pth")

    spec = importlib.util.spec_from_file_location(
        "jax_convert_dreamsim", os.path.join(ROOT, "tools",
                                             "convert_dreamsim.py"))
    jtool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jtool)
    assert jtool.main(["--input", str(src),
                       "--output", str(tmp_path / "jax")]) == 0
    assert convert_dreamsim.main(["--input", str(src),
                                  "--output", str(tmp_path / "port")]) == 0

    def manifest(which):
        with open(tmp_path / which / "manifest.json") as f:
            return json.load(f)

    want, got = manifest("jax"), manifest("port")
    assert got == want
    assert [b["source"]["branch"] for b in got["branches"]] == [
        "dino_vitb16", "clip_vitb16", "open_clip_vitb16"]
    for b in got["branches"]:
        with np.load(tmp_path / "jax" / b["file"]) as jz, \
                np.load(tmp_path / "port" / b["file"]) as tz:
            assert sorted(jz.files) == sorted(tz.files)
            for k in jz.files:
                np.testing.assert_array_equal(tz[k], jz[k], err_msg=k)
    ds = dreamsim_vit.load_ensemble(str(tmp_path / "port"), device="cpu")
    assert len(ds.extractors) == 3
    assert ds.extractors[2].cfg.proj_dim == 512


def test_verify_real_make_tiny_cpu(tmp_path):
    out = tmp_path / "verdict.json"
    rc = verify_real.main(["--make-tiny", str(tmp_path / "ck"),
                           "--device", "cpu",
                           "--workdir", str(tmp_path / "work"),
                           "--output", str(out)])
    verdict = json.loads(out.read_text())
    assert rc == 0 and verdict["verdict"] == "pass", verdict
    steps = verdict["checkpoints"]["tiny"]
    for name in verify_real.PORT_STEPS:
        assert steps[name]["ok"] is True, (name, steps[name])
    for name in verify_real.REFERENCE_STEPS:
        assert steps[name]["ok"] is None, (name, steps[name])
        assert "--reference" in steps[name]["not_run"]
    assert steps["bench"]["decode_tok_s"] > 0
    assert steps["eval_smoke"]["metrics"] >= 8
    assert 1.0 <= steps["spec_acceptance"]["spec_rate_hinted_t08"] <= 5.0
    # off a card, a checkpoint under 3 B parameters is served as JAX serves
    # it: the fp32 tree with an fp32 cache, which spec_acceptance and bench
    # run on; eval_smoke on the bf16 load examples.eval makes
    assert steps["import"]["serve_quantized"] is False
    assert (steps["serve_load"]["mode"],
            steps["serve_load"]["cache_dtype"]) == ("fp32", "float32")
    for name in ("spec_acceptance", "bench"):
        assert (steps[name]["weights"], steps[name]["cache_dtype"]) == (
            "float32", "float32"), (name, steps[name])
    assert steps["eval_smoke"]["weights"] == "bfloat16"
    # the checkpoint came from the port's own exporter
    with open(tmp_path / "ck" / "config.json") as f:
        assert json.load(f)["model_type"] == "detikzify"


def _jax_serve_rule():
    """The JAX runbook's serve rule and its two serve_load results, read
    from ``tools/verify_real.py`` (its ``import`` step, line 189, and its
    ``serve_load`` step, lines 314-323)."""
    with open(os.path.join(ROOT, "tools", "verify_real.py")) as f:
        src = f.read()
    rule = "bool(args.quantize) or (n > 3_000_000_000 and not args.cpu)"
    assert f"quant = {rule}" in src
    serve = src[src.index('@step("serve_load")'):
                src.index('@step("spec_acceptance")')]
    assert 'return {"mode": "int8", "cache_dtype": "bfloat16"}' in serve
    assert 'return {"mode": "fp32", "cache_dtype": "float32"}' in serve
    return rule


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("n_params", [541_885_888, 3_000_000_000,
                                      3_000_000_001, 8_000_000_000])
def test_verify_real_serve_rule_is_jax(n_params, quantize, device):
    """``serve_plan`` gives the JAX runbook's serving weights and cache:
    int8 / bf16 when ``--quantize`` is given or a card serves more than
    3 B parameters, fp32 / fp32 otherwise (``--device cpu`` standing for
    JAX's ``--cpu``)."""
    import argparse

    args = argparse.Namespace(quantize=quantize, cpu=device == "cpu")
    quant = eval(_jax_serve_rule(), {}, {"args": args, "n": n_params})
    want = ("int8", "bfloat16") if quant else ("fp32", "float32")
    assert verify_real.serve_plan(n_params, quantize, device) == want


def test_verify_real_quantize_serves_int8_cpu(tmp_path):
    """With ``--quantize`` the fp32 tree is dropped for an int8 load with a
    bf16 cache, and spec_acceptance runs on those weights and that cache."""
    ck = tmp_path / "ck"
    verify_real.make_tiny_checkpoint(str(ck))
    _, args = verify_real.parse_args(
        ["--checkpoint", f"tiny={ck}", "--device", "cpu", "--quantize",
         "--spec-tokens", "8", "--workdir", str(tmp_path / "work")])
    steps = verify_real.verify_checkpoint(
        "tiny", str(ck), args,
        steps=("import", "serve_load", "spec_acceptance"))
    assert steps["import"]["serve_quantized"] is True
    assert (steps["serve_load"]["mode"],
            steps["serve_load"]["cache_dtype"]) == ("int8", "bfloat16")
    assert (steps["spec_acceptance"]["weights"],
            steps["spec_acceptance"]["cache_dtype"]) == ("int8", "bfloat16")
    assert steps["bench"]["ok"] is None and steps["eval_smoke"]["ok"] is None


def test_verify_real_counts_only_steps_that_ran():
    assert verify_real.verdict_of(
        {"a": {"import": {"ok": True}, "bench": {"ok": None}}}
    )["verdict"] == "pass"
    assert verify_real.verdict_of(
        {"a": {"import": {"ok": True}, "bench": {"ok": False}}}
    )["verdict"] == "fail"
    assert verify_real.verdict_of(
        {"a": {"import": {"ok": None}}})["verdict"] == "fail"


def test_imagesim_takes_per_channel_statistics():
    cfg = tiny_test_config(vocab_size=512)
    params = convert.init_random(cfg, device="cpu", dtype=torch.float32)
    pixels = torch.randint(0, 256, (2, 8, 8, 3), dtype=torch.uint8)
    scalar = ImageSim(params.vision, cfg, image_mean=0.5, image_std=0.5)
    lists = ImageSim(params.vision, cfg, image_mean=[0.5, 0.5, 0.5],
                     image_std=[0.5, 0.5, 0.5])
    torch.testing.assert_close(lists._norm(pixels), scalar._norm(pixels),
                               rtol=0, atol=0)
    skew = ImageSim(params.vision, cfg, image_mean=[0.0, 0.5, 1.0],
                    image_std=[1.0, 0.5, 0.25])
    got = skew._norm(pixels)
    want = (pixels.float() / 255 - torch.tensor([0.0, 0.5, 1.0])) \
        / torch.tensor([1.0, 0.5, 0.25])
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError):
        ImageSim(params.vision, cfg, mode="nope")
