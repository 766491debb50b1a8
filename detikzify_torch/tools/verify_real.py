#!/usr/bin/env python
"""Real-weights verification runbook (counterpart of
``tools/verify_real.py``): one command per checkpoint,

    python -m detikzify_torch.tools.verify_real \\
        --checkpoint ds-1.3b=/ckpts/detikzify-ds-1.3b [--checkpoint ...] \\
        [--device cuda|cpu] [--quantize] [--reference PATH] [--tex]

For each checkpoint directory it runs, recording a verdict per step:

  1. ``import``           -- checkpoint -> the port's params/config/processor
                             (``models.load.load`` on ``--device``; int8
                             weight-only with ``--quantize``).
  2. ``processor_parity`` -- tokens and pixels against the reference
                             processor loaded from the same directory.
  3. ``logit_parity``     -- fp32 forward logits against the reference
                             model (max abs diff <= --atol) and 24-token
                             greedy equality through the decode engine.
  4. ``export_gate``      -- the port's ``save_pretrained`` export loads
                             through the reference's own loader with the
                             same logits.
  5. ``spec_acceptance``  -- measured tokens/step with the checkpoint's
                             tokenizer: unhinted sampling (T=0.8) and
                             MCTS-style parent-continuation hints, beside
                             the TPU's 1.3 verify break-even.
  6. ``bench``            -- batched decode tok/s, prefix-hit start ms,
                             MCTS rollouts/min (parallelism 8), p50 time
                             to first compile.
  7. ``eval_smoke``       -- ``examples.eval``'s protocol (``predict``'s
                             per-item search, then ``score``) on a small
                             synthetic test set: every metric finite.

Steps 2-4 need the reference package: they run only with ``--reference
PATH`` (its parity runs on the CPU in fp32) and are reported as
``not_run`` without it, never as passed. LaTeX: steps 6-7 use the
FakeBackend unless ``--tex`` is given.

``--make-tiny DIR`` writes a tiny checkpoint with the port's own
``save_pretrained`` (a byte-level BPE tokenizer through ``tokenizers`` and
``transformers``, which only a CPU host has) and verifies it.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from typing import Optional, Sequence

PORT_STEPS = ("import", "spec_acceptance", "bench", "eval_smoke")
REFERENCE_STEPS = ("processor_parity", "logit_parity", "export_gate")
STEPS = ("import",) + REFERENCE_STEPS + ("spec_acceptance", "bench",
                                         "eval_smoke")
#: the JAX package's verify/plain break-even, measured on a TPU
TPU_BREAK_EVEN = 1.3


def log(*a):
    print("[verify_real]", *a, file=sys.stderr, flush=True)


def _figure(size=64):
    from PIL import Image, ImageDraw

    img = Image.new("RGB", (size, size), "white")
    ImageDraw.Draw(img).ellipse([8, 8, size - 12, size - 12],
                                outline="black", width=2)
    ImageDraw.Draw(img).line([4, size - 6, size - 6, 4], fill="blue")
    return img


def make_tiny_checkpoint(path: str) -> None:
    """Write a tiny checkpoint with the port's ``save_pretrained``: random
    fp32 weights at the reference parity tests' shape and a byte-level BPE
    tokenizer trained on a few TikZ lines."""
    import torch
    import transformers
    from tokenizers import (Tokenizer, decoders, models, pre_tokenizers,
                            trainers)

    from detikzify_torch.config import (DetikzifyConfig, TextConfig,
                                        VisionConfig)
    from detikzify_torch.models import convert
    from detikzify_torch.models.load import save_pretrained
    from detikzify_torch.processing import DetikzifyProcessor

    corpus = [
        "\\documentclass{article}\n\\begin{document}\nHi\n\\end{document}\n",
        "\\begin{tikzpicture}\n\\draw (0,0) -- (1,1);\n\\end{tikzpicture}\n",
        "\\draw[red,thick] circle (3);\n", "x y z 0 1 2 ( ) { } ; , .\n",
    ]
    tok = Tokenizer(models.BPE(unk_token=None))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(corpus, trainers.BpeTrainer(
        vocab_size=320, special_tokens=["<pad>", "<s>", "</s>", "<image>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    fast = transformers.PreTrainedTokenizerFast(
        tokenizer_object=tok, bos_token="<s>", eos_token="</s>",
        pad_token="<pad>", additional_special_tokens=["<image>"],
        model_max_length=128)
    cfg = DetikzifyConfig(
        vision=VisionConfig(hidden_size=48, intermediate_size=96,
                            num_hidden_layers=2, num_attention_heads=4,
                            image_size=42, patch_size=14),
        text=TextConfig(vocab_size=len(fast), hidden_size=64,
                        intermediate_size=128, num_hidden_layers=2,
                        num_attention_heads=4, num_key_value_heads=2,
                        max_position_embeddings=256, rope_theta=10000.0),
        image_token_id=fast.convert_tokens_to_ids("<image>"),
        bos_token_id=fast.bos_token_id, eos_token_id=fast.eos_token_id,
        pad_token_id=fast.pad_token_id, concat_factor=3,
        model_max_length=128, dtype="float32")
    params = convert.init_random(cfg, device="cpu", dtype=torch.float32)
    save_pretrained(path, params, cfg, DetikzifyProcessor(fast, cfg))
    log(f"tiny checkpoint written to {path}")


def _rollouts(eng, prompt, embeds, n, max_new):
    """Start ``n`` rollouts (as slots free up) and decode them to the end;
    returns (new tokens, seconds)."""
    t0 = time.time()
    queue, active, toks = n, [], 0
    while queue or active:
        while queue and eng.num_free_slots > 0:
            active.append(eng.start(list(prompt), image_embeds=embeds,
                                    max_new_tokens=max_new, lazy=True))
            queue -= 1
        eng.step()
        for ro in [r for r in active if r.finished]:
            toks += ro.new_tokens
            eng.release(ro)
            active.remove(ro)
    return toks, time.time() - t0


def _testset(n: int):
    """``n`` synthetic test items: a figure, its program and a caption."""
    from PIL import ImageDraw

    rows = []
    for i in range(n):
        f = _figure()
        ImageDraw.Draw(f).rectangle([2 + i, 2, 30, 30 + i], outline="red")
        rows.append({"image": f, "code": f"\\draw (0,{i}) -- (1,1);",
                     "caption": f"figure {i}"})
    return rows


def verify_checkpoint(name: str, path: str, args,
                      steps: Optional[Sequence[str]] = None) -> dict:
    """Run ``steps`` (default: every step) on one checkpoint; a step not
    run is recorded as ``{"ok": None, "not_run": reason}``."""
    import numpy as np
    import torch

    from detikzify_torch.engine import DecodeEngine
    from detikzify_torch.models import load as mload
    from detikzify_torch.ops.sampling import SamplingParams

    steps = STEPS if steps is None else tuple(steps)
    device = torch.device(args.device)
    out: dict = {"path": path}
    state: dict = {}

    def step(key):
        def deco(fn):
            if key not in steps:
                out[key] = {"ok": None, "not_run": "not requested"}
                return
            if key in REFERENCE_STEPS and not args.reference:
                out[key] = {"ok": None,
                            "not_run": "needs --reference PATH"}
                return
            t0 = time.time()
            try:
                val = fn()
                out[key] = {"ok": True, **(val or {})}
            except Exception as e:  # noqa: BLE001 -- recorded per step
                log(f"{name}.{key} FAILED: {type(e).__name__}: {e}")
                traceback.print_exc()
                out[key] = {"ok": False,
                            "error": f"{type(e).__name__}: {e}"}
            out[key]["seconds"] = round(time.time() - t0, 1)
            log(f"{name}.{key}: "
                f"{'ok' if out[key]['ok'] else 'FAILED'} "
                f"({out[key]['seconds']}s)")
        return deco

    on_card = device.type == "cuda"
    cache = torch.bfloat16 if on_card else torch.float32

    @step("import")
    def _():
        dtype = torch.bfloat16 if on_card else torch.float32
        params, cfg, proc = mload.load(
            path, dtype=dtype, quantize=bool(args.quantize),
            vision_tower=args.vision_tower or None, device=device)
        n = sum(t.numel() for t in params.parameters())
        state.update(params=params, cfg=cfg, proc=proc)
        return {"n_params": int(n), "quantized": bool(args.quantize),
                "device": str(device)}

    if not out["import"].get("ok"):
        return out
    cfg, params, proc = state["cfg"], state["params"], state["proc"]
    img = _figure(cfg.vision.image_size)

    def reference():
        if "ref" not in state:
            import importlib.util

            spec = importlib.util.spec_from_file_location(
                "reference_loader",
                os.path.join(os.path.dirname(os.path.dirname(
                    os.path.dirname(os.path.abspath(__file__)))),
                    "tests", "reference_loader.py"))
            loader = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(loader)
            loader.REFERENCE_PATH = args.reference
            ref = loader.load_reference()
            model, rproc = ref.model.load(path, dtype=torch.float32)
            cpu_params, _, cpu_proc = mload.load(
                path, dtype=torch.float32, device="cpu",
                vision_tower=args.vision_tower or None)
            state.update(ref=ref, ref_model=model.eval(), ref_proc=rproc,
                         cpu_params=cpu_params, cpu_proc=cpu_proc)
        return state

    @step("processor_parity")
    def _():
        st = reference()
        ref_in = st["ref_proc"](images=img, text="\\draw (0,0)",
                                return_tensors="pt")
        our_in = st["cpu_proc"](images=img, text="\\draw (0,0)")
        assert [int(t) for t in our_in.input_ids[0]] == \
            ref_in["input_ids"][0].tolist(), "token ids diverge"
        dp = np.abs(np.asarray(our_in.pixel_values[0])
                    - ref_in["pixel_values"][0].permute(1, 2, 0)
                    .numpy()).max()
        assert dp < 1e-5, f"pixel values diverge by {dp}"
        return {"pixel_max_diff": float(dp)}

    @step("logit_parity")
    def _():
        from detikzify_torch.models import detikzify as dtk

        st = reference()
        ref_in = st["ref_proc"](images=img, text="", return_tensors="pt")
        with torch.inference_mode():
            ref_logits = st["ref_model"](
                input_ids=ref_in["input_ids"],
                pixel_values=ref_in["pixel_values"]).logits.numpy()
            our_in = st["cpu_proc"](images=img, text="")
            ids = torch.as_tensor(np.asarray(our_in.input_ids))
            pix = torch.as_tensor(np.asarray(our_in.pixel_values))
            logits, _ = dtk.forward(st["cpu_params"], cfg, ids, pix)
        d = float(np.abs(logits.float().numpy() - ref_logits).max())
        assert d <= args.atol, f"logit max diff {d} > atol {args.atol}"
        with torch.inference_mode():
            ref_toks = st["ref_model"].generate(
                input_ids=ref_in["input_ids"],
                pixel_values=ref_in["pixel_values"], do_sample=False,
                max_new_tokens=24, bad_words_ids=[[cfg.image_token_id]],
                begin_suppress_tokens=[cfg.eos_token_id])[0].tolist()
        eng = DecodeEngine(st["cpu_params"], cfg, num_slots=2,
                           max_len=min(cfg.model_max_length, 512),
                           cache_dtype=torch.float32, device="cpu",
                           sampling=SamplingParams(temperature=0.0))
        ro = eng.start([int(t) for t in our_in.input_ids[0]],
                       image_embeds=eng.encode_image(pix),
                       max_new_tokens=24)
        eng.run()
        ours = list(ro.token_ids)
        assert ours == ref_toks, "greedy streams diverge"
        return {"logit_max_diff": d, "greedy_tokens": len(ours)}

    @step("export_gate")
    def _():
        import shutil

        st = reference()
        export = os.path.join(args.workdir, f"{name}_export")
        mload.save_pretrained(export, st["cpu_params"], cfg, st["cpu_proc"])
        for extra in ("tokenizer.json", "tokenizer_config.json",
                      "special_tokens_map.json", "processor_config.json",
                      "preprocessor_config.json"):
            src = os.path.join(path, extra)
            if os.path.exists(src):
                shutil.copy(src, os.path.join(export, extra))
        m2, p2 = st["ref"].model.load(export, dtype=torch.float32)
        ref_in = p2(images=img, text="", return_tensors="pt")
        with torch.inference_mode():
            a = m2.eval()(input_ids=ref_in["input_ids"],
                          pixel_values=ref_in["pixel_values"]).logits
            b = st["ref_model"](input_ids=ref_in["input_ids"],
                                pixel_values=ref_in["pixel_values"]).logits
        d = float((a - b).abs().max())
        assert d <= args.atol, f"reference disagrees with our export by {d}"
        return {"roundtrip_logit_max_diff": d}

    @step("spec_acceptance")
    def _():
        eng = DecodeEngine(params, cfg, num_slots=4,
                           max_len=min(cfg.model_max_length, 512),
                           cache_dtype=cache, speculate=4,
                           spec_min_rate=0.0, device=device,
                           sampling=SamplingParams(temperature=0.8,
                                                   top_p=0.95))
        prompt = [cfg.image_token_id] * cfg.image_seq_len
        embeds = eng.encode_image(proc(images=img).pixel_values)
        hints = []
        for _ in range(4):       # unhinted sampling window
            ro = eng.start(list(prompt), image_embeds=embeds,
                           max_new_tokens=args.spec_tokens)
            eng.run()
            hints.append(list(ro.token_ids[len(prompt):]))
            eng.release(ro)
        unhinted = eng.spec_rate
        eng.counters["spec_steps"] = eng.counters["spec_tokens"] = 0
        for h in hints:          # parent-continuation hints (MCTS shape)
            ro = eng.start(list(prompt), image_embeds=embeds,
                           max_new_tokens=args.spec_tokens, hint=h)
            eng.run()
            eng.release(ro)
        hinted = eng.spec_rate
        return {"spec_rate_unhinted_t08": round(unhinted, 3),
                "spec_rate_hinted_t08": round(hinted, 3),
                "break_even_tpu": TPU_BREAK_EVEN}

    @step("bench")
    def _():
        from detikzify_torch.evaluate.harness import (
            generate_until_compilable, p50_time_to_first_compile)
        from detikzify_torch.infer import DetikzifyPipeline
        from detikzify_torch.infer.tikz import FakeBackend, set_backend

        if not args.tex:
            set_backend(FakeBackend(latency=0.25))
        try:
            eng = DecodeEngine(params, cfg, num_slots=8,
                               max_len=min(cfg.model_max_length, 512),
                               decode_block=32, cache_dtype=cache,
                               device=device,
                               sampling=SamplingParams(temperature=0.8,
                                                       top_p=0.95))
            prompt = [cfg.image_token_id] * cfg.image_seq_len
            embeds = eng.encode_image(proc(images=img).pixel_values)
            # an 8-rollout warmup, then the measured 16 (two full waves)
            for n_rollouts in (8, 16):
                toks, secs = _rollouts(eng, prompt, embeds, n_rollouts,
                                       args.bench_tokens)
            ro = eng.start(list(prompt), image_embeds=embeds,
                           max_new_tokens=2)
            eng.run()
            pfx = eng.store_prefix("root", ro, length=len(prompt))
            eng.release(ro)
            t0 = time.time()
            ro = eng.start(list(prompt) + [cfg.bos_token_id],
                           image_embeds=embeds, max_new_tokens=1,
                           prefix=pfx, lazy=True)
            eng.flush()
            pfx_ms = (time.time() - t0) * 1e3
            eng.release(ro)
            eng.run()
            pipe = DetikzifyPipeline(params, cfg, proc, engine=eng,
                                     metric="fast", device=device)
            list(pipe.simulate(image=img, expansions=1))     # warmup
            t0 = time.time()
            list(pipe.simulate(image=img, expansions=8, parallelism=8))
            mcts_min = 8 / (time.time() - t0) * 60
            ttfc = []
            for _ in range(3):
                r = generate_until_compilable(pipe, img, max_expansions=8,
                                              parallelism=8)
                if r.compiled:
                    ttfc.append(r.seconds)
            return {
                "decode_tok_s": round(toks / secs, 1),
                "prefix_hit_start_ms": round(pfx_ms, 1),
                "mcts_rollouts_min_par8": round(mcts_min, 1),
                "p50_ttfc_s": round(p50_time_to_first_compile(ttfc), 2)
                if ttfc else None,
                "backend": "latexmk" if args.tex else "fake",
            }
        finally:
            if not args.tex:
                set_backend(None)

    @step("eval_smoke")
    def _():
        from detikzify_torch.evaluate.harness import generate_until_compilable
        from detikzify_torch.examples.eval import score
        from detikzify_torch.infer import DetikzifyPipeline
        from detikzify_torch.infer.tikz import FakeBackend, set_backend

        testset = _testset(args.eval_items)
        if not args.tex:
            set_backend(FakeBackend(latency=0.0))
        try:
            pipe = DetikzifyPipeline(params, cfg, proc, metric="fast",
                                     device=device)
            rows = []
            for ex in testset:      # examples.eval.predict's per-item run
                r = generate_until_compilable(pipe, ex["image"],
                                              parallelism=4)
                rows.append({"code": r.best_code, "score": r.best_score,
                             "num_programs": r.num_programs,
                             "lengths": r.program_lengths,
                             "seconds": r.seconds})
            vals = score(name, rows, testset, params, cfg, proc)
        finally:
            if not args.tex:
                set_backend(None)
        bad = {k: v for k, v in vals.items()
               if isinstance(v, float) and not np.isfinite(v)}
        assert not bad, f"non-finite metrics: {bad}"
        scores_path = os.path.join(args.workdir, f"{name}_scores.json")
        with open(scores_path, "w") as f:
            json.dump({name: vals}, f)
        return {"metrics": len(vals), "scores_json": scores_path}

    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--checkpoint", action="append", default=[],
                   help="NAME=PATH of a checkpoint dir (repeatable)")
    p.add_argument("--vision-tower", default=None,
                   help="timm SigLIP tower dir (v1 checkpoints)")
    p.add_argument("--reference", default=None,
                   help="reference repo path: runs the parity and export "
                        "steps (reported not_run without it)")
    p.add_argument("--tex", action="store_true",
                   help="use the real latexmk toolchain (default: "
                        "FakeBackend)")
    p.add_argument("--quantize", action="store_true",
                   help="load the weights int8 weight-only")
    p.add_argument("--device", default="cuda",
                   help="device of the serving steps ('cpu' runs the "
                        "kernels' plain versions)")
    p.add_argument("--atol", type=float, default=3e-4,
                   help="fp32 logit-parity tolerance")
    p.add_argument("--bench-tokens", type=int, default=32)
    p.add_argument("--spec-tokens", type=int, default=48)
    p.add_argument("--eval-items", type=int, default=3)
    p.add_argument("--workdir", default="verify_real_work")
    p.add_argument("--output", default=None,
                   help="also write the JSON verdict here")
    p.add_argument("--make-tiny", default=None, metavar="DIR",
                   help="write a tiny checkpoint at DIR with the port's "
                        "save_pretrained and verify it")
    return p, p.parse_args(argv)


def verdict_of(results: dict) -> dict:
    """Pass when every step that ran passed (``not_run`` steps count for
    nothing)."""
    ran = [v["ok"] for r in results.values() for v in r.values()
           if isinstance(v, dict) and v.get("ok") is not None]
    ok = bool(ran) and all(ran)
    return {"verdict": "pass" if ok else "fail", "checkpoints": results}


def main(argv=None):
    p, args = parse_args(argv)
    os.makedirs(args.workdir, exist_ok=True)
    if args.make_tiny:
        make_tiny_checkpoint(args.make_tiny)
        args.checkpoint.append(f"tiny={args.make_tiny}")
    if not args.checkpoint:
        p.error("at least one --checkpoint NAME=PATH (or --make-tiny)")
    results = {}
    for spec in args.checkpoint:
        name, _, path = spec.partition("=")
        if not path:
            name, path = os.path.basename(spec.rstrip("/")), spec
        log(f"=== verifying {name} ({path}) ===")
        results[name] = verify_checkpoint(name, path, args)
    verdict = verdict_of(results)
    line = json.dumps(verdict)
    print(line)
    if args.output:
        with open(args.output, "w") as f:
            f.write(line + "\n")
    return 0 if verdict["verdict"] == "pass" else 1


if __name__ == "__main__":
    sys.exit(main())
