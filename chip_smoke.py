#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``detikzify_torch``) on one GPU.

    python3 chip_smoke.py            # one CUDA card; exits non-zero without

Phases, each printing one JSON line:

1. device  -- the card's name and power limit as nvidia-smi reports them;
2. build   -- compile every hand-written kernel (one nvcc per source, all
              at once) and time it;
3. kernels -- hold each kernel (K1-K5) against its plain PyTorch version on
              the card, in bf16, at the main path's shapes (K4: the verify
              window of speculate=4 with a dead slot and one past the table
              edge; K3: a 2048-row cache and a 1024-row kv_limit view; K5:
              every int8 product of the simulate paths at 1, 8, 40 and 64
              rows) and at the v1 family's (K1 on the 729-patch tower, its
              MAP head and a 243-token prefill window at head_dim 64; K2 at
              8 query rows per KV head; K5 at TinyLlama's fused products)
              and the TikZero adapter's (K1 as the gated cross-attention
              over a key-masked caption, and as the caption model's causal
              pass with a key mask),
              and time kernel, plain version and the PyTorch library
              call (CUDA events, median of many launches, L2 flushed before
              each), next to the least time the card needs for the same
              work; mutants of the plain versions of K3 and K4 must fail;
4. reference -- the model path on the card (bf16, kernels) against the
              same weights on the host CPU (fp32, plain versions) at full
              width and 2+2 layers, with bf16 and with int8 + fused weights,
              for v2-8b and for the v1 model (tapped at layer 0); and, bf16,
              ``tikzero-adapter`` (2 vision layers with their cross-attention
              blocks, a 2-layer caption model at Llama-3.2-1B's widths);
5. main    -- random-weight ``detikzify-v2-8b`` at full width and depth in
              bf16: three ``DetikzifyPipeline.sample()`` requests and one
              ``sample_batch()`` of three figures, 128 new tokens each;
6. profile -- one more ``sample()`` request of 32 tokens under
              torch.profiler: the card's busy time and idle share;
7. contiguous -- the same bf16 weights through the contiguous-cache API:
              ``detikzify.prefill`` of eight figures into a ``KVCache`` of
              8 x 2048 rows, greedy ``decode_step`` (K3), one
              ``decode_verify_step``, held against a greedy engine run;
8. spec_greedy -- plain greedy against ``speculate=4`` (K4) on the same
              eight figures, divergence allowed only at a near-tie; one
              rollout hinted with its own greedy continuation;
9. tikzero_sample -- the TikZero adapter at the ``tikzero-adapter``
              preset's widths (random, ~0.41 B parameters) and a caption
              model at ``meta-llama/Llama-3.2-1B``'s published widths
              (random, ~1.24 B), written under ``build/`` by
              ``save_adapter`` / ``save_embedding_model`` and loaded back
              by ``load_adapter_params``, bit for bit; on the same bf16
              weights, ``sample()`` with a figure and a caption and with a
              caption alone (the adapter's blank image), 128 new tokens;
              the caption-conditioned encoder pass timed against the plain
              one;
10. tikzero_simulate -- ``simulate()`` with the caption: 8 expansions,
              parallelism 8, SelfSim EMD against the caption-conditioned
              features of the figure, one wave profiled;
11. load   -- the same bf16 weights exported by ``save_pretrained`` into
              a directory under ``build/`` and loaded back by
              ``load_params(..., quantize=True)`` (each projection quantized
              on the host, only int8 on the card), held bit for bit against
              ``quantize_params`` of the same weights in place; GB written,
              write and load seconds, host RSS, the card's peak memory;
12. simulate -- the loaded int8 weights, fused, in ``DetikzifyPipeline``
              with SelfSim (``metric="model"``, EMD) running ``simulate()``:
              16 expansions, parallelism 8, 128 new tokens; rollouts/min,
              tokens/s, SelfSim waves, memory, and one wave of 8 expansions
              under torch.profiler;
13. simulate_spec -- the same ``simulate()`` on a speculative engine
              (speculate=4), with every draft class kept on and then with
              the default gating (spec_min_rate 1.3);
14. v1_sample -- random-weight ``detikzify-tl-1.1b`` at full width and
              depth (the timm SigLIP tower at 384 px tapped at its
              second-to-last layer, TinyLlama) written as a v1 checkpoint
              and timm tower in the reference's names, loaded back by
              ``load_params(..., vision_tower=...)`` bit for bit, and driven
              as ``main`` drives v2-8b;
15. v1_simulate -- the same checkpoint loaded with ``quantize=True`` and
              fused, ``simulate()`` with 8 expansions and SelfSim (cos, as
              v1 pins it);
16. the ``kernels`` JSON line (launches on each path above, each counted
   from 0 just before the path ran and read just after, and their sum),
   the nvidia-smi line, and as the last line
   ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no result.
``--cpu-rehearsal`` runs the same phases on the CPU at ``tiny-test`` with
the plain versions (no kernels, no timings of the card); it exists for the
test suite and never prints a device result.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent

PEAK_BF16_FLOPS = 989e12       # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12           # H100 SXM HBM3 bandwidth
BF16_U = 2.0 ** -8             # bf16 unit roundoff

# (name, B, S, T, NH, NKV, Hd, mode) for K1 at the main path's shapes
K1_CASES = (
    ("vision", 3, 900, 900, 16, 16, 72, "full"),
    ("map_head", 3, 1, 900, 16, 16, 72, "full"),
    ("prefill_window", 3, 512, 640, 32, 8, 128, "window"),
)
K2_CASE = dict(B=8, NH=32, NKV=8, Hd=128, page=128, m=16,
               lengths=(300, 517, 800, 1024, 1311, 1600, 1900, 2048))
# K4: the verify window of speculate=4 (K1 = 5 rows a slot) at v2-8b;
# starts spread as K2's lengths, one slot past the table edge (2045 + 5 >
# 16 * 128) and one dead slot (start 0)
K4_CASE = dict(B=8, K1=5, NH=32, NKV=8, Hd=128, page=128, m=16,
               starts=(300, 517, 800, 1024, 1311, 1600, 2045, 0))
# K3: a contiguous cache of 2048 rows with K2's lengths, read whole and
# through a kv_limit view of 1024 rows
K3_CASE = dict(B=8, L=2048, NH=32, NKV=8, Hd=128,
               lengths=K2_CASE["lengths"], limits=(None, 1024))
# (name, K, N, output) for K5: every int8 product of the simulate path that
# K5 takes (fused qkv, o, fused gateup, down, the fp32 lm_head, the MAP
# head's q and o), each at 1, 8 (the engine's slots) and 64 rows
K5_CASES = (
    ("qkv", 4096, 6144, "bf16"), ("o", 4096, 4096, "bf16"),
    ("gateup", 4096, 28672, "bf16"), ("down", 14336, 4096, "bf16"),
    ("lm_head", 4096, 128256, "fp32"), ("map_head_q_o", 1152, 1152, "bf16"),
)
K5_ROWS = (1, 8, 40, 64)  # 40 = 8 slots x 5 rows of the verify forward
K5_FP32_SUMS = 2        # fp32 sums whose rounding errors an fp32 K5 check
#                         allows for: the kernel's and the plain version's
# the device functions of each hand-written kernel, as the profiler names
# them (K1-K4 launch a merge after their split blocks; K5 narrow blocks up
# to 8 rows, wide ones above, and a reduce after wide blocks split over K)
KERNEL_FUNCTIONS = {
    "flash_attention": ("flash_fwd_kernel", "flash_split_kernel",
                        "flash_split_merge_kernel"),
    "paged_decode": ("paged_split_kernel", "paged_merge_kernel"),
    "decode_contig": ("contig_split_kernel", "contig_merge_kernel"),
    "paged_verify": ("verify_split_kernel", "verify_merge_kernel"),
    "int8_gemv": ("int8_gemv_narrow_kernel", "int8_gemv_kernel",
                  "int8_gemv_reduce_kernel"),
}
# the v1 family's shapes (detikzify-tl-1.1b: the timm SigLIP tower at 384
# px, 729 patches, and TinyLlama, head_dim 64, 32/4 heads): K1 on the
# tower, its MAP head and a prefill window of a 243-image-token prompt (a
# bucket of 256 rows; the third row restored from a 128-row prefix)
V1_PROMPT = 243
K1_V1_CASES = (
    ("v1_vision", 3, 729, 729, 16, 16, 72, "full"),
    ("v1_map_head", 3, 1, 729, 16, 16, 72, "full"),
    ("v1_prefill_window", 3, 256, 384, 32, 4, 64, "window"),
)
# K2 at 8 query rows per KV head (the wrapper's limit), lengths 243-2048
K2_V1_CASE = dict(B=8, NH=32, NKV=4, Hd=64, page=128, m=16,
                  lengths=(243, 517, 800, 1024, 1311, 1600, 1900, 2048))
# K5 at TinyLlama's fused products; its lm_head (N = 32002, not a multiple
# of 128) takes the plain dequant product by the JAX eligibility rule
K5_V1_CASES = (
    ("v1_qkv", 2048, 2560, "bf16"), ("v1_o", 2048, 2048, "bf16"),
    ("v1_gateup", 2048, 11264, "bf16"), ("v1_down", 5632, 2048, "bf16"),
)
K5_V1_ROWS = (1, 8)
# K1 at the TikZero adapter's shapes, (name, B, S, T, NH, NKV, Hd, mode,
# key lengths): the gated cross-attention (900 patch queries over a caption
# padded on the right to 64 tokens, 16/16 heads at Hd 72) and the caption
# model's causal pass with a key mask (Llama-3.2-1B: 32/8 heads at Hd 64)
K1_TIKZERO_CASES = (
    ("cross", 2, 900, 64, 16, 16, 72, "mask", (17, 64)),
    ("caption", 2, 64, 64, 32, 8, 64, "causal_mask", (23, 64)),
)
# meta-llama/Llama-3.2-1B's config.json: the TikZero caption model
LLAMA32_1B = dict(
    vocab_size=128256, hidden_size=2048, intermediate_size=8192,
    num_hidden_layers=16, num_attention_heads=32, num_key_value_heads=8,
    max_position_embeddings=131072, rms_norm_eps=1e-5, rope_theta=500000.0,
    rope_scaling={"factor": 32.0, "high_freq_factor": 4.0,
                  "low_freq_factor": 1.0,
                  "original_max_position_embeddings": 8192,
                  "rope_type": "llama3"},
    tie_word_embeddings=True, hidden_act="silu")
TIKZERO_CAPTION = ("a bar chart of rollouts per minute on three machines, "
                   "with error bars and a dashed line at the mean")
TIKZERO_EXPANSIONS = 8  # MCTS expansions of the tikzero_simulate phase
V1_EXPANSIONS = 8       # MCTS expansions of the v1_simulate phase
SIM_EXPANSIONS = 16     # MCTS expansions of the simulate phases
SPECULATE = 4           # draft tokens per verify step (K1 = 5)
CONTIG_NEW_TOKENS = 64  # greedy tokens of the contiguous phase


_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also carries ``t_s``, the seconds
    since the script started."""
    if "phase" in obj:
        obj = dict(obj, t_s=time.perf_counter() - _START)
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Median kernel time with CUDA events, L2 flushed before each launch.
    A spin of the card (``torch.cuda._sleep``, ~0.3 ms) is queued after the
    flush, so the start event, the launch and the end event are all queued
    before the card reaches them: the host's time to issue the call does
    not count, only the card's."""

    def __init__(self, torch, device, iters: int):
        self.torch = torch
        self.iters = iters
        self.flush_buf = torch.empty(64 << 20, dtype=torch.uint8,
                                     device=device)

    def __call__(self, fn) -> float:
        torch = self.torch
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(self.iters):
            self.flush_buf.zero_()
            torch.cuda._sleep(500_000)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


def k1_inputs(torch, gen, device, b, s, t, nh, nkv, hd, mode, prompt=300,
              lengths=None):
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32).to(torch.bfloat16)

    q, k, v = rnd(b, s, nh, hd), rnd(b, t, nkv, hd), rnd(b, t, nkv, hd)
    kw = {}
    visible_keys = b * s * t
    if mode == "window":
        # two fresh prompts and one row restored from a 128-row prefix
        # (q_offsets > 0), as the engine's fused start builds them
        offs = [0, 0, 128]
        lims = [prompt, prompt, 128 + prompt]
        kw = dict(q_offsets=torch.tensor(offs, dtype=torch.int32,
                                         device=device),
                  kv_limits=torch.tensor(lims, dtype=torch.int32,
                                         device=device))
        visible_keys = sum(min(o + i + 1, lim) for o, lim in zip(offs, lims)
                           for i in range(s))
    elif mode in ("mask", "causal_mask"):
        # captions padded on the right to T tokens
        kw = dict(kv_mask=(torch.arange(t, device=device)[None, :]
                           < torch.tensor(lengths, device=device)[:, None]
                           ).contiguous())
        visible_keys = s * sum(lengths)
        if mode == "causal_mask":
            kw["causal"] = True
            visible_keys = sum(min(i + (t - s) + 1, n) for n in lengths
                               for i in range(s))
    return q, k, v, kw, visible_keys


def tolerance_check(torch, got, want, pv_abs) -> dict:
    """|kernel - plain| <= 2u (pv_abs + |plain|) elementwise, u = 2^-8, with
    pv_abs = sum_t p_t |v_t| the plain version run on |v|: the mass that
    reaches each output element. Both sides round the output to bf16 once,
    and each rounds the probabilities to bf16 at a different point (the
    plain version after normalising, K1 before; K2 keeps p in fp32 where
    the plain version rounds it), each costing at most u * pv_abs."""
    err = (got.float() - want.float()).abs()
    bound = 2 * BF16_U * (pv_abs.float() + want.float().abs())
    ok = (bool(torch.isfinite(got.float()).all())
          and bool((err <= bound).all()))
    return {"max_abs_err": float(err.max()),
            "tolerance": "2^-7 * (plain(|v|) + |plain|) elementwise",
            "max_err_over_tol": float((err / bound).max()),
            "tol_over_median_abs_plain": float(
                bound.median() / want.float().abs().median()),
            "ok": ok}


def control_check(torch, got, mutant, pv_abs, what: str) -> float:
    """A mutant of the plain version (one causal row too many, one block too
    few) held against the kernel's output must FAIL the tolerance, or the
    tolerance is too loose to see such a fault. Returns its max error over
    the tolerance."""
    ctl = tolerance_check(torch, got, mutant, pv_abs)
    if ctl["ok"]:
        raise SystemExit(f"{what}: the tolerance passes a mutant: {ctl}")
    return ctl["max_err_over_tol"]


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card needs: bytes over the HBM rate, or bf16
    operations over the tensor-core peak, whichever is larger."""
    by_bytes = nbytes / PEAK_BYTES >= flops / PEAK_BF16_FLOPS
    return {"bound_ms": max(nbytes / PEAK_BYTES,
                            flops / PEAK_BF16_FLOPS) * 1e3,
            "bound_by": "bytes" if by_bytes else "operations"}


def k5_tolerance_check(torch, got, want, mag, k: int, out_dtype) -> dict:
    """|kernel - plain| <= u_out |plain| + acc elementwise, mag =
    plain(|x|, |q|) the sum of the products' magnitudes.

    bf16 output: u_out = 2^-7, one rounding of the output (a whole bf16
    ulp, since the two fp32 sums may fall on either side of a rounding
    boundary), and acc = K 2^-23 mag, the worst case of two fp32 sums of K
    products in different orders.

    fp32 output (the lm_head's logits): u_out = 0 and acc = 2 sqrt(K)
    2^-24 mag, the random-walk size of the same two sums' rounding errors,
    factor 2 for the two sums. The worst-case K 2^-23 would be sqrt(K)
    (64 at K 4096) times looser and would let an output rounded through
    bf16 pass; the caller holds a bf16-rounded copy of the output against
    this bound as a control that must fail."""
    want = want.float()
    err = (got.float() - want).abs()
    if out_dtype == torch.bfloat16:
        bound = 2.0 ** -7 * want.abs() + k * 2.0 ** -23 * mag
        rule = "2^-7 |plain| + K 2^-23 plain(|x|,|q|)"
    else:
        bound = K5_FP32_SUMS * k ** 0.5 * 2.0 ** -24 * mag
        rule = "2 sqrt(K) 2^-24 plain(|x|,|q|)"
    ok = (bool(torch.isfinite(got.float()).all())
          and bool((err <= bound).all()))
    return {"max_abs_err": float(err.max()), "tolerance": rule,
            "max_err_over_tol": float((err / bound).max()), "ok": ok}


def k5_rows(torch, gen, device, rehearsal: bool, timer) -> list:
    """K5 against int8_matmul_plain at every K5 product of the simulate
    path; times kernel, plain version and the bf16 F.linear yardstick."""
    import torch.nn.functional as F

    from detikzify_torch.ops import quant_matmul
    from detikzify_torch.ops.quant import quantize_kernel

    sms = (torch.cuda.get_device_properties(device).multi_processor_count
           if device.type == "cuda" else 132)
    rows = []
    for (name, k, n, out), row_counts in (
            [(c, K5_ROWS) for c in K5_CASES]
            + [(c, K5_V1_ROWS) for c in K5_V1_CASES]):
        if rehearsal:       # tiny shapes: the CPU only checks the wiring
            k, n = 256, 384
        w = torch.randn((n, k), generator=gen, device=device) * k ** -0.5
        q, scale = quantize_kernel(w)
        w_bf16 = (q.float() * scale[:, None]).to(torch.bfloat16)
        del w
        out_dtype = torch.float32 if out == "fp32" else torch.bfloat16
        for m in row_counts:
            x = torch.randn((m, k), generator=gen, device=device,
                            dtype=torch.float32).to(torch.bfloat16)
            got = quant_matmul.int8_matmul(x, q, scale, out_dtype)
            want = quant_matmul.int8_matmul_plain(x, q, scale, out_dtype)
            mag = quant_matmul.int8_matmul_plain(x.abs(), q.abs(), scale,
                                                 torch.float32)
            tol = k5_tolerance_check(torch, got, want, mag, k, out_dtype)
            if not tol.pop("ok"):
                raise SystemExit(f"K5 {name} rows {m}: kernel disagrees "
                                 f"with its plain version: {tol}")
            if out_dtype == torch.float32:
                # control: the same output rounded through bf16 must fail
                ctl = k5_tolerance_check(torch, got.to(torch.bfloat16), want,
                                         mag, k, out_dtype)
                if ctl["ok"]:
                    raise SystemExit(f"K5 {name} rows {m}: the fp32 check "
                                     "passes an output rounded to bf16")
                tol["bf16_control_max_err_over_tol"] = ctl["max_err_over_tol"]
            nbytes = n * k + m * k * 2 + n * 4 + m * n * (
                4 if out == "fp32" else 2)
            flops = 2 * m * n * k
            plan = quant_matmul.gemv_plan(m, n, k, sms)
            row = {"name": f"int8_gemv/{name}/rows{m}",
                   "kernel": "int8_gemv", "route": "cuda",
                   "source": "detikzify_torch/csrc/int8_gemv.cu",
                   "replaces": "detikzify_tpu/ops/quant_matmul.py:40",
                   "shape": {"M": m, "K": k, "N": n, "out": out},
                   "plan": plan._asdict(), **tol, **bound(nbytes, flops)}
            if timer is not None:
                row["ms"] = timer(lambda: quant_matmul.int8_gemv(
                    x, q, scale, out_dtype))
                row["plain_ms"] = timer(lambda: quant_matmul.
                                        int8_matmul_plain(x, q, scale,
                                                          out_dtype))
                # library yardstick: one cuBLAS product on the dequantised
                # bf16 weight (twice the weight bytes)
                row["library_ms"] = timer(lambda: F.linear(x, w_bf16))
            rows.append(row)
        del q, scale, w_bf16
    return rows


def kernel_phase(torch, device, rehearsal: bool, iters: int):
    from detikzify_torch.ops import attention, flash

    gen = torch.Generator(device=device).manual_seed(1234)
    timer = None if rehearsal else Timer(torch, device, iters)
    rows = []
    for (name, b, s, t, nh, nkv, hd, mode), prompt, lengths in (
            [(c, 300, None) for c in K1_CASES]
            + [(c, V1_PROMPT, None) for c in K1_V1_CASES]
            + [(c[:8], None, c[8]) for c in K1_TIKZERO_CASES]):
        if rehearsal:   # tiny shapes: the CPU only checks the wiring
            s, t = min(s, 9), 12
            lengths = lengths and tuple(min(n, t) for n in lengths)
        q, k, v, kw, vis = k1_inputs(torch, gen, device, b, s, t, nh, nkv,
                                     hd, mode, prompt, lengths)
        got = flash.flash_attention(q, k, v, **kw)
        want = attention.attend_plain(q, k, v, **kw)
        tol = tolerance_check(torch, got, want,
                              attention.attend_plain(q, k, v.abs(), **kw))
        if not tol.pop("ok"):
            raise SystemExit(f"K1 {name}: kernel disagrees with its plain "
                             f"version: {tol}")
        row = {"name": f"flash_attention/{name}", "kernel": "flash_attention",
               "route": "cuda", "source": "detikzify_torch/csrc/flash_attn.cu",
               "replaces": "detikzify_tpu/ops/flash.py:187",
               "shape": {"B": b, "S": s, "T": t, "NH": nh, "NKV": nkv,
                         "Hd": hd, "mode": mode,
                         **({"key_lengths": list(lengths)} if lengths
                            else {})},
               **tol}
        row.update(bound(2 * (q.numel() * 2 + k.numel() + v.numel())
                         + (b * t if lengths else 0), 4 * nh * hd * vis))
        if timer is not None:
            import torch.nn.functional as F

            row["ms"] = timer(lambda: flash.flash_attention(q, k, v, **kw))
            row["plain_ms"] = timer(
                lambda: attention.attend_plain(q, k, v, **kw))
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            mask = None
            if mode == "window":
                qpos = (kw["q_offsets"][:, None, None, None]
                        + torch.arange(s, device=device)[None, None, :, None])
                kpos = torch.arange(t, device=device)[None, None, None, :]
                mask = (kpos <= qpos) & (kpos
                                         < kw["kv_limits"][:, None, None, None])
            elif lengths:
                mask = kw["kv_mask"][:, None, None, :]
                if kw.get("causal"):
                    mask = mask & torch.ones((s, t), dtype=torch.bool,
                                             device=device).tril(t - s)
            row["library_ms"] = timer(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=nh != nkv))
        rows.append(row)

    rows.append(k2_row(torch, gen, device, rehearsal, timer, K2_CASE,
                       "paged_decode"))
    rows.append(k2_row(torch, gen, device, rehearsal, timer, K2_V1_CASE,
                       "paged_decode/v1"))
    rows.append(k4_row(torch, gen, device, rehearsal, timer))
    rows.extend(k3_rows(torch, gen, device, rehearsal, timer))
    rows.extend(k5_rows(torch, gen, device, rehearsal, timer))
    return rows


def k2_row(torch, gen, device, rehearsal: bool, timer, case: dict,
           name: str) -> dict:
    """K2, decode over the page pool, against its plain version; SDPA with
    a length mask over pre-gathered pages is the library yardstick."""
    from detikzify_torch.ops import paged

    c = dict(case)
    if rehearsal:
        c.update(B=2, NH=4, NKV=2, Hd=64, page=16, m=3, lengths=(5, 40))
    b, nh, nkv, hd, page, m = (c[x] for x in ("B", "NH", "NKV", "Hd", "page",
                                              "m"))
    n_pages = b * m + 1
    pool_k = torch.randn((n_pages, page, nkv, hd), generator=gen,
                         device=device).to(torch.bfloat16)
    pool_v = torch.randn((n_pages, page, nkv, hd), generator=gen,
                         device=device).to(torch.bfloat16)
    perm = torch.randperm(n_pages, generator=gen, device=device)[:b * m]
    tab = perm.reshape(b, m).to(torch.int32).contiguous()
    lengths = torch.tensor(c["lengths"], dtype=torch.int32, device=device)
    q = torch.randn((b, nh, hd), generator=gen,
                    device=device).to(torch.bfloat16)
    got = paged.decode_attend_paged(q, pool_k, pool_v, tab, lengths)
    want = paged.decode_attend_paged_plain(q, pool_k, pool_v, tab, lengths)
    tol = tolerance_check(torch, got, want, paged.decode_attend_paged_plain(
        q, pool_k, pool_v.abs(), tab, lengths))
    if not tol.pop("ok"):
        raise SystemExit(f"K2 {name}: kernel disagrees with its plain "
                         f"version: {tol}")
    live = sum(c["lengths"])
    nbytes = live * nkv * hd * 2 * 2 + 2 * q.numel() * 2
    flops = 4 * nh * hd * live
    row = {"name": name, "kernel": "paged_decode", "route": "cuda",
           "source": "detikzify_torch/csrc/paged_decode.cu",
           "replaces": "detikzify_tpu/ops/paged.py:194",
           "shape": {"B": b, "NH": nh, "NKV": nkv, "Hd": hd, "page": page,
                     "m": m, "lengths": list(c["lengths"])},
           **tol, **bound(nbytes, flops)}
    if timer is not None:
        import torch.nn.functional as F

        row["ms"] = timer(lambda: paged.decode_attend_paged(
            q, pool_k, pool_v, tab, lengths))
        row["plain_ms"] = timer(lambda: paged.decode_attend_paged_plain(
            q, pool_k, pool_v, tab, lengths))
        # library yardstick: SDPA on pre-gathered contiguous pages with the
        # length mask (the gather itself is not in the timing)
        kg = paged.gather_pages(pool_k, tab).transpose(1, 2).contiguous()
        vg = paged.gather_pages(pool_v, tab).transpose(1, 2).contiguous()
        mask = (torch.arange(m * page, device=device)[None, :]
                < lengths[:, None])[:, None, None, :]
        qs = q[:, :, None, :]
        row["library_ms"] = timer(lambda: F.scaled_dot_product_attention(
            qs, kg, vg, attn_mask=mask, enable_gqa=True))
    return row


def k4_row(torch, gen, device, rehearsal: bool, timer) -> dict:
    """K4, the speculative verify window, against its plain version at the
    v2-8b shapes of speculate=4; SDPA with a per-row boolean mask over
    pre-gathered pages is the library yardstick."""
    import torch.nn.functional as F

    from detikzify_torch.ops import paged

    c = dict(K4_CASE)
    if rehearsal:
        c.update(B=3, NH=4, NKV=2, Hd=64, page=64, m=2, starts=(5, 124, 0))
    b, k1, nh, nkv, hd, page, m = (c[x] for x in ("B", "K1", "NH", "NKV",
                                                  "Hd", "page", "m"))
    n_pages = b * m + 1

    def rnd(*shape):
        return torch.randn(shape, generator=gen,
                           device=device).to(torch.bfloat16)

    pool_k, pool_v = rnd(n_pages, page, nkv, hd), rnd(n_pages, page, nkv, hd)
    perm = torch.randperm(n_pages, generator=gen, device=device)[:b * m]
    tab = perm.reshape(b, m).to(torch.int32).contiguous()
    starts = torch.tensor(c["starts"], dtype=torch.int32, device=device)
    q = rnd(b, k1, nh, hd)
    got = paged.decode_verify_attend_paged(q, pool_k, pool_v, tab, starts)
    want = paged.decode_verify_attend_paged_plain(q, pool_k, pool_v, tab,
                                                  starts)
    pv_abs = paged.decode_verify_attend_paged_plain(q, pool_k, pool_v.abs(),
                                                    tab, starts)
    tol = tolerance_check(torch, got, want, pv_abs)
    if not tol.pop("ok"):
        raise SystemExit(f"K4: kernel disagrees with its plain version: "
                         f"{tol}")
    tol["control_late_limit_max_err_over_tol"] = control_check(
        torch, got, paged.decode_verify_attend_paged_plain(
            q, pool_k, pool_v, tab, starts + 1), pv_abs,
        "K4 with every causal limit one row late")
    width = m * page
    rows_read = sum(min(s0 + k1, width) for s0 in c["starts"])
    visible = sum(min(s0 + j + 1, width) for s0 in c["starts"]
                  for j in range(k1))
    row = {"name": "paged_verify", "kernel": "paged_verify", "route": "cuda",
           "source": "detikzify_torch/csrc/paged_verify.cu",
           "replaces": "detikzify_tpu/ops/paged.py:363",
           "shape": {"B": b, "K1": k1, "NH": nh, "NKV": nkv, "Hd": hd,
                     "page": page, "m": m, "starts": list(c["starts"])},
           **tol, **bound(rows_read * nkv * hd * 2 * 2 + 2 * q.numel() * 2,
                          4 * nh * hd * visible)}
    if timer is not None:
        row["ms"] = timer(lambda: paged.decode_verify_attend_paged(
            q, pool_k, pool_v, tab, starts))
        row["plain_ms"] = timer(lambda: paged.decode_verify_attend_paged_plain(
            q, pool_k, pool_v, tab, starts))
        # library yardstick: SDPA on pre-gathered pages with the per-row
        # causal mask (the gather itself is not in the timing)
        kg = paged.gather_pages(pool_k, tab).transpose(1, 2).contiguous()
        vg = paged.gather_pages(pool_v, tab).transpose(1, 2).contiguous()
        limit = (starts[:, None] + torch.arange(k1, device=device)[None]
                 + 1)[:, None, :, None]
        mask = torch.arange(width, device=device)[None, None, None] < limit
        qs = q.transpose(1, 2).contiguous()
        row["library_ms"] = timer(lambda: F.scaled_dot_product_attention(
            qs, kg, vg, attn_mask=mask, enable_gqa=True))
    return row


def k3_rows(torch, gen, device, rehearsal: bool, timer) -> list:
    """K3, decode over a contiguous cache, against its plain version: the
    whole 2048-row cache, then a kv_limit view of 1024 rows read in place;
    SDPA with a length mask is the library yardstick."""
    import torch.nn.functional as F

    from detikzify_torch.ops import attention

    c = dict(K3_CASE)
    if rehearsal:
        c.update(B=2, L=96, NH=4, NKV=2, Hd=64, lengths=(70, 96),
                 limits=(None, 80))
    b, length, nh, nkv, hd = (c[x] for x in ("B", "L", "NH", "NKV", "Hd"))

    def rnd(*shape):
        return torch.randn(shape, generator=gen,
                           device=device).to(torch.bfloat16)

    q = rnd(b, nh, hd)
    k_full, v_full = rnd(b, length, nkv, hd), rnd(b, length, nkv, hd)
    rows = []
    for limit in c["limits"]:
        k, v = k_full, v_full
        lens = torch.tensor(c["lengths"], dtype=torch.int32, device=device)
        if limit is not None:       # a view, not a copy: read in place
            k, v, lens = k[:, :limit], v[:, :limit], lens.clamp(max=limit)
        got = attention.decode_attend(q, k, v, lens)
        want = attention.decode_attend_plain(q, k, v, lens)
        pv_abs = attention.decode_attend_plain(q, k, v.abs(), lens)
        tol = tolerance_check(torch, got, want, pv_abs)
        if not tol.pop("ok"):
            raise SystemExit(f"K3 (limit {limit}): kernel disagrees with "
                             f"its plain version: {tol}")
        tol["control_block_short_max_err_over_tol"] = control_check(
            torch, got, attention.decode_attend_plain(q, k, v, lens - 64),
            pv_abs, "K3 reading one 64-row block short")
        live = int(lens.sum())
        row = {"name": "decode_contig" + ("" if limit is None
                                          else f"/kv_limit{limit}"),
               "kernel": "decode_contig", "route": "cuda",
               "source": "detikzify_torch/csrc/decode_contig.cu",
               "replaces": "detikzify_tpu/ops/decode_flash.py:183",
               "shape": {"B": b, "L": k.shape[1], "NH": nh, "NKV": nkv,
                         "Hd": hd, "lengths": lens.tolist(),
                         "view_of_rows": length if limit else None},
               **tol, **bound(live * nkv * hd * 2 * 2 + 2 * q.numel() * 2,
                              4 * nh * hd * live)}
        if timer is not None:
            row["ms"] = timer(lambda: attention.decode_attend(q, k, v, lens))
            row["plain_ms"] = timer(lambda: attention.decode_attend_plain(
                q, k, v, lens))
            kt = k.transpose(1, 2).contiguous()
            vt = v.transpose(1, 2).contiguous()
            mask = (torch.arange(k.shape[1], device=device)[None, :]
                    < lens[:, None])[:, None, None, :]
            qs = q[:, :, None, :]
            row["library_ms"] = timer(lambda: F.scaled_dot_product_attention(
                qs, kt, vt, attn_mask=mask, enable_gqa=True))
        rows.append(row)
    return rows


def v1_config(rehearsal: bool, feature_layer=None):
    """The v1 model of the v1 phases: ``detikzify-tl-1.1b`` as its
    ``config.json`` describes it (the timm so400m tower at 384 px, 729
    patches, 243 image tokens; TinyLlama), tapped at ``feature_layer`` (the
    second-to-last of the tower's layers by default). The rehearsal's is
    tiny-test with v1's wiring: bos 1, eos 2, the image and pad tokens at
    the top of the vocabulary, a biased projector, SelfSim pinned to cos,
    and an image size that leaves pixels past the last whole patch (44 px
    at patch 14, as 384 px does)."""
    from detikzify_torch.config import get_config, tiny_test_config
    from detikzify_torch.models import import_hf

    if rehearsal:
        base = tiny_test_config(vocab_size=512)
        cfg = base.replace(
            vision=base.vision.replace(image_size=44),
            image_token_id=510, pad_token_id=511, bos_token_id=1,
            eos_token_id=2, projector_bias=True, pooling_mode="cos",
            is_v1=True)
    else:
        cfg = import_hf.config_from_hf_json(
            v1_hf_config(get_config("detikzify-tl-1.1b"), 0))
    if feature_layer is None:
        feature_layer = cfg.vision.num_hidden_layers - 2
    return cfg.replace(feature_layer=feature_layer)


def v1_hf_config(cfg, feature_layer: int) -> dict:
    """A v1 checkpoint's flat ``config.json`` (reference ``model/v1/
    configuration_detikzify.py``) for ``cfg``'s decoder."""
    t = cfg.text
    return {"architectures": ["DetikzifyForCausalLM"],
            "model_type": "detikzify", "vocab_size": t.vocab_size,
            "hidden_size": t.hidden_size,
            "intermediate_size": t.intermediate_size,
            "num_hidden_layers": t.num_hidden_layers,
            "num_attention_heads": t.num_attention_heads,
            "num_key_value_heads": t.num_key_value_heads,
            "max_position_embeddings": t.max_position_embeddings,
            "rms_norm_eps": t.rms_norm_eps, "rope_theta": t.rope_theta,
            "hidden_act": t.hidden_act,
            "tie_word_embeddings": t.tie_word_embeddings,
            "patch_token_id": cfg.image_token_id,
            "bos_token_id": cfg.bos_token_id,
            "eos_token_id": cfg.eos_token_id,
            "pad_token_id": cfg.pad_token_id,
            "concat_patches": cfg.concat_factor,
            "feature_layer": feature_layer}


def tikzero_configs(rehearsal: bool):
    """(model config with its ``AdapterConfig``, caption model config): the
    ``tikzero-adapter`` preset and Llama-3.2-1B, or tiny-test sizes."""
    from detikzify_torch.config import (AdapterConfig, TextConfig,
                                        get_config)

    if not rehearsal:
        return get_config("tikzero-adapter"), TextConfig(**LLAMA32_1B)
    ecfg = TextConfig(**dict(LLAMA32_1B, vocab_size=512, hidden_size=48,
                             intermediate_size=96, num_hidden_layers=2,
                             num_attention_heads=4, num_key_value_heads=2))
    cfg = get_config("tiny-test").replace(adapter=AdapterConfig(
        embedding_hidden_size=48, num_attention_heads=4))
    return cfg, ecfg


def reference_phase(torch, device, rehearsal: bool, seed: int,
                    v1: bool = False, tikzero: bool = False):
    """The model path on the card (bf16, kernels) against the same weights
    on the host CPU (fp32, plain versions) at full width cut to 2 vision +
    2 text layers: v2-8b, or (``v1``) the v1 model tapped at layer 0, or
    (``tikzero``) the ``tikzero-adapter`` preset with the cross-attention
    blocks of its 2 vision layers and a 2-layer caption model at
    Llama-3.2-1B's widths, conditioned on two captions of different
    lengths; vision tower, a paged prefill of the image tokens (300 for v2,
    243 for v1) + 16 text tokens, then 4 zero-copy decode steps. Once with
    the bf16 weights (K1, K2), once with their int8 + fused form (K5 too;
    not for tikzero, whose path runs bf16)."""
    import copy

    import numpy as np

    from detikzify_torch.config import get_config
    from detikzify_torch.models import convert, detikzify, llama
    from detikzify_torch.models.embedding import AdapterBundle
    from detikzify_torch.ops.quant import fuse_projections, quantize_params
    from detikzify_torch.processing import ByteTokenizer

    if v1:
        base = v1_config(rehearsal, feature_layer=0)
    elif tikzero:
        base, ecfg = tikzero_configs(rehearsal)
        ecfg = ecfg.replace(num_hidden_layers=2)
    else:
        base = get_config("tiny-test" if rehearsal else "detikzify-v2-8b")
    cfg = base.replace(
        vision=base.vision.replace(num_hidden_layers=2),
        text=base.text.replace(num_hidden_layers=2))
    cpu = torch.device("cpu")
    ref = convert.init_random(cfg, device=cpu, dtype=torch.float32,
                              generator=torch.Generator().manual_seed(seed))
    dut_dtype = torch.float32 if rehearsal else torch.bfloat16
    dut = copy.deepcopy(ref).to(device=device, dtype=dut_dtype)
    bundles = {}
    if tikzero:
        g = torch.Generator().manual_seed(seed + 1)
        ref_b = AdapterBundle(
            convert.init_random_adapter(cfg.vision, cfg.adapter, device=cpu,
                                        dtype=torch.float32, generator=g),
            cfg.adapter,
            convert.init_random_llama(ecfg, device=cpu, dtype=torch.float32,
                                      generator=g),
            ecfg, smoke_tokenizer(ByteTokenizer, cfg))
        with torch.no_grad():       # gates off zero, one value a block
            for i, blk in enumerate(ref_b.adapter_params.layers):
                blk.attn_gate.fill_(0.5 - i)
                blk.mlp_gate.fill_(i - 0.5)
        bundles = {"cpu": ref_b, "dut": AdapterBundle(
            copy.deepcopy(ref_b.adapter_params).to(device, dut_dtype),
            cfg.adapter,
            copy.deepcopy(ref_b.embed_params).to(device, dut_dtype),
            ecfg, ref_b.tokenizer)}
    captions = [TIKZERO_CAPTION, "a red square"]
    rng = np.random.default_rng(seed)
    size = cfg.vision.image_size
    pix = rng.standard_normal((1, size, size, 3)).astype(np.float32)
    n_img, n_txt, page = cfg.image_seq_len, 16, 128 if not rehearsal else 16
    prompt = ([cfg.image_token_id] * n_img + [cfg.bos_token_id]
              + [int(t) for t in rng.integers(0, 256, n_txt - 1)])
    s = 1 << (len(prompt) - 1).bit_length()
    ids = np.zeros((1, s), np.int32)
    ids[0, :len(prompt)] = prompt
    m = -(-(s + 8) // page)
    steps = [int(t) for t in rng.integers(0, 256, 4)]

    @torch.inference_mode()
    def run(params, dev, bundle=None):
        dt = params.dtype
        i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa
        pool = llama.init_paged_cache(cfg.text, m + 1, page, dtype=dt,
                                      device=dev)
        tab = torch.arange(m, dtype=torch.int32, device=dev)[None]
        ai = None
        if bundle is not None:      # the padded caption conditions the tower
            ai = bundle.adapter_inputs(captions)
            ai = ai._replace(cross_states=ai.cross_states[1:],
                             cross_mask=ai.cross_mask[1:])
        emb = detikzify.encode_image(params, cfg, torch.from_numpy(pix).to(
            dev), adapter=ai)
        out = []
        logits, _ = detikzify.prefill_paged(
            params, cfg, torch.from_numpy(ids).to(dev), emb, i32([0]),
            i32([len(prompt)]), pool, torch.zeros((1, 0), dtype=torch.int32,
                                                  device=dev),
            tab, i32([0]), image_offsets=i32([0]), trash_row=m * page - 1,
            trash_page=m)
        out.append(logits)
        for j, tok in enumerate(steps):
            logits, _ = detikzify.decode_step_paged(
                params, cfg, i32([tok]), i32([len(prompt) + j]), pool, tab,
                kv_pages=m, trash_row=m * page - 1, trash_page=m)
            out.append(logits)
        return torch.cat(out).float().cpu(), emb.float().cpu()

    def compare(weights: str, dut, ref) -> None:
        got, got_emb = run(dut, device, bundles.get("dut"))
        want, want_emb = run(ref, cpu, bundles.get("cpu"))
        scale = float(want.std())
        rel = float((got - want).abs().max()) / scale
        cos = float(torch.nn.functional.cosine_similarity(got, want, dim=-1)
                    .min())
        emb_cos = float(torch.nn.functional.cosine_similarity(
            got_emb.flatten(1), want_emb.flatten(1)).min())
        agree = int((got.argmax(-1) == want.argmax(-1)).sum())
        result = {"phase": "reference",
                  "model": "tikzero" if tikzero else "v1" if v1 else "v2",
                  "weights": weights, "layers": {"vision": 2, "text": 2},
                  "feature_layer": cfg.feature_layer,
                  "max_abs_err_over_std": rel, "min_cosine": cos,
                  "image_tokens_cosine": emb_cos,
                  "argmax_agree": f"{agree}/{got.shape[0]}",
                  "tolerance": "cosine >= 0.999 and max|err| <= 0.1 std"}
        ok = (bool(torch.isfinite(got).all()) and cos >= 0.999
              and emb_cos >= 0.999 and rel <= 0.1)
        if tikzero:
            # the caption model alone: hidden states of both captions at
            # their valid positions (the shorter one padded on the right)
            (gh, gm), (wh, wm) = (bundles[k].embed_captions(captions)
                                  for k in ("dut", "cpu"))
            valid = wm.cpu()
            hcos = float(torch.nn.functional.cosine_similarity(
                gh.float().cpu()[valid], wh.float()[valid], dim=-1).min())
            result.update(caption_layers=2, caption_tokens=[
                int(x) for x in valid.sum(-1)],
                caption_hidden_min_cosine=hcos)
            ok = ok and hcos >= 0.999 and torch.equal(gm.cpu(), valid)
        emit(result)
        if not ok:
            raise SystemExit(f"card path disagrees with the fp32 "
                             f"reference: {result}")

    compare("bf16", dut, ref)
    if tikzero:
        return
    # int8 + fused: the same quantized tree on the card (bf16 activations,
    # K5 for the decode rows, the lm_head and the MAP head) and on the CPU
    # (fp32 activations, plain versions)
    del dut
    qref = fuse_projections(quantize_params(ref))
    qdut = copy.deepcopy(qref).to(device=device, dtype=(
        torch.float32 if rehearsal else torch.bfloat16))
    compare("int8+fused", qdut, qref)


def synthetic_figures(n: int, seed: int):
    """Line-art figures drawn from a seed (numpy RNG, PIL)."""
    import numpy as np
    from PIL import Image, ImageDraw

    rng = np.random.default_rng(seed)
    figs = []
    for _ in range(n):
        w, h = (int(x) for x in rng.integers(240, 640, 2))
        img = Image.new("RGB", (w, h), "white")
        d = ImageDraw.Draw(img)
        for _ in range(int(rng.integers(3, 9))):
            x0, x1 = sorted(int(x) for x in rng.integers(0, w, 2))
            y0, y1 = sorted(int(y) for y in rng.integers(0, h, 2))
            color = tuple(int(c) for c in rng.integers(0, 200, 3))
            kind = int(rng.integers(3))
            if kind == 0:
                d.rectangle([x0, y0, x1, y1], outline=color, width=2)
            elif kind == 1:
                d.ellipse([x0, y0, x1, y1], outline=color, width=2)
            else:
                d.line([x0, y0, x1, y1], fill=color, width=2)
        figs.append(img)
    return figs


def smoke_tokenizer(byte_tokenizer, cfg):
    """The byte tokenizer with every id above the 256 bytes decoding to
    text too: one id in 16 to a newline, the others to a letter. Random
    weights spread their tokens over the whole vocabulary (128,256 ids at
    v2-8b), and the byte tokenizer decodes all but the first 256 to
    nothing, so every rollout would be the same empty program and SelfSim
    would see one render per search. Through this one each rollout is a
    distinct program of several lines, without braces, which FakeBackend
    compiles and renders from the program's hash."""

    class SmokeTokenizer(byte_tokenizer):
        def decode(self, token_ids, skip_special_tokens=False):
            return super().decode([
                t if t < 256 or t in self.all_special_ids
                else 10 if t % 16 == 0 else 97 + t % 26
                for t in token_ids], skip_special_tokens)

    return SmokeTokenizer(vocab_size=cfg.text.vocab_size,
                          image_token_id=cfg.image_token_id,
                          bos_token_id=cfg.bos_token_id,
                          eos_token_id=cfg.eos_token_id,
                          pad_token_id=cfg.pad_token_id,
                          model_max_length=2048)


def profile_call(torch, fn, label: str) -> dict:
    """``fn()`` timed plainly, then once more under torch.profiler: device
    busy time is the sum of the device-side events (kernels, copies), set
    against the plain call's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) \
            or getattr(e, "self_cuda_time_total", 0)

    rows = [(e.key, dev_us(e), e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy_ms = sum(r[1] for r in rows) / 1e3
    if busy_ms <= 0:
        raise SystemExit("torch.profiler recorded no device time")
    rows.sort(key=lambda r: -r[1])
    # device time of each hand-written kernel, over all of its functions
    kernel_ms = {name: sum(us for k, us, _ in rows
                           if any(f in k for f in funcs)) / 1e3
                 for name, funcs in KERNEL_FUNCTIONS.items()}
    return {"phase": "profile", "request": label, "wall_ms": wall_ms,
            "device_busy_ms": busy_ms,
            "device_idle_share": max(0.0, 1 - busy_ms / wall_ms),
            "kernel_ms": kernel_ms,
            "top": [{"name": k[:80], "device_ms": us / 1e3, "calls": n}
                    for k, us, n in rows[:10]]}


def main_phase(torch, device, rehearsal: bool, seed: int,
               max_new_tokens: int):
    """Random-weight ``detikzify-v2-8b`` (bf16, full width and depth) drawn
    on the card from ``seed``, driven by ``sample_drive``."""
    from detikzify_torch.config import get_config
    from detikzify_torch.models import convert
    from detikzify_torch.processing import ByteTokenizer, DetikzifyProcessor

    t0 = time.perf_counter()
    cfg = get_config("tiny-test" if rehearsal else "detikzify-v2-8b")
    dtype = torch.float32 if rehearsal else torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(seed)
    params = convert.init_random(cfg, device=device, dtype=dtype,
                                 generator=gen)
    if not rehearsal:
        torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    processor = DetikzifyProcessor(smoke_tokenizer(ByteTokenizer, cfg), cfg)
    counts = sample_drive(torch, device, rehearsal, seed, params, processor,
                          max_new_tokens, phase="main",
                          preset="tiny-test" if rehearsal
                          else "detikzify-v2-8b",
                          stages={"init_weights_s": init_s})
    return counts, params, processor


def sample_drive(torch, device, rehearsal: bool, seed: int, params,
                 processor, max_new_tokens: int, *, phase: str, preset: str,
                 stages: dict, extra: Optional[dict] = None) -> dict:
    """Three ``DetikzifyPipeline.sample()`` requests and one
    ``sample_batch()`` of three figures, the launch counters reset just
    before and read just after; then one profiled ``sample()``. Fails on a
    pool leak, a held slot, a token outside the vocabulary, the banned
    ``<image>`` token, or image tokens that are not finite or of the wrong
    shape."""
    from detikzify_torch.infer import DetikzifyPipeline, TikzDocument
    from detikzify_torch.ops import launch_counts, reset_launch_counts

    def sync():
        if not rehearsal:
            torch.cuda.synchronize()

    cfg = processor.cfg
    dtype = params.dtype
    stages = dict(stages)
    t0 = time.perf_counter()
    pipe = DetikzifyPipeline(params, cfg, processor, metric="fast",
                             num_slots=8, device=device, seed=seed)
    eng = pipe.engine
    sync()
    stages["engine_s"] = time.perf_counter() - t0
    figs = synthetic_figures(3, seed)

    # time spent inside engine.step (decode blocks; each ends in a host
    # fetch of the block's tokens)
    decode = {"s": 0.0}
    step = eng.step

    def timed_step(*a, **kw):
        t = time.perf_counter()
        try:
            return step(*a, **kw)
        finally:
            decode["s"] += time.perf_counter() - t

    eng.step = timed_step
    # every token the engine hands to a rollout on the main path
    seen = []
    accept = eng._accept_token

    def recording_accept(ro, tok):
        seen.append(tok)
        return accept(ro, tok)

    eng._accept_token = recording_accept
    free0 = eng.num_free_pages
    reset_launch_counts()
    if not rehearsal:
        torch.cuda.reset_peak_memory_stats()
    docs = []
    tokens0 = eng.counters["decode_tokens"]
    t_main = time.perf_counter()
    for i, fig in enumerate(figs):
        t0 = time.perf_counter()
        docs.append(pipe.sample(image=fig, max_new_tokens=max_new_tokens))
        sync()
        stages[f"sample_{i}_s"] = time.perf_counter() - t0
        held = eng.prefix_pages_used
        if eng.num_free_pages != free0 - held:
            raise SystemExit(f"pool leak after sample {i}: "
                             f"{eng.num_free_pages} free, expected "
                             f"{free0} - {held}")
    t0 = time.perf_counter()
    docs.extend(pipe.sample_batch(figs, max_new_tokens=max_new_tokens))
    sync()
    stages["sample_batch_s"] = time.perf_counter() - t0
    main_s = time.perf_counter() - t_main
    counts = launch_counts()
    del eng.step, eng._accept_token     # the class's methods again

    if eng.num_free_pages != free0 - eng.prefix_pages_used:
        raise SystemExit("pool leak after sample_batch")
    if len(docs) != 6 or not all(isinstance(d, TikzDocument) for d in docs):
        raise SystemExit("main path returned no documents")
    if eng.num_active or eng.num_free_slots != eng.num_slots:
        raise SystemExit("slots still held after the requests")
    if not rehearsal:
        for name in ("flash_attention", "paged_decode"):
            if counts[name] <= 0:
                raise SystemExit(f"{phase} never launched {name}")
    if not seen or min(seen) < 0 or max(seen) >= cfg.text.vocab_size:
        raise SystemExit("generated ids outside the vocabulary")
    if cfg.image_token_id in seen:
        raise SystemExit("the banned <image> token was generated")
    # finite logits and image tokens of the expected shape on one figure
    emb = eng.encode_image(processor(images=[pipe.load(figs[0])])
                           .pixel_values)
    if (tuple(emb.shape) != (1, cfg.image_seq_len, cfg.text.hidden_size)
            or not bool(torch.isfinite(emb.float()).all())):
        raise SystemExit(f"image tokens {tuple(emb.shape)} not finite "
                         "or of the wrong shape")
    decode_tokens = eng.counters["decode_tokens"] - tokens0
    result = {
        "phase": phase, "preset": preset,
        "dtype": str(dtype).replace("torch.", ""),
        "requests": {"sample": 3, "sample_batch": 1, "figures": 6,
                     "max_new_tokens": max_new_tokens},
        "stages_s": stages, "main_s": main_s,
        "decode_s": decode["s"], "decode_tokens": decode_tokens,
        "decode_tokens_per_s": decode_tokens / max(decode["s"], 1e-9),
        "launches": counts, "engine_counters": dict(eng.counters),
        "pool_pages": int(eng._page_refs.shape[0]),
        "code_chars": [len(d.code) for d in docs], **(extra or {}),
    }
    if not rehearsal:
        result["max_memory_allocated_bytes"] = \
            torch.cuda.max_memory_allocated()
    emit(result)
    if not rehearsal:
        prof = profile_call(torch, lambda: pipe.sample(
            image=figs[0], max_new_tokens=32), "sample(), 32 new tokens")
        emit(dict(prof, model=preset))
    pipe.close()
    return counts


def simulate_phase(torch, device, rehearsal: bool, seed: int, params,
                   processor, max_new_tokens: int, *,
                   phase: str = "simulate", preset: str = "detikzify-v2-8b",
                   expansions: int = SIM_EXPANSIONS,
                   weights: str = "int8 + fused", adapter=None,
                   text: Optional[str] = None,
                   kernels=("flash_attention", "paged_decode", "int8_gemv")
                   ) -> dict:
    """MCTS ``simulate()`` scored by SelfSim, by default on int8 + fused
    weights (those ``load_params(quantize=True)`` loaded, fused):
    ``DetikzifyPipeline`` with its default ``metric="model"`` (EMD for v2,
    cos for v1) runs ``expansions`` expansions with parallelism 8 on one
    synthetic figure, the launch counters reset just before and read just
    after; with ``adapter`` and ``text`` the search is caption-conditioned
    and SelfSim scores against the caption-conditioned features of the
    figure. The smoke tokenizer makes each rollout a distinct program, so
    SelfSim scores batched waves of several renders inside the search.
    Fails unless each of ``kernels`` launched."""
    import math

    from detikzify_torch.infer import DetikzifyPipeline, TikzDocument
    from detikzify_torch.ops import launch_counts, reset_launch_counts
    from detikzify_torch.ops.quant import params_nbytes

    def sync():
        if not rehearsal:
            torch.cuda.synchronize()

    cfg = processor.cfg
    _free(torch, rehearsal)     # earlier phases' engines and page pools
    pipe = DetikzifyPipeline(params, cfg, processor, num_slots=8,
                             device=device, seed=seed, adapter=adapter)
    eng, metric = pipe.engine, pipe.metric
    if cfg.is_v1 and metric.mode != "cos":
        raise SystemExit(f"{phase}: SelfSim resolved to {metric.mode}; v1 "
                         "pins cos")
    fig = synthetic_figures(1, seed + 1)[0]

    # the renders in each SelfSim wave enqueued by the search
    wave_sizes = []
    dispatch = metric.score_against_async

    def counted_dispatch(imgs, ref_image=None, text=None):
        # keeps the ``text`` keyword: a text-conditioned search batches
        # its waves only through a metric that takes it
        wave_sizes.append(len(imgs))
        return dispatch(imgs, ref_image, text=text)

    metric.score_against_async = counted_dispatch
    single = {"n": 0}
    score = metric.score

    def counted_score(*a, **kw):
        single["n"] += 1
        return score(*a, **kw)

    metric.score = counted_score
    free0 = eng.num_free_pages
    tokens0 = eng.counters["decode_tokens"]
    reset_launch_counts()
    if not rehearsal:
        torch.cuda.reset_peak_memory_stats()
    sync()
    t0 = time.perf_counter()
    results = list(pipe.simulate(image=fig, text=text,
                                 expansions=expansions, parallelism=8,
                                 max_new_tokens=max_new_tokens))
    sync()
    wall_s = time.perf_counter() - t0
    counts = launch_counts()
    del metric.score_against_async, metric.score   # the class's methods
    decode_tokens = eng.counters["decode_tokens"] - tokens0

    if len(results) != expansions or not all(
            isinstance(d, TikzDocument) for _, d in results):
        raise SystemExit(f"{phase} yielded {len(results)} results, "
                         f"expected {expansions} (score, document) pairs")
    scores = [float(sc) for sc, _ in results]
    if not all(math.isfinite(sc) for sc in scores):
        raise SystemExit(f"{phase} gave non-finite scores: {scores}")
    scored = sum(wave_sizes) + single["n"]
    if scored <= 0:
        raise SystemExit(f"SelfSim scored no render during {phase}")
    if max(wave_sizes, default=0) < 2:
        raise SystemExit(f"no SelfSim wave scored more than one render "
                         f"during {phase}: waves {wave_sizes}")
    if eng.num_active or eng.num_free_slots != eng.num_slots:
        raise SystemExit(f"slots still held after {phase}")
    if eng.num_free_pages != free0 - eng.prefix_pages_used:
        raise SystemExit(f"pool leak after {phase}")
    if not rehearsal:
        for name in kernels:
            if counts[name] <= 0:
                raise SystemExit(f"{phase} never launched {name}")
    result = {
        "phase": phase, "preset": preset, "weights": weights,
        "metric": f"SelfSim {metric.mode}"
        + (" against caption-conditioned features" if text else ""),
        "expansions": expansions, "parallelism": 8,
        "max_new_tokens": max_new_tokens, "wall_s": wall_s, "rollouts": len(results),
        "rollouts_per_min": len(results) / wall_s * 60,
        "decode_tokens": decode_tokens,
        "decode_tokens_per_s": decode_tokens / wall_s,
        "selfsim_wave_sizes": wave_sizes, "selfsim_scored_renders": scored,
        "distinct_programs": len({d.code for _, d in results}),
        "scores": scores, "launches": counts,
        "weight_bytes": params_nbytes(params),
        "engine_counters": dict(eng.counters),
    }
    if not rehearsal:
        result["max_memory_allocated_bytes"] = \
            torch.cuda.max_memory_allocated()
        # one SelfSim wave of 8 renders against the cached input features,
        # and its two parts: the encoder pass and the pair scores (EMD)
        from detikzify_torch.evaluate.imagesim import score_pairs

        renders = synthetic_figures(8, seed + 2)
        pix = metric._tensor(metric._stack(renders))
        ref = metric.features(fig, text)

        def wall_ms(fn):
            fn()
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t) * 1e3, out

        result["selfsim_wave8_ms"], _ = wall_ms(
            lambda: metric.score_against(renders, fig, text=text))
        result["selfsim_wave8_encoder_ms"], feats = wall_ms(
            lambda: metric.embed(pix))
        result["selfsim_wave8_scores_ms"], _ = wall_ms(
            lambda: score_pairs(feats, ref.expand_as(feats), metric.mode))
        prof = profile_call(torch, lambda: list(pipe.simulate(
            image=fig, text=text, expansions=8, parallelism=8,
            max_new_tokens=32)),
            "simulate(), one wave of 8 expansions, 32 new tokens")
        result["wave_device_idle_share"] = prof["device_idle_share"]
        result["wave_k1_ms"] = prof["kernel_ms"]["flash_attention"]
    emit(result)
    if not rehearsal:
        emit(dict(prof, model=preset))
    pipe.close()
    return counts


def tikzero_phases(torch, device, rehearsal: bool, seed: int, params,
                   processor, max_new_tokens: int) -> dict:
    """The TikZero adapter on the bf16 weights of ``main``: a random adapter
    at the ``tikzero-adapter`` preset's widths and a random caption model at
    Llama-3.2-1B's are written under ``build/`` (``save_adapter``,
    ``save_embedding_model``) and loaded back by ``load_adapter_params``
    (the weight half of ``load_adapter``), bit for bit. Then
    ``tikzero_sample``: ``sample()`` with a figure and a caption and with
    the caption alone, 128 new tokens each, the counters reset just before
    and read just after; the caption-conditioned encoder pass and the
    caption model are timed beside the plain encoder pass. Then
    ``tikzero_simulate`` (``simulate_phase`` with the caption). Returns the
    launch counts of both paths."""
    import dataclasses
    import shutil
    import tempfile

    from detikzify_torch.infer import DetikzifyPipeline, TikzDocument
    from detikzify_torch.models import convert, detikzify
    from detikzify_torch.models import load as mload
    from detikzify_torch.models.embedding import AdapterBundle
    from detikzify_torch.ops import launch_counts, reset_launch_counts
    from detikzify_torch.ops.quant import params_nbytes

    def sync():
        if not rehearsal:
            torch.cuda.synchronize()

    tcfg, ecfg = tikzero_configs(rehearsal)
    cfg = processor.cfg
    if dataclasses.replace(tcfg, adapter=None) != cfg:
        raise SystemExit("tikzero: the preset is not the model of main")
    acfg = tcfg.adapter
    dtype = params.dtype
    preset = "tiny-test" if rehearsal else "tikzero-adapter"
    _free(torch, rehearsal)
    gen = torch.Generator(device=device).manual_seed(seed + 201)
    t0 = time.perf_counter()
    adapter = convert.init_random_adapter(tcfg.vision, acfg, device=device,
                                          dtype=dtype, generator=gen)
    embed = convert.init_random_llama(ecfg, device=device, dtype=dtype,
                                      generator=gen)
    sync()
    init_s = time.perf_counter() - t0
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="tikzero_", dir=build)
    apath, epath = os.path.join(tmp, "adapter"), os.path.join(tmp, "caption")
    try:
        t0 = time.perf_counter()
        nbytes = mload.save_adapter(apath, adapter, acfg)
        nbytes_e = mload.save_embedding_model(epath, embed, ecfg)
        write_s = time.perf_counter() - t0
        if not rehearsal:
            torch.cuda.reset_peak_memory_stats()
            card0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        ladapter, lacfg, lembed, lecfg = mload.load_adapter_params(
            apath, tcfg.vision, epath, acfg=acfg, dtype=dtype, device=device)
        sync()
        load_s = time.perf_counter() - t0
        card = {}
        if not rehearsal:
            card = {"card_peak_above_before_bytes":
                    torch.cuda.max_memory_allocated() - card0}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    diffs = {"adapter": state_diff(torch, ladapter, adapter),
             "caption_model": state_diff(torch, lembed, embed)}
    checkpoint = {
        "adapter_parameters": sum(p.numel() for p in adapter.parameters()),
        "caption_model_parameters": sum(p.numel()
                                        for p in embed.parameters()),
        "adapter_bytes": nbytes, "caption_model_bytes": nbytes_e,
        "gb_written": (nbytes + nbytes_e) / 1e9, "init_s": init_s,
        "write_s": write_s, "load_s": load_s, **card,
        "loaded_vs_written": diffs, "config_round_trip": lecfg == ecfg}
    if lecfg != ecfg or lacfg != acfg or any(
            d["differing_entries"] != 0 for d in diffs.values()):
        emit({"phase": "tikzero_sample", "checkpoint": checkpoint})
        raise SystemExit(f"tikzero: the loaded adapter or caption model "
                         f"differs from what was written: {checkpoint}")
    del adapter, embed
    bundle = AdapterBundle(ladapter, lacfg, lembed, lecfg,
                           processor.tokenizer)
    fig = synthetic_figures(1, seed + 1)[0]
    stages = {}

    # the caption-conditioned encoder pass beside the plain one, and the
    # caption model alone, in turns (host clock around a synchronised call)
    pv = torch.as_tensor(processor(images=[fig]).pixel_values, device=device)
    ai = bundle.adapter_inputs([TIKZERO_CAPTION])

    def plain_pass():
        return detikzify.encode_image(params, cfg, pv)

    def adapter_pass():
        return detikzify.encode_image(params, cfg, pv, adapter=ai)

    def caption_pass():
        return bundle.adapter_inputs([TIKZERO_CAPTION])

    with torch.inference_mode():
        plain_emb, cond_emb = plain_pass(), adapter_pass()
        times = {"encoder_plain": [], "encoder_adapter": [],
                 "caption_model": []}
        for _ in range(1 if rehearsal else 5):
            for name, fn in (("encoder_plain", plain_pass),
                             ("encoder_adapter", adapter_pass),
                             ("caption_model", caption_pass),
                             ("encoder_adapter", adapter_pass),
                             ("encoder_plain", plain_pass)):
                sync()
                t0 = time.perf_counter()
                fn()
                sync()
                times[name].append((time.perf_counter() - t0) * 1e3)
    timing = {f"{k}_ms": statistics.median(v) for k, v in times.items()}
    emb_shape = (1, cfg.image_seq_len, cfg.text.hidden_size)
    if (tuple(cond_emb.shape) != emb_shape
            or not bool(torch.isfinite(cond_emb.float()).all())):
        raise SystemExit("tikzero: caption-conditioned image tokens "
                         f"{tuple(cond_emb.shape)} not finite or of the "
                         "wrong shape")
    moved = float((cond_emb.float() - plain_emb.float()).abs().max())
    if not moved > 0:
        raise SystemExit("tikzero: the caption did not change the image "
                         "tokens")

    pipe = DetikzifyPipeline(params, cfg, processor, metric="fast",
                             num_slots=8, device=device, seed=seed,
                             adapter=bundle)
    eng = pipe.engine
    free0 = eng.num_free_pages
    tokens0 = eng.counters["decode_tokens"]
    reset_launch_counts()
    t_main = time.perf_counter()
    docs = []
    for name, kw in (("image_caption", dict(image=fig)),
                     ("caption", {})):
        t0 = time.perf_counter()
        docs.append(pipe.sample(text=TIKZERO_CAPTION,
                                max_new_tokens=max_new_tokens, **kw))
        sync()
        stages[f"sample_{name}_s"] = time.perf_counter() - t0
    main_s = time.perf_counter() - t_main
    counts = launch_counts()
    decode_tokens = eng.counters["decode_tokens"] - tokens0
    if not all(isinstance(d, TikzDocument) for d in docs):
        raise SystemExit("tikzero_sample returned no documents")
    if eng.num_active or eng.num_free_slots != eng.num_slots:
        raise SystemExit("tikzero_sample: slots still held")
    if eng.num_free_pages != free0 - eng.prefix_pages_used:
        raise SystemExit("tikzero_sample: pool leak")
    if not rehearsal:
        for name in ("flash_attention", "paged_decode"):
            if counts[name] <= 0:
                raise SystemExit(f"tikzero_sample never launched {name}")
    # a caption alone: image tokens of the adapter's blank, conditioned
    g = pipe.generator(text=TIKZERO_CAPTION, max_new_tokens=8)
    try:
        blank = g.image_embeds
        root = len(g.root.token_ids)
    finally:
        g.close()
    if (root != cfg.image_seq_len or tuple(blank.shape) != emb_shape
            or not bool(torch.isfinite(blank.float()).all())):
        raise SystemExit(f"tikzero: a caption alone gave a root of {root} "
                         f"tokens, image tokens {tuple(blank.shape)}")
    result = {
        "phase": "tikzero_sample", "preset": preset,
        "dtype": str(dtype).replace("torch.", ""),
        "adapter": acfg.to_dict(),
        "caption_model": {k: getattr(ecfg, k) for k in (
            "hidden_size", "intermediate_size", "num_hidden_layers",
            "num_attention_heads", "num_key_value_heads", "vocab_size",
            "tie_word_embeddings")},
        "caption_tokens": int(bundle.tokenize(TIKZERO_CAPTION)[1].sum()),
        "checkpoint": checkpoint,
        "requests": {"sample_image_caption": 1, "sample_caption": 1,
                     "max_new_tokens": max_new_tokens},
        "stages_s": stages, "main_s": main_s, **timing,
        "image_tokens_moved_by_caption_max_abs": moved,
        "decode_tokens": decode_tokens, "launches": counts,
        "weight_bytes": {"model": params_nbytes(params),
                         "adapter": params_nbytes(ladapter),
                         "caption_model": params_nbytes(lembed)},
        "code_chars": [len(d.code) for d in docs]}
    if not rehearsal:
        result["max_memory_allocated_bytes"] = \
            torch.cuda.max_memory_allocated()
    emit(result)
    pipe.close()
    del pipe, eng
    _free(torch, rehearsal)
    paths = {"tikzero_sample": counts}
    paths["tikzero_simulate"] = simulate_phase(
        torch, device, rehearsal, seed, params, processor, max_new_tokens,
        phase="tikzero_simulate", preset=preset,
        expansions=TIKZERO_EXPANSIONS, weights=str(dtype).replace(
            "torch.", ""), adapter=bundle, text=TIKZERO_CAPTION,
        kernels=("flash_attention", "paged_decode"))
    del bundle, ladapter, lembed
    _free(torch, rehearsal)
    return paths


def host_rss() -> dict:
    """This process's resident set now (``VmRSS``) and its peak over its
    whole life (``ru_maxrss``), in bytes."""
    import resource

    now = -1
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                now = int(line.split()[1]) * 1024
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    return {"rss_bytes": now, "lifetime_peak_rss_bytes": peak}


def state_diff(torch, a, b) -> dict:
    """Two modules' state dicts compared bit for bit: the tensors and the
    entries that differ, and the largest difference among them."""
    sa, sb = a.state_dict(), b.state_dict()
    if set(sa) != set(sb):
        return {"keys_only_in_first": sorted(set(sa) - set(sb))[:10],
                "keys_only_in_second": sorted(set(sb) - set(sa))[:10],
                "differing_entries": -1}
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    bad, n_bad, worst = [], 0, 0.0
    for k, x in sa.items():
        y = sb[k]
        if x.dtype != y.dtype or x.shape != y.shape:
            bad.append(k)
            n_bad += x.numel()
            continue
        y = y.to(x.device)
        n = int((x.view(ints[x.element_size()])
                 != y.view(ints[y.element_size()])).sum())
        if n:
            bad.append(k)
            n_bad += n
            worst = max(worst, float((x.float() - y.float()).abs().max()))
    return {"tensors": len(sa), "differing_tensors": bad[:10],
            "n_differing_tensors": len(bad), "differing_entries": n_bad,
            "max_abs_diff": worst}


def load_phase(torch, device, rehearsal: bool, params, processor):
    """Checkpoint export and int8 load at full width and depth: the main
    phase's bf16 weights go out through ``save_pretrained`` into a
    directory under ``build/`` and come back through ``load_params(...,
    quantize=True)`` (each projection quantized on the host, only int8 on
    the card). The loaded weights must equal, bit for bit, the same bf16
    weights quantized in place on the card (``quantize_params``): both do
    the same fp32 arithmetic. Returns (launch counts, the loaded weights
    fused)."""
    import dataclasses
    import shutil
    import tempfile

    from detikzify_torch.models import load as mload
    from detikzify_torch.ops import launch_counts, reset_launch_counts
    from detikzify_torch.ops.quant import (fuse_projections, params_nbytes,
                                           quantize_params,
                                           quantize_params_host)

    def sync():
        if not rehearsal:
            torch.cuda.synchronize()

    cfg = processor.cfg
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    need, free = params_nbytes(params), shutil.disk_usage(build).free
    if free < need + (1 << 30):
        raise SystemExit(f"load: {free} bytes free where build/ lives, the "
                         f"export needs {need} and 1 GiB to spare")
    _free(torch, rehearsal)
    tmp = tempfile.mkdtemp(prefix="load_", dir=build)
    reset_launch_counts()
    try:
        sync()
        t0 = time.perf_counter()
        nbytes = mload.save_pretrained(tmp, params, cfg)
        write_s = time.perf_counter() - t0
        rss0 = host_rss()
        if not rehearsal:
            torch.cuda.reset_peak_memory_stats()
            card0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        loaded, lcfg = mload.load_params(tmp, dtype=params.dtype,
                                         quantize=True, device=device)
        sync()
        load_s = time.perf_counter() - t0
        rss1 = host_rss()
        # the host quantization alone, in a call of its own, on the same
        # weights viewed on the host (the file is in the page cache now)
        host = mload.load_weights(tmp, lcfg, dtype=params.dtype,
                                  device="cpu")
        t0 = time.perf_counter()
        quantize_params_host(host, device="cpu")
        quantize_s = time.perf_counter() - t0
        del host
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    counts = launch_counts()
    card = {}
    if not rehearsal:
        card = {"card_bytes_before": card0,
                "card_peak_above_before_bytes":
                    torch.cuda.max_memory_allocated() - card0}
    int8_bytes = params_nbytes(loaded)

    # the reference: the same bf16 weights quantized in place on the card
    t0 = time.perf_counter()
    quantize_params(params)
    sync()
    in_place_s = time.perf_counter() - t0
    diff = state_diff(torch, loaded, params)
    same_cfg = dataclasses.replace(
        lcfg, dtype=cfg.dtype, model_max_length=cfg.model_max_length) == cfg
    result = {
        "phase": "load", "preset": "tiny-test" if rehearsal
        else "detikzify-v2-8b", "weights_written": str(params.dtype)
        .replace("torch.", ""), "bytes_written": nbytes,
        "gb_written": nbytes / 1e9, "write_s": write_s,
        "write_gb_per_s": nbytes / 1e9 / write_s,
        "load_quantized_s": load_s, "host_quantize_alone_s": quantize_s,
        "load_gb_per_s": nbytes / 1e9 / load_s,
        "host_before_load": rss0, "host_after_load": rss1,
        "int8_weight_bytes": int8_bytes, **card,
        "in_place_quantize_s": in_place_s, "config_round_trip": same_cfg,
        "loaded_vs_in_place_quantized": diff,
        "rule": "loaded int8 weights equal in-place quantize_params of the "
                "same bf16 weights, bit for bit (q, scale and the rest)",
        "launches": counts}
    emit(result)
    if not same_cfg:
        raise SystemExit(f"load: config.json gave {lcfg}, expected {cfg}")
    if diff["differing_entries"] != 0:
        raise SystemExit(f"load: the loaded int8 weights differ from the "
                         f"in-place quantized ones: {diff}")
    fuse_projections(loaded)
    _free(torch, rehearsal)
    return counts, loaded


def write_v1_checkpoint(torch, params, cfg, path: str, tower: str) -> int:
    """Write ``params`` as a v1 checkpoint in the reference's names: the
    LLaMA ``model.*`` keys, ``lm_head`` and the biased ``mm_projector``
    with a flat ``config.json`` in ``path``; the vision tower in timm's
    names (q/k/v packed into ``attn.qkv``, the MAP head as ``attn_pool``
    with k/v packed into ``kv``) with a ``preprocessor_config.json`` in
    ``tower``. Returns the bytes of the two safetensors files."""
    from detikzify_torch.models.safetensors_io import save_file

    t, v = params.text, params.vision
    state = {"model.embed_tokens.weight": t.embed_tokens,
             "model.norm.weight": t.norm.scale,
             "lm_head.weight": t.lm_head.weight,
             "model.mm_projector.weight": params.connector.proj.weight,
             "model.mm_projector.bias": params.connector.proj.bias}
    for i, lp in enumerate(t.layers):
        b = f"model.layers.{i}"
        state[f"{b}.input_layernorm.weight"] = lp.input_ln.scale
        state[f"{b}.post_attention_layernorm.weight"] = lp.post_ln.scale
        for ours in "qkvo":
            state[f"{b}.self_attn.{ours}_proj.weight"] = \
                getattr(lp.attn, ours).weight
        for ours in ("gate", "up", "down"):
            state[f"{b}.mlp.{ours}_proj.weight"] = \
                getattr(lp.mlp, ours).weight

    vc = cfg.vision
    emb = v.embeddings
    vstate = {"patch_embed.proj.weight": emb.patch.weight.reshape(
                  vc.hidden_size, vc.num_channels, vc.patch_size,
                  vc.patch_size),
              "patch_embed.proj.bias": emb.patch.bias,
              "pos_embed": emb.position[None],
              "norm.weight": v.post_ln.scale, "norm.bias": v.post_ln.bias}

    def put(name, lin):
        vstate[f"{name}.weight"], vstate[f"{name}.bias"] = lin.weight, \
            lin.bias

    def packed(name, lins):
        vstate[f"{name}.weight"] = torch.cat([x.weight for x in lins])
        vstate[f"{name}.bias"] = torch.cat([x.bias for x in lins])

    for i, lp in enumerate(v.layers):
        b = f"blocks.{i}"
        for ours, theirs in (("ln1", "norm1"), ("ln2", "norm2")):
            norm = getattr(lp, ours)
            vstate[f"{b}.{theirs}.weight"] = norm.scale
            vstate[f"{b}.{theirs}.bias"] = norm.bias
        packed(f"{b}.attn.qkv", (lp.attn.q, lp.attn.k, lp.attn.v))
        put(f"{b}.attn.proj", lp.attn.o)
        put(f"{b}.mlp.fc1", lp.mlp.fc1)
        put(f"{b}.mlp.fc2", lp.mlp.fc2)
    h = v.head
    vstate["attn_pool.latent"] = h.probe
    put("attn_pool.q", h.attn.q)
    packed("attn_pool.kv", (h.attn.k, h.attn.v))
    put("attn_pool.proj", h.attn.o)
    vstate["attn_pool.norm.weight"] = h.ln.scale
    vstate["attn_pool.norm.bias"] = h.ln.bias
    put("attn_pool.mlp.fc1", h.mlp.fc1)
    put("attn_pool.mlp.fc2", h.mlp.fc2)

    os.makedirs(path, exist_ok=True)
    os.makedirs(tower, exist_ok=True)
    nbytes = save_file(state, os.path.join(path, "model.safetensors"))
    nbytes += save_file(vstate, os.path.join(tower, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(v1_hf_config(cfg, cfg.feature_layer), f, indent=2)
    with open(os.path.join(tower, "preprocessor_config.json"), "w") as f:
        json.dump({"image_mean": [0.5] * 3, "image_std": [0.5] * 3}, f)
    return nbytes


def v1_phases(torch, device, rehearsal: bool, seed: int,
              max_new_tokens: int) -> dict:
    """The v1 family at full width and depth (``detikzify-tl-1.1b``, the
    tower tapped at its second-to-last layer): random weights drawn on the
    card from ``seed`` are written as a v1 checkpoint and its timm tower
    (``write_v1_checkpoint``) and loaded back through ``load_params(...,
    vision_tower=...)`` (in the rehearsal, whose tiny tower config.json
    cannot describe, through ``load_weights`` with the tiny config), bit
    for bit equal to what was written. Then ``v1_sample``: ``sample_drive``
    on the bf16 weights; and ``v1_simulate``: the same checkpoint loaded
    with ``quantize=True`` and fused, ``simulate()`` with SelfSim (cos, as
    v1 pins it). Returns the launch counts of both paths."""
    import dataclasses
    import shutil
    import tempfile

    from detikzify_torch.models import convert
    from detikzify_torch.models import load as mload
    from detikzify_torch.ops.quant import fuse_projections
    from detikzify_torch.processing import ByteTokenizer, DetikzifyProcessor

    def sync():
        if not rehearsal:
            torch.cuda.synchronize()

    cfg = v1_config(rehearsal)
    preset = "tiny-test (v1)" if rehearsal else "detikzify-tl-1.1b"
    dtype = torch.float32 if rehearsal else torch.bfloat16
    src = convert.init_random(cfg, device=device, dtype=dtype,
                              generator=torch.Generator(device=device)
                              .manual_seed(seed + 101))
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="v1_", dir=build)
    ckpt, tower = os.path.join(tmp, "ckpt"), os.path.join(tmp, "tower")

    def load_v1(quantize: bool):
        kw = dict(dtype=dtype, vision_tower=tower, quantize=quantize,
                  device=device)
        if rehearsal:
            return mload.load_weights(ckpt, cfg, **kw)
        params, lcfg = mload.load_params(ckpt, **kw)
        if dataclasses.replace(lcfg, model_max_length=cfg.model_max_length,
                               dtype=cfg.dtype) != cfg:
            raise SystemExit(f"v1 config.json gave {lcfg}, expected {cfg}")
        return params

    try:
        sync()
        t0 = time.perf_counter()
        nbytes = write_v1_checkpoint(torch, src, cfg, ckpt, tower)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        params = load_v1(False)
        sync()
        load_s = time.perf_counter() - t0
        diff = state_diff(torch, params, src)
        if diff["differing_entries"] != 0:
            raise SystemExit(f"v1: the loaded weights differ from those "
                             f"written: {diff}")
        del src
        t0 = time.perf_counter()
        qparams = fuse_projections(load_v1(True))
        sync()
        load_q_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    processor = DetikzifyProcessor(smoke_tokenizer(ByteTokenizer, cfg), cfg)
    paths = {"v1_sample": sample_drive(
        torch, device, rehearsal, seed, params, processor, max_new_tokens,
        phase="v1_sample", preset=preset,
        stages={"write_checkpoint_s": write_s, "load_s": load_s,
                "load_quantized_fused_s": load_q_s},
        extra={"feature_layer": cfg.feature_layer,
               "image_tokens": cfg.image_seq_len,
               "checkpoint_bytes": nbytes,
               "loaded_vs_written": diff})}
    del params
    paths["v1_simulate"] = simulate_phase(
        torch, device, rehearsal, seed, qparams, processor, max_new_tokens,
        phase="v1_simulate", preset=preset, expansions=V1_EXPANSIONS)
    del qparams
    _free(torch, rehearsal)
    return paths



def _engine(torch, params, cfg, device, seed, temperature=0.0, **kw):
    """A decode engine of 8 slots over 2048 rows, greedy by default."""
    from detikzify_torch.engine import DecodeEngine
    from detikzify_torch.ops.sampling import SamplingParams

    return DecodeEngine(params, cfg, num_slots=8, max_len=2048,
                        sampling=SamplingParams(temperature=temperature),
                        device=device, seed=seed, **kw)


def _free(torch, rehearsal: bool) -> None:
    gc.collect()
    if not rehearsal:
        torch.cuda.empty_cache()


def _greedy_prompts(torch, device, params, processor, seed: int):
    """Eight synthetic figures as the engine's greedy runs see them: their
    root prompts (image tokens) and their projected image tokens."""
    from detikzify_torch.models import detikzify

    figs = synthetic_figures(8, seed + 3)
    out = processor(images=figs)
    with torch.inference_mode():
        emb = detikzify.encode_image(params, processor.cfg, torch.as_tensor(
            out.pixel_values, device=device))
    return [[int(t) for t in row] for row in out.input_ids], emb


def _compare_logits(torch, got, want) -> dict:
    got, want = got.float(), want.float()
    cos = torch.nn.functional.cosine_similarity(got, want, dim=-1)
    return {"max_abs_diff_over_std": float((got - want).abs().max()
                                           / want.std()),
            "min_cosine": float(cos.min()),
            "argmax_agree": f"{int((got.argmax(-1) == want.argmax(-1)).sum())}"
                            f"/{got.numel() // got.shape[-1]}"}


def contiguous_phase(torch, device, rehearsal: bool, seed: int, params,
                     processor, prompts, emb, n_new: int) -> dict:
    """The contiguous-cache model API on bf16 weights: ``detikzify.prefill``
    of eight figure prompts into a ``KVCache`` of 8 slots x 2048 rows, then
    greedy ``detikzify.decode_step`` (K3 over a kv_limit view), held
    against a greedy engine run (page pool, K2) on the same prompts; then
    one ``detikzify.decode_verify_step`` over the last 5 tokens, held
    against the decode steps that produced them."""
    from detikzify_torch.engine import BUCKETS
    from detikzify_torch.models import detikzify, llama
    from detikzify_torch.ops import launch_counts, reset_launch_counts
    from detikzify_torch.ops.sampling import sample

    cfg = processor.cfg
    dev = device
    eng = _engine(torch, params, cfg, device, seed)
    captured = {}
    prefill_paged = detikzify.prefill_paged

    def capture(*a, **kw):      # the engine's first-step logits
        logits, pool = prefill_paged(*a, **kw)
        captured["logits"] = logits.clone()
        return logits, pool

    detikzify.prefill_paged = capture
    try:
        ros = eng.start_many(prompts, image_embeds=emb, max_new_tokens=n_new)
        while not all(ro.finished for ro in ros):
            eng.step()
    finally:
        detikzify.prefill_paged = prefill_paged
    engine_new = [ro.token_ids[ro.prompt_len:] for ro in ros]
    for ro in ros:
        eng.release(ro)
    del eng
    _free(torch, rehearsal)

    b, lens = len(prompts), [len(p) for p in prompts]
    s = 1 << (max(lens) - 1).bit_length()
    ids = torch.zeros((b, s), dtype=torch.int32, device=dev)
    for i, p in enumerate(prompts):
        ids[i, :len(p)] = torch.tensor(p, dtype=torch.int32, device=dev)
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa
    banned, eos = (cfg.image_token_id,), cfg.eos_token_id
    cache = llama.init_cache(cfg.text, b, 2048, dtype=params.dtype,
                             device=dev)
    reset_launch_counts()
    if not rehearsal:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        logits, _ = detikzify.prefill(params, cfg, ids, emb, i32([0] * b),
                                      i32(lens), cache)
        first = _compare_logits(torch, logits, captured["logits"])
        tok = sample(logits, None, temperature=0.0, banned_tokens=banned,
                     suppress_begin_tokens=(eos,),
                     is_first=torch.ones((b,), dtype=torch.bool,
                                         device=dev))
        stream, last = [tok], []
        pos = i32(lens)
        for step in range(n_new - 1):
            need = max(lens) + step + 1
            limit = next((x for x in BUCKETS if need <= x <= 2048), 2048)
            logits, _ = detikzify.decode_step(params, cfg, tok, pos, cache,
                                              kv_limit=limit)
            last = (last + [logits])[-(SPECULATE + 1):]
            tok = sample(logits, None, temperature=0.0,
                         banned_tokens=banned)
            stream.append(tok)
            pos = pos + 1
        # the verify forward over the last K+1 inputs, at their positions
        block = torch.stack(stream[-(SPECULATE + 2):-1], dim=1)
        vlogits, _ = detikzify.decode_verify_step(
            params, cfg, block, pos - (SPECULATE + 1), cache)
    if not rehearsal:
        torch.cuda.synchronize()
    contig_s = time.perf_counter() - t0
    counts = launch_counts()
    verify = _compare_logits(torch, vlogits, torch.stack(last, dim=1))
    contig_new = torch.stack(stream, dim=1).tolist()

    same, total, diverge = 0, 0, []
    for i, (e, c) in enumerate(zip(engine_new, contig_new)):
        e = e[:e.index(eos) + 1] if eos in e else e    # the engine freezes
        n = len(e)
        same += sum(x == y for x, y in zip(e, c[:n]))
        total += n
        diverge.append(next((j for j in range(n) if e[j] != c[j]), None))
    result = {
        "phase": "contiguous", "weights": str(params.dtype).replace(
            "torch.", ""), "slots": b, "cache_rows": 2048,
        "prompt_tokens": lens[0], "new_tokens": n_new,
        "first_step_logits_vs_engine": first,
        "first_step_tolerance": "cosine >= 0.9999 and max|diff| <= "
                                "0.05 std",
        "identical_token_share": same / max(total, 1),
        "first_divergence_per_slot": diverge,
        "verify_vs_decode_logits": verify,
        "verify_tolerance": "cosine >= 0.999",
        "wall_s": contig_s, "tokens_per_s": b * n_new / contig_s,
        "launches": counts}
    emit(result)
    if not (first["min_cosine"] >= 0.9999
            and first["max_abs_diff_over_std"] <= 0.05):
        raise SystemExit("contiguous prefill disagrees with the engine's "
                         f"first step: {first}")
    if tuple(vlogits.shape) != (b, SPECULATE + 1, cfg.text.vocab_size) or \
            not bool(torch.isfinite(vlogits).all()) or \
            verify["min_cosine"] < 0.999:
        raise SystemExit(f"decode_verify_step disagrees with the decode "
                         f"steps: {verify}")
    if not rehearsal:
        for name in ("flash_attention", "decode_contig"):
            if counts[name] <= 0:
                raise SystemExit(f"the contiguous path never launched {name}")
    del cache
    _free(torch, rehearsal)
    return counts


def spec_greedy_phase(torch, device, rehearsal: bool, seed: int, params,
                      processor, prompts, emb, n_new: int) -> dict:
    """Speculative greedy decoding on bf16 weights: a plain greedy engine
    and a speculative one (speculate=4, spec_min_rate=0, K4) on the same
    eight figures. Their streams may part only at a near-tie: at the first
    differing token the plain run's top-1 - top-2 logit gap must be at most
    tau = 2 max|verify - plain| over the positions both runs computed from
    the same tokens. Then one rollout hinted with the plain continuation
    must accept more than 2 tokens a step."""
    from detikzify_torch.models import detikzify
    from detikzify_torch.ops import launch_counts, reset_launch_counts

    cfg = processor.cfg
    reset_launch_counts()
    plain_rows = {}                       # (slot, input position) -> logits
    decode_step_paged = detikzify.decode_step_paged

    def record_plain(params_, cfg_, tokens, positions, *a, **kw):
        logits, pool = decode_step_paged(params_, cfg_, tokens, positions,
                                         *a, **kw)
        for slot, p in enumerate(positions.tolist()):
            plain_rows[(slot, p)] = logits[slot]
        return logits, pool

    def run(eng, **kw):
        ros = eng.start_many(prompts, image_embeds=emb, max_new_tokens=n_new,
                             **kw)
        t0 = time.perf_counter()
        while not all(ro.finished for ro in ros):
            eng.step()
        if not rehearsal:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out = [(ro.slot, list(ro.token_ids), ro.prompt_len) for ro in ros]
        for ro in ros:
            eng.release(ro)
        return out, wall

    detikzify.decode_step_paged = record_plain
    try:
        plain, plain_s = run(_engine(torch, params, cfg, device, seed))
    finally:
        detikzify.decode_step_paged = decode_step_paged
    _free(torch, rehearsal)

    calls = []
    verify = detikzify.decode_verify_step_paged_zerocopy

    def record_verify(params_, cfg_, block, start, *a, dead=None, **kw):
        logits, pool = verify(params_, cfg_, block, start, *a, dead=dead,
                              **kw)
        calls.append((block.tolist(), start.tolist(), dead.tolist(), logits))
        return logits, pool

    eng = _engine(torch, params, cfg, device, seed, speculate=SPECULATE,
                  spec_min_rate=0.0)
    detikzify.decode_verify_step_paged_zerocopy = record_verify
    try:
        spec, spec_s = run(eng)
    finally:
        detikzify.decode_verify_step_paged_zerocopy = verify
    if [x[0] for x in spec] != [x[0] for x in plain]:
        raise SystemExit("the two engines placed the figures on different "
                         "slots")
    spec_counters = dict(eng.counters)
    del eng
    _free(torch, rehearsal)

    # |verify - plain| at every position whose input tokens the two runs
    # share (before the first differing token, and at it)
    diverge, same, total = [], 0, 0
    for (slot, want, plen), (_, got, _) in zip(plain, spec):
        n = min(len(want), len(got))
        same += sum(x == y for x, y in zip(want[plen:n], got[plen:n]))
        total += len(want) - plen
        d = next((j for j in range(plen, n) if want[j] != got[j]), None)
        diverge.append(d)
    diffs, at = [], {}
    for block, starts, dead, logits in calls:
        for (slot, want, plen), d in zip(plain, diverge):
            if dead[slot]:
                continue
            for j in range(SPECULATE + 1):
                p = starts[slot] + j           # input position of column j
                hi = len(want) - 1 if d is None else d - 1
                if p < plen or p > hi or block[slot][:j + 1] != \
                        want[starts[slot]:p + 1]:
                    continue
                row = plain_rows.get((slot, p))
                if row is None:
                    continue
                err = float((logits[slot, j].float() - row.float()).abs()
                            .max())
                diffs.append(err)
                at[(slot, p)] = err
    tau = 2 * max(diffs) if diffs else 0.0
    gaps = []
    for (slot, want, plen), d in zip(plain, diverge):
        if d is None:
            continue
        row = plain_rows.get((slot, d - 1))
        if row is None:                   # the first token: prefill logits
            raise SystemExit(f"slot {slot}: speculative and plain streams "
                             "differ at their first token")
        top = row.float().clone()
        top[cfg.image_token_id] = -float("inf")
        v2 = torch.topk(top, 2).values
        gaps.append({"slot": slot, "token_index": d - plen,
                     "top1_top2_gap": float(v2[0] - v2[1]),
                     "verify_minus_plain_there": at.get((slot, d - 1))})
    plain_rows.clear()
    calls.clear()
    _free(torch, rehearsal)

    # one rollout hinted with the plain greedy continuation of figure 0
    hint = plain[0][1][plain[0][2]:]
    eng = _engine(torch, params, cfg, device, seed, speculate=SPECULATE,
                  spec_min_rate=0.0)
    ro = eng.start(prompts[0], image_embeds=emb[:1], max_new_tokens=n_new,
                   hint=hint)
    while not ro.finished:
        eng.step()
    hinted = {"spec_rate": eng.spec_rate,
              "spec_steps": eng.counters["spec_steps"],
              "same_as_plain": list(ro.token_ids) == plain[0][1],
              "hint_tokens": len(hint),
              "hint_distinct_tokens": len(set(hint))}
    eng.release(ro)
    del eng
    _free(torch, rehearsal)
    counts = launch_counts()
    result = {
        "phase": "spec_greedy", "weights": str(params.dtype).replace(
            "torch.", ""), "slots": len(prompts), "new_tokens": n_new,
        "speculate": SPECULATE, "spec_min_rate": 0.0,
        "identical_token_share": same / max(total, 1),
        "first_divergence_per_slot": [None if d is None else d - p[2]
                                      for d, p in zip(diverge, plain)],
        "matched_positions": len(diffs),
        "max_abs_verify_minus_plain": max(diffs) if diffs else None,
        "tau": tau, "tau_rule": "2 max|verify - plain| over matched "
                                "positions",
        "divergences": gaps,
        "plain_s": plain_s, "spec_s": spec_s,
        "spec_rate": spec_counters["spec_tokens"]
        / max(spec_counters["spec_steps"], 1),
        "spec_counters": {k: v for k, v in spec_counters.items()
                          if k.startswith("spec_") or k.startswith("decode")},
        "hinted": hinted, "launches": counts}
    emit(result)
    for g in gaps:
        if not g["top1_top2_gap"] <= tau:
            raise SystemExit(f"speculative greedy parted from plain greedy "
                             f"at a gap above tau={tau}: {g}")
    if hinted["spec_rate"] <= 2.0:
        raise SystemExit(f"a rollout hinted with its own greedy "
                         f"continuation accepted {hinted['spec_rate']} "
                         "tokens a step, expected more than 2")
    if not rehearsal:
        for name in ("paged_decode", "paged_verify"):
            if counts[name] <= 0:
                raise SystemExit(f"spec_greedy never launched {name}")
    return counts


def simulate_spec_phase(torch, device, rehearsal: bool, seed: int, params,
                        processor, max_new_tokens: int) -> dict:
    """``simulate()`` on a speculative engine (speculate=4) over the int8 +
    fused weights of the simulate phase, the same figure and SelfSim:
    first with every draft class kept on (spec_min_rate=0), then with the
    default gating (1.3). Counters reset just before each and read just
    after."""
    import math

    from detikzify_torch.infer import DetikzifyPipeline, TikzDocument
    from detikzify_torch.ops import launch_counts, reset_launch_counts
    from detikzify_torch.ops.sampling import SamplingParams

    cfg = processor.cfg
    fig = synthetic_figures(1, seed + 1)[0]
    paths = {}
    for path, min_rate in (("simulate_spec", 0.0),
                           ("simulate_spec_gated", 1.3)):
        _free(torch, rehearsal)
        eng = _engine(torch, params, cfg, device, seed,
                      temperature=SamplingParams().temperature,
                      speculate=SPECULATE, spec_min_rate=min_rate)
        pipe = DetikzifyPipeline(params, cfg, processor, engine=eng,
                                 device=device, seed=seed)
        free0 = eng.num_free_pages
        reset_launch_counts()
        if not rehearsal:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = list(pipe.simulate(image=fig, expansions=SIM_EXPANSIONS,
                                     parallelism=8,
                                     max_new_tokens=max_new_tokens))
        if not rehearsal:
            torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = launch_counts()
        c = dict(eng.counters)
        if len(results) != SIM_EXPANSIONS or not all(
                isinstance(d, TikzDocument) and math.isfinite(float(sc))
                for sc, d in results):
            raise SystemExit(f"{path}: simulate yielded {len(results)} "
                             "results or non-finite scores")
        if eng.num_active or eng.num_free_slots != eng.num_slots:
            raise SystemExit(f"{path}: slots still held after simulate")
        if eng.num_free_pages != free0 - eng.prefix_pages_used:
            raise SystemExit(f"{path}: pool leak after simulate")
        if c["spec_steps"] <= 0:
            raise SystemExit(f"{path}: no speculative step ran")
        if not rehearsal:
            for name in ("flash_attention", "paged_verify", "int8_gemv"):
                if counts[name] <= 0:
                    raise SystemExit(f"{path} never launched {name}")
        result = {
            "phase": path, "weights": "int8 + fused",
            "metric": f"SelfSim {pipe.metric.mode}",
            "speculate": SPECULATE, "spec_min_rate": min_rate,
            "expansions": SIM_EXPANSIONS, "parallelism": 8,
            "max_new_tokens": max_new_tokens, "wall_s": wall_s,
            "rollouts": len(results),
            "rollouts_per_min": len(results) / wall_s * 60,
            "decode_tokens": c["decode_tokens"],
            "decode_tokens_per_s": c["decode_tokens"] / wall_s,
            "spec_rate": eng.spec_rate,
            "spec_rate_hinted": c["spec_tokens_hint"]
            / max(c["spec_steps_hint"], 1),
            "spec_counters": {k: v for k, v in c.items()
                              if k.startswith(("spec_", "decode_"))
                              or k == "buf_resyncs"},
            "classes_bailed_out": [k for k, st in eng._spec_cls.items()
                                   if not st["on"]],
            "distinct_programs": len({d.code for _, d in results}),
            "launches": counts}
        if not rehearsal and min_rate == 0.0:
            prof = profile_call(torch, lambda: list(pipe.simulate(
                image=fig, expansions=8, parallelism=8, max_new_tokens=32)),
                "speculative simulate(), one wave of 8 expansions, 32 new "
                "tokens")
            result["wave_device_idle_share"] = prof["device_idle_share"]
            emit(result)
            emit(prof)
        else:
            emit(result)
        paths[path] = counts
        pipe.close()
        del pipe, eng
    _free(torch, rehearsal)
    return paths


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-new-tokens", type=int, default=128)
    ap.add_argument("--iters", type=int, default=30,
                    help="timed launches per kernel measurement")
    ap.add_argument("--skip-main", action="store_true",
                    help="build and hold the kernels only")
    args = ap.parse_args(argv)

    if not (ROOT / "detikzify_torch" / "csrc").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository "
              "(detikzify_torch/ not found beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    rehearsal = args.cpu_rehearsal
    if rehearsal:
        device = torch.device("cpu")
        torch.manual_seed(args.seed)
    else:
        if not torch.cuda.is_available():
            print("chip_smoke.py: torch.cuda.is_available() is false",
                  file=sys.stderr)
            return 1
        device = torch.device("cuda", 0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        smi = nvidia_smi()
        emit({"phase": "device", "nvidia_smi": smi,
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "name": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()})
        from detikzify_torch.ops import build_all

        t0 = time.perf_counter()
        logs = build_all()
        ptxas = {name: [ln.strip() for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln
                        or "entry function" in ln][:64]
                 for name, log in logs.items()}
        emit({"phase": "build", "seconds": time.perf_counter() - t0,
              "ptxas": ptxas})

    rows = kernel_phase(torch, device, rehearsal, args.iters)
    if args.skip_main:      # a kernel-only run prints no result line
        emit({"kernels": rows})
        return 0
    from detikzify_torch.infer import FakeBackend, set_backend

    reference_phase(torch, device, rehearsal, args.seed)
    reference_phase(torch, device, rehearsal, args.seed, v1=True)
    reference_phase(torch, device, rehearsal, args.seed, tikzero=True)
    set_backend(FakeBackend())
    paths = {}
    paths["sample"], params, processor = main_phase(
        torch, device, rehearsal, args.seed, args.max_new_tokens)
    # the phases on bf16 weights run before simulate quantizes them
    prompts, emb = _greedy_prompts(torch, device, params, processor,
                                   args.seed)
    paths["contiguous"] = contiguous_phase(
        torch, device, rehearsal, args.seed, params, processor, prompts, emb,
        min(CONTIG_NEW_TOKENS, args.max_new_tokens))
    paths["spec_greedy"] = spec_greedy_phase(
        torch, device, rehearsal, args.seed, params, processor, prompts, emb,
        args.max_new_tokens)
    del emb
    paths.update(tikzero_phases(torch, device, rehearsal, args.seed, params,
                                processor, args.max_new_tokens))
    # export the bf16 weights and load them back int8: what simulate runs
    paths["load"], qparams = load_phase(torch, device, rehearsal, params,
                                        processor)
    del params
    paths["simulate"] = simulate_phase(
        torch, device, rehearsal, args.seed, qparams, processor,
        args.max_new_tokens,
        preset="tiny-test" if rehearsal else "detikzify-v2-8b")
    paths.update(simulate_spec_phase(torch, device, rehearsal, args.seed,
                                     qparams, processor, args.max_new_tokens))
    del qparams
    _free(torch, rehearsal)
    paths.update(v1_phases(torch, device, rehearsal, args.seed,
                           args.max_new_tokens))
    for row in rows:
        # launches on each path, each counted from 0 just before it ran;
        # "launches" is their sum
        row["launches_by_path"] = {path: counts.get(row["kernel"], 0)
                                   for path, counts in paths.items()}
        row["launches"] = sum(row["launches_by_path"].values())
    emit({"kernels": rows})
    if rehearsal:
        emit({"ok": True, "rehearsal": "cpu"})
        return 0
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
