#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``detikzify_torch``) on one GPU.

    python3 chip_smoke.py            # one CUDA card; exits non-zero without

Phases, each printing one JSON line:

1. device  -- the card's name and power limit as nvidia-smi reports them;
2. build   -- compile every hand-written kernel (one nvcc per source, all
              at once) and time it;
3. kernels -- hold each kernel (K1-K5) against its plain PyTorch version on
              the card, in bf16 (and K1-K4's fp32 kernels in fp32, see
              below), at the main path's shapes (K4: the verify
              window of speculate=4 with a dead slot and one past the table
              edge; K3: a 2048-row cache and a 1024-row kv_limit view; K5:
              every int8 product of the simulate paths at 1, 8, 40 and 64
              rows; K1 also on the four figures of a fused serving
              wave) and at the v1 family's (K1 on the 729-patch tower, its
              MAP head and a 243-token prefill window at head_dim 64; K2 at
              8 query rows per KV head; K5 at TinyLlama's fused products)
              and the TikZero adapter's (K1 as the gated cross-attention
              over a key-masked caption, and as the caption model's causal
              pass with a key mask) and ClipScore's (K1 on the SigLIP text
              tower's 64 positions and the 384-px vision tower's 729
              patches) and training's (K1 on DeepSeek-1.3B's causal pass
              over 4 rows of 640 with a key mask) and post-training's
              (K1 on adapter distillation's tower over 8 figures and its
              cross-attention over 8 key-masked captions, and on GRPO's
              causal log-prob pass over 16 rollouts of 428 tokens) and
              the command line's (K2 over serve_bench's 16 DS-1.3b slots,
              K5 at DS-1.3b's fused products at 16 rows and at v2-8b's
              unfused k/v and gate/up products, which eval's int8 load
              gives, at 8) and the DS-7b phase's (K2 at MHA, 32/32 heads
              of 128; K5 at DeepSeek-7B's fused products at 1 and 8
              rows), and K1-K4's fp32 kernels at ClipScore's fp32 towers
              (K1 on the text tower, the vision tower and its MAP head)
              and at the spec model's head_dim 32 in fp32 and in bf16
              (K1 on its training pass and its prefill window, K2, K4 and
              K3) and at detikzify-ds-1.3b's shapes in fp32, which
              verify_real's fp32 leg gives them (K1 on the tower and the
              prefill window at 16 heads of 128; K2 at its bench decode,
              K4 at its verify window, K3 over a 512-row cache), each
              fp32 one held to 2^-16 of the
              mass with an output rounded through bf16 as a control that
              must fail (and, for K1, the plain version in one TF32 pass),
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
              and ClipScore's two towers at so400m-384's widths, 2 + 2
              layers, in fp32 as the JAX metric builds them (K1's fp32
              kernel), pooled outputs and scores;
5. main    -- random-weight ``detikzify-v2-8b`` at full width and depth in
              bf16: three ``DetikzifyPipeline.sample()`` requests and one
              ``sample_batch()`` of three figures, 128 new tokens each;
6. profile -- one more ``sample()`` request of ``PROFILE_NEW_TOKENS``
              (16) tokens under torch.profiler: the card's busy time and
              idle share;
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
              caption alone (the adapter's blank image),
              ``SIDE_NEW_TOKENS`` (48) new tokens;
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
              the default gating (spec_min_rate 1.3) over 64 expansions of
              256 tokens, long enough that a draft class bails out and the
              leg decodes plain blocks (K2) too;
13b. pipelined -- ``DecodeEngine(pipelined=True)`` against eager stepping,
              greedy, every decode step recorded (so on eager engines), then
              a pipelined speculative run (eager, for the verify/plain step
              ratio) and one profiled block on graphs;
13c. graphs -- each decode block as a CUDA graph (the engine's default on
              a card) against eager dispatch (``graphs=False``) in turns:
              greedy streams and launches equal, plain and speculate=4;
              ms a step, a profiled block, ``sample()`` and ``simulate()``
              of each, pipelined dispatch over graphs, captures, capture
              seconds and pool bytes;
14. serve  -- the HTTP server (``serve.make_server``) on the same int8 +
              fused weights, SelfSim, 8 slots over 2048 rows, driven over
              real HTTP: an idle greedy request (equal to a direct
              ``sample()``), four concurrent requests fused into one wave,
              four requests under a running 16-expansion search (each
              back before its result), two concurrent 8-expansion
              searches (interleaved, one request beside them profiled), a
              token stream, /healthz, /metrics and a malformed request;
              latencies, rollouts/min, engine steps of the idle requests;
15. evaluate -- the evaluation protocol through the port's script,
              ``detikzify_torch.examples.eval``: ``predict`` loads the
              ``load`` phase's exported checkpoint int8 into a
              ``ReplicaPool`` (one replica on the card) and predicts four
              test items (reference programs, their renders, captions) by
              ``generate_until_compilable`` (fast mode, parallelism 8)
              into a ``PredictionCache``; a second ``predict`` takes them
              from the cache; one item in model mode; then ``score``:
              compile rate, token efficiency, sampling throughput,
              SelfSim, KID, CrystalBLEU, EED (native library), DreamSim
              (the dreamsim package's ViT-B/16 ensemble layout, random,
              through its ``.pth`` files and back through
              ``save_ensemble``/``load_ensemble``), ClipScore (a random
              ``google/siglip-so400m-patch14-384`` two-tower written and
              loaded back in fp32, the JAX metric's type), and the
              redacted variants;
15b. verify_real -- ``detikzify_torch.tools.verify_real`` with no flag, in
              two legs: the int8 leg on the load phase's v2-8b export
              (8.47 B parameters, over the runbook's 3 B line:
              ``serve_load`` int8 with a bf16 cache, ``eval_smoke``) and
              the fp32 leg on a ``detikzify-ds-1.3b`` v1 checkpoint and
              timm tower written under ``build/`` (``serve_load`` places
              the fp32 tree with an fp32 cache, then ``spec_acceptance``
              and ``bench`` on it, through K1's, K4's and K2's fp32
              kernels and no K5);
16. replicas -- ``parallel.ReplicaPool`` on the int8 + fused weights, one
              replica (``devices=None``) and two sharing ``cuda:0``:
              ``map_until_compilable`` (fast mode), a greedy
              ``map_sample`` held against one greedy pipeline, K2's
              launches against the replicas' own decode steps; items/s,
              peak memory;
17. trace  -- ``utils.profiling.trace`` around one ``sample()`` of 32
              tokens, its prefill in a span: the trace file holds the
              span and K1's and K2's device functions;
18. infer_cli -- ``detikzify_torch.examples.infer.main`` on the exported
              bf16 checkpoint, two PNG paths on stdin: one-shot with
              ``--output``, then ``--mcts``;
19. serve_bench -- ``detikzify_torch.examples.serve_bench.main`` at its
              DS-1.3b shape (zeros, int8 + fused, 16 slots, decode block
              128), ``SERVE_BENCH_ARGV``'s requests and clients; the
              export directory is deleted before it;
19b. spec_acceptance -- the BPE speculation measurement on the JAX
              package's spec model (4 heads of 32 in fp32: K1's fp32
              kernel, the fp32 K2 and K4), then the plain and verify step
              times (``spec_acceptance_steps``);
19c. ds7b  -- tracked configuration #3, ``detikzify-ds-7b`` int8 +
              fused at full width and depth (random weights from the
              seed): 8 slots of 640 rows, decode block 32, T 0.8 / top-p
              0.95, two runs of 16 streamed rollouts of 128 tokens, each
              consumer holding every token of its rollout, then one
              ``sample()`` through the v1 tower with a token and a text
              streamer; tokens/s, peak memory, one profiled block;
20. v1_sample -- random-weight ``detikzify-tl-1.1b`` at full width and
              depth (the timm SigLIP tower at 384 px tapped at its
              second-to-last layer, TinyLlama) written as a v1 checkpoint
              and timm tower in the reference's names, loaded back by
              ``load_params(..., vision_tower=...)`` bit for bit, and driven
              as ``main`` drives v2-8b;
21. v1_simulate -- the same checkpoint loaded with ``quantize=True`` and
              fused, ``simulate()`` with 8 expansions and SelfSim (cos, as
              v1 pins it);
22. k1_backward -- K1's backward at the training shapes (the decoder's
              causal pass with a key mask, the tower's 900 patches,
              distillation's key-masked cross-attention): the
              gradients through ``flash_attention`` (K1 forward, the plain
              version recomputed) against autograd through the plain
              version, a backward without the causal mask as a control
              that must fail; K1, recompute and SDPA forward/backward
              times;
23. reference (train) -- ``detikzify-ds-1.3b`` at full width, 2 + 2
              layers: loss and every leaf's gradient on the card (bf16,
              K1) against fp32 on the host CPU;
24. train  -- ``detikzify-ds-1.3b`` at full width and depth, random bf16
              weights: 3 steps at grad_accum 1 and 3 at 2, micro 4 x 640,
              remat, 8-bit Adam moments; loss, grad norm, seconds,
              tokens/s, TFLOP/s by 6 N T, peak memory, one step profiled
              (busy and idle share, K1's forward, the backward's
              recompute);
25. trainer -- ``Trainer`` on those weights (AdamW, moments in bf16):
              8 synthetic figures, sketch ratio 0.5, 2 steps, a checkpoint
              under ``build/`` resumed bit for bit by a second trainer
              (GB, save and restore seconds), then deleted;
26. pretrain -- ``pretrain()`` on those weights: only the connector
              moves, ``modality_projector.npz`` is read back by the
              loader's overlay;
27. reference (adapter, grpo) -- at full width, 2 layers: the
              distillation loss and every adapter leaf's gradient
              (``tikzero-adapter``), the GRPO loss and every trainable
              leaf's gradient (``detikzify-ds-1.3b``), card bf16 against
              host fp32;
28. grpo   -- ``refine()`` on the train phase's weights: SelfSim rewards
              over FakeBackend renders, 8 rollouts of 128 tokens for each
              of 2 figures a step, 2 steps, the KL anchor on, 2 updates a
              batch; rollout, reward and update seconds, one update
              profiled; the caller's weights unchanged;
29. adapter_pretrain -- ``pretrain_adapter()`` at ``tikzero-adapter``,
              full width and depth (random tower, adapter and caption
              model): 16 figures, 2 steps of 8, one profiled; only the
              adapter moves;
30. adapter_train -- ``train_adapter_llm()`` (TikZero+) on those weights
              with the decoder cut to 8 of its 32 layers: 2 steps
              caption-conditioned, 2 in image mode; only a copy of the
              decoder trains;
31. the ``kernels`` JSON line (launches on each path above, each counted
   from 0 just before the path ran and read just after, and their sum;
   ``train`` counts the train and trainer phases; a kernel inside a CUDA
   graph counts at each replay), the nvidia-smi line,
   and as the last line ``{"ok": true, "device": {...}}``.

Every decode engine on a card runs its blocks as CUDA graphs unless a
phase says otherwise: the phases that record each decode step's logits
(spec_greedy, pipelined's recorded runs, replicas, the tp phase's
unsharded reference) build theirs eagerly (``eager_engines``), and an
engine over a model axis is eager.

Any failed check raises, so the script exits non-zero and prints no result.
``--cpu-rehearsal`` runs the same phases on the CPU at ``tiny-test`` with
the plain versions (no kernels, no timings of the card); it exists for the
test suite and never prints a device result.
"""
from __future__ import annotations

import argparse
import contextlib
import faulthandler
import gc
import importlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent

PEAK_BF16_FLOPS = 989e12       # H100 SXM dense bf16 tensor-core peak
PEAK_FP32_FLOPS = 67e12        # H100 SXM fp32 (FFMA, outside the tensor cores)
PEAK_TF32_FLOPS = 495e12       # H100 SXM dense TF32 tensor-core peak
TF32X3 = 3                     # TF32 products per fp32 product in 3xTF32
PEAK_BYTES = 3.35e12           # H100 SXM HBM3 bandwidth
BF16_U = 2.0 ** -8             # bf16 unit roundoff
# the fp32 kernels' tolerance, in place of bf16's 2u: the fp32 kernels and
# their plain versions (other summation orders, the kernels' ex2.approx)
# differed by at most 0.06 of it (9.2e-7 of the mass that reaches an
# element) at these shapes on an H100 with FFMA products, and one rounding
# through bf16 (2^-9) or TF32 products (2^-11) is 2^5-2^7 times it. K1's
# fp32 kernel runs 3xTF32 (hi*hi + hi*lo + lo*hi of two TF32 halves,
# ~2^-21 of each product): its two controls, the output rounded through
# bf16 and the plain version with TF32 products, must both fail it
F32_TOL = 2.0 ** -16

# (name, B, S, T, NH, NKV, Hd, mode) for K1 at the main path's shapes
K1_CASES = (
    ("vision", 3, 900, 900, 16, 16, 72, "full"),
    ("map_head", 3, 1, 900, 16, 16, 72, "full"),
    ("prefill_window", 3, 512, 640, 32, 8, 128, "window"),
)
# K1 at the serve path's fused sampling wave: one vision pass over the
# four figures of a wave
K1_SERVE_CASES = (
    ("vision_fused4", 4, 900, 900, 16, 16, 72, "full"),
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
# (the decode kernels' functions are templates over the element type: a
# bf16 one's name holds "<__nv_bfloat16" demangled, "I13__nv_bfloat16"
# mangled, an fp32 one's "<float" or "If")
def _typed(*funcs):
    return {t: tuple(f + m for f in funcs for m in marks)
            for t, marks in (("bf16", ("<__nv_bfloat16", "I13__nv_bfloat16")),
                             ("f32", ("<float", "If")))}


_PAGED = _typed("paged_split_kernel", "paged_merge_kernel")
_CONTIG = _typed("contig_split_kernel", "contig_merge_kernel")
_VERIFY = _typed("verify_split_kernel", "verify_merge_kernel")
KERNEL_FUNCTIONS = {
    "flash_attention": ("flash_fwd_kernel", "flash_split_kernel",
                        "flash_split_merge_kernel"),
    "flash_attention_f32": ("flash_f32_tile_kernel",
                            "flash_f32_split_kernel"),
    "paged_decode": _PAGED["bf16"], "paged_decode_f32": _PAGED["f32"],
    "decode_contig": _CONTIG["bf16"], "decode_contig_f32": _CONTIG["f32"],
    "paged_verify": _VERIFY["bf16"], "paged_verify_f32": _VERIFY["f32"],
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
# K5 at the evaluate phase's unfused int8 products (``examples/eval.py``'s
# ``predict`` loads with quantize=True and does not fuse): k and v (N =
# 1024), gate and up (N = 14336); q has o's shape. 8 rows, the slots
K5_EVAL_CASES = (
    ("unfused_k_v", 4096, 1024, "bf16"),
    ("unfused_gate_up", 4096, 14336, "bf16"),
)
K5_EVAL_ROWS = (8,)
# serve_bench's engine (``detikzify-ds-1.3b``, int8 + fused, 16 slots of
# 640 rows, 6 pages): K2 over 16 slots at 16/16 heads of 128, lengths from
# the 301-token prompt to the 640-row limit; K5 at DeepSeek-1.3B's fused
# products at 16 rows. Its lm_head (N = 32258, not a multiple of 128)
# takes the plain dequant product by the JAX eligibility rule
K2_DS13_CASE = dict(B=16, NH=16, NKV=16, Hd=128, page=128, m=6,
                    lengths=tuple(301 + (640 - 301) * i // 15
                                  for i in range(16)))
K5_DS13_CASES = (
    ("ds13_qkv", 2048, 6144, "bf16"), ("ds13_o", 2048, 2048, "bf16"),
    ("ds13_gateup", 2048, 11008, "bf16"), ("ds13_down", 5504, 2048, "bf16"),
)
K5_DS13_ROWS = (16,)
# the ds7b phase (``detikzify-ds-7b``, bench.py's seven_bench: int8 + fused,
# 8 slots of 640 rows, 301-token prompts, 128 new tokens): K2 at MHA (32
# query heads over 32 KV heads of 128, G = 1) over the 4 pages a 32-step
# block attends, lengths 302-429; K5 at DeepSeek-7B's fused products at 1
# and 8 rows. Its lm_head (N = 32258, not a multiple of 128) takes the
# plain dequant product by the JAX eligibility rule
K2_DS7_CASE = dict(B=8, NH=32, NKV=32, Hd=128, page=128, m=4,
                   lengths=(302, 320, 338, 356, 374, 392, 410, 429))
K5_DS7_CASES = (
    ("ds7_qkv", 4096, 12288, "bf16"), ("ds7_o", 4096, 4096, "bf16"),
    ("ds7_gateup", 4096, 22016, "bf16"), ("ds7_down", 11008, 4096, "bf16"),
)
K5_DS7_ROWS = (1, 8)
# the ds7b phase's engine and traffic (bench.py's seven_bench): 8 slots of
# 640 rows, 32-step decode blocks, T 0.8 / top-p 0.95, rollouts of 128
# tokens, two runs of 2 x 8 rollouts after a warm-up of 8 x 16
DS7_PRESET = "detikzify-ds-7b"
DS7_SLOTS, DS7_MAX_LEN, DS7_BLOCK = 8, 640, 32
DS7_NEW_TOKENS, DS7_WARMUP_TOKENS, DS7_RUNS = 128, 16, 2
# K1 at the TikZero adapter's shapes, (name, B, S, T, NH, NKV, Hd, mode,
# key lengths): the gated cross-attention (900 patch queries over a caption
# padded on the right to 64 tokens, 16/16 heads at Hd 72) and the caption
# model's causal pass with a key mask (Llama-3.2-1B: 32/8 heads at Hd 64)
K1_TIKZERO_CASES = (
    ("cross", 2, 900, 64, 16, 16, 72, "mask", (17, 64)),
    ("caption", 2, 64, 64, 32, 8, 64, "causal_mask", (23, 64)),
)
# the tp phase's shapes: v2-8b over a model axis of 2, each rank's shard.
# K1 on the tower and MAP head at 8 of the 16 heads of 72, the prefill
# window at 16/4 of the 32/8 heads of 128; K2 and K4 at 16/4 heads (the
# GQA group stays 4); K5 at the column-parallel fused qkv (N 3072), gateup
# (N 14336) and lm_head (N 64128) and the row-parallel o (K 2048) and down
# (K 7168), at 8 rows and 40 (the verify forward)
K1_TP_CASES = (
    ("tp2_vision", 3, 900, 900, 8, 8, 72, "full"),
    ("tp2_map_head", 3, 1, 900, 8, 8, 72, "full"),
    ("tp2_prefill_window", 3, 512, 640, 16, 4, 128, "window"),
)
K2_TP_CASE = dict(K2_CASE, NH=16, NKV=4)
K4_TP_CASE = dict(K4_CASE, NH=16, NKV=4)
K5_TP_CASES = (
    ("tp2_qkv", 4096, 3072, "bf16"), ("tp2_o", 2048, 4096, "bf16"),
    ("tp2_gateup", 4096, 14336, "bf16"), ("tp2_down", 7168, 4096, "bf16"),
    ("tp2_lm_head", 4096, 64128, "fp32"),
)
K5_TP_ROWS = (8, 40)
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
# the gated speculative leg: enough slot-steps that a draft class fails two
# 1024-slot-step windows and bails out (random weights accept almost no
# sampled draft), so the leg switches between speculative and plain blocks
# and resyncs the histories (DecodeEngine._update_spec_gating, _resync_buf)
SIM_GATED_EXPANSIONS, SIM_GATED_NEW_TOKENS = 64, 256
GRAPH_NEW_TOKENS = 128  # greedy tokens a figure of the graphs phase
GRAPH_SIM_EXPANSIONS = 8  # its simulate() A/B: one wave of 8
SPECULATE = 4           # draft tokens per verify step (K1 = 5)
CONTIG_NEW_TOKENS = 64  # greedy tokens of the contiguous phase
# K1 at ClipScore's towers (google/siglip-so400m-patch14-384, 16 heads at
# Hd 72): the text tower over 8 captions of 64 positions, no key mask, and
# the vision tower at 384 px (27 x 27 = 729 patches) over 4 renders
K1_EVAL_CASES = (
    ("clip_text", 8, 64, 64, 16, 16, 72, "full"),
    ("clip_vision", 4, 729, 729, 16, 16, 72, "full"),
)
# K1 in float32 at ClipScore's towers as the JAX metric builds them (fp32,
# the evaluate phase's): the text tower, the vision tower and its MAP head
K1_EVAL_F32_CASES = (
    ("clip_text_f32", 8, 64, 64, 16, 16, 72, "full"),
    ("clip_vision_f32", 4, 729, 729, 16, 16, 72, "full"),
    ("clip_map_head_f32", 4, 1, 729, 16, 16, 72, "full"),
)
# the spec_acceptance model (JAX's: 4 heads of 32, fp32, an fp32 page pool
# of 128-row pages, max_len 640, 8 slots, 9-token prompts, 48 new tokens):
# K1 on the overfit's causal pass (8 rows of 128) and on the engine's
# prefill window (one 9-token prompt in a 16-row bucket over 16 + 128
# rows); K2 and K4 over one page of every slot (plain and speculate=4
# steps); K3 over a contiguous 640-row cache (the contiguous API at this
# model). Each also in bf16 at head_dim 32 (a caller's bf16 spec model)
SPEC_PROMPT = 9
K1_SPEC_CASES = (
    ("spec_train", 8, 128, 128, 4, 4, 32, "causal"),
    ("spec_prefill", 1, 16, 144, 4, 4, 32, "window"),
)
# the verify_real phase's fp32 leg serves detikzify-ds-1.3b whole (a v1
# checkpoint with its timm tower, under the 3 B parameters below which the
# JAX runbook serves a checkpoint in fp32 on a card): K1 in float32 at its
# shapes, the so400m tower's 729 patches of one figure (16 heads of 72)
# and the engine's prefill window (the 243-token prompt in a 256-row
# bucket over 384 rows, 16 heads of 128) for one rollout and for a wave of
# 8 (from the third row on restored from a 128-row prefix, as k1_inputs
# builds a window)
DS13_PROMPT = 243
K1_DS13_F32_CASES = (
    ("ds13_vision_f32", 1, 729, 729, 16, 16, 72, "full"),
    ("ds13_prefill_f32", 1, 256, 384, 16, 16, 128, "window"),
    ("ds13_prefill_wave_f32", 8, 256, 384, 16, 16, 128, "window"),
)
# K2 in float32 at that leg's bench decode (8 slots of four 128-row pages,
# max_len 512: the prompt and up to 32 tokens); K4 at its spec_acceptance
# verify window (4 slots, K+1 = 5, starts over the 48 speculated tokens,
# one dead slot); K3, which no fp32 path launches, over a contiguous
# 512-row cache with K2's lengths, whole and through a 256-row view
K2_DS13_F32_CASE = dict(B=8, NH=16, NKV=16, Hd=128, page=128, m=4,
                        lengths=(244, 248, 252, 256, 260, 264, 269, 275))
K4_DS13_F32_CASE = dict(B=4, K1=5, NH=16, NKV=16, Hd=128, page=128, m=4,
                        starts=(243, 262, 286, 0))
K3_DS13_F32_CASE = dict(B=8, L=512, NH=16, NKV=16, Hd=128,
                        lengths=K2_DS13_F32_CASE["lengths"],
                        limits=(None, 256))
K2_SPEC_CASE = dict(B=8, NH=4, NKV=4, Hd=32, page=128, m=1,
                    lengths=(10, 16, 22, 28, 34, 40, 46, 57))
K4_SPEC_CASE = dict(B=8, K1=5, NH=4, NKV=4, Hd=32, page=128, m=1,
                    starts=(9, 15, 21, 27, 33, 39, 45, 52))
K3_SPEC_CASE = dict(B=8, L=640, NH=4, NKV=4, Hd=32,
                    lengths=(70, 130, 190, 250, 310, 370, 430, 640),
                    limits=(None, 320))
# google/siglip-so400m-patch14-384's config.json: both towers share the
# layer geometry; the text tower's vocabulary and positions
SIGLIP_SO400M = dict(hidden_size=1152, intermediate_size=4304,
                     num_hidden_layers=27, num_attention_heads=16,
                     image_size=384, patch_size=14,
                     hidden_act="gelu_pytorch_tanh", layer_norm_eps=1e-6)
SIGLIP_TEXT_VOCAB, SIGLIP_TEXT_POSITIONS = 32000, 64
# the dreamsim package's ensemble towers: ViT-B/16 at 224 px (width,
# MLP, layers, patch, image side) and the CLIP pair's projection width
DREAMSIM_VITB16 = (768, 3072, 12, 16, 224, 512)
EVAL_ITEMS = 4          # test items of the evaluate phase
# the model-mode item searches to this many programs (two waves of 8), not
# to a wall time: a minimum of seconds kept 1 program whenever the host
# was slower during the search than during the fast-mode items
EVAL_MODEL_MODE_PROGRAMS = 16
# the replicas phase: figures searched by map_until_compilable (fast mode)
# and figures of the greedy map_sample held against a single pipeline
# (cut from 6 and 4 to keep the whole run near 1000 s: two replicas on one
# card took twice one's time, PR 13 call 1)
REPLICA_ITEMS, REPLICA_GREEDY = 2, 2
# serve_bench's traffic on the card: its defaults are 48 requests from 16
# clients, which its fused waves' staggered starts (two 128-step blocks a
# member) stretched to 577 s; 4 requests from 4 clients took 101 s of a
# 1123 s run once the pipelined, verify_real, spec_acceptance and mesh
# phases were in, so 2 requests from 2 clients of 80 tokens
SERVE_BENCH_ARGV = ["--requests", "2", "--clients", "2",
                    "--max-new-tokens", "80"]
SERVE_MCTS_EXPANSIONS = 16  # the search that sampling requests run beside
SERVE_PAIR_EXPANSIONS = 8   # each of the two concurrent searches
# the pipelined phase: greedy tokens a slot and the decode block
# (256 tokens until PR 15: 128 keep 8 blocks a run, and the cut holds the
# whole script under its limit with the tp phase in; see SIDE_NEW_TOKENS)
PIPE_NEW_TOKENS, PIPE_BLOCK = 128, 16
# the phases beside the main path generate this many tokens a request, not
# --max-new-tokens (128): tikzero_sample/simulate, serve, evaluate,
# verify_real, replicas, infer_cli and v1_sample/simulate. Their checks
# hold fusion, ordering under a search, caching, parity with one pipeline
# and checkpoints, none of which needs a longer rollout. The whole script
# took 1348 s on an H100 at 700 W with the tp phase in and no cut (PR 15,
# call 2), over its 1200 s limit; these halved rollouts, PIPE_NEW_TOKENS
# and PROFILE_NEW_TOKENS bring it back under. 48 from 64 since the fp32
# K1's 3xTF32 build (34 s against 15) and the fp32 kernel rows took the
# whole script to 1045 s on an H100 at 700 W whose host had run it in
# 1011 s before them
SIDE_NEW_TOKENS = 48
# the profiled requests (one sample(), one simulate() wave): the
# profiler's reading of a 32-token request's events took ~25-45 s of each
# profile (call 2); 16 tokens keep several decode steps in the window
PROFILE_NEW_TOKENS = 16
VERIFY_REAL_ITEMS = 2   # eval_smoke's test items in the verify_real phase
# the verify_real phase: its int8 leg serves the load phase's v2-8b export
# (8.47 B parameters, quantized by the serve rule, no --quantize), its fp32
# leg a detikzify-ds-1.3b export; the fp32 leg's speculated and benched
# tokens a rollout
VERIFY_REAL_FP32_PRESET = "detikzify-ds-1.3b"
VERIFY_REAL_SPEC_TOKENS, VERIFY_REAL_BENCH_TOKENS = 48, 32
# training at bench.py's train_bench shape: detikzify-ds-1.3b full
# fine-tune, bf16 weights, micro-batch 4 at sequence 640 (300 image tokens
# + code), remat, 8-bit Adam moments, grad_accum 1 and 2
TRAIN_PRESET = "detikzify-ds-1.3b"
TRAIN_MICRO, TRAIN_SEQ, TRAIN_ACCUMS, TRAIN_STEPS = 4, 640, (1, 2), 3
TRAIN_LR = 5e-5
# K1 in that step: the decoder's causal pass over 4 rows of 640 with a key
# mask (the rows' code ends at these lengths) at DeepSeek-1.3B's 16/16
# heads of 128, and the tower's 900 patches over the 4 figures
K1_TRAIN_CASES = (
    ("train_decoder", 4, 640, 640, 16, 16, 128, "causal_mask",
     (640, 611, 523, 467)),
)
# post-training: adapter distillation at ``tikzero-adapter`` (the
# tower over 8 figures, teacher and student, and the adapter's
# cross-attention of 900 patches over 8 captions padded to 64 tokens, 16
# heads of 72) and GRPO's log-prob pass at ``detikzify-ds-1.3b`` (16
# rollouts of 300 image tokens + 128, causal, 16/16 heads of 128)
DISTILL_CAPTION_LENGTHS = (64, 58, 51, 47, 40, 33, 26, 17)
K1_POSTTRAIN_CASES = (
    ("distill_tower", 8, 900, 900, 16, 16, 72, "full", None),
    ("distill_cross", 8, 900, 64, 16, 16, 72, "mask",
     DISTILL_CAPTION_LENGTHS),
    ("grpo_logprobs", 16, 428, 428, 16, 16, 128, "causal", None),
)
DISTILL_FIGURES, DISTILL_MICRO = 16, 8  # 2 steps of 8 figures
TIKZERO_PLUS_LAYERS = 8     # adapter_train's decoder: 8 of Llama-3.1-8B's 32
TIKZERO_PLUS_ITEMS, TIKZERO_PLUS_MICRO = 8, 4
TIKZERO_PLUS_LR = 5e-5
GRPO_GENERATIONS, GRPO_NEW_TOKENS, GRPO_PROMPTS, GRPO_STEPS = 8, 128, 2, 2
# the tp phase: greedy figures of its sample_batch leg; the decode and
# verify calls a part whose whole logits rows it keeps for tau; the
# training leg's layers a tower (DS-1.3b at full width; its 24 and 27
# would add ~2 x 20 s of gloo collectives over one card); its first-step
# logits' bound against the unsharded int8 model's; its ranks' time limit
TP_FIGURES, TP_KEEP_CALLS, TP_TRAIN_LAYERS = 8, 16, 8
# the speculative leg's tokens a row (SIDE_NEW_TOKENS' reason: K4 and the
# hinted and unhinted draft classes run from the first verify step)
TP_SPEC_NEW_TOKENS = 64
# the whole script's tp legs (``--tp-only`` keeps --max-new-tokens): a
# decode step over gloo with both ranks on one card took 215-688 ms, so a
# 64-token leg took 14-44 s of the run; 32 tokens still hold every stream
# against the unsharded model and the first-step logits
TP_NEW_TOKENS = 32
TP_LOGITS_MIN_COSINE = 0.999
TP_TIMEOUT_S = 900
K1_BACKWARD_CASES = K1_TRAIN_CASES + (
    ("train_vision", 4, 900, 900, 16, 16, 72, "full", None),
    K1_POSTTRAIN_CASES[1],          # distillation's key-masked cross shape
)
# K1's backward recomputes the plain version, as autograd through the
# plain version does: the two agree to the bf16 resolution of the largest
# gradient of each of dq, dk, dv
K1_GRAD_TOL = 2.0 ** -8
# the training reference: each leaf's gradient on the card within this
# relative L2 error of the fp32 one (a leaf whose fp32 gradient is below
# 1e-3 of the largest leaf's is held against that floor instead)
TRAIN_REF_GRAD_TOL, TRAIN_REF_LOSS_TOL = 5e-2, 1e-2


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
              lengths=None, dtype=None):
    dtype = dtype or torch.bfloat16

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32).to(dtype)

    q, k, v = rnd(b, s, nh, hd), rnd(b, t, nkv, hd), rnd(b, t, nkv, hd)
    kw = {}
    visible_keys = b * s * t
    if mode == "window":
        # fresh prompts and, from the third row on, one restored from a
        # 128-row prefix (q_offsets > 0), as the engine's fused start
        # builds them
        offs = [0 if i != 2 else 128 for i in range(b)]
        lims = [prompt + o for o in offs]
        kw = dict(q_offsets=torch.tensor(offs, dtype=torch.int32,
                                         device=device),
                  kv_limits=torch.tensor(lims, dtype=torch.int32,
                                         device=device))
        visible_keys = sum(min(o + i + 1, lim) for o, lim in zip(offs, lims)
                           for i in range(s))
    elif mode == "causal":
        kw = dict(causal=True)
        visible_keys = b * sum(min(i + (t - s) + 1, t) for i in range(s))
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
    the plain version rounds it), each costing at most u * pv_abs. An fp32
    plain version (fp32 inputs) is held to ``F32_TOL`` in place of 2u."""
    f32 = want.dtype == torch.float32
    err = (got.float() - want.float()).abs()
    bound = (F32_TOL if f32 else 2 * BF16_U) * (pv_abs.float()
                                                + want.float().abs())
    ok = (bool(torch.isfinite(got.float()).all())
          and bool((err <= bound).all()))
    return {"max_abs_err": float(err.max()),
            "tolerance": ("2^-16" if f32 else "2^-7")
            + " * (plain(|v|) + |plain|) elementwise",
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


def bound(nbytes: float, flops: float, peak: float = PEAK_BF16_FLOPS
          ) -> dict:
    """The least time the card needs: bytes over the HBM rate, or the
    operations over ``peak`` (the bf16 tensor-core peak; the fp32 FFMA
    peak for the fp32 kernels), whichever is larger."""
    by_bytes = nbytes / PEAK_BYTES >= flops / peak
    return {"bound_ms": max(nbytes / PEAK_BYTES, flops / peak) * 1e3,
            "bound_by": "bytes" if by_bytes else "operations"}


def f32_control(torch, got, want, pv_abs, what: str) -> float:
    """The fp32 kernels' control: their output rounded through bf16 must
    fail ``F32_TOL``, or the tolerance could not tell an fp32 kernel from
    a bf16 one."""
    return control_check(torch, got.to(torch.bfloat16).float(), want,
                         pv_abs, f"{what} rounded through bf16")


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
            + [(c, K5_V1_ROWS) for c in K5_V1_CASES]
            + [(c, K5_EVAL_ROWS) for c in K5_EVAL_CASES]
            + [(c, K5_DS13_ROWS) for c in K5_DS13_CASES]
            + [(c, K5_DS7_ROWS) for c in K5_DS7_CASES]
            + [(c, K5_TP_ROWS) for c in K5_TP_CASES]):
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


def tf32_round(torch, x):
    """``x`` (fp32) rounded to TF32's 10 mantissa bits, to nearest with
    ties away from zero, as ``cvt.rna.tf32.f32`` rounds it."""
    bits = x.contiguous().view(torch.int32)
    return torch.bitwise_and(bits + 0x1000, -0x2000).view(torch.float32)


def tf32_plain(torch, plain, q, k, v, **kw):
    """The 1xTF32 control: ``plain`` on q, k and v rounded to TF32, with
    the card's fp32 matmuls in TF32 (at S = 1 cuBLAS runs a GEMV in fp32,
    so the rounded operands carry the single pass there too)."""
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return plain(*(tf32_round(torch, x) for x in (q, k, v)), **kw)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


def k1_row(torch, gen, device, rehearsal: bool, timer, case, prompt,
           lengths, dtype) -> dict:
    """K1 (bf16 or float32) against its plain version at one shape; times
    kernel, plain version and SDPA. An fp32 row carries two controls that
    must fail its tolerance (the output rounded through bf16; on the card,
    the plain version with TF32 products) and its bound on the design's
    units beside the FFMA one."""
    from detikzify_torch.ops import attention, flash

    name, b, s, t, nh, nkv, hd, mode = case
    if rehearsal:   # tiny shapes: the CPU only checks the wiring
        s, t = min(s, 9), 12
        lengths = lengths and tuple(min(n, t) for n in lengths)
    q, k, v, kw, vis = k1_inputs(torch, gen, device, b, s, t, nh, nkv, hd,
                                 mode, prompt, lengths, dtype)
    is_f32 = dtype == torch.float32
    if is_f32 and not name.endswith("_f32"):
        name += "_f32"
    elif dtype == torch.bfloat16 and hd == 32:
        name += "_bf16"
    kernel = "flash_attention_f32" if is_f32 else "flash_attention"
    got = flash.flash_attention(q, k, v, **kw)
    want = attention.attend_plain(q, k, v, **kw)
    pv_abs = attention.attend_plain(q, k, v.abs(), **kw)
    tol = tolerance_check(torch, got, want, pv_abs)
    if not tol.pop("ok"):
        raise SystemExit(f"K1 {name}: kernel disagrees with its plain "
                         f"version: {tol}")
    if is_f32:
        tol["bf16_control_max_err_over_tol"] = f32_control(
            torch, got, want, pv_abs, f"K1 {name}")
        if not rehearsal:
            tol["tf32_control_max_err_over_tol"] = control_check(
                torch, tf32_plain(torch, attention.attend_plain, q, k, v,
                                  **kw), want, pv_abs,
                f"K1 {name}: the plain version in one TF32 pass")
    row = {"name": f"flash_attention/{name}", "kernel": kernel,
           "route": "cuda",
           "source": "detikzify_torch/csrc/"
           + ("flash_attn_f32.cu" if is_f32 else "flash_attn.cu"),
           "replaces": "detikzify_tpu/ops/flash.py:187",
           "shape": {"B": b, "S": s, "T": t, "NH": nh, "NKV": nkv, "Hd": hd,
                     "mode": mode, "dtype": str(dtype).replace("torch.", ""),
                     **({"key_lengths": list(lengths)} if lengths else {})},
           **tol}
    nbytes = (q.element_size() * (2 * q.numel() + k.numel() + v.numel())
              + (b * t if lengths else 0))
    flops = 4 * nh * hd * vis
    if not is_f32:
        row.update(bound(nbytes, flops, PEAK_BF16_FLOPS))
    else:
        # the split-key path (S <= 16 over > 256 keys) runs FFMA, the
        # tiles 3xTF32 on the tensor cores
        ffma = bound(nbytes, flops, PEAK_FP32_FLOPS)
        tf32 = bound(nbytes, TF32X3 * flops, PEAK_TF32_FLOPS)
        small = s <= flash.SMALL_S and t > flash.SPLIT_MIN_T_F32
        row.update(ffma if small else tf32)
        row.update(bound_units="FFMA, 67 TFLOP/s" if small
                   else "3xTF32, 3 x 495 TFLOP/s dense",
                   bound_ffma_ms=ffma["bound_ms"],
                   bound_tf32x3_ms=tf32["bound_ms"])
    if timer is not None:
        import torch.nn.functional as F

        row["ms"] = timer(lambda: flash.flash_attention(q, k, v, **kw))
        row["plain_ms"] = timer(lambda: attention.attend_plain(q, k, v, **kw))
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        mask = None
        if mode == "window":
            qpos = (kw["q_offsets"][:, None, None, None]
                    + torch.arange(s, device=device)[None, None, :, None])
            kpos = torch.arange(t, device=device)[None, None, None, :]
            mask = (kpos <= qpos) & (kpos
                                     < kw["kv_limits"][:, None, None, None])
        elif lengths:
            mask = _sdpa_mask(torch, kw, s, t, device)
        row["library_ms"] = timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=mode == "causal",
            enable_gqa=nh != nkv))
    return row


def k1_cases(torch):
    """(case, prompt, key lengths, dtype) of every K1 row."""
    bf16, f32 = torch.bfloat16, torch.float32
    return ([(c, 300, None, bf16) for c in K1_CASES + K1_SERVE_CASES]
            + [(c, V1_PROMPT, None, bf16) for c in K1_V1_CASES]
            + [(c[:8], None, c[8], bf16) for c in K1_TIKZERO_CASES]
            + [(c, None, None, bf16) for c in K1_EVAL_CASES]
            + [(c[:8], None, c[8], bf16) for c in K1_TRAIN_CASES]
            + [(c[:8], None, c[8], bf16) for c in K1_POSTTRAIN_CASES]
            + [(c, 300, None, bf16) for c in K1_TP_CASES]
            + [(c, None, None, f32) for c in K1_EVAL_F32_CASES]
            + [(c, SPEC_PROMPT, None, dt) for dt in (f32, bf16)
               for c in K1_SPEC_CASES]
            + [(c, DS13_PROMPT, None, f32) for c in K1_DS13_F32_CASES])


def f32_decode_cases():
    """(row builder, case, name) of every float32 K2, K4 and K3 row: the
    spec model's shapes and detikzify-ds-1.3b's."""
    return ((k2_row, K2_SPEC_CASE, "paged_decode/spec_f32"),
            (k4_row, K4_SPEC_CASE, "paged_verify/spec_f32"),
            (k3_rows, K3_SPEC_CASE, "decode_contig/spec_f32"),
            (k2_row, K2_DS13_F32_CASE, "paged_decode/ds13_f32"),
            (k4_row, K4_DS13_F32_CASE, "paged_verify/ds13_f32"),
            (k3_rows, K3_DS13_F32_CASE, "decode_contig/ds13_f32"))


def f32_decode_rows(torch, gen, device, rehearsal: bool, timer) -> list:
    """K2, K4 and K3 in float32 (``f32_decode_cases``), then at the spec
    model's shapes in bf16."""
    rows = []
    for fn, case, name in f32_decode_cases():
        got = fn(torch, gen, device, rehearsal, timer, case, name,
                 torch.float32)
        rows.extend(got if isinstance(got, list) else [got])
    bf16 = torch.bfloat16
    rows.append(k2_row(torch, gen, device, rehearsal, timer, K2_SPEC_CASE,
                       "paged_decode/spec_bf16", bf16))
    rows.append(k4_row(torch, gen, device, rehearsal, timer, K4_SPEC_CASE,
                       "paged_verify/spec_bf16", bf16))
    rows.extend(k3_rows(torch, gen, device, rehearsal, timer, K3_SPEC_CASE,
                        "decode_contig/spec_bf16", bf16))
    return rows


def kernel_phase(torch, device, rehearsal: bool, iters: int):
    gen = torch.Generator(device=device).manual_seed(1234)
    timer = None if rehearsal else Timer(torch, device, iters)
    rows = [k1_row(torch, gen, device, rehearsal, timer, *c)
            for c in k1_cases(torch)]
    rows.append(k2_row(torch, gen, device, rehearsal, timer, K2_CASE,
                       "paged_decode"))
    rows.append(k2_row(torch, gen, device, rehearsal, timer, K2_V1_CASE,
                       "paged_decode/v1"))
    rows.append(k2_row(torch, gen, device, rehearsal, timer, K2_DS13_CASE,
                       "paged_decode/ds13_16slots"))
    rows.append(k2_row(torch, gen, device, rehearsal, timer, K2_TP_CASE,
                       "paged_decode/tp2"))
    rows.append(k2_row(torch, gen, device, rehearsal, timer, K2_DS7_CASE,
                       "paged_decode/ds7b"))
    rows.append(k4_row(torch, gen, device, rehearsal, timer))
    rows.append(k4_row(torch, gen, device, rehearsal, timer, K4_TP_CASE,
                       "paged_verify/tp2"))
    rows.extend(k3_rows(torch, gen, device, rehearsal, timer))
    rows.extend(f32_decode_rows(torch, gen, device, rehearsal, timer))
    rows.extend(k5_rows(torch, gen, device, rehearsal, timer))
    return rows


def _sdpa_mask(torch, kw, s, t, device):
    """The boolean mask SDPA takes for K1's key mask / causal inputs."""
    mask = kw["kv_mask"][:, None, None, :]
    if kw.get("causal"):
        mask = mask & torch.ones((s, t), dtype=torch.bool,
                                 device=device).tril(t - s)
    return mask


def k1_backward_phase(torch, device, rehearsal: bool, iters: int) -> dict:
    """K1's backward at the training shapes: the gradients through
    ``flash_attention`` (K1's forward, then the plain version recomputed
    and differentiated) against autograd through ``attend_plain`` on the
    same bf16 inputs, within ``K1_GRAD_TOL`` of each gradient's largest
    value; a backward that drops the causal mask must fail the same check.
    Times K1's forward, the recompute backward, and SDPA's forward and
    backward (autograd) on the same inputs."""
    import torch.nn.functional as F

    from detikzify_torch.ops import attention, flash

    gen = torch.Generator(device=device).manual_seed(4321)
    timer = None if rehearsal else Timer(torch, device, iters)
    rows = []
    for name, b, s, t, nh, nkv, hd, mode, lengths in K1_BACKWARD_CASES:
        if rehearsal:   # key lengths scaled, so the key mask masks keys
            full_t, s, t = t, min(s, 9), 12
            lengths = lengths and tuple(max(1, n * t // full_t)
                                        for n in lengths)
        q, k, v, kw, vis = k1_inputs(torch, gen, device, b, s, t, nh, nkv,
                                     hd, mode, lengths=lengths)
        dout = torch.randn(q.shape, generator=gen, device=device).to(q.dtype)

        def grads(fn, **over):
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]
            out = fn(*leaves, **dict(kw, **over))
            return torch.autograd.grad(out, leaves, dout)

        def over_tol(got, want):
            return max(float((g.float() - w.float()).abs().max())
                       / (K1_GRAD_TOL * float(w.float().abs().max()))
                       for g, w in zip(got, want))

        got = grads(flash.flash_attention)
        want = grads(attention.attend_plain)
        row = {"name": f"flash_attention_backward/{name}",
               "shape": {"B": b, "S": s, "T": t, "NH": nh, "NKV": nkv,
                         "Hd": hd, "mode": mode,
                         **({"key_lengths": list(lengths)} if lengths
                            else {})},
               "tolerance": "|grad - plain grad| <= 2^-8 max|plain grad| "
                            "for each of dq, dk, dv",
               "max_err_over_tol": over_tol(got, want),
               "finite": all(bool(torch.isfinite(g.float()).all())
                             for g in got)}
        if row["max_err_over_tol"] > 1 or not row["finite"]:
            raise SystemExit(f"K1 backward {name}: the gradients disagree "
                             f"with the plain version's: {row}")
        if kw.get("causal"):
            # control: a backward without the causal mask must fail
            mutant = grads(attention.attend_plain, causal=False)
            row["no_causal_mutant_err_over_tol"] = over_tol(mutant, want)
            if row["no_causal_mutant_err_over_tol"] <= 1:
                raise SystemExit(f"K1 backward {name}: the tolerance passes "
                                 "a backward without the causal mask")
        elif "kv_mask" in kw:
            # control: a backward without the key mask must fail
            mutant = grads(attention.attend_plain, kv_mask=None)
            row["no_key_mask_mutant_err_over_tol"] = over_tol(mutant, want)
            if row["no_key_mask_mutant_err_over_tol"] <= 1:
                raise SystemExit(f"K1 backward {name}: the tolerance passes "
                                 "a backward without the key mask")
        if timer is not None:
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]
            out = flash.flash_attention(*leaves, **kw)
            row["forward_ms"] = timer(lambda: flash.flash_attention(
                q, k, v, **kw))
            row["backward_ms"] = timer(lambda: torch.autograd.grad(
                out, leaves, dout, retain_graph=True))
            tl = [x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v)]
            mask = _sdpa_mask(torch, kw, s, t, device) if lengths else None
            sdpa = F.scaled_dot_product_attention(
                *tl, attn_mask=mask, enable_gqa=nh != nkv)
            dt = dout.transpose(1, 2)
            row["sdpa_forward_ms"] = timer(
                lambda: F.scaled_dot_product_attention(
                    *(x.detach() for x in tl), attn_mask=mask,
                    enable_gqa=nh != nkv))
            row["sdpa_backward_ms"] = timer(lambda: torch.autograd.grad(
                sdpa, tl, dt, retain_graph=True))
            del out, sdpa
        rows.append(row)
    result = {"phase": "k1_backward", "rows": rows}
    emit(result)
    return result


def _dtype_tag(torch, dtype) -> tuple:
    """(kernel name suffix, element bytes, operations peak) of a dtype the
    decode kernels take."""
    if dtype == torch.float32:
        return "_f32", 4, PEAK_FP32_FLOPS
    return "", 2, PEAK_BF16_FLOPS


def k2_row(torch, gen, device, rehearsal: bool, timer, case: dict,
           name: str, dtype=None) -> dict:
    """K2, decode over the page pool (bf16, or float32 through its fp32
    entry point), against its plain version; SDPA with a length mask over
    pre-gathered pages is the library yardstick."""
    from detikzify_torch.ops import paged

    dtype = dtype or torch.bfloat16
    suffix, esize, peak = _dtype_tag(torch, dtype)
    c = dict(case)
    if rehearsal:
        c.update(B=2, NH=4, NKV=2, Hd=c["Hd"] if c["Hd"] == 32 else 64,
                 page=16, m=3, lengths=(5, 40))
    b, nh, nkv, hd, page, m = (c[x] for x in ("B", "NH", "NKV", "Hd", "page",
                                              "m"))
    n_pages = b * m + 1
    pool_k = torch.randn((n_pages, page, nkv, hd), generator=gen,
                         device=device).to(dtype)
    pool_v = torch.randn((n_pages, page, nkv, hd), generator=gen,
                         device=device).to(dtype)
    perm = torch.randperm(n_pages, generator=gen, device=device)[:b * m]
    tab = perm.reshape(b, m).to(torch.int32).contiguous()
    lengths = torch.tensor(c["lengths"], dtype=torch.int32, device=device)
    q = torch.randn((b, nh, hd), generator=gen, device=device).to(dtype)
    got = paged.decode_attend_paged(q, pool_k, pool_v, tab, lengths)
    want = paged.decode_attend_paged_plain(q, pool_k, pool_v, tab, lengths)
    pv_abs = paged.decode_attend_paged_plain(q, pool_k, pool_v.abs(), tab,
                                             lengths)
    tol = tolerance_check(torch, got, want, pv_abs)
    if not tol.pop("ok"):
        raise SystemExit(f"K2 {name}: kernel disagrees with its plain "
                         f"version: {tol}")
    if suffix:
        tol["bf16_control_max_err_over_tol"] = f32_control(
            torch, got, want, pv_abs, f"K2 {name}")
    live = sum(c["lengths"])
    nbytes = (live * nkv * hd * 2 + 2 * q.numel()) * esize
    flops = 4 * nh * hd * live
    row = {"name": name, "kernel": "paged_decode" + suffix, "route": "cuda",
           "source": "detikzify_torch/csrc/paged_decode.cu",
           "replaces": "detikzify_tpu/ops/paged.py:194",
           "shape": {"B": b, "NH": nh, "NKV": nkv, "Hd": hd, "page": page,
                     "m": m, "lengths": list(c["lengths"]),
                     "dtype": str(dtype).replace("torch.", "")},
           **tol, **bound(nbytes, flops, peak)}
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


def k4_row(torch, gen, device, rehearsal: bool, timer, case=K4_CASE,
           name: str = "paged_verify", dtype=None) -> dict:
    """K4, the speculative verify window (bf16, or float32 through its
    fp32 entry point), against its plain version at the shapes of
    speculate=4 (``case``; v2-8b's by default); SDPA with a per-row
    boolean mask over pre-gathered pages is the library yardstick."""
    import torch.nn.functional as F

    from detikzify_torch.ops import paged

    dtype = dtype or torch.bfloat16
    suffix, esize, peak = _dtype_tag(torch, dtype)
    c = dict(case)
    if rehearsal:
        c.update(B=3, NH=4, NKV=2, Hd=c["Hd"] if c["Hd"] == 32 else 64,
                 page=64, m=2, starts=(5, 124, 0))
    b, k1, nh, nkv, hd, page, m = (c[x] for x in ("B", "K1", "NH", "NKV",
                                                  "Hd", "page", "m"))
    n_pages = b * m + 1

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

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
        raise SystemExit(f"K4 {name}: kernel disagrees with its plain "
                         f"version: {tol}")
    tol["control_late_limit_max_err_over_tol"] = control_check(
        torch, got, paged.decode_verify_attend_paged_plain(
            q, pool_k, pool_v, tab, starts + 1), pv_abs,
        "K4 with every causal limit one row late")
    if suffix:
        tol["bf16_control_max_err_over_tol"] = f32_control(
            torch, got, want, pv_abs, f"K4 {name}")
    width = m * page
    rows_read = sum(min(s0 + k1, width) for s0 in c["starts"])
    visible = sum(min(s0 + j + 1, width) for s0 in c["starts"]
                  for j in range(k1))
    row = {"name": name, "kernel": "paged_verify" + suffix, "route": "cuda",
           "source": "detikzify_torch/csrc/paged_verify.cu",
           "replaces": "detikzify_tpu/ops/paged.py:363",
           "shape": {"B": b, "K1": k1, "NH": nh, "NKV": nkv, "Hd": hd,
                     "page": page, "m": m, "starts": list(c["starts"]),
                     "dtype": str(dtype).replace("torch.", "")},
           **tol, **bound((rows_read * nkv * hd * 2 + 2 * q.numel()) * esize,
                          4 * nh * hd * visible, peak)}
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


def k3_rows(torch, gen, device, rehearsal: bool, timer, case=K3_CASE,
            name: str = "decode_contig", dtype=None) -> list:
    """K3, decode over a contiguous cache (bf16, or float32 through its
    fp32 entry point), against its plain version: the whole cache, then a
    kv_limit view read in place (v2-8b's 2048 rows and 1024 by default);
    SDPA with a length mask is the library yardstick."""
    import torch.nn.functional as F

    from detikzify_torch.ops import attention

    dtype = dtype or torch.bfloat16
    suffix, esize, peak = _dtype_tag(torch, dtype)
    c = dict(case)
    if rehearsal:
        c.update(B=2, L=96, NH=4, NKV=2, Hd=c["Hd"] if c["Hd"] == 32 else 64,
                 lengths=(70, 96), limits=(None, 80))
    b, length, nh, nkv, hd = (c[x] for x in ("B", "L", "NH", "NKV", "Hd"))

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

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
        if suffix:
            tol["bf16_control_max_err_over_tol"] = f32_control(
                torch, got, want, pv_abs, f"K3 {name}")
        live = int(lens.sum())
        row = {"name": name + ("" if limit is None
                               else f"/kv_limit{limit}"),
               "kernel": "decode_contig" + suffix, "route": "cuda",
               "source": "detikzify_torch/csrc/decode_contig.cu",
               "replaces": "detikzify_tpu/ops/decode_flash.py:183",
               "shape": {"B": b, "L": k.shape[1], "NH": nh, "NKV": nkv,
                         "Hd": hd, "lengths": lens.tolist(),
                         "view_of_rows": length if limit else None,
                         "dtype": str(dtype).replace("torch.", "")},
               **tol, **bound((live * nkv * hd * 2 + 2 * q.numel()) * esize,
                              4 * nh * hd * live, peak)}
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


def v1_config(rehearsal: bool, feature_layer=None,
              preset: str = "detikzify-tl-1.1b"):
    """The v1 model of the v1 phases: ``detikzify-tl-1.1b`` (or another v1
    ``preset``) as its ``config.json`` describes it (the timm so400m tower
    at 384 px, 729 patches, 243 image tokens; TinyLlama's decoder, or the
    preset's), tapped at ``feature_layer`` (the
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
            v1_hf_config(get_config(preset), 0))
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


def smoke_tokenizer(byte_tokenizer, cfg, model_max_length: int = 2048):
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
                          model_max_length=model_max_length)


def device_activity():
    """The profiler activities of the inference windows: the device's
    alone. Their paths open no profiler span (only K1's backward does,
    which ``_profile_step`` reads with the host's events), and reading a
    window's host events took 15-35 s of a whole run on an H100 (one
    sample() of 16 tokens: 22 s; the ds7b block: 35 s, 11 s without
    them, with the same busy time, 217.1 against 216.9 ms)."""
    from torch.profiler import ProfilerActivity

    return [ProfilerActivity.CUDA]


def _device_time(prof, top: int = 10) -> dict:
    """The device side of a torch.profiler run: busy ms (the sum of every
    device event, kernels and copies, whichever thread launched them; not
    the device-side ranges of ``record_function`` spans, which cover
    kernels already counted), each hand-written kernel's ms over all of
    its functions, and the ``top`` device functions."""
    from torch.autograd import DeviceType

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) \
            or getattr(e, "self_cuda_time_total", 0)

    spans = {e.name for e in prof.events()
             if getattr(e, "is_user_annotation", False)}
    rows = [(e.key, dev_us(e), e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and dev_us(e) > 0
            and e.key not in spans]
    rows.sort(key=lambda r: -r[1])
    return {"device_busy_ms": sum(r[1] for r in rows) / 1e3,
            "kernel_ms": {name: sum(us for k, us, _ in rows
                                    if any(f in k for f in funcs)) / 1e3
                          for name, funcs in KERNEL_FUNCTIONS.items()},
            "top": [{"name": k[:80], "device_ms": us / 1e3, "calls": n}
                    for k, us, n in rows[:top]]}


def profile_call(torch, fn, label: str) -> dict:
    """``fn()`` timed plainly, then once more under torch.profiler: device
    busy time against the plain call's wall time. The profiler records the
    device's activity alone (``device_activity``)."""
    from torch.profiler import profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=device_activity()) as prof:
        fn()
        torch.cuda.synchronize()
    dev = _device_time(prof)
    if dev["device_busy_ms"] <= 0:
        raise SystemExit("torch.profiler recorded no device time")
    return {"phase": "profile", "request": label, "wall_ms": wall_ms,
            **dev, "device_idle_share": max(
                0.0, 1 - dev["device_busy_ms"] / wall_ms)}


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
            image=figs[0], max_new_tokens=PROFILE_NEW_TOKENS),
            f"sample(), {PROFILE_NEW_TOKENS} new tokens")
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
            max_new_tokens=PROFILE_NEW_TOKENS)),
            f"simulate(), one wave of 8 expansions, {PROFILE_NEW_TOKENS} "
            "new tokens")
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
    the caption alone, ``max_new_tokens`` each, the counters reset just before
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


def load_phase(torch, device, rehearsal: bool, params, processor,
               export_dir: str):
    """Checkpoint export and int8 load at full width and depth: the main
    phase's bf16 weights go out through ``save_pretrained`` into
    ``export_dir`` (under ``build/``; the caller deletes it once the
    phases that read the checkpoint are done) and come back through
    ``load_params(..., quantize=True)`` (each projection quantized on the
    host, only int8 on the card). The loaded weights must equal, bit for
    bit, the same bf16 weights quantized in place on the card
    (``quantize_params``): both do the same fp32 arithmetic. Returns
    (launch counts, the loaded weights fused)."""
    import dataclasses
    import shutil

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
    reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    nbytes = mload.save_pretrained(export_dir, params, cfg)
    write_s = time.perf_counter() - t0
    rss0 = host_rss()
    if not rehearsal:
        torch.cuda.reset_peak_memory_stats()
        card0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    loaded, lcfg = mload.load_params(export_dir, dtype=params.dtype,
                                     quantize=True, device=device)
    sync()
    load_s = time.perf_counter() - t0
    rss1 = host_rss()
    # the host quantization alone, in a call of its own, on the same
    # weights viewed on the host (the file is in the page cache now)
    host = mload.load_weights(export_dir, lcfg, dtype=params.dtype,
                              device="cpu")
    t0 = time.perf_counter()
    quantize_params_host(host, device="cpu")
    quantize_s = time.perf_counter() - t0
    del host
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


@contextlib.contextmanager
def eager_engines():
    """Decode engines built inside decode eagerly (``graphs=False``). A
    phase that records every decode step by wrapping a model function
    needs Python to run at every step, and a CUDA graph's replay runs none:
    under a graph the wrapper would record the capture alone, once a
    program, and the phase would pass on an empty or stale record."""
    from detikzify_torch.engine import decode as engine_mod

    init = engine_mod.DecodeEngine.__init__

    def eager_init(self, *a, graphs=False, **kw):
        init(self, *a, graphs=graphs, **kw)

    engine_mod.DecodeEngine.__init__ = eager_init
    try:
        yield
    finally:
        engine_mod.DecodeEngine.__init__ = init


def _not_capturing(torch) -> None:
    """A recording wrapper's guard: it raises inside a CUDA graph capture
    (where it would record nothing that replays) instead of passing."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise SystemExit("a recording wrapper ran inside a CUDA graph "
                         "capture; build its engine under eager_engines()")


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
        _not_capturing(torch)
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
        plain, plain_s = run(_engine(torch, params, cfg, device, seed,
                                     graphs=False))
    finally:
        detikzify.decode_step_paged = decode_step_paged
    _free(torch, rehearsal)

    calls = []
    verify = detikzify.decode_verify_step_paged_zerocopy

    def record_verify(params_, cfg_, block, start, *a, dead=None, **kw):
        _not_capturing(torch)
        logits, pool = verify(params_, cfg_, block, start, *a, dead=dead,
                              **kw)
        calls.append((block.tolist(), start.tolist(), dead.tolist(), logits))
        return logits, pool

    eng = _engine(torch, params, cfg, device, seed, speculate=SPECULATE,
                  spec_min_rate=0.0, graphs=False)
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
    default gating (1.3) at ``SIM_GATED_EXPANSIONS`` expansions of
    ``SIM_GATED_NEW_TOKENS`` tokens, long enough for a draft class to bail
    out: the gated leg must then decode plain blocks too (K2). Counters
    reset just before each and read just after."""
    import math

    from detikzify_torch.infer import DetikzifyPipeline, TikzDocument
    from detikzify_torch.ops import launch_counts, reset_launch_counts
    from detikzify_torch.ops.sampling import SamplingParams

    cfg = processor.cfg
    fig = synthetic_figures(1, seed + 1)[0]
    paths = {}
    gated = ((SIM_EXPANSIONS, max_new_tokens) if rehearsal
             else (SIM_GATED_EXPANSIONS, SIM_GATED_NEW_TOKENS))
    for path, min_rate, (expansions, new_tokens) in (
            ("simulate_spec", 0.0, (SIM_EXPANSIONS, max_new_tokens)),
            ("simulate_spec_gated", 1.3, gated)):
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
        results = list(pipe.simulate(image=fig, expansions=expansions,
                                     parallelism=8,
                                     max_new_tokens=new_tokens))
        if not rehearsal:
            torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = launch_counts()
        c = dict(eng.counters)
        if len(results) != expansions or not all(
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
            need = ("flash_attention", "paged_verify", "int8_gemv") + (
                ("paged_decode",) if min_rate > 0 else ())
            for name in need:
                if counts[name] <= 0:
                    raise SystemExit(f"{path} never launched {name}")
        result = {
            "phase": path, "weights": "int8 + fused",
            "metric": f"SelfSim {pipe.metric.mode}",
            "speculate": SPECULATE, "spec_min_rate": min_rate,
            "expansions": expansions, "parallelism": 8,
            "max_new_tokens": new_tokens, "wall_s": wall_s,
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
            "graph_stats": dict(eng.graph_stats),
            "programs": sorted(str(key[:3]) for key in eng._programs),
            "launches": counts}
        if not rehearsal and min_rate == 0.0:
            prof = profile_call(torch, lambda: list(pipe.simulate(
                image=fig, expansions=8, parallelism=8,
                max_new_tokens=PROFILE_NEW_TOKENS)),
                "speculative simulate(), one wave of 8 expansions, "
                f"{PROFILE_NEW_TOKENS} new tokens")
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


def _http(base: str, path: str, payload=None, timeout: float = 600):
    """(status, JSON body) of a GET of ``path``, or of a POST of
    ``payload``; an error status comes back, not raised."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(base + path, data=data, headers={
        "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _sse(base: str, payload: dict, first=None, timeout: float = 600):
    """POST ``payload`` to ``/v1/stream``: (status, [(monotonic time,
    event, data)]). ``first`` (a threading.Event) is set at the first
    ``candidate`` event, and in any case once the stream ends."""
    import http.client
    from urllib.parse import urlparse

    u = urlparse(base)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=timeout)
    events, kind = [], None
    try:
        conn.request("POST", "/v1/stream", body=json.dumps(payload).encode(),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        for raw in resp:
            line = raw.decode().rstrip("\n")
            if line.startswith("event: "):
                kind = line[len("event: "):]
            elif line.startswith("data: "):
                events.append((time.monotonic(), kind,
                               json.loads(line[len("data: "):])))
                if kind == "candidate" and first is not None:
                    first.set()
        return resp.status, events
    finally:
        conn.close()
        if first is not None:
            first.set()


def _png_b64(img) -> str:
    import base64
    import io

    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _stream_result(status: int, events: list, what: str):
    """The ``result`` event of a finished stream, its time, and the
    candidate events' times; raises on anything else."""
    kinds = [k for _, k, _ in events]
    if status != 200 or not kinds or kinds[-1] != "result":
        raise SystemExit(f"serve: {what} stream ended with status {status}, "
                         f"events {kinds[-3:]}: "
                         f"{events[-1][2] if events else None}")
    cand = [t for t, k, _ in events if k == "candidate"]
    return events[-1][2], events[-1][0], cand


def _profile_window(torch, fn):
    """``fn()`` under torch.profiler: (the profile, the window's wall ms).
    The profile is read later (``_window_time``): its events are parsed
    when first read, on this thread, which holds the interpreter lock for
    seconds and would stall a server thread still at work."""
    from torch.profiler import profile

    torch.cuda.synchronize()
    with profile(activities=device_activity()) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return prof, wall_ms


def _window_time(prof, wall_ms: float) -> dict:
    """The card's busy time in a ``_profile_window`` (every thread's
    launches) against the window's wall time."""
    dev = _device_time(prof, top=8)
    if dev["device_busy_ms"] <= 0:
        raise SystemExit("torch.profiler recorded no device time")
    return {"wall_ms": wall_ms, **dev, "device_idle_share": max(
        0.0, 1 - dev["device_busy_ms"] / wall_ms)}


class SchedulerGate:
    """Holds the server's scheduler thread before it takes a sampling wave
    or advances a search, until ``n`` requests armed for (``arm(n)``) have
    been queued. Requests sent together then meet in the scheduler however
    the host schedules the client threads: the fused wave and the two
    interleaved searches are checked on what the scheduler does with
    requests that are all there, not on the clients' timing. Unarmed it
    holds nothing."""

    def __init__(self, inference):
        import threading

        self.cond = threading.Condition()
        self.queued = self.want = 0
        submit = inference.submit

        def counted(job):
            out = submit(job)
            with self.cond:
                self.queued += 1
                self.cond.notify_all()
            return out

        inference.submit = counted
        for name in ("_take_wave", "_advance_mcts"):
            setattr(inference, name, self._held(getattr(inference, name)))

    def arm(self, n: int) -> None:
        with self.cond:
            self.queued, self.want = 0, n

    def _held(self, fn):
        def call(*args, **kw):
            with self.cond:
                if not self.cond.wait_for(
                        lambda: self.queued >= self.want, timeout=600):
                    raise RuntimeError(f"serve: {self.queued} of "
                                       f"{self.want} requests queued")
            return fn(*args, **kw)
        return call


def serve_phase(torch, device, rehearsal: bool, seed: int, params, cfg,
                max_new_tokens: int) -> dict:
    """The HTTP server (``serve.make_server``) on the int8 + fused weights
    of ``simulate``: a ``DetikzifyPipeline`` of 8 slots over 2048 rows with
    SelfSim (EMD), the server on 127.0.0.1 with a 50 ms batching window and
    its defaults otherwise (2 reserved slots, 4 searches at most), driven
    over real HTTP by client threads. Counters reset just before the
    traffic and read once the scheduler thread has joined. Fails unless:
    an idle greedy request returns the code of a direct ``sample()``
    exactly; four concurrent requests fuse into one wave; four requests
    sent after a search's first candidate all return before its result;
    two concurrent searches both yield candidates before either finishes;
    streamed tokens make up the result; /healthz, /metrics and a malformed
    request (400) answer; no request failed; K1, K2 and K5 launched and K3
    and K4 did not."""
    import math
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from detikzify_torch.infer import DetikzifyPipeline
    from detikzify_torch.ops import launch_counts, reset_launch_counts
    from detikzify_torch.processing import ByteTokenizer, DetikzifyProcessor
    from detikzify_torch.serve import make_server

    _free(torch, rehearsal)
    # the server hands a search no max_new_tokens (its rollouts run to the
    # tokenizer's model_max_length, as in the JAX server), so the tokenizer
    # bounds every rollout at max_new_tokens past the image tokens
    processor = DetikzifyProcessor(smoke_tokenizer(
        ByteTokenizer, cfg, cfg.image_seq_len + max_new_tokens), cfg)
    pipe = DetikzifyPipeline(params, cfg, processor, num_slots=8,
                             max_len=2048, device=device, seed=seed)
    eng = pipe.engine
    figs = synthetic_figures(12, seed + 5)
    b64 = [_png_b64(f) for f in figs]
    new = {"max_new_tokens": max_new_tokens}

    def sync():
        if not rehearsal:
            torch.cuda.synchronize()

    # the reference for the idle greedy request, before the counters reset
    t0 = time.perf_counter()
    want = pipe.sample(image=figs[0], temperature=0.0,
                       max_new_tokens=max_new_tokens).code
    sync()
    direct_s = time.perf_counter() - t0
    # engine.step calls and the host time inside them (each ends in a
    # fetch of the block's tokens), read around the idle requests
    steps = {"calls": 0, "s": 0.0}
    step = eng.step

    def counted_step(*a, **kw):
        t = time.perf_counter()
        try:
            return step(*a, **kw)
        finally:
            steps["calls"] += 1
            steps["s"] += time.perf_counter() - t

    def snapshot():
        return (steps["calls"], steps["s"], eng.counters["decode_tokens"],
                eng.counters["decode_dispatches"])

    def since(before):
        now = snapshot()
        return {"step_calls": now[0] - before[0],
                "step_s": now[1] - before[1],
                "decode_tokens": now[2] - before[2],
                "decode_dispatches": now[3] - before[3]}

    eng.step = counted_step
    free0 = eng.num_free_pages
    httpd, inference = make_server(pipe, host="127.0.0.1", port=0,
                                   batch_window_s=0.05)
    gate = SchedulerGate(inference)
    http_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    result = {"phase": "serve", "preset": "tiny-test" if rehearsal
              else "detikzify-v2-8b", "weights": "int8 + fused",
              "metric": f"SelfSim {pipe.metric.mode}", "num_slots": 8,
              "max_len": 2048, "batch_window_s": 0.05,
              "sample_reserve": inference.sample_reserve,
              "max_active_mcts": inference.max_active_mcts,
              "max_new_tokens": max_new_tokens,
              "direct_greedy_sample_s": direct_s}
    reset_launch_counts()
    t_phase = time.perf_counter()
    http_thread.start()
    pool = ThreadPoolExecutor(8)
    try:
        # 1. idle greedy: the code of the direct sample(), exactly
        t0, before = time.perf_counter(), snapshot()
        status, body = _http(base, "/v1/generate", dict(
            new, image=b64[0], temperature=0.0))
        result["idle_greedy_s"] = time.perf_counter() - t0
        result["idle_greedy_engine"] = since(before)
        if status != 200 or body.get("code") != want:
            raise SystemExit(f"serve: idle greedy request gave {status} "
                             f"{str(body)[:200]!r}, the direct sample() "
                             f"{want[:200]!r}")

        # 2. four concurrent image-only requests: one fused wave
        batched0 = inference.requests["batched"]
        barrier = threading.Barrier(4)

        def timed_sample(i, wait=None):
            if wait is not None:
                wait.wait()
            t = time.monotonic()
            status, body = _http(base, "/v1/generate", dict(
                new, image=b64[i], temperature=0.8))
            if status != 200:
                raise SystemExit(f"serve: sampling request {i} gave "
                                 f"{status}: {body}")
            return t, time.monotonic()

        t0, before = time.perf_counter(), snapshot()
        gate.arm(4)
        fused = [f.result() for f in [pool.submit(timed_sample, 1 + i,
                                                  barrier)
                                      for i in range(4)]]
        result["fused_wave_s"] = time.perf_counter() - t0
        result["fused_wave_engine"] = since(before)
        result["fused_latency_s"] = [b - a for a, b in fused]
        if inference.requests["batched"] - batched0 < 4:
            raise SystemExit("serve: four concurrent requests did not fuse "
                             "into one wave (batched "
                             f"{inference.requests['batched'] - batched0})")

        # 3. sampling under a running search
        first = threading.Event()
        t_mcts = time.monotonic()
        search = pool.submit(_sse, base, {
            "image": b64[5], "algorithm": "mcts",
            "expansions": SERVE_MCTS_EXPANSIONS, "timeout": 0}, first)
        first.wait(600)
        under = [f.result() for f in [pool.submit(timed_sample, 6 + i)
                                      for i in range(4)]]
        mcts_body, t_result, cand = _stream_result(*search.result(),
                                                   "the MCTS")
        if len(mcts_body["candidates"]) != SERVE_MCTS_EXPANSIONS:
            raise SystemExit("serve: the search returned "
                             f"{len(mcts_body['candidates'])} candidates")
        lat = sorted(b - a for a, b in under)
        result["under_mcts"] = {
            "latency_s": lat, "p50_s": statistics.median(lat),
            "p95_s": lat[min(len(lat) - 1, round(0.95 * (len(lat) - 1)))],
            "returned_before_search_result": [b < t_result
                                              for _, b in under],
            "mcts_wall_s": t_result - t_mcts,
            "mcts_first_candidate_s": cand[0] - t_mcts,
            "mcts_rollouts_per_min": SERVE_MCTS_EXPANSIONS
            / (t_result - t_mcts) * 60,
            "mcts_scores": [c["score"] for c in mcts_body["candidates"]]}
        if not all(math.isfinite(x) for x in
                   result["under_mcts"]["mcts_scores"]):
            raise SystemExit("serve: the search gave non-finite scores")
        if not rehearsal and not all(
                result["under_mcts"]["returned_before_search_result"]):
            # on the CPU a tiny search can end before the requests arrive
            raise SystemExit("serve: a sampling request sent under the "
                             "search returned after its result: "
                             f"{result['under_mcts']}")

        # 4. two concurrent searches, interleaved; once both have yielded,
        # one sampling request beside them profiled: the card's busy time
        # against the request's wall time
        stalls0 = inference.requests["mcts_stalls"]
        firsts = [threading.Event() for _ in range(2)]
        gate.arm(2)
        pair = [pool.submit(_sse, base, {
            "image": b64[10 + i], "algorithm": "mcts",
            "expansions": SERVE_PAIR_EXPANSIONS, "timeout": 0}, firsts[i])
            for i in range(2)]
        for first in firsts:
            first.wait(600)
        window = None if rehearsal else _profile_window(
            torch, lambda: timed_sample(2))
        (body_a, end_a, cand_a), (body_b, end_b, cand_b) = (
            _stream_result(*f.result(), "a paired MCTS") for f in pair)
        if window is not None:      # read once both searches are done
            result["profile_sample_under_mcts"] = _window_time(*window)
        if not (len(cand_a) == len(cand_b) == SERVE_PAIR_EXPANSIONS
                and cand_a[0] < end_b and cand_b[0] < end_a):
            raise SystemExit("serve: the two searches did not interleave: "
                             f"{len(cand_a)}, {len(cand_b)} candidates")
        result["two_searches"] = {
            "wall_s": max(end_a, end_b) - min(cand_a[0], cand_b[0]),
            "first_candidates_before_other_end": True,
            "mcts_stalls": inference.requests["mcts_stalls"] - stalls0}

        # 5. a streamed sampling request: its tokens make up its result
        status, events = _sse(base, dict(new, image=b64[4],
                                         temperature=0.8))
        body, _, _ = _stream_result(status, events, "the sampling")
        tokens = "".join(d["text"] for _, k, d in events if k == "token")
        if tokens != body["code"] or not tokens:
            raise SystemExit("serve: streamed tokens do not make up the "
                             "result")
        result["stream_token_events"] = sum(k == "token"
                                            for _, k, _ in events)


        # 6. introspection and a malformed request
        status, health = _http(base, "/healthz")
        status_m, metrics = _http(base, "/metrics")
        keys = {"engine", "spec_rate", "num_slots", "num_free_slots",
                "prefix_pages_used", "requests", "queue_depth",
                "active_mcts", "waiting_mcts", "compiling", "latency_s"}
        if (status, status_m) != (200, 200) or set(metrics) != keys \
                or health.get("status") != "ok":
            raise SystemExit(f"serve: /healthz {status}, /metrics "
                             f"{status_m} with keys {sorted(metrics)}")
        status, body = _http(base, "/v1/generate", {"image": "not base64"})
        if status != 400:
            raise SystemExit(f"serve: a malformed request got {status}")
        result["latency_s"] = metrics["latency_s"]
    finally:
        pool.shutdown(wait=True)
        httpd.shutdown()
        inference.stop()
        httpd.server_close()
        http_thread.join(timeout=30)
        del eng.step                    # the class's method again
    sync()
    counts = launch_counts()
    result["t_traffic_s"] = time.perf_counter() - t_phase
    if inference._thread.is_alive() or http_thread.is_alive():
        raise SystemExit("serve: the server's threads did not stop")
    if inference.requests["failed"] != 0:
        raise SystemExit(f"serve: failed requests {inference.requests}")
    if eng.num_active or eng.num_free_slots != eng.num_slots:
        raise SystemExit("serve: slots still held after the traffic")
    if eng.num_free_pages != free0 - eng.prefix_pages_used:
        raise SystemExit("serve: pool leak after the traffic")
    if not rehearsal:
        for name in ("flash_attention", "paged_decode", "int8_gemv"):
            if counts[name] <= 0:
                raise SystemExit(f"serve never launched {name}")
        for name in ("decode_contig", "paged_verify"):
            if counts[name] != 0:
                raise SystemExit(f"serve launched {name}")
    result.update(requests=dict(inference.requests),
                  engine_counters=dict(eng.counters), launches=counts)
    if not rehearsal:
        result["max_memory_allocated_bytes"] = \
            torch.cuda.max_memory_allocated()
    emit(result)
    pipe.close()
    return counts


def siglip_two_tower(rehearsal: bool, layers: Optional[int] = None):
    """ClipScore's two-tower configuration: ``google/siglip-so400m-
    patch14-384``'s published config (``SIGLIP_SO400M``; tiny widths in the
    rehearsal), both towers cut to ``layers`` when given. Returns (vision
    config, text config, vocabulary, positions)."""
    from detikzify_torch.config import VisionConfig

    if rehearsal:
        cfg = VisionConfig(hidden_size=48, intermediate_size=96,
                           num_hidden_layers=2, num_attention_heads=4,
                           image_size=42, patch_size=14)
        vocab, positions = 300, 16
    else:
        cfg = VisionConfig(**SIGLIP_SO400M)
        vocab, positions = SIGLIP_TEXT_VOCAB, SIGLIP_TEXT_POSITIONS
    if layers is not None:
        cfg = cfg.replace(num_hidden_layers=layers)
    return cfg, cfg, vocab, positions


def clip_tokenizer(vocab: int):
    """The smoke tokenizer at the SigLIP text tower's vocabulary (its
    specials below ``vocab``; eos = pad = 1, as SigLIP's tokenizer has)."""
    from types import SimpleNamespace

    from detikzify_torch.processing import ByteTokenizer

    cfg = SimpleNamespace(text=SimpleNamespace(vocab_size=vocab),
                          image_token_id=vocab - 2, bos_token_id=vocab - 1,
                          eos_token_id=1, pad_token_id=1)
    return smoke_tokenizer(ByteTokenizer, cfg)


def random_siglip_towers(torch, device, dtype, rehearsal: bool, seed: int,
                         layers: Optional[int] = None):
    """A random two-tower model (``models.load.SiglipTowers``) drawn on
    ``device`` from ``seed``; logit scale log(10) and bias -10, SigLIP's
    initial values (the scale rounded to float32, as checkpoints keep
    it)."""
    import math

    import numpy as np

    from detikzify_torch.models import convert
    from detikzify_torch.models.load import SiglipTowers

    vcfg, tcfg, vocab, positions = siglip_two_tower(rehearsal, layers)
    gen = torch.Generator(device=device).manual_seed(seed)
    vision = convert.init_random_siglip_vision(vcfg, device=device,
                                               dtype=dtype, generator=gen)
    text = convert.init_random_siglip_text(tcfg, vocab, positions,
                                           device=device, dtype=dtype,
                                           generator=gen)
    return SiglipTowers(vision, text, vcfg, tcfg,
                        float(np.float32(math.log(10.0))), -10.0)


def clip_metric(towers, tokenizer):
    from detikzify_torch.evaluate import ClipScore

    return ClipScore(towers.vision, towers.text, towers.cfg, tokenizer,
                     logit_scale=towers.logit_scale,
                     logit_bias=towers.logit_bias, text_cfg=towers.text_cfg,
                     text_max_len=towers.text.embeddings.position.shape[0])


def clip_reference_phase(torch, device, rehearsal: bool, seed: int) -> None:
    """ClipScore's towers at full width and 2 + 2 layers, in fp32 as the
    JAX metric builds them: both towers' pooled outputs and the scores on
    the card (K1's fp32 kernel) against the same weights on the host CPU
    (the plain versions)."""
    import copy

    import numpy as np

    from detikzify_torch.models import siglip
    from detikzify_torch.models.load import SiglipTowers
    from detikzify_torch.ops import KERNELS
    from detikzify_torch.processing import preprocess_image

    cpu = torch.device("cpu")
    ref = random_siglip_towers(torch, cpu, torch.float32, rehearsal, seed,
                               layers=2)
    dut = SiglipTowers(copy.deepcopy(ref.vision).to(device),
                       copy.deepcopy(ref.text).to(device), *ref[2:])
    figs = synthetic_figures(3, seed + 11)
    captions = [TIKZERO_CAPTION, "a red square", ""]
    tok = clip_tokenizer(ref.text.embeddings.token.shape[0])
    pixels = torch.from_numpy(np.stack([
        preprocess_image(f, ref.cfg.image_size, do_trim=True) for f in figs]))
    f32_launches = KERNELS["flash_attention_f32"].launches
    out = {}
    for name, t in (("cpu", ref), ("dut", dut)):
        metric = clip_metric(t, tok)
        ids = torch.from_numpy(metric._tokenize(captions))
        with torch.inference_mode():
            img = siglip.apply(t.vision, t.cfg, pixels.to(metric.device))
            txt = siglip.apply_text(t.text, t.text_cfg, ids.to(metric.device))
        out[name] = (img["pooler_output"].float().cpu(),
                     txt["pooler_output"].float().cpu(),
                     metric.score_batch(figs, captions))
    f32_launches = KERNELS["flash_attention_f32"].launches - f32_launches
    cos = torch.nn.functional.cosine_similarity
    img_cos = float(cos(out["dut"][0], out["cpu"][0], dim=-1).min())
    txt_cos = float(cos(out["dut"][1], out["cpu"][1], dim=-1).min())
    score_diff = float(np.abs(out["dut"][2] - out["cpu"][2]).max())
    result = {"phase": "reference", "model": "clipscore", "weights": "fp32",
              "layers": {"vision": 2, "text": 2},
              "image_pooled_min_cosine": img_cos,
              "text_pooled_min_cosine": txt_cos,
              "scores": [float(s) for s in out["dut"][2]],
              "scores_max_abs_diff": score_diff,
              "flash_attention_f32_launches": f32_launches,
              "tolerance": "pooled cosine >= 0.9999, scores within 1e-4"}
    emit(result)
    if not (img_cos >= 0.9999 and txt_cos >= 0.9999 and score_diff <= 1e-4
            and np.isfinite(out["dut"][2]).all()):
        raise SystemExit(f"ClipScore towers on the card disagree with the "
                         f"fp32 reference: {result}")
    if not rehearsal and f32_launches <= 0:
        raise SystemExit("ClipScore's fp32 towers never launched K1's fp32 "
                         "kernel")


def eval_testset(n: int, seed: int) -> list:
    """``n`` test items as ``examples/eval.py`` reads them: a reference
    TikZ program of several lines (distinct shapes, positions and labels;
    FakeBackend compiles it), its FakeBackend render as ``image`` and a
    short ``caption``."""
    import numpy as np

    from detikzify_torch.infer import TikzDocument

    rng = np.random.default_rng(seed)
    shapes = ("rectangle", "circle", "ellipse", "grid")
    items = []
    for i in range(n):
        x, y = (int(v) for v in rng.integers(1, 5, 2))
        shape = shapes[i % len(shapes)]
        body = {"rectangle": f"\\draw[thick] (0,0) rectangle ({x},{y});",
                "circle": f"\\draw[blue] ({x},{y}) circle ({1 + i % 2});",
                "ellipse": f"\\fill[red!40] (0,0) ellipse ({x} and {y});",
                "grid": f"\\draw[step=0.5,gray] (0,0) grid ({x},{y});"}[shape]
        code = ("\\documentclass[tikz]{standalone}\n\\begin{document}\n"
                "\\begin{tikzpicture}\n" + body + "\n"
                f"\\draw[->] (0,0) -- ({x + 1},0) node[right] {{$x_{i}$}};\n"
                f"\\node at ({x / 2},{y + 0.5}) {{item {i}}};\n"
                "\\end{tikzpicture}\n\\end{document}")
        image = TikzDocument(code).rasterize()
        if image is None:
            raise SystemExit(f"evaluate: reference program {i} did not "
                             "compile")
        items.append({"code": code, "image": image,
                      "caption": f"a {shape} labelled item {i} with an "
                                 "x axis"})
    return items


def _timm_vit_state(torch, gen, d: int, inter: int, layers: int, patch: int,
                    side: int, norm_pre: bool = False) -> dict:
    """A random ViT in timm naming (the dreamsim package's merged towers,
    as ``tests/test_dreamsim.py::_timm_b16_state`` draws them)."""
    def t(*shape):
        return torch.randn(*shape, generator=gen) * 0.02

    n = (side // patch) ** 2
    sd = {"cls_token": t(1, 1, d), "pos_embed": t(1, n + 1, d),
          "patch_embed.proj.weight": t(d, 3, patch, patch),
          "patch_embed.proj.bias": t(d), "norm.weight": 1 + t(d),
          "norm.bias": t(d)}
    if norm_pre:
        sd["norm_pre.weight"] = 1 + t(d)
        sd["norm_pre.bias"] = t(d)
    for i in range(layers):
        b = f"blocks.{i}"
        sd.update({
            f"{b}.norm1.weight": 1 + t(d), f"{b}.norm1.bias": t(d),
            f"{b}.attn.qkv.weight": t(3 * d, d),
            f"{b}.attn.qkv.bias": t(3 * d),
            f"{b}.attn.proj.weight": t(d, d), f"{b}.attn.proj.bias": t(d),
            f"{b}.norm2.weight": 1 + t(d), f"{b}.norm2.bias": t(d),
            f"{b}.mlp.fc1.weight": t(inter, d),
            f"{b}.mlp.fc1.bias": t(inter),
            f"{b}.mlp.fc2.weight": t(d, inter), f"{b}.mlp.fc2.bias": t(d),
        })
    return sd


def write_dreamsim_branches(torch, path: str, rehearsal: bool,
                            seed: int) -> dict:
    """The ``dreamsim`` package's published ensemble layout, random, as
    ``.pth`` files: ``dino_vitb16`` (a bare timm state dict),
    ``clip_vitb16`` (``{"model", "proj"}``, CLIP's ln_pre kept as
    ``norm_pre``) and ``open_clip_vitb16`` (``proj`` inside the state
    dict); ViT-B/16 at 224 px (12 layers, width 768, MLP 3072) with a
    512-wide projection on the CLIP pair. Returns branch -> path."""
    d, inter, layers, patch, side, proj = (
        (32, 64, 2, 8, 32, 16) if rehearsal
        else DREAMSIM_VITB16)
    gen = torch.Generator().manual_seed(seed)
    paths = {}
    for branch, norm_pre in (("dino_vitb16", False), ("clip_vitb16", True),
                             ("open_clip_vitb16", True)):
        sd = _timm_vit_state(torch, gen, d, inter, layers, patch, side,
                             norm_pre)
        obj = sd
        if branch == "clip_vitb16":
            obj = {"model": sd, "proj": torch.randn(d, proj, generator=gen)
                   * 0.02}
        elif branch == "open_clip_vitb16":
            sd["proj"] = torch.randn(d, proj, generator=gen) * 0.02
        paths[branch] = os.path.join(path,
                                     f"{branch}_pretrain_lora_merged.pth")
        torch.save(obj, paths[branch])
    return paths


def _tree_diff(a: dict, b: dict) -> int:
    """Entries that differ, bit for bit, between two trees of fp32
    tensors; -1 where their keys or shapes differ."""
    import numpy as np

    if a.keys() != b.keys():
        return -1
    n = 0
    for k in a:
        if isinstance(a[k], dict):
            sub = _tree_diff(a[k], b[k])
            if sub < 0:
                return -1
            n += sub
        elif a[k].shape != b[k].shape or a[k].dtype != b[k].dtype:
            return -1
        else:
            n += int((a[k].cpu().numpy().view(np.uint32)
                      != b[k].cpu().numpy().view(np.uint32)).sum())
    return n


@contextlib.contextmanager
def checkpoint_tokenizer(cfg, model_max_length: int):
    """``models.load.load`` with the smoke tokenizer in place of the
    checkpoint's: a checkpoint that ``save_pretrained`` wrote carries no
    tokenizer files, and the card's machine has no ``transformers`` to
    read them. The weights, config and image statistics load as they
    would; ``model_max_length`` bounds each rollout past the prompt."""
    from detikzify_torch.models import load as mload
    from detikzify_torch.processing import ByteTokenizer

    tok = smoke_tokenizer(ByteTokenizer, cfg, model_max_length)
    load_tokenizer = mload.load_tokenizer
    mload.load_tokenizer = lambda path: tok
    try:
        yield tok
    finally:
        mload.load_tokenizer = load_tokenizer


def evaluate_phase(torch, device, rehearsal: bool, seed: int, cfg,
                   export_dir: str, max_new_tokens: int) -> dict:
    """The evaluation protocol through the port's script,
    ``detikzify_torch.examples.eval``: ``predict`` and ``score`` on the
    ``load`` phase's exported v2-8b checkpoint, loaded int8
    (``quantize=True``) into one ``ReplicaPool`` replica on the card, over
    ``EVAL_ITEMS`` test items (reference programs FakeBackend compiles,
    their renders, captions), as ``main`` holds them in memory.

    Predict: ``generate_until_compilable`` in fast mode, parallelism 8,
    into a ``PredictionCache`` under ``build/``; a second ``predict``, on
    the weights the first loaded, takes every item from the cache (no new
    search, no kernel launch); after each pass every engine of the pool
    ``predict`` built must hold no slot and no page beyond its stored
    prefixes (``ReplicaPool`` is wrapped to see them); one item
    again in model mode (SelfSim EMD, ``score_improve`` to
    ``EVAL_MODEL_MODE_PROGRAMS`` programs; its engine held to the same
    slot and page check). Score: CompileSuccessRate,
    MeanTokenEfficiency, MeanSamplingThroughput, SelfSim (cos), KID on the
    model's tower, CrystalBLEU, TexEditDistance (native library), DreamSim
    (three random branches at the ``dreamsim`` package's published layout,
    written as ``.pth`` and loaded by ``from_dreamsim_checkpoint``, then
    saved and loaded back bit for bit), ClipScore (a random two-tower at
    ``google/siglip-so400m-patch14-384``'s widths written as a
    ``SiglipModel`` checkpoint and loaded back bit for bit in bf16), and
    the redacted variants through ``FakeBackend.render_redacted``. The
    launch counters are reset around predict and around score; fails
    unless K1, K2 and K5 launched while predicting and K1 while scoring,
    and unless every metric is finite and in its range."""
    import math
    import shutil
    import tempfile

    from detikzify_torch import native
    from detikzify_torch.evaluate import crystalbleu, harness
    from detikzify_torch.evaluate import dreamsim_vit
    from detikzify_torch.examples import eval as eval_script
    from detikzify_torch.infer import DetikzifyPipeline
    from detikzify_torch.models import load as mload
    from detikzify_torch.ops import launch_counts, reset_launch_counts
    from detikzify_torch.parallel import replicas

    def sync():
        if not rehearsal:
            torch.cuda.synchronize()

    # every pool ``predict`` builds, with each engine's free pages at birth
    pools = []
    pool_cls = replicas.ReplicaPool

    class WatchedPool(pool_cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.free0 = [p.engine.num_free_pages for p in self.pipelines]
            pools.append(self)

    def held_by(new_pools) -> list:
        """Engines of ``new_pools`` still holding slots, or pages beyond
        their stored prefixes."""
        held = []
        for pool in new_pools:
            for p, free0 in zip(pool.pipelines, pool.free0):
                eng = p.engine
                if eng.num_active or eng.num_free_slots != eng.num_slots \
                        or eng.num_free_pages != free0 - eng.prefix_pages_used:
                    held.append({"device": str(eng.device),
                                 "active": eng.num_active,
                                 "free_slots": eng.num_free_slots,
                                 "free_pages": eng.num_free_pages,
                                 "free_pages_at_start": free0,
                                 "prefix_pages": eng.prefix_pages_used})
        return held

    if not native.available():
        raise SystemExit("evaluate: the native library did not build "
                         f"({native.lib_path()})")
    _free(torch, rehearsal)
    testset = eval_testset(EVAL_ITEMS, seed + 13)
    # the script's names, wrapped: its searches counted, its loads timed,
    # its CrystalBLEU's corpus cache under build/
    searches, loads, bleus = [], [], []
    script = {k: getattr(eval_script, k) for k in
              ("generate_until_compilable", "load", "CrystalBLEU")}

    def counted_search(*a, **kw):
        searches.append(1)
        return script["generate_until_compilable"](*a, **kw)

    def timed_load(*a, **kw):
        t = time.perf_counter()
        out = script["load"](*a, **kw)
        sync()
        loads.append(time.perf_counter() - t)
        return out

    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="eval_", dir=build)

    def bleu(refs):
        bleus.append(script["CrystalBLEU"](
            refs, cache_dir=os.path.join(tmp, "bleu")))
        return bleus[-1]

    eval_script.generate_until_compilable = counted_search
    eval_script.load = timed_load
    eval_script.CrystalBLEU = bleu
    replicas.ReplicaPool = WatchedPool
    # "cuda" places one replica on every local card (one here)
    where = "cpu" if rehearsal else "cuda"
    stages, result = {}, {"phase": "evaluate", "items": EVAL_ITEMS,
                          "entry": "detikzify_torch.examples.eval"}
    try:
        cache_dir = os.path.join(tmp, "cache")
        with checkpoint_tokenizer(cfg, cfg.image_seq_len + max_new_tokens):
            reset_launch_counts()
            sync()
            t0 = time.perf_counter()
            rows, params, pcfg, processor = eval_script.predict(
                "v2-8b", export_dir, testset, cache_dir, 0, parallelism=8,
                quantize=True, device=where)
            sync()
            stages["predict_s"] = time.perf_counter() - t0
            predict_counts = launch_counts()
            searched = len(searches)
            held = {"predict": held_by(pools)}
            first_pools = len(pools)
            # the cache pass: predict again on the weights loaded above
            # (the load itself ran in the first pass)
            eval_script.load = lambda *a, **kw: (params, pcfg, processor)
            reset_launch_counts()
            t0 = time.perf_counter()
            rows2, *_ = eval_script.predict(
                "v2-8b", export_dir, testset, cache_dir, 0, parallelism=8,
                quantize=True, device=where)
            stages["cache_pass_s"] = time.perf_counter() - t0
            cache_counts = launch_counts()
            held["cache_pass"] = held_by(pools[first_pools:])
            del _
        n_pools = [first_pools, len(pools) - first_pools]
        for pool in pools:
            pool.close()
        pools.clear()
        stages["load_s"] = loads
        new_searches = len(searches) - searched
        _free(torch, rehearsal)
        # model mode (predict with a timeout) improves until a minimum of
        # seconds; an infinite one ends the search at its expansions, a
        # count of programs
        reset_launch_counts()
        pipe = DetikzifyPipeline(params, pcfg, processor, num_slots=8,
                                 device=device, seed=seed)
        free0 = pipe.engine.num_free_pages
        t0 = time.perf_counter()
        improved = harness.generate_until_compilable(
            pipe, testset[0]["image"], score_improve=True,
            min_seconds=math.inf, max_expansions=EVAL_MODEL_MODE_PROGRAMS,
            parallelism=8)
        sync()
        stages["model_mode_s"] = time.perf_counter() - t0
        model_mode_counts = launch_counts()
        eng = pipe.engine
        if eng.num_active or eng.num_free_slots != eng.num_slots \
                or eng.num_free_pages != free0 - eng.prefix_pages_used:
            held["model_mode"] = [{"active": eng.num_active,
                                   "free_slots": eng.num_free_slots,
                                   "free_pages": eng.num_free_pages,
                                   "free_pages_at_start": free0,
                                   "prefix_pages": eng.prefix_pages_used}]
        pipe.close()
        del pipe, eng
        # a cached row also carries its key
        if searched != EVAL_ITEMS or new_searches != 0 or [
                {k: v for k, v in r.items() if k != "key"}
                for r in rows2] != rows:
            raise SystemExit(f"evaluate: predict searched {searched} of "
                             f"{EVAL_ITEMS} items, the cache pass ran "
                             f"{new_searches} new searches")
        if improved.num_programs != EVAL_MODEL_MODE_PROGRAMS \
                or not improved.compiled:
            raise SystemExit(f"evaluate: model mode kept {improved}")
        if n_pools != [1, 1]:
            raise SystemExit(f"evaluate: predict built {n_pools} pools, "
                             "expected one a pass")
        if any(held.values()):
            raise SystemExit(f"evaluate: slots or pages still held: {held}")

        # DreamSim: the published ensemble layout, random, in and out
        t0 = time.perf_counter()
        branches = write_dreamsim_branches(torch, tmp, rehearsal, seed + 14)
        stages["dreamsim_write_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        dreamsim = dreamsim_vit.from_dreamsim_checkpoint(branches,
                                                         device=device)
        manifest = dreamsim_vit.save_ensemble(os.path.join(tmp, "ensemble"),
                                              dreamsim)
        back = dreamsim_vit.load_ensemble(os.path.join(tmp, "ensemble"),
                                          device=device)
        stages["dreamsim_load_round_trip_s"] = time.perf_counter() - t0
        dreamsim_diff = [_tree_diff(a.params, b.params) for a, b in
                         zip(dreamsim.extractors, back.extractors)]
        dreamsim_self = dreamsim.similarity(testset[0]["image"],
                                            testset[0]["image"])
        del dreamsim

        # ClipScore: so400m's two towers, random, in and out, in fp32 as
        # the JAX metric builds them (K1's fp32 kernel on the card)
        dtype = torch.float32
        t0 = time.perf_counter()
        towers = random_siglip_towers(torch, device, dtype, rehearsal,
                                      seed + 15)
        clip_dir = os.path.join(tmp, "siglip")
        clip_bytes = mload.save_siglip_towers(clip_dir, towers)
        loaded = mload.load_siglip_towers(clip_dir, dtype=dtype,
                                          device=device)
        stages["clip_write_load_s"] = time.perf_counter() - t0
        clip_diff = {"vision": state_diff(torch, loaded.vision,
                                          towers.vision),
                     "text": state_diff(torch, loaded.text, towers.text),
                     "scalars_equal": (loaded.logit_scale,
                                       loaded.logit_bias)
                     == (towers.logit_scale, towers.logit_bias)}
        del towers
        clip = clip_metric(loaded, clip_tokenizer(
            loaded.text.embeddings.token.shape[0]))

        # ---- score, the script's own -----------------------------------
        reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        metrics = eval_script.score("v2-8b", rows, testset, params, pcfg,
                                    processor, clip_metric=clip,
                                    dreamsim_metric=back)
        sync()
        stages["score_s"] = time.perf_counter() - t0
        score_counts = launch_counts()
        result["crystalbleu_shared_ngrams"] = "native" if isinstance(
            bleus[-1].shared, crystalbleu.HashedNgramSet) else "python"
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        for k, v in script.items():
            setattr(eval_script, k, v)
        replicas.ReplicaPool = pool_cls
        for pool in pools:
            pool.close()

    ranges = {"CompileSuccessRate": (1.0, 1.0),
              "MeanTokenEfficiency": (0.0, 1.0),
              "MeanSamplingThroughput": (1.0, math.inf),
              "SelfSim": (-1.0, 1.0), "SelfSim_redacted": (-1.0, 1.0),
              "KID": (-math.inf, math.inf), "CrystalBLEU": (0.0, 1.0),
              "TexEditDistance": (0.0, 1.0), "DreamSim": (-1.0, 1.0),
              "DreamSim_redacted": (-1.0, 1.0),
              "ClipScore": (0.0, 1.0), "ClipScore_redacted": (0.0, 1.0)}
    out_of_range = {k: metrics.get(k) for k in ranges
                    if not (k in metrics and math.isfinite(metrics[k])
                            and ranges[k][0] <= metrics[k] <= ranges[k][1])}
    # ClipScore is a sigmoid: open interval
    for k in ("ClipScore", "ClipScore_redacted"):
        if not 0.0 < metrics.get(k, 0.0) < 1.0:
            out_of_range[k] = metrics.get(k)
    result.update({
        "weights": "int8 (load quantize=True)", "metrics": metrics,
        "stages_s": stages, "cache": {"first_pass_hits":
                                          EVAL_ITEMS - searched,
                                      "second_pass_hits":
                                          EVAL_ITEMS - new_searches,
                                      "second_pass_new_searches":
                                          new_searches},
        "predictions": [{"num_programs": r["num_programs"],
                         "lengths": r["lengths"], "seconds": r["seconds"],
                         "score": r["score"]} for r in rows],
        "model_mode": {"expansions": EVAL_MODEL_MODE_PROGRAMS,
                       "num_programs": improved.num_programs,
                       "seconds": improved.seconds,
                       "best_score": improved.best_score},
        "native_available": native.available(),
        "tex_tokenizer": "pygments" if _has_pygments() else "regex",
        "dreamsim": {"branches": list(branches),
                     "n_params": [b["n_params"] for b in
                                  manifest["branches"]],
                     "configs": [b["config"] for b in manifest["branches"]],
                     "round_trip_differing_entries": dreamsim_diff,
                     "self_similarity": dreamsim_self},
        "clipscore": {"checkpoint_bytes": clip_bytes,
                      "vision_layers": loaded.cfg.num_hidden_layers,
                      "text_layers": loaded.text_cfg.num_hidden_layers,
                      "loaded_vs_written": clip_diff,
                      "dtype": str(dtype).replace("torch.", "")},
        "launches_predict": predict_counts,
        "launches_cache_pass": cache_counts,
        "launches_model_mode": model_mode_counts,
        "launches_score": score_counts,
        "pools_built": n_pools, "held_after": held,
    })
    emit(result)
    problems = []
    if out_of_range:
        problems.append(f"metrics out of range: {out_of_range}")
    if any(d != 0 for d in dreamsim_diff) or abs(dreamsim_self - 1) > 1e-3:
        problems.append("DreamSim weights did not round-trip or an image "
                        "is not similar to itself")
    if clip_diff["vision"]["differing_entries"] \
            or clip_diff["text"]["differing_entries"] \
            or not clip_diff["scalars_equal"]:
        problems.append("ClipScore weights did not round-trip")
    if result["crystalbleu_shared_ngrams"] != "native":
        problems.append("CrystalBLEU's corpus pass did not run native")
    if any(cache_counts.values()):
        problems.append(f"the cache pass launched kernels: {cache_counts}")
    if not rehearsal:
        for name in ("flash_attention", "paged_decode", "int8_gemv"):
            if predict_counts[name] <= 0:
                problems.append(f"prediction never launched {name}")
        if score_counts["flash_attention"] <= 0:
            problems.append("scoring never launched flash_attention")
        if score_counts["flash_attention_f32"] <= 0:
            problems.append("ClipScore's fp32 towers never launched "
                            "flash_attention_f32")
    if problems:
        raise SystemExit(f"evaluate: {'; '.join(problems)}")
    return {"evaluate_predict": predict_counts,
            "evaluate_model_mode": model_mode_counts,
            "evaluate_score": score_counts}


def _greedy_parity(torch, cfg, want: list, got: list, rows: dict,
                   run: str) -> dict:
    """Greedy streams of one figure per entry, ``want`` from the single
    pipeline and ``got`` from ``run``: (tokens, logits by stream index).
    They may part only at a near-tie (``spec_greedy``'s rule): at the first
    differing token the single run's top-1 - top-2 logit gap must be at
    most tau = 2 max|got - want| over the logits both computed from the
    same tokens."""
    diffs, gaps, same, total = [], [], 0, 0
    for i, (w, g) in enumerate(zip(want, got)):
        n = min(len(w), len(g))
        same += sum(x == y for x, y in zip(w[:n], g[:n]))
        total += len(w)
        d = next((j for j in range(n) if w[j] != g[j]), None)
        if d == 0:
            raise SystemExit(f"replicas: figure {i} of {run} parted from "
                             "the single pipeline at its first token")
        for j in range(1, len(w) if d is None else d + 1):
            a, b = rows.get(("single", i, j)), rows.get((run, i, j))
            if a is not None and b is not None:
                diffs.append(float((a - b).abs().max()))
        if d is not None:
            top = rows[("single", i, d)].clone()
            top[cfg.image_token_id] = -float("inf")
            v2 = torch.topk(top, 2).values
            gaps.append({"figure": i, "token_index": d,
                         "top1_top2_gap": float(v2[0] - v2[1])})
    tau = 2 * max(diffs) if diffs else 0.0
    return {"identical_token_share": same / max(total, 1),
            "matched_positions": len(diffs),
            "max_abs_logits_diff": max(diffs) if diffs else None,
            "tau": tau, "divergences": gaps,
            "ok": all(g["top1_top2_gap"] <= tau for g in gaps)}


def replicas_phase(torch, device, rehearsal: bool, seed: int, params, cfg,
                   max_new_tokens: int) -> dict:
    """``parallel.ReplicaPool`` on the int8 + fused v2-8b weights (SelfSim
    EMD pipelines in fast mode, FakeBackend renders), first (a) with
    ``devices=None`` (one replica on each card: one here), then (b) with
    two replicas on ``cuda:0`` sharing the weights, each with its own
    engine and page pool. For each: ``map_until_compilable`` over
    ``REPLICA_ITEMS`` figures (fast mode, parallelism 8): every item
    answered once, and in (b) both workers took items (each replica's first
    search waits, up to a minute, until every replica has started one);
    then a greedy ``map_sample`` of ``REPLICA_GREEDY`` figures at
    ``max_new_tokens`` tokens, held against one greedy pipeline on the same
    figures (``_greedy_parity``). K2's launches must equal the replicas'
    own decode steps times the layers, and the greedy map's K1, K2 and K5
    launches those of the single pipeline's same work: no count is lost
    to the worker threads. Items/s and the card's peak memory are
    recorded; (b) against (a) is not a claim. Returns launch counts by
    path."""
    import threading

    from detikzify_torch.infer import DetikzifyPipeline
    from detikzify_torch.models import detikzify
    from detikzify_torch.ops import launch_counts, reset_launch_counts
    from detikzify_torch.parallel import ReplicaPool
    from detikzify_torch.processing import ByteTokenizer, DetikzifyProcessor

    def sync():
        if not rehearsal:
            torch.cuda.synchronize()

    _free(torch, rehearsal)
    processor = DetikzifyProcessor(smoke_tokenizer(
        ByteTokenizer, cfg, cfg.image_seq_len + max_new_tokens), cfg)
    layers = cfg.text.num_hidden_layers
    figs = synthetic_figures(REPLICA_ITEMS, seed + 21)
    greedy = figs[:REPLICA_GREEDY]
    ident = {id(f): i for i, f in enumerate(greedy)}

    # each greedy sample's tokens and decode logits, keyed by (run,
    # figure, stream index); the run and figure of a thread's sample() in
    # a thread-local. Rows are kept on the card with their positions and
    # keyed after the run, so recording adds no host sync
    local = threading.local()
    streams, raw, rows = {}, [], {}
    decode_step_paged = detikzify.decode_step_paged

    def record(params_, cfg_, tokens, positions, *a, **kw):
        _not_capturing(torch)
        logits, pool_ = decode_step_paged(params_, cfg_, tokens, positions,
                                          *a, **kw)
        ctx = getattr(local, "ctx", None)
        if ctx is not None:
            run, fig, eng = ctx
            for ro in list(eng._rollouts.values()):
                raw.append((run, fig, ro.prompt_len,
                            positions[ro.slot].clone(),
                            logits[ro.slot].float().clone()))
        return logits, pool_

    def key_rows():
        # the input at stream index j gives the logits of j + 1
        for run, fig, plen, pos, row in raw:
            rows[(run, fig, int(pos) - plen + 1)] = row
        raw.clear()

    def traced(pipe, run: str):
        """``pipe.sample`` and its engine's accepted tokens, recorded."""
        eng = pipe.engine
        sample, accept = pipe.sample, eng._accept_token

        def accepting(ro, tok):
            ctx = getattr(local, "ctx", None)
            if ctx is not None:
                streams.setdefault(ctx[:2], []).append(int(tok))
            return accept(ro, tok)

        def sampling(image=None, **kw):
            local.ctx = (run, ident[id(image)], eng)
            try:
                return sample(image=image, **kw)
            finally:
                local.ctx = None

        eng._accept_token = accepting
        pipe.sample = sampling

    def decode_steps(pipes):
        return sum(p.engine.counters["decode_steps"] for p in pipes)

    greedy_kw = dict(temperature=0.0, max_new_tokens=max_new_tokens)
    detikzify.decode_step_paged = record
    result = {"phase": "replicas", "weights": "int8 + fused",
              "items": REPLICA_ITEMS, "greedy_figures": REPLICA_GREEDY,
              "new_tokens": max_new_tokens, "runs": {}}
    paths, parity = {}, {}
    # the recorded greedy samples need every decode step in Python
    eager = eager_engines()
    eager.__enter__()
    try:
        # the single greedy pipeline the replicas are held against
        single = DetikzifyPipeline(params, cfg, processor, metric="fast",
                                   num_slots=8, device=device, seed=seed)
        traced(single, "single")
        reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        with torch.inference_mode():
            for img in greedy:
                single.sample(image=img, **greedy_kw)
        sync()
        single_s = time.perf_counter() - t0
        paths["replicas_single"] = single_counts = launch_counts()
        single.close()
        del single
        key_rows()
        want = [streams[("single", i)] for i in range(len(greedy))]

        for run, devices in (
                ("one", ["cpu"] if rehearsal else None),
                ("two", [device, device])):
            _free(torch, rehearsal)
            if not rehearsal:
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            pool = ReplicaPool(params, cfg, processor, devices=devices,
                               metric="fast", num_slots=8)
            build_s = time.perf_counter() - t0
            pipes = pool.pipelines
            shared = all(p.engine.params is params for p in pipes)
            pools = {p.engine.cache.k.data_ptr() for p in pipes}
            # which replica searched which item; every replica's first
            # search waits until each replica has begun one
            gate = threading.Barrier(len(pipes))
            taken = [0] * len(pipes)

            def gated(r, simulate):
                def simulate_(*a, **kw):
                    if taken[r] == 0:
                        gate.wait(timeout=60)
                    taken[r] += 1
                    return simulate(*a, **kw)
                return simulate_

            for r, p in enumerate(pipes):
                p.simulate = gated(r, p.simulate)
            steps0 = decode_steps(pipes)
            reset_launch_counts()
            sync()
            t0 = time.perf_counter()
            results = pool.map_until_compilable(figs, parallelism=8)
            sync()
            map_s = time.perf_counter() - t0
            map_counts = launch_counts()
            map_steps = decode_steps(pipes) - steps0
            bad = [r for r in results if isinstance(r, Exception)
                   or r.num_programs < 1]
            for r, p in enumerate(pipes):
                del p.simulate                 # the pipeline's own method
                traced(p, run)
            steps0 = decode_steps(pipes)
            reset_launch_counts()
            sync()
            t0 = time.perf_counter()
            docs = pool.map_sample(greedy, **greedy_kw)
            sync()
            greedy_s = time.perf_counter() - t0
            greedy_counts = launch_counts()
            greedy_steps = decode_steps(pipes) - steps0
            peak = (None if rehearsal else torch.cuda.max_memory_allocated())
            held = [p.engine.num_active for p in pipes]
            pool.close()
            del pool, pipes
            key_rows()
            got = [streams.get((run, i), []) for i in range(len(greedy))]
            parity[run] = _greedy_parity(torch, cfg, want, got, rows, run)
            paths[f"replicas_{run}"] = {
                k: map_counts[k] + greedy_counts[k] for k in map_counts}
            result["runs"][run] = {
                "devices": [str(d) for d in (devices or ["cuda:0"])],
                "replicas": len(taken), "shared_weights": shared,
                "distinct_page_pools": len(pools), "pool_build_s": build_s,
                "map_until_compilable": {
                    "seconds": map_s, "items_per_s": len(figs) / map_s,
                    "items_by_replica": taken, "failed": len(bad),
                    "num_programs": [getattr(r, "num_programs", None)
                                     for r in results],
                    "decode_steps": map_steps, "launches": map_counts},
                "map_sample": {
                    "seconds": greedy_s,
                    "figures_per_s": len(greedy) / greedy_s,
                    "codes_nonempty": sum(bool(getattr(d, "code", ""))
                                          for d in docs),
                    "decode_steps": greedy_steps,
                    "launches": greedy_counts,
                    **{k: v for k, v in parity[run].items() if k != "ok"}},
                "card_peak_bytes": peak, "slots_held_after": held}
            problems = []
            if bad or sum(taken) != len(figs):
                problems.append(f"{len(bad)} items failed, {sum(taken)} "
                                f"searched of {len(figs)}")
            if run == "two" and (min(taken) == 0 or not shared
                                 or len(pools) != 2):
                problems.append(f"items by replica {taken}, shared "
                                f"weights {shared}, {len(pools)} pools")
            if any(held) or any(isinstance(d, Exception) for d in docs):
                problems.append(f"slots held {held} or a sample raised")
            if not parity[run]["ok"]:
                problems.append(f"greedy streams parted above tau: "
                                f"{parity[run]}")
            if not rehearsal:
                for what, counts, steps in (
                        ("map_until_compilable", map_counts, map_steps),
                        ("map_sample", greedy_counts, greedy_steps)):
                    if counts["paged_decode"] != steps * layers or any(
                            counts[k] <= 0 for k in
                            ("flash_attention", "paged_decode",
                             "int8_gemv")):
                        problems.append(
                            f"{what} launched {counts} over {steps} decode "
                            f"steps of {layers} layers")
                if {k: greedy_counts[k] for k in
                        ("flash_attention", "paged_decode", "int8_gemv")} \
                        != {k: single_counts[k] for k in
                            ("flash_attention", "paged_decode",
                             "int8_gemv")}:
                    problems.append(f"the greedy map launched "
                                    f"{greedy_counts}, the single pipeline "
                                    f"{single_counts} for the same work")
            if problems:
                emit(result)
                raise SystemExit(f"replicas ({run}): {'; '.join(problems)}")
    finally:
        detikzify.decode_step_paged = decode_step_paged
        eager.__exit__(None, None, None)
        raw.clear()
        rows.clear()
    result["single"] = {"seconds": single_s, "launches": single_counts}
    emit(result)
    _free(torch, rehearsal)
    return paths


def _png_paths(n: int, seed: int, where: Path) -> list:
    paths = []
    for i, img in enumerate(synthetic_figures(n, seed)):
        path = where / f"figure{i}.png"
        img.save(path)
        paths.append(str(path))
    return paths


def infer_cli_phase(torch, device, rehearsal: bool, seed: int, cfg,
                    export_dir: str, max_new_tokens: int) -> dict:
    """The REPL of ``detikzify_torch.examples.infer`` in process, on the
    ``load`` phase's exported bf16 v2-8b checkpoint (SelfSim, the
    default), stdin two PNG paths written under ``build/``: once one-shot
    with ``--output`` (each program printed, the file written), once with
    ``--mcts --timeout 20 --parallelism 8``. Wall seconds and K1, K2
    launches of each run."""
    import io
    import shutil
    import tempfile
    from contextlib import redirect_stdout

    from detikzify_torch.examples import infer as infer_script
    from detikzify_torch.ops import launch_counts, reset_launch_counts

    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="infer_", dir=build))
    result, paths, problems = {"phase": "infer_cli", "weights": "bf16",
                               "entry": "detikzify_torch.examples.infer",
                               "runs": {}}, {}, []
    stdin = sys.stdin
    try:
        pngs = _png_paths(2, seed + 31, tmp)
        tex = tmp / "best.tex"
        where = "cpu" if rehearsal else "cuda"
        for run, extra in (
                ("one_shot", ["--output", str(tex)]),
                ("mcts", ["--mcts", "--timeout", "20",
                          "--parallelism", "8"])):
            _free(torch, rehearsal)
            out = io.StringIO()
            sys.stdin = io.StringIO("\n".join(pngs) + "\n")
            reset_launch_counts()
            t0 = time.perf_counter()
            with checkpoint_tokenizer(cfg, cfg.image_seq_len
                                      + max_new_tokens), \
                    redirect_stdout(out):
                infer_script.main(["--model", export_dir, "--device",
                                   where, *extra])
            wall = time.perf_counter() - t0
            counts = launch_counts()
            paths[f"infer_cli_{run}"] = counts
            text = out.getvalue()
            row = {"seconds": wall, "stdout_lines": len(text.splitlines()),
                   "saved": text.count("saved to"),
                   "scores": text.count("[score "),
                   "launches": counts}
            if run == "one_shot":
                row["tex_bytes"] = tex.stat().st_size if tex.exists() else 0
                if row["saved"] != 2 or not row["tex_bytes"]:
                    problems.append(f"one-shot saved {row['saved']} "
                                    f"programs, {row.get('tex_bytes')} "
                                    "bytes")
            elif row["scores"] < 2:
                problems.append(f"MCTS printed {row['scores']} scores for "
                                "two figures")
            if "no output" in text:
                problems.append(f"{run}: a figure had no output")
            if not rehearsal:
                for name in ("flash_attention", "paged_decode"):
                    if counts[name] <= 0:
                        problems.append(f"{run} never launched {name}")
            result["runs"][run] = row
    finally:
        sys.stdin = stdin
        shutil.rmtree(tmp, ignore_errors=True)
    emit(result)
    if problems:
        raise SystemExit(f"infer_cli: {'; '.join(problems)}")
    return paths


def serve_bench_phase(torch, device, rehearsal: bool) -> dict:
    """``detikzify_torch.examples.serve_bench.main`` in process at its
    documented shape: ``detikzify-ds-1.3b`` zero-initialized, int8 +
    fused, 16 slots, decode block 128, its default tokens, with
    ``SERVE_BENCH_ARGV``'s requests and clients (the rehearsal: ``--tiny``
    on the CPU, 6 requests). Its report line, and K1, K2 and K5
    launches."""
    import io
    from contextlib import redirect_stdout

    from detikzify_torch.examples import serve_bench
    from detikzify_torch.ops import launch_counts, reset_launch_counts

    argv = (["--tiny", "--device", "cpu", "--requests", "6", "--clients",
             "3", "--max-new-tokens", "8"] if rehearsal
            else SERVE_BENCH_ARGV)
    _free(torch, rehearsal)
    if not rehearsal:
        torch.cuda.reset_peak_memory_stats()
    out = io.StringIO()
    reset_launch_counts()
    t0 = time.perf_counter()
    with redirect_stdout(out):
        serve_bench.main(argv)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    report = json.loads(out.getvalue().strip().splitlines()[-1])
    requests = int(argv[argv.index("--requests") + 1])
    result = {"phase": "serve_bench", "argv": argv,
              "entry": "detikzify_torch.examples.serve_bench",
              "preset": "tiny-test" if rehearsal else "detikzify-ds-1.3b",
              "weights": "fp32" if rehearsal else "zeros, int8 + fused",
              "seconds": wall, "report": report, "launches": counts,
              "card_peak_bytes": None if rehearsal
              else torch.cuda.max_memory_allocated()}
    emit(result)
    problems = []
    if report["failed"] != 0 or report["requests"] != requests + 1 \
            or report["fused_fraction"] <= 0:
        problems.append(f"report {report}")
    if not rehearsal:
        for name in ("flash_attention", "paged_decode", "int8_gemv"):
            if counts[name] <= 0:
                problems.append(f"never launched {name}")
    if problems:
        raise SystemExit(f"serve_bench: {'; '.join(problems)}")
    _free(torch, rehearsal)
    return counts


def trace_phase(torch, device, rehearsal: bool, seed: int, params,
                processor) -> dict:
    """``utils.profiling.trace`` around one ``sample()`` of 32 tokens on the
    int8 + fused weights, its prefill inside ``span("prefill")``, both
    timed on the host by ``utils.profiling.Timer``: the
    trace file under ``build/`` must hold the span and, on the card,
    K1's and K2's device functions (``KERNEL_FUNCTIONS``)."""
    import shutil
    import tempfile

    from detikzify_torch.infer import DetikzifyPipeline
    from detikzify_torch.ops import launch_counts, reset_launch_counts
    from detikzify_torch.utils.profiling import Timer, span, trace

    _free(torch, rehearsal)
    pipe = DetikzifyPipeline(params, processor.cfg, processor, metric="fast",
                             num_slots=8, device=device, seed=seed)
    eng = pipe.engine
    start = eng.start

    timer = Timer()

    def annotated_start(*a, **kw):
        with span("prefill"), timer("prefill"):
            return start(*a, **kw)

    eng.start = annotated_start
    fig = synthetic_figures(1, seed + 41)[0]
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="trace_", dir=build)
    try:
        reset_launch_counts()
        t0 = time.perf_counter()
        with trace(tmp), timer("sample"):
            doc = pipe.sample(image=fig, max_new_tokens=32)
            if not rehearsal:
                torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        files = sorted(Path(tmp).rglob("*.pt.trace.json*"))
        text = files[0].read_text(errors="replace") if files else ""
        found = {"prefill": '"prefill"' in text,
                 **{name: any(f in text for f in KERNEL_FUNCTIONS[name])
                    for name in ("flash_attention", "paged_decode")}}
        result = {"phase": "trace", "seconds": wall,
                  "files": [f.name for f in files],
                  "trace_bytes": sum(f.stat().st_size for f in files),
                  "found": found, "code_chars": len(doc.code),
                  "host_phases": timer.summary(), "launches": counts}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        pipe.close()
    emit(result)
    want = ["prefill"] + ([] if rehearsal
                          else ["flash_attention", "paged_decode"])
    missing = [k for k in want if not found[k]]
    if len(files) != 1 or missing or timer.counts["prefill"] < 1:
        raise SystemExit(f"trace: {len(files)} trace files, missing "
                         f"{missing}, {timer.counts['prefill']} prefills "
                         "timed")
    return counts


def train_batch(processor, n: int, seed: int, max_length: int) -> dict:
    """``n`` synthetic figures with ``generate_corpus`` programs, tokenized
    and padded to ``max_length`` as the trainer's batches are (numpy)."""
    from detikzify_torch.dataset.synthetic import generate_corpus
    from detikzify_torch.train import data as tdata

    items = [{"image": f, "text": c} for f, c in zip(
        synthetic_figures(n, seed), generate_corpus(n, seed))]
    return tdata._collate(processor, items, max_length)


def _train_config(rehearsal: bool, layers: Optional[int] = None):
    from detikzify_torch.config import get_config

    cfg = get_config("tiny-test" if rehearsal else TRAIN_PRESET)
    if layers is not None:
        cfg = cfg.replace(vision=cfg.vision.replace(num_hidden_layers=layers),
                          text=cfg.text.replace(num_hidden_layers=layers))
    return cfg


def train_reference_phase(torch, device, rehearsal: bool, seed: int) -> None:
    """The training path on the card (bf16 weights, K1 forward, its
    recompute backward) against the same weights on the host CPU (fp32,
    plain versions): ``detikzify-ds-1.3b`` at full width cut to 2 vision +
    2 text layers, one batch of 2 figures with their programs at sequence
    640. The loss within ``TRAIN_REF_LOSS_TOL`` relative, each leaf's
    gradient (through ``params_to_numpy``) within ``TRAIN_REF_GRAD_TOL``
    relative L2 error."""
    import copy

    import numpy as np

    from detikzify_torch.models import convert
    from detikzify_torch.processing import ByteTokenizer, DetikzifyProcessor
    from detikzify_torch.train.step import (label_smoothing_free_loss,
                                            trainable_mask)
    from detikzify_torch.train.trainer import to_device

    cfg = _train_config(rehearsal, layers=2)
    cpu = torch.device("cpu")
    ref = convert.init_random(cfg, device=cpu, dtype=torch.float32,
                              generator=torch.Generator().manual_seed(
                                  seed + 7))
    dut = copy.deepcopy(ref).to(device=device, dtype=(
        torch.float32 if rehearsal else torch.bfloat16))
    processor = DetikzifyProcessor(smoke_tokenizer(ByteTokenizer, cfg), cfg)
    batch = train_batch(processor, 2, seed + 7,
                        64 if rehearsal else TRAIN_SEQ)

    def loss_and_grads(params, dev):
        trainable_mask(params, "all")
        trained = list(params.parameters())
        loss = label_smoothing_free_loss(params, cfg, to_device(batch, dev))
        grads = torch.autograd.grad(loss, trained, allow_unused=True)
        tree = convert.params_to_numpy(params, {
            p: torch.zeros_like(p) if g is None else g
            for p, g in zip(trained, grads)})
        return float(loss.detach()), tree

    got_loss, got = loss_and_grads(dut, device)
    want_loss, want = loss_and_grads(ref, cpu)
    errs = _leaf_errors(got, want)
    rel_loss = abs(got_loss - want_loss) / abs(want_loss)
    result = {"phase": "reference", "model": "train", "weights": "bf16",
              "preset": "tiny-test" if rehearsal else TRAIN_PRESET,
              "layers": {"vision": 2, "text": 2},
              "batch": {"B": 2, "S": int(batch["input_ids"].shape[1]),
                        "code_tokens": [int(x) for x in (
                            batch["labels"] != -100).sum(-1)]},
              "loss": got_loss, "loss_fp32": want_loss,
              "loss_rel_err": rel_loss, **errs,
              "tolerance": f"loss {TRAIN_REF_LOSS_TOL} relative; each "
                           f"leaf's gradient {TRAIN_REF_GRAD_TOL} relative "
                           "L2 (norm floor 1e-3 of the largest leaf's)"}
    emit(result)
    if not (np.isfinite(got_loss) and rel_loss <= TRAIN_REF_LOSS_TOL
            and errs["grad_rel_l2_max"] <= TRAIN_REF_GRAD_TOL):
        raise SystemExit(f"training gradients on the card disagree with "
                         f"the fp32 reference: {result}")


def _profile_step(torch, fn) -> dict:
    """One training step timed plainly, then one more under torch.profiler:
    the card's busy ms against the plain step's wall ms (the profiler slows
    the host), K1's forward ms and the ms of K1's backward (the plain
    version recomputed, the ``flash_attention_backward`` span)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    profiled_ms = (time.perf_counter() - t0) * 1e3
    dev = _device_time(prof)
    if dev["device_busy_ms"] <= 0:
        raise SystemExit("torch.profiler recorded no device time")
    from torch.autograd import DeviceType

    # the host-side span: its device time is that of the kernels launched
    # inside it (the device-side range of the same name spans gaps too)
    recompute = [getattr(e, "device_time_total", None)
                 or getattr(e, "cuda_time_total", 0)
                 for e in prof.events()
                 if e.name == "flash_attention_backward"
                 and e.device_type == DeviceType.CPU]
    return {"wall_ms": wall_ms, "wall_ms_profiled": profiled_ms, **dev,
            "device_idle_share": max(0.0, 1 - dev["device_busy_ms"]
                                     / wall_ms),
            "k1_forward_ms": dev["kernel_ms"]["flash_attention"],
            "k1_backward_recompute_ms": sum(recompute) / 1e3}


def train_phase(torch, device, rehearsal: bool, seed: int):
    """``detikzify-ds-1.3b`` at full width and depth, random bf16 weights
    drawn on the card from ``seed``, at bench.py's training shape: micro
    4 x 640, remat, 8-bit Adam moments; ``TRAIN_STEPS`` steps at
    grad_accum 1 and then 2, each with a fresh optimizer. Per step: loss,
    grad norm, wall seconds, tokens/s and TFLOP/s by 6 N T (after the
    first step); peak memory per run; one more step of grad_accum 1 under
    torch.profiler. Fails on a non-finite loss or weights the steps did
    not move. Returns (params, cfg, processor) for the trainer phases."""
    import math

    from detikzify_torch.models import convert
    from detikzify_torch.processing import ByteTokenizer, DetikzifyProcessor
    from detikzify_torch.train.step import (init_state, make_optimizer,
                                            make_train_step, trainable_mask)
    from detikzify_torch.train.trainer import to_device

    def sync():
        if not rehearsal:
            torch.cuda.synchronize()

    cfg = _train_config(rehearsal)
    seq = 64 if rehearsal else TRAIN_SEQ
    t0 = time.perf_counter()
    params = convert.init_random(
        cfg, device=device, dtype=torch.float32 if rehearsal
        else torch.bfloat16,
        generator=torch.Generator(device=device).manual_seed(seed + 11))
    sync()
    n_params = sum(p.numel() for p in params.parameters())
    processor = DetikzifyProcessor(smoke_tokenizer(ByteTokenizer, cfg), cfg)
    result = {"phase": "train",
              "preset": "tiny-test" if rehearsal else TRAIN_PRESET,
              "params": n_params, "init_weights_s": time.perf_counter() - t0,
              "micro_batch": TRAIN_MICRO, "seq": seq, "remat": True,
              "moment_dtype": "quant8", "learning_rate": TRAIN_LR,
              "flops_per_token": "6 N (N = every parameter)", "runs": []}
    watch = params.text.layers[0].mlp.down.weight
    start = watch.detach().clone()
    for ga in TRAIN_ACCUMS:
        batch = to_device(train_batch(processor, TRAIN_MICRO * ga,
                                      seed + ga, seq), device)
        opt = make_optimizer(TRAIN_LR, total_steps=TRAIN_STEPS,
                             trainable=trainable_mask(params, "all"),
                             moment_dtype="quant8")
        state = init_state(params, opt)
        step = make_train_step(cfg, opt, grad_accum=ga, remat=True)
        if not rehearsal:
            torch.cuda.reset_peak_memory_stats()
        run = {"grad_accum": ga, "tokens_per_step": TRAIN_MICRO * ga * seq,
               "code_tokens": int((batch["labels"] != -100).sum()),
               "steps": []}
        for i in range(TRAIN_STEPS):
            sync()
            t = time.perf_counter()
            state, metrics = step(state, batch)
            sync()
            dt = time.perf_counter() - t
            rec = {"step": i + 1, "loss": float(metrics["loss"]),
                   "grad_norm": float(metrics["grad_norm"]), "wall_s": dt}
            if i > 0:       # the first step carries one-time costs
                rec["tokens_per_s"] = run["tokens_per_step"] / dt
                rec["tflops_6nt"] = (6 * n_params * run["tokens_per_step"]
                                     / dt / 1e12)
            run["steps"].append(rec)
            if not (math.isfinite(rec["loss"])
                    and math.isfinite(rec["grad_norm"])):
                raise SystemExit(f"train: a non-finite step: {rec}")
        if not rehearsal:
            run["max_memory_allocated_bytes"] = \
                torch.cuda.max_memory_allocated()
            if ga == 1:
                run["profile"] = _profile_step(
                    torch, lambda: step(state, batch))
        result["runs"].append(run)
        del state, opt, step, batch
        _free(torch, rehearsal)
    result["moved_max_abs"] = float((watch.detach().float()
                                     - start.float()).abs().max())
    emit(result)
    if result["moved_max_abs"] <= 0:
        raise SystemExit("train: the steps did not move the weights")
    return params, cfg, processor


def trainer_phase(torch, device, rehearsal: bool, seed: int, params, cfg,
                  processor) -> None:
    """``Trainer`` (AdamW with moments in the weights' dtype, JAX's
    ``TrainConfig`` defaults otherwise) on the train phase's weights: 8
    synthetic figures with ``generate_corpus`` programs, sketch ratio 0.5,
    micro 1 x grad_accum 2 at ``max_length`` 640; 2 steps, one checkpoint
    written under ``build/``. A second ``Trainer`` on fresh random weights
    resumes from it at step 2 with the first one's weights bit for bit.
    The checkpoint's GB, save and restore seconds; then it is deleted."""
    import shutil
    import tempfile

    from detikzify_torch.dataset.synthetic import generate_corpus
    from detikzify_torch.models import convert
    from detikzify_torch.train import TrainConfig, Trainer
    from detikzify_torch.train.data import SketchDataset

    def sync():
        if not rehearsal:
            torch.cuda.synchronize()

    def dataset():
        return SketchDataset([{"image": f, "text": c} for f, c in zip(
            synthetic_figures(8, seed + 21), generate_corpus(8, seed))],
            sketch_ratio=0.5, seed=seed)

    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    out = tempfile.mkdtemp(prefix="train_", dir=build)
    logs = []
    result = {"phase": "trainer", "figures": 8, "micro_batch": 1,
              "grad_accum": 2, "max_length": 64 if rehearsal else TRAIN_SEQ,
              "sketch_ratio": 0.5}
    try:
        tc = TrainConfig(output_dir=out, epochs=1, micro_batch_size=1,
                         grad_accum=2, max_length=result["max_length"],
                         sketch_ratio=0.5, save_epoch_fraction=1.0,
                         logging_steps=1, seed=seed)
        trainer = Trainer(params, cfg, processor, dataset(), tc,
                          device=device, log_fn=logs.append)
        save = trainer.ckpt.save
        saves = []

        def timed_save(*a, **kw):
            sync()
            t = time.perf_counter()
            path = save(*a, **kw)
            saves.append(time.perf_counter() - t)
            return path
        trainer.ckpt.save = timed_save
        t0 = time.perf_counter()
        state = trainer.train(max_steps=2)
        sync()
        result["train_s"] = time.perf_counter() - t0
        ckpts = sorted(os.listdir(out))
        nbytes = sum(f.stat().st_size for f in Path(out).rglob("*")
                     if f.is_file())
        result.update(steps=state.step, checkpoints=ckpts,
                      checkpoint_gb=nbytes / 1e9, save_s=saves,
                      steps_per_epoch=trainer.steps_per_epoch, log=logs)
        del trainer, state
        _free(torch, rehearsal)
        fresh = convert.init_random(
            cfg, device=device, dtype=params.dtype,
            generator=torch.Generator(device=device).manual_seed(seed + 31))
        trainer2 = Trainer(fresh, cfg, processor, dataset(), tc,
                           device=device, log_fn=logs.append)
        sync()
        t0 = time.perf_counter()
        resumed = trainer2._resume()
        sync()
        result["restore_s"] = time.perf_counter() - t0
        result["resumed_step"] = resumed
        result["restored_vs_trained"] = state_diff(torch, fresh, params)
        del trainer2, fresh
    finally:
        shutil.rmtree(out, ignore_errors=True)
    _free(torch, rehearsal)
    emit(result)
    if (result["steps"] != 2 or result["resumed_step"] != 2
            or result["checkpoints"] != ["checkpoint-2"]
            or result["restored_vs_trained"]["differing_entries"] != 0):
        raise SystemExit(f"trainer: the run or its resume failed: {result}")


def pretrain_phase(torch, device, rehearsal: bool, seed: int, params, cfg,
                   processor) -> None:
    """``pretrain()`` on the train phase's weights: 4 synthetic figures
    with captions, batch 2 of micro 1, one epoch (2 steps: the first runs
    at learning rate 0). Only the connector may move, and
    ``modality_projector.npz`` is read back by the port's loader overlay
    bit for bit."""
    import copy
    import shutil
    import tempfile
    import types

    from detikzify_torch.dataset.synthetic import generate_corpus
    from detikzify_torch.models.load import _overlay_projector
    from detikzify_torch.train import pretrain

    def sync():
        if not rehearsal:
            torch.cuda.synchronize()

    before = {n: p.detach().clone() for n, p in params.named_parameters()}
    data = [{"image": f, "text": f"a figure of {c.splitlines()[1][:40]}"}
            for f, c in zip(synthetic_figures(4, seed + 41),
                            generate_corpus(4, seed + 41))]
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    out = tempfile.mkdtemp(prefix="pretrain_", dir=build)
    logs = []
    try:
        sync()
        t0 = time.perf_counter()
        trained, _ = pretrain(out, params, cfg, processor, data,
                              batch_size=2, micro_batch_size=1,
                              learning_rate=1e-3, epochs=1,
                              max_length=64 if rehearsal else TRAIN_SEQ,
                              device=device, log_fn=logs.append)
        sync()
        seconds = time.perf_counter() - t0
        moved = {n: float((p.detach().float() - before[n].float())
                          .abs().max())
                 for n, p in trained.named_parameters()}
        npz = os.path.join(out, "modality_projector.npz")
        holder = types.SimpleNamespace(
            connector=copy.deepcopy(trained.connector))
        _overlay_projector(holder, npz, trained.dtype)
        overlay_equal = bool(torch.equal(holder.connector.proj.weight,
                                         trained.connector.proj.weight))
        npz_bytes = os.path.getsize(npz)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    del before
    _free(torch, rehearsal)
    others = {n: d for n, d in moved.items()
              if not n.startswith("connector.")}
    result = {"phase": "pretrain", "figures": 4, "steps": 2,
              "seconds": seconds, "log": logs,
              "connector_moved_max_abs": max(
                  d for n, d in moved.items() if n.startswith("connector.")),
              "embed_tokens_moved_max_abs": moved["text.embed_tokens"],
              "other_leaves_moved": sum(d > 0 for d in others.values()),
              "modality_projector_npz_bytes": npz_bytes,
              "overlay_equal": overlay_equal}
    emit(result)
    if (result["connector_moved_max_abs"] <= 0
            or result["other_leaves_moved"] or not overlay_equal):
        raise SystemExit(f"pretrain: {result}")


# ------------------------------------------------------------ post-training


class GradCapture:
    """An optimizer with ``train.step.AdamW``'s interface that keeps the
    gradients a step hands it and changes nothing: the reference rows read
    a step's gradients through it."""

    def __init__(self):
        self.grads = {}

    def init(self, params) -> dict:
        return {}

    def update(self, params, grads, state) -> dict:
        self.grads = dict(grads)
        return state


def _leaf_errors(got: dict, want: dict) -> dict:
    """Per-leaf relative L2 error of two JAX-layout gradient trees (numpy),
    each leaf against the larger of its fp32 norm and 1e-3 of the largest
    leaf's norm: the worst five, the largest and the median."""
    import numpy as np

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}/")
            else:
                yield prefix + k, v

    got, want = dict(flat(got)), dict(flat(want))
    norms = {k: float(np.linalg.norm(w)) for k, w in want.items()}
    floor = 1e-3 * max(norms.values())
    errs = {k: float(np.linalg.norm(got[k] - w)) / max(norms[k], floor)
            for k, w in want.items()}
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:5]
    return {"leaves": len(errs), "grad_rel_l2_max": worst[0][1],
            "grad_rel_l2_median": float(np.median(list(errs.values()))),
            "worst_leaves": worst}


def made_up_captions(n: int, seed: int) -> list:
    """Short captions of the kind TikZero's training pairs carry."""
    import numpy as np

    rng = np.random.default_rng(seed)
    kinds = ("bar chart", "line plot", "scatter plot", "flow diagram",
             "tree", "graph", "circuit", "grid")
    things = ("three machines", "rollouts per minute", "two groups",
              "a binary search", "the training loss", "six nodes")
    return [f"a {kinds[int(rng.integers(len(kinds)))]} of "
            f"{things[int(rng.integers(len(things)))]}"
            + " with a legend" * int(rng.integers(2)) for _ in range(n)]


def posttrain_reference_phase(torch, device, rehearsal: bool,
                              seed: int) -> None:
    """The post-training paths on the card (bf16 weights, K1 forward, its
    recompute backward) against the same weights on the host CPU (fp32,
    plain versions), at full width cut to 2 layers, each through its own
    step with ``GradCapture``: ``adapter`` -- the distillation loss and
    every adapter leaf's gradient (``adapter_to_numpy``) at
    ``tikzero-adapter`` (the tower's 2 layers with their cross-attention
    blocks, 2 figures, two captions' hidden states at Llama-3.2-1B's
    width with a key mask); ``grpo`` -- the GRPO loss (KL term on) and
    every trainable leaf's gradient (``params_to_numpy``: the connector
    and the decoder; the tower is frozen) at ``detikzify-ds-1.3b`` 2 + 2
    layers, 2 rollouts of 32 tokens after the 300 image tokens, the tower's
    features computed on each side. Held within ``TRAIN_REF_LOSS_TOL``
    and ``TRAIN_REF_GRAD_TOL`` as the training reference is."""
    import copy

    import numpy as np

    from detikzify_torch.models import convert, detikzify
    from detikzify_torch.processing import preprocess_image
    from detikzify_torch.train.adapter import (DistillLossConfig,
                                               DistillState,
                                               make_distill_step)
    from detikzify_torch.train.grpo import (GRPOConfig, GRPOState,
                                            make_grpo_step,
                                            make_refine_optimizer,
                                            sequence_logprobs)

    cpu = torch.device("cpu")
    dut_dtype = torch.float32 if rehearsal else torch.bfloat16
    rng = np.random.default_rng(seed + 13)

    def held(result, got_loss, want_loss, got, want):
        result.update(loss=got_loss, loss_fp32=want_loss,
                      loss_rel_err=abs(got_loss - want_loss) / abs(want_loss),
                      **_leaf_errors(got, want),
                      tolerance=f"loss {TRAIN_REF_LOSS_TOL} relative; each "
                                f"leaf's gradient {TRAIN_REF_GRAD_TOL} "
                                "relative L2 (norm floor 1e-3 of the "
                                "largest leaf's)")
        emit(result)
        if not (np.isfinite(got_loss)
                and result["loss_rel_err"] <= TRAIN_REF_LOSS_TOL
                and result["grad_rel_l2_max"] <= TRAIN_REF_GRAD_TOL):
            raise SystemExit(f"{result['model']} gradients on the card "
                             f"disagree with the fp32 reference: {result}")

    # --- adapter distillation
    base, _ = tikzero_configs(rehearsal)
    cfg = base.replace(vision=base.vision.replace(num_hidden_layers=2))
    g = torch.Generator().manual_seed(seed + 13)
    vision = convert.init_random_siglip_vision(cfg.vision, device=cpu,
                                               dtype=torch.float32,
                                               generator=g)
    adapter = convert.init_random_adapter(cfg.vision, cfg.adapter,
                                          device=cpu, dtype=torch.float32,
                                          generator=g)
    with torch.no_grad():       # gates off zero, one value a block
        for i, blk in enumerate(adapter.layers):
            blk.attn_gate.fill_(0.5 - i)
            blk.mlp_gate.fill_(i - 0.5)
    size = cfg.vision.image_size
    figs = synthetic_figures(2, seed + 13)
    t = 24
    mask = np.zeros((2, t), bool)
    mask[0], mask[1, :13] = True, True
    batch = {"teacher_pixels": np.stack([preprocess_image(f, size)
                                         for f in figs]),
             "student_pixels": 0.25 * np.stack([preprocess_image(f, size)
                                                for f in figs[::-1]]),
             "caption_hidden": rng.standard_normal(
                 (2, t, cfg.adapter.embedding_hidden_size)).astype(
                     np.float32),
             "caption_mask": mask}

    def distill(vision, adapter, dev):
        adapter.requires_grad_(True)
        cap = GradCapture()
        step = make_distill_step(cfg, vision, cap, DistillLossConfig())
        _, m = step(DistillState(adapter, {}, 0),
                    {k: torch.from_numpy(v).to(dev)
                     for k, v in batch.items()})
        adapter.requires_grad_(False)
        return float(m["loss"]), convert.adapter_to_numpy(adapter,
                                                          cap.grads)

    dut = (copy.deepcopy(vision).to(device, dut_dtype),
           copy.deepcopy(adapter).to(device, dut_dtype))
    got_loss, got = distill(*dut, device)
    want_loss, want = distill(vision, adapter, cpu)
    held({"phase": "reference", "model": "adapter", "weights": "bf16",
          "preset": "tiny-test" if rehearsal else "tikzero-adapter",
          "layers": {"vision": 2, "cross_attention": 2},
          "batch": {"B": 2, "caption_tokens": [t, 13]}},
         got_loss, want_loss, got, want)
    del dut, vision, adapter

    # --- GRPO
    cfg = _train_config(rehearsal, layers=2)
    ref = convert.init_random(cfg, device=cpu, dtype=torch.float32,
                              generator=torch.Generator().manual_seed(
                                  seed + 17))
    seq, n_new = cfg.image_seq_len, 32 if not rehearsal else 8
    tokens = np.full((2, seq + n_new), cfg.pad_token_id, np.int32)
    tokens[:, :seq] = cfg.image_token_id
    tokens[:, seq:] = rng.integers(0, 256, (2, n_new))
    comp = np.zeros(tokens.shape, bool)
    comp[0, seq:] = True
    comp[1, seq:seq + n_new // 2] = True
    tokens[1, seq + n_new // 2:] = cfg.pad_token_id
    pix = preprocess_image(synthetic_figures(1, seed + 17)[0],
                           cfg.vision.image_size)[None]
    gcfg = GRPOConfig(beta=0.04)

    def grpo(params, dev):
        make_refine_optimizer(params, gcfg)     # trainable: all but vision
        cap = GradCapture()
        step = make_grpo_step(cfg, cap, gcfg)
        tb = {"tokens": torch.from_numpy(tokens).to(dev),
              "completion_mask": torch.from_numpy(comp).to(dev),
              "advantages": torch.tensor([1.0, -0.5], device=dev)}
        with torch.no_grad():
            feats = detikzify.vision_features(
                params, cfg, torch.from_numpy(pix).to(dev))
            tb["vision_feats"] = feats.expand(2, *feats.shape[1:])
            tb["ref_logprobs"] = sequence_logprobs(
                params, cfg, tb["tokens"], None, tb["completion_mask"],
                image_embeds=detikzify.connector(
                    params, tb["vision_feats"], cfg.concat_factor)) - 0.05
        _, m = step(GRPOState(params, {}, 0), tb)
        params.requires_grad_(False)
        tree = convert.params_to_numpy(params, cap.grads)
        del tree["vision"]                      # frozen: no gradient
        return float(m["loss"]), tree

    dut = copy.deepcopy(ref).to(device=device, dtype=dut_dtype)
    got_loss, got = grpo(dut, device)
    want_loss, want = grpo(ref, cpu)
    held({"phase": "reference", "model": "grpo", "weights": "bf16",
          "preset": "tiny-test" if rehearsal else TRAIN_PRESET,
          "layers": {"vision": 2, "text": 2},
          "batch": {"B": 2, "S": int(tokens.shape[1]),
                    "completion_tokens": [int(x) for x in comp.sum(-1)]}},
         got_loss, want_loss, got, want)
    del dut, ref
    _free(torch, rehearsal)


def tikzero_train_weights(torch, device, rehearsal: bool, seed: int):
    """``tikzero-adapter`` at full width, random bf16 weights drawn on the
    card: the tower (SigLIP so400m at 420 px) at its full 27 layers, the
    decoder (Llama-3.1-8B's widths) cut to ``TIKZERO_PLUS_LAYERS``, the
    adapter (0.41 B) and a caption model at Llama-3.2-1B's widths (16
    layers, 1.24 B). Returns (params, cfg, bundle, processor): the
    processor an ``AdapterProcessor`` over ``smoke_tokenizer``, which the
    caption model reads too."""
    from detikzify_torch.models import convert
    from detikzify_torch.models.embedding import AdapterBundle
    from detikzify_torch.processing import ByteTokenizer, DetikzifyProcessor
    from detikzify_torch.processing_adapter import AdapterProcessor

    cfg, ecfg = tikzero_configs(rehearsal)
    if not rehearsal:
        cfg = cfg.replace(text=cfg.text.replace(
            num_hidden_layers=TIKZERO_PLUS_LAYERS))
    dtype = torch.float32 if rehearsal else torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(seed + 301)
    params = convert.init_random(cfg, device=device, dtype=dtype,
                                 generator=gen)
    adapter = convert.init_random_adapter(cfg.vision, cfg.adapter,
                                          device=device, dtype=dtype,
                                          generator=gen)
    embed = convert.init_random_llama(ecfg, device=device, dtype=dtype,
                                      generator=gen)
    tok = smoke_tokenizer(ByteTokenizer, cfg)
    bundle = AdapterBundle(adapter, cfg.adapter, embed, ecfg, tok)
    processor = AdapterProcessor(DetikzifyProcessor(tok, cfg), tok)
    return params, cfg, bundle, processor


def _timed_steps(torch, module, name: str, rehearsal: bool, record):
    """Patch ``module.<name>`` (a step factory) so each step it makes is
    timed on a synchronised clock and handed to ``record(state, batch,
    metrics, seconds, step_fn)``; returns the undo."""
    real = getattr(module, name)

    def factory(*a, **kw):
        fn = real(*a, **kw)

        def step(state, batch):
            if not rehearsal:
                torch.cuda.synchronize()
            t = time.perf_counter()
            state, metrics = fn(state, batch)
            if not rehearsal:
                torch.cuda.synchronize()
            record(state, batch, metrics, time.perf_counter() - t, fn)
            return state, metrics
        return step

    setattr(module, name, factory)
    return lambda: setattr(module, name, real)


def _peak(torch, rehearsal: bool) -> dict:
    return {} if rehearsal else {
        "peak_memory_bytes": torch.cuda.max_memory_allocated()}


def adapter_pretrain_phase(torch, device, rehearsal: bool, seed: int,
                           params, cfg, bundle) -> None:
    """``pretrain_adapter`` at ``tikzero-adapter``, full width and depth:
    ``DISTILL_FIGURES`` synthetic figures with made-up captions, micro and
    batch ``DISTILL_MICRO``, one epoch (2 steps; the first at the warmup's
    learning rate 0). Per step: seconds, the loss and its four terms, peak
    memory; one more step profiled. Fails on a non-finite loss, an adapter
    that did not move, or a tower or caption model that changed."""
    import math
    import shutil
    import tempfile

    from detikzify_torch.train.adapter import pretrain_adapter

    # the package's ``pretrain`` is the function, as in the JAX package
    pretrain_mod = importlib.import_module(
        "detikzify_torch.train.adapter.pretrain")

    adapter = bundle.adapter_params
    tower0 = {k: v.clone() for k, v in params.vision.state_dict().items()}
    caption0 = {k: v.clone()
                for k, v in bundle.embed_params.state_dict().items()}
    watch = adapter.layers[0].attn.q.weight
    start = watch.detach().clone()
    data = [{"image": f, "text": c} for f, c in zip(
        synthetic_figures(DISTILL_FIGURES, seed + 311),
        made_up_captions(DISTILL_FIGURES, seed + 311))]
    steps, last = [], {}

    def record(state, batch, metrics, seconds, fn):
        steps.append({"step": len(steps) + 1, "wall_s": seconds,
                      "caption_tokens": int(batch["caption_mask"].shape[1]),
                      **{k: float(metrics[k]) for k in
                         ("loss", "pool", "avg", "patch", "layer")},
                      **_peak(torch, rehearsal)})
        last.update(state=state, batch=batch, fn=fn)

    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    undo = _timed_steps(torch, pretrain_mod, "make_distill_step", rehearsal,
                        record)
    out = tempfile.mkdtemp(prefix="adapter_pretrain_", dir=build)
    if not rehearsal:
        torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        pretrain_adapter(out, bundle, cfg, params.vision, data,
                         batch_size=DISTILL_MICRO,
                         micro_batch_size=DISTILL_MICRO, epochs=1,
                         seed=seed, log_fn=lambda m: None)
        seconds = time.perf_counter() - t0
        ckpts = sorted(os.listdir(out))
    finally:
        undo()
        shutil.rmtree(out, ignore_errors=True)
    result = {"phase": "adapter_pretrain", "preset": "tiny-test"
              if rehearsal else "tikzero-adapter",
              "adapter_parameters": sum(p.numel()
                                        for p in adapter.parameters()),
              "caption_model_parameters": sum(
                  p.numel() for p in bundle.embed_params.parameters()),
              "figures": DISTILL_FIGURES, "micro_batch": DISTILL_MICRO,
              "seconds": seconds, "steps": steps, "checkpoints": ckpts,
              "adapter_moved_max_abs": float(
                  (watch.detach().float() - start.float()).abs().max())}
    if not rehearsal:
        adapter.requires_grad_(True)
        try:
            result["profile"] = _profile_step(
                torch, lambda: last["fn"](last["state"], last["batch"]))
        finally:
            adapter.requires_grad_(False)
    result["tower_changed_tensors"] = sum(
        not torch.equal(v, tower0[k])
        for k, v in params.vision.state_dict().items())
    result["caption_model_changed_tensors"] = sum(
        not torch.equal(v, caption0[k])
        for k, v in bundle.embed_params.state_dict().items())
    del tower0, caption0, last
    _free(torch, rehearsal)
    emit(result)
    if (len(steps) != 2 or not all(math.isfinite(s["loss"]) for s in steps)
            or result["adapter_moved_max_abs"] <= 0
            or result["tower_changed_tensors"]
            or result["caption_model_changed_tensors"]
            or ckpts != ["checkpoint-2"]):
        raise SystemExit(f"adapter_pretrain: {result}")


def adapter_train_phase(torch, device, rehearsal: bool, seed: int, params,
                        cfg, bundle, processor) -> None:
    """``train_adapter_llm`` (TikZero+) at ``tikzero-adapter``, full width,
    the decoder cut to ``TIKZERO_PLUS_LAYERS``: caption-conditioned on
    ``TIKZERO_PLUS_ITEMS`` captions with ``generate_corpus`` programs and
    no figure (the adapter's blank image), micro ``TIKZERO_PLUS_MICRO`` (2
    steps), then the same in image mode with their figures (2 steps: a
    run of one step has no cosine schedule, in the JAX package neither).
    Per step: seconds,
    tokens/s, peak memory. Fails unless only the returned text tower moved
    and the caller's stayed as it was."""
    import math
    import shutil
    import tempfile

    from detikzify_torch.dataset.synthetic import generate_corpus
    from detikzify_torch.train.adapter import train_adapter_llm

    train_mod = importlib.import_module("detikzify_torch.train.adapter.train")

    n = TIKZERO_PLUS_ITEMS
    codes = generate_corpus(n, seed + 321)
    captions = made_up_captions(n, seed + 321)
    text0 = {k: v.clone() for k, v in params.text.state_dict().items()}
    steps = []

    def record(state, batch, metrics, seconds, fn):
        tokens = int(batch["input_ids"].numel())
        steps.append({"step": len(steps) + 1, "wall_s": seconds,
                      "loss": float(metrics["loss"]), "tokens": tokens,
                      "seq": int(batch["input_ids"].shape[1]),
                      "tokens_per_s": tokens / seconds,
                      **_peak(torch, rehearsal)})

    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    undo = _timed_steps(torch, train_mod, "make_adapter_train_step",
                        rehearsal, record)
    out = tempfile.mkdtemp(prefix="adapter_train_", dir=build)
    if not rehearsal:
        torch.cuda.reset_peak_memory_stats()
    runs = {}
    try:
        for mode, items, condition in (
                ("caption_condition",
                 [{"caption": c, "code": k} for c, k in zip(captions, codes)],
                 True),
                ("image", [{"caption": c, "code": k, "image": f}
                           for c, k, f in zip(captions, codes,
                                              synthetic_figures(n, seed))],
                 False)):
            n0, t0 = len(steps), time.perf_counter()
            trained = train_adapter_llm(
                os.path.join(out, mode), params, cfg, processor, bundle,
                items, caption_condition=condition,
                micro_batch_size=TIKZERO_PLUS_MICRO,
                learning_rate=TIKZERO_PLUS_LR, seed=seed,
                log_fn=lambda m: None)
            runs[mode] = {
                "seconds": time.perf_counter() - t0, "steps": steps[n0:],
                "text_moved_max_abs": float(
                    (trained.text.layers[0].mlp.down.weight.detach().float()
                     - params.text.layers[0].mlp.down.weight.detach()
                     .float()).abs().max()),
                "shares_vision_and_connector": (
                    trained.vision is params.vision
                    and trained.connector is params.connector),
                "returns_a_copy_of_text": trained.text is not params.text}
            del trained
            _free(torch, rehearsal)
    finally:
        undo()
        shutil.rmtree(out, ignore_errors=True)
    changed = sum(not torch.equal(v, text0[k])
                  for k, v in params.text.state_dict().items())
    del text0
    _free(torch, rehearsal)
    result = {"phase": "adapter_train", "preset": "tiny-test"
              if rehearsal else "tikzero-adapter",
              "decoder_layers": cfg.text.num_hidden_layers,
              "parameters": sum(p.numel() for p in params.parameters()),
              "micro_batch": TIKZERO_PLUS_MICRO, "runs": runs,
              "callers_text_changed_tensors": changed}
    emit(result)
    ok = (changed == 0 and [len(r["steps"]) for r in runs.values()] == [2, 2]
          and all(math.isfinite(s["loss"])
                  for r in runs.values() for s in r["steps"])
          and all(r["text_moved_max_abs"] > 0
                  and r["shares_vision_and_connector"]
                  and r["returns_a_copy_of_text"] for r in runs.values()))
    if not ok:
        raise SystemExit(f"adapter_train: {result}")


def grpo_phase(torch, device, rehearsal: bool, seed: int, params, cfg,
               processor) -> None:
    """``refine`` (GRPO) on the train phase's ``detikzify-ds-1.3b`` (full
    width and depth, bf16): ``SelfSimReward`` over ``FakeBackend`` renders
    (``smoke_tokenizer`` makes each rollout a distinct program),
    ``GRPO_GENERATIONS`` rollouts of ``GRPO_NEW_TOKENS`` for each of
    ``GRPO_PROMPTS`` figures a step, ``GRPO_STEPS`` steps, the KL anchor
    on and 2 updates a batch (the ref and old log-prob passes both run).
    Per step: rollout seconds and tokens/s, reward and update seconds,
    reward mean and max, loss, ratio, peak memory; one more update
    profiled. Fails unless the rewards differ, the policy moved outside
    the tower, and the caller's weights (the tower and the KL anchor)
    stayed bit for bit."""
    import numpy as np

    from detikzify_torch.engine import DecodeEngine
    from detikzify_torch.evaluate.imagesim import ImageSim
    from detikzify_torch.infer import CompileService, FakeBackend
    from detikzify_torch.models import detikzify
    from detikzify_torch.ops.sampling import SamplingParams
    from detikzify_torch.processing import preprocess_image
    from detikzify_torch.train.grpo import (GRPOConfig, GRPOState,
                                            SelfSimReward, make_grpo_step,
                                            make_refine_optimizer, refine,
                                            sequence_logprobs)

    def sync():
        if not rehearsal:
            torch.cuda.synchronize()

    new_tokens = 8 if rehearsal else GRPO_NEW_TOKENS
    # refine's learning rate (1e-6): Adam's steps of ~1e-6 move only the
    # bf16 weights below ~2.4e-4 in size, whose unit is below 2e-6
    gcfg = GRPOConfig(num_generations=GRPO_GENERATIONS,
                      max_new_tokens=new_tokens, beta=0.04,
                      updates_per_batch=2)
    engine = DecodeEngine(params, cfg, num_slots=min(GRPO_GENERATIONS, 16),
                          max_len=cfg.image_seq_len + 2 + new_tokens,
                          sampling=SamplingParams(), device=device,
                          seed=seed)
    before = {k: v.clone() for k, v in params.state_dict().items()}
    figs = synthetic_figures(4, seed + 331)
    selfsim = SelfSimReward(ImageSim.from_detikzify(params, cfg),
                            CompileService(workers=4, backend=FakeBackend()))
    steps, marks = [], {"t": time.perf_counter(),
                        "tokens": engine.counters["decode_tokens"]}

    def reward(images, codes):
        t0 = time.perf_counter()
        rewards = selfsim(images, codes)
        sync()
        tokens = engine.counters["decode_tokens"]
        steps.append({"step": len(steps), "rollouts": len(codes),
                      "rollout_s": t0 - marks["t"],
                      "rollout_tokens": tokens - marks["tokens"],
                      "rollout_tokens_per_s": (tokens - marks["tokens"])
                      / (t0 - marks["t"]),
                      "reward_s": time.perf_counter() - t0,
                      "reward_mean": float(rewards.mean()),
                      "reward_max": float(rewards.max()),
                      "rewards": [float(r) for r in rewards]})
        marks["t"] = time.perf_counter()
        return rewards

    def log(line):
        sync()
        now = time.perf_counter()
        steps[-1].update(update_s=now - marks["t"],
                         loss=float(line.split("loss ")[1].split(",")[0]),
                         ratio=float(line.split("ratio ")[1]),
                         **_peak(torch, rehearsal))
        marks.update(t=now, tokens=engine.counters["decode_tokens"])

    if not rehearsal:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    policy = refine(params, cfg, processor, figs, reward, gcfg=gcfg,
                    engine=engine, steps=GRPO_STEPS,
                    prompts_per_step=GRPO_PROMPTS, seed=seed, log_fn=log)
    seconds = time.perf_counter() - t0
    selfsim.compiler.shutdown()
    result = {"phase": "grpo", "preset": "tiny-test" if rehearsal
              else TRAIN_PRESET, "seconds": seconds,
              "num_generations": GRPO_GENERATIONS,
              "max_new_tokens": new_tokens, "prompts_per_step": GRPO_PROMPTS,
              "learning_rate": gcfg.learning_rate, "beta": gcfg.beta,
              "updates_per_batch": gcfg.updates_per_batch, "steps": steps,
              "distinct_rewards": len({r for s in steps
                                       for r in s["rewards"]}),
              "text_moved_max_abs": float(
                  (policy.text.layers[0].mlp.down.weight.detach().float()
                   - params.text.layers[0].mlp.down.weight.detach().float())
                  .abs().max()),
              "text_moved_share": float(
                  (policy.text.layers[0].mlp.down.weight
                   != params.text.layers[0].mlp.down.weight).float().mean()),
              "connector_moved_max_abs": float(
                  (policy.connector.proj.weight.detach().float()
                   - params.connector.proj.weight.detach().float())
                  .abs().max()),
              "shares_vision": policy.vision is params.vision,
              "engine_samples_the_policy": engine.params is policy}
    if not rehearsal:
        # one more update at refine's shape, profiled
        b = GRPO_PROMPTS * GRPO_GENERATIONS
        width = cfg.image_seq_len + new_tokens
        rng = np.random.default_rng(seed)
        tokens = np.full((b, width), cfg.image_token_id, np.int32)
        tokens[:, cfg.image_seq_len:] = rng.integers(0, 256, (b, new_tokens))
        comp = np.zeros(tokens.shape, bool)
        comp[:, cfg.image_seq_len:] = True
        opt = make_refine_optimizer(policy, gcfg)
        with torch.no_grad():
            feats = detikzify.vision_features(policy, cfg, torch.from_numpy(
                preprocess_image(figs[0], cfg.vision.image_size))[None].to(
                    device))
        batch = {"tokens": torch.from_numpy(tokens).to(device),
                 "completion_mask": torch.from_numpy(comp).to(device),
                 "advantages": torch.from_numpy(rng.standard_normal(b).astype(
                     np.float32)).to(device),
                 "vision_feats": feats.expand(b, *feats.shape[1:])}
        with torch.no_grad():
            batch["ref_logprobs"] = sequence_logprobs(
                policy, cfg, batch["tokens"], None, batch["completion_mask"],
                image_embeds=detikzify.connector(policy, batch["vision_feats"],
                                                 cfg.concat_factor))
        state = GRPOState(policy, opt.init(policy), 0)
        step = make_grpo_step(cfg, opt, gcfg)
        result["profile"] = _profile_step(torch, lambda: step(state, batch))
        policy.requires_grad_(False)
        del opt, state, step, batch
    result["callers_changed_tensors"] = sum(
        not torch.equal(v, before[k]) for k, v in params.state_dict().items())
    del before, policy, engine
    _free(torch, rehearsal)
    emit(result)
    if (result["distinct_rewards"] < 2 or result["text_moved_max_abs"] <= 0
            or result["connector_moved_max_abs"] <= 0
            or not result["shares_vision"]
            or not result["engine_samples_the_policy"]
            or result["callers_changed_tensors"]
            or len(steps) != GRPO_STEPS
            or not all(np.isfinite(s["loss"]) for s in steps)):
        raise SystemExit(f"grpo: {result}")


def _decode_rows(records) -> dict:
    """(slot, write position) -> that decode step's logits row, from the
    (positions, logits) pairs a recording ``decode_step_paged`` kept."""
    rows = {}
    for positions, logits in records:
        for slot, p in enumerate(positions.tolist()):
            rows[(slot, p)] = logits[slot]
    records.clear()
    return rows


def _checked_dispatch(torch, eng) -> None:
    """Run every ``_dispatch`` of ``eng`` under
    ``torch.cuda.set_sync_debug_mode("error")``: any operation that waits
    on the device inside it raises."""
    dispatch = eng._dispatch

    def checked(k):
        torch.cuda.set_sync_debug_mode("error")
        try:
            dispatch(k)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    eng._dispatch = checked


def pipelined_phase(torch, device, rehearsal: bool, seed: int, params,
                    processor, n_new: int) -> dict:
    """``DecodeEngine(pipelined=True)`` on the int8 + fused v2-8b: eight
    figures (prompts of 300 image tokens), ``n_new`` greedy tokens each,
    decode block ``PIPE_BLOCK``, eager and then pipelined. Every pipelined
    dispatch runs under the sync debug mode "error". The streams may part
    only at a near-tie: at the first differing token the eager run's
    top-1 - top-2 logit gap must be at most tau = 2 max|pipelined - eager|
    over the positions both runs computed from the same tokens (the
    pipelined page bound can be larger, which changes K2's split). Then
    one pipelined ``speculate=4`` run (K4). Tokens/s of each, the ms of a
    decode step (the verify/plain ratio on this model), and one pipelined
    block under torch.profiler (busy and idle share). The launches of the
    pipelined run and of the speculative one are counted from 0 just before
    each and read just after: the paths ``pipelined`` and
    ``pipelined_spec``."""
    from detikzify_torch.models import detikzify
    from detikzify_torch.ops import launch_counts, reset_launch_counts

    cfg = processor.cfg
    prompts, emb = _greedy_prompts(torch, device, params, processor, seed)
    decode_step_paged = detikzify.decode_step_paged
    records = []

    def record(params_, cfg_, tokens, positions, *a, **kw):
        _not_capturing(torch)
        logits, pool = decode_step_paged(params_, cfg_, tokens, positions,
                                         *a, **kw)
        records.append((positions, logits))    # no host read here
        return logits, pool

    def sync():
        if not rehearsal:
            torch.cuda.synchronize()

    def run(eng, new_tokens):
        ros = eng.start_many(prompts, image_embeds=emb,
                             max_new_tokens=new_tokens)
        sync()
        t0 = time.perf_counter()
        while not all(ro.finished for ro in ros) or eng.has_inflight:
            eng.step()
        sync()
        wall = time.perf_counter() - t0
        out = [(ro.slot, list(ro.token_ids), ro.prompt_len) for ro in ros]
        new = sum(ro.new_tokens for ro in ros)
        for ro in ros:
            eng.release(ro)
        return out, {"wall_s": wall, "new_tokens": new,
                     "tokens_per_s": new / wall,
                     "decode_steps": eng.counters["decode_steps"],
                     "decode_dispatches": eng.counters["decode_dispatches"],
                     "step_ms": wall * 1e3 / max(
                         eng.counters["decode_steps"], 1)}

    # the recorded runs decode eagerly (every step through ``record``),
    # and so does the speculative run, whose step the verify/plain ratio
    # holds against the pipelined one's; the profiled block runs on graphs
    kw = dict(decode_block=PIPE_BLOCK)
    detikzify.decode_step_paged = record
    try:
        eager, eager_run = run(_engine(torch, params, cfg, device, seed,
                                       graphs=False, **kw), n_new)
        eager_rows = _decode_rows(records)
        eng = _engine(torch, params, cfg, device, seed, pipelined=True,
                      graphs=False, **kw)
        if not rehearsal:
            _checked_dispatch(torch, eng)
        # the launches of the pipelined run alone
        reset_launch_counts()
        piped, piped_run = run(eng, n_new)
        counts = launch_counts()
        piped_rows = _decode_rows(records)
    finally:
        detikzify.decode_step_paged = decode_step_paged
    if not eager_rows or not piped_rows:
        raise SystemExit("pipelined: a recorded run recorded no decode step")
    if [x[0] for x in piped] != [x[0] for x in eager]:
        raise SystemExit("the two engines placed the figures on different "
                         "slots")
    diverge, same, total = [], 0, 0
    for (slot, want, plen), (_, got, _) in zip(eager, piped):
        n = min(len(want), len(got))
        same += sum(x == y for x, y in zip(want[plen:n], got[plen:n]))
        total += len(want) - plen
        diverge.append(next((j for j in range(plen, n)
                             if want[j] != got[j]), None))
    pairs = []
    for (slot, want, plen), d in zip(eager, diverge):
        hi = len(want) - 2 if d is None else d - 1
        for p in range(plen, hi + 1):
            a, b = eager_rows.get((slot, p)), piped_rows.get((slot, p))
            if a is not None and b is not None:
                pairs.append((a, b))
    diffs = (torch.stack([(a.float() - b.float()).abs().amax()
                          for a, b in pairs]).tolist() if pairs else [])
    tau = 2 * max(diffs) if diffs else 0.0
    gaps = []
    for (slot, want, plen), d in zip(eager, diverge):
        if d is None:
            continue
        row = eager_rows.get((slot, d - 1))
        if row is None:
            raise SystemExit(f"slot {slot}: pipelined and eager streams "
                             "differ at their first token")
        top = row.float().clone()
        top[cfg.image_token_id] = -float("inf")
        v2 = torch.topk(top, 2).values
        gaps.append({"slot": slot, "token_index": d - plen,
                     "top1_top2_gap": float(v2[0] - v2[1])})
    del eager_rows, piped_rows
    _free(torch, rehearsal)

    spec_eng = _engine(torch, params, cfg, device, seed, pipelined=True,
                       speculate=SPECULATE, spec_min_rate=0.0, graphs=False,
                       **kw)
    if not rehearsal:
        _checked_dispatch(torch, spec_eng)
    reset_launch_counts()
    spec, spec_run = run(spec_eng, n_new)
    spec_counts = launch_counts()
    spec_run["spec_rate"] = spec_eng.spec_rate
    spec_run["identical_to_eager_share"] = sum(
        a[1] == b[1] for a, b in zip(spec, eager)) / len(eager)
    del spec_eng
    _free(torch, rehearsal)

    profile = None
    if not rehearsal:
        # one pipelined block in its steady state (a block in flight)
        e = _engine(torch, params, cfg, device, seed, pipelined=True, **kw)
        e.start_many(prompts, image_embeds=emb,
                     max_new_tokens=8 * PIPE_BLOCK)
        for _ in range(3):
            e.step()
        prof, wall_ms = _profile_window(torch, e.step)
        profile = _window_time(prof, wall_ms)
        del e, prof
        _free(torch, rehearsal)
    del emb
    result = {
        "phase": "pipelined", "weights": "int8 + fused", "slots": len(eager),
        "prompt_tokens": eager[0][2], "new_tokens": n_new,
        "decode_block": PIPE_BLOCK, "eager": eager_run,
        "pipelined": piped_run, "speculative_pipelined": spec_run,
        "verify_plain_step_ratio": spec_run["step_ms"]
        / piped_run["step_ms"],
        "dispatch_sync_check": "every pipelined dispatch under "
                               "set_sync_debug_mode('error')"
                               if not rehearsal else "not on the CPU",
        "identical_token_share": same / max(total, 1),
        "first_divergence_per_slot": [None if d is None else d - p[2]
                                      for d, p in zip(diverge, eager)],
        "matched_positions": len(diffs),
        "max_abs_pipelined_minus_eager": max(diffs) if diffs else None,
        "tau": tau, "tau_rule": "2 max|pipelined - eager| over matched "
                                "positions",
        "divergences": gaps, "pipelined_block_profile": profile,
        "launches": {"pipelined": counts, "pipelined_spec": spec_counts},
        "nvidia_smi": None if rehearsal else nvidia_smi()}
    emit(result)
    for g in gaps:
        if not g["top1_top2_gap"] <= tau:
            raise SystemExit(f"pipelined greedy parted from eager greedy at "
                             f"a gap above tau={tau}: {g}")
    if rehearsal and gaps:
        raise SystemExit("pipelined and eager greedy streams differ on the "
                         "CPU")
    if not rehearsal:
        for path, got, names in (
                ("pipelined", counts,
                 ("flash_attention", "paged_decode", "int8_gemv")),
                ("pipelined_spec", spec_counts,
                 ("flash_attention", "paged_verify", "int8_gemv"))):
            for name in names:
                if got[name] <= 0:
                    raise SystemExit(f"{path} never launched {name}")
    return {"pipelined": counts, "pipelined_spec": spec_counts}


def graphs_phase(torch, device, rehearsal: bool, seed: int, params,
                 processor, n_new: int) -> dict:
    """CUDA graphs (``DecodeEngine._build_jit``) against eager dispatch
    (``graphs=False``) on the int8 + fused v2-8b at 8 slots, every pair in
    turns (eager, graph, graph, eager) on fresh engines:

      * eight figures (prompts of 300 image tokens), ``n_new`` greedy
        tokens each, plain and ``speculate=4`` (spec_min_rate 0): the
        greedy streams and the launches of every kernel must be equal
        between the graph and the eager runs, and on a graph engine every
        block after its key's first call must be one replay (dispatches =
        captures + replays); each graph engine reports the graphs it
        captured, their capture seconds and its memory pool's bytes;
      * ms a decode step with the eight slots live (two blocks to warm up,
        four timed), eager and graph, plain and verify (the verify/plain
        ratio of each), then graph dispatch eager against pipelined;
      * one block of each under torch.profiler: busy ms and idle share;
      * ``sample()`` of one figure (vision, prefill, ``n_new`` tokens,
        SelfSim off) and ``simulate()`` (``GRAPH_SIM_EXPANSIONS``
        expansions, parallelism 8, SelfSim EMD), each on a fresh
        pipeline a turn (its captures inside the wall time).

    The launches of the first graph run of each mode are the paths
    ``graphs`` and ``graphs_spec``."""
    from detikzify_torch.infer import DetikzifyPipeline
    from detikzify_torch.ops import launch_counts, reset_launch_counts

    def sync():
        if not rehearsal:
            torch.cuda.synchronize()

    cfg = processor.cfg
    prompts, emb = _greedy_prompts(torch, device, params, processor, seed)
    # on the CPU a "graph" engine is the default one, which decodes eagerly
    kinds = {"eager": {"graphs": False},
             "graph": {} if rehearsal else {"graphs": True}}
    turns = ("eager", "graph", "graph", "eager")

    def graph_report(eng) -> dict:
        return dict(eng.graph_stats, programs=len(eng._programs),
                    pool_bytes=0 if rehearsal else eng.graph_pool_bytes())

    def greedy_run(kind: str, spec: int) -> tuple:
        extra = dict(speculate=spec, spec_min_rate=0.0) if spec else {}
        eng = _engine(torch, params, cfg, device, seed, **kinds[kind],
                      **extra)
        reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        ros = eng.start_many(prompts, image_embeds=emb, max_new_tokens=n_new)
        while not all(ro.finished for ro in ros):
            eng.step()
        sync()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        streams = [list(ro.token_ids) for ro in ros]
        new = sum(ro.new_tokens for ro in ros)
        for ro in ros:
            eng.release(ro)
        c = eng.counters
        run = {"kind": kind, "wall_s": wall, "new_tokens": new,
               "tokens_per_s": new / wall,
               "decode_steps": c["decode_steps"],
               "decode_dispatches": c["decode_dispatches"],
               "spec_rate": eng.spec_rate if spec else None,
               **graph_report(eng), "launches": counts}
        if (kind == "graph" and not rehearsal
                and c["decode_dispatches"] != run["captures"]
                + run["replays"]):
            raise SystemExit(f"graphs: {c['decode_dispatches']} dispatches "
                             f"but {run['captures']} captures and "
                             f"{run['replays']} replays")
        del eng
        _free(torch, rehearsal)
        return run, streams, counts

    result = {"phase": "graphs", "weights": "int8 + fused",
              "slots": len(prompts), "prompt_tokens": len(prompts[0]),
              "new_tokens": n_new, "turns": list(turns)}
    paths = {}
    for mode, spec in (("plain", 0), ("spec", SPECULATE)):
        runs, streams, counts = [], [], []
        for kind in turns:
            run, st, ct = greedy_run(kind, spec)
            runs.append(run)
            streams.append(st)
            counts.append(ct)
        path = "graphs" if mode == "plain" else "graphs_spec"
        paths[path] = counts[turns.index("graph")]
        same_streams = all(st == streams[0] for st in streams)
        same_counts = all(ct == counts[0] for ct in counts)
        result[mode] = {"runs": runs, "streams_equal": same_streams,
                        "launches_equal": same_counts}
        if not same_streams:
            emit(result)
            raise SystemExit(f"graphs ({mode}): greedy streams differ "
                             "between graph and eager runs")
        if not same_counts:
            emit(result)
            raise SystemExit(f"graphs ({mode}): kernel launches differ "
                             f"between graph and eager runs: {counts}")
        if not rehearsal:
            need = ("flash_attention", "int8_gemv",
                    "paged_verify" if spec else "paged_decode")
            for name in need:
                if paths[path][name] <= 0:
                    raise SystemExit(f"{path} never launched {name}")

    # ms a decode step in the steady state: eager against graph, plain and
    # verify steps (sampled at T 0.8, so the slots stay in one page bucket
    # and no capture falls inside the timed blocks), then the graph
    # engine's eager dispatch against its pipelined one
    def step_ms(kind: str, pipelined: bool = False, spec: bool = False
                ) -> float:
        extra = (dict(temperature=0.8, speculate=SPECULATE,
                      spec_min_rate=0.0) if spec else {})
        eng = _engine(torch, params, cfg, device, seed, pipelined=pipelined,
                      **kinds[kind], **extra)
        ms = _step_ms(torch, eng, prompts, rehearsal)
        del eng
        _free(torch, rehearsal)
        return ms

    result["step_ms"] = [{"kind": k, "ms": step_ms(k)} for k in turns]
    result["verify_step_ms"] = [{"kind": k, "ms": step_ms(k, spec=True)}
                                for k in turns]
    result["verify_plain_step_ratio"] = {
        k: statistics.mean(r["ms"] for r in result["verify_step_ms"]
                           if r["kind"] == k)
        / statistics.mean(r["ms"] for r in result["step_ms"]
                          if r["kind"] == k) for k in kinds}
    result["graph_dispatch_step_ms"] = [
        {"pipelined": p, "ms": step_ms("graph", p)}
        for p in (False, True, True, False)]

    # one block of each kind under the profiler, the slots live
    if not rehearsal:
        result["block_profile"] = {}
        for kind in ("eager", "graph"):
            eng = _engine(torch, params, cfg, device, seed, **kinds[kind])
            ros = eng.start_many(prompts, image_embeds=emb,
                                 max_new_tokens=8 * eng.decode_block)
            for _ in range(3):
                eng.step()
            prof, wall_ms = _profile_window(torch, eng.step)
            result["block_profile"][kind] = _window_time(prof, wall_ms)
            for ro in ros:
                eng.release(ro)
            del eng, prof
            _free(torch, rehearsal)

    # sample() and simulate() end to end, a fresh pipeline a turn
    fig = synthetic_figures(1, seed + 1)[0]

    def pipeline_run(kind: str, what: str) -> dict:
        eng = _engine(torch, params, cfg, device, seed,
                      temperature=0.8 if what == "simulate" else 0.0,
                      **kinds[kind])
        pipe = DetikzifyPipeline(
            params, cfg, processor, engine=eng, device=device, seed=seed,
            **({"metric": "fast"} if what == "sample" else {}))
        sync()
        t0 = time.perf_counter()
        if what == "sample":
            out = pipe.sample(image=fig, max_new_tokens=n_new)
            n = 1 if out.code is not None else 0
        else:
            n = len(list(pipe.simulate(image=fig,
                                       expansions=GRAPH_SIM_EXPANSIONS,
                                       parallelism=8,
                                       max_new_tokens=n_new)))
        sync()
        wall = time.perf_counter() - t0
        run = {"kind": kind, "wall_s": wall,
               "decode_steps": eng.counters["decode_steps"],
               **graph_report(eng)}
        if what == "simulate":
            run["rollouts"] = n
            run["rollouts_per_min"] = n / wall * 60
        pipe.close()
        del pipe, eng
        _free(torch, rehearsal)
        return run

    result["sample"] = [pipeline_run(k, "sample") for k in turns]
    result["simulate"] = [pipeline_run(k, "simulate") for k in turns]
    if not rehearsal:
        result["nvidia_smi"] = nvidia_smi()
    emit(result)
    del emb
    _free(torch, rehearsal)
    return paths


def _step_ms(torch, eng, prompts, rehearsal: bool, blocks: int = 4) -> float:
    """ms of one decode step of ``eng`` with every prompt live: two blocks
    to warm up, then ``blocks`` timed, each waited for."""
    ros = [eng.start(list(p), max_new_tokens=(blocks + 3)
                     * eng.decode_block * (1 + eng.spec), lazy=True)
           for p in prompts]
    for _ in range(2):
        eng.step()
    if not rehearsal:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(blocks):
        eng.step()
    if not rehearsal:
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (blocks * eng.decode_block)
    for ro in ros:
        eng.release(ro)
    return ms


def ds7b_config(rehearsal: bool):
    """``detikzify-ds-7b`` (DeepSeek-Coder-6.7B: 30 layers, MHA with 32
    heads of 128, vocabulary 32258; the v1 tower, 300 image tokens) at
    ``model_max_length`` 640, as bench.py's seven_bench runs it. The
    rehearsal's is tiny-test wired as DS-7b: MHA (as many KV heads as
    heads), v1 (a biased projector, SelfSim pinned to cos) and a vocabulary
    of 500, whose lm_head N is not a multiple of 128."""
    from detikzify_torch.config import get_config, tiny_test_config

    if rehearsal:
        base = tiny_test_config(vocab_size=500)
        return base.replace(
            text=base.text.replace(
                num_key_value_heads=base.text.num_attention_heads),
            is_v1=True, projector_bias=True, pooling_mode="cos",
            model_max_length=DS7_MAX_LEN)
    return get_config(DS7_PRESET).replace(model_max_length=DS7_MAX_LEN)


def ds7b_phase(torch, device, rehearsal: bool, seed: int) -> dict:
    """Tracked configuration #3, DS-7b int8 streaming decode (bench.py's
    seven_bench), at full width and depth: random bf16 weights drawn on the
    card from ``seed``, quantized in place and fused (the 13.4 GB bf16
    tree fits the card, so ``quantize_params`` runs there rather than
    ``quantize_params_host``); a ``DecodeEngine`` of 8 slots, max_len 640,
    decode_block 32, sampling at T 0.8 / top-p 0.95. Traffic: a warm-up of
    8 rollouts of 16 tokens, then two runs of 2 x 8 rollouts of 128 tokens
    started lazily on the image prompt (300 image tokens + bos, the tower's
    embedding of one synthetic figure), each with an ``on_token``
    consumer; every consumer must have seen exactly its rollout's tokens.
    Then one ``DetikzifyPipeline.sample()`` on the same engine through the
    v1 tower with a token streamer and a text streamer attached (the
    webui/SSE path), consumed on another thread: the streamed ids must
    decode to the document's code and the text deltas must spell it.
    K2 runs at G = 1, K5 at the fused qkv (N 12288), o, gateup (N 22016)
    and down (K 11008); the lm_head (N 32258) takes the dequantized product
    by JAX's rule. The launches of the two runs and the sample are the
    path's, counted from 0 just before them; then one decode block of 8
    live slots is profiled (the card's idle share)."""
    import threading

    from detikzify_torch.engine import DecodeEngine
    from detikzify_torch.infer import DetikzifyPipeline
    from detikzify_torch.models import convert
    from detikzify_torch.ops import launch_counts, reset_launch_counts
    from detikzify_torch.ops.cuda import device_scope
    from detikzify_torch.ops.quant import (QuantLinear, fuse_projections,
                                           params_nbytes, quantize_params)
    from detikzify_torch.ops.sampling import SamplingParams
    from detikzify_torch.processing import ByteTokenizer, DetikzifyProcessor
    from detikzify_torch.utils.generation import (StreamerList,
                                                  TextIteratorStreamer,
                                                  TokenStreamer)

    def sync():
        if not rehearsal:
            torch.cuda.synchronize()

    cfg = ds7b_config(rehearsal)
    if not rehearsal:
        torch.cuda.reset_peak_memory_stats()
    stages = {}
    t0 = time.perf_counter()
    params = convert.init_random(
        cfg, device=device, dtype=torch.float32 if rehearsal
        else torch.bfloat16,
        generator=torch.Generator(device=device).manual_seed(seed + 71))
    sync()
    stages["init_weights_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fuse_projections(quantize_params(params))
    sync()
    stages["quantize_fuse_s"] = time.perf_counter() - t0
    layer = params.text.layers[0]
    products = {"qkv": layer.attn.qkv, "o": layer.attn.o,
                "gateup": layer.mlp.gateup, "down": layer.mlp.down,
                "lm_head": params.text.lm_head}
    if not all(isinstance(m, QuantLinear) for m in products.values()):
        raise SystemExit(f"ds7b: not every product is int8: {products}")
    # [N, K] of each product; K5 takes those with K and N multiples of 128
    shapes = {name: list(m.q.shape) for name, m in products.items()}
    k5_eligible = {name: n % 128 == 0 and k % 128 == 0
                   for name, (n, k) in shapes.items()}

    processor = DetikzifyProcessor(
        smoke_tokenizer(ByteTokenizer, cfg, DS7_MAX_LEN), cfg)
    eng = DecodeEngine(
        params, cfg, num_slots=DS7_SLOTS, max_len=DS7_MAX_LEN,
        decode_block=DS7_BLOCK, prefix_budget_bytes=64 << 20,
        sampling=SamplingParams(temperature=0.8, top_p=0.95, top_k=0),
        device=device, seed=seed)
    pipe = DetikzifyPipeline(params, cfg, processor, metric="fast",
                             engine=eng, device=device, seed=seed)
    fig = synthetic_figures(1, seed + 72)[0]
    emb = eng.encode_image(processor(images=[pipe.load(fig)]).pixel_values)
    prompt = [cfg.image_token_id] * cfg.image_seq_len + [cfg.bos_token_id]

    def run_streaming(n: int, max_new: int, eng=eng) -> dict:
        streams = [[] for _ in range(n)]
        results, started, active = {}, 0, []
        t0 = time.perf_counter()
        while started < n or active:
            while started < n and eng.num_free_slots > 0:
                active.append((started, eng.start(
                    list(prompt), image_embeds=emb, max_new_tokens=max_new,
                    lazy=True, on_token=streams[started].append)))
                started += 1
            eng.step()
            for i, ro in list(active):
                if ro.finished:
                    results[i] = list(ro.token_ids[ro.prompt_len:])
                    eng.release(ro)
                    active.remove((i, ro))
        sync()
        seconds = time.perf_counter() - t0
        if any(streams[i] != results[i] for i in range(n)):
            raise SystemExit("ds7b: a consumer's tokens differ from its "
                             "rollout's")
        tokens = sum(len(r) for r in results.values())
        if sum(len(st) for st in streams) != tokens:
            raise SystemExit("ds7b: the consumers did not see every token")
        return {"rollouts": n, "tokens": tokens, "seconds": seconds,
                "tokens_per_s": tokens / seconds,
                "finished_at_eos": sum(
                    bool(r) and r[-1] == cfg.eos_token_id
                    for r in results.values())}

    free0 = eng.num_free_pages
    warm = run_streaming(DS7_SLOTS, DS7_WARMUP_TOKENS)
    # the same traffic on an eager engine (graphs=False) before and after
    # the two graph runs: eager, graph, graph, eager
    eager_eng = DecodeEngine(
        params, cfg, num_slots=DS7_SLOTS, max_len=DS7_MAX_LEN,
        decode_block=DS7_BLOCK, prefix_budget_bytes=64 << 20,
        sampling=SamplingParams(temperature=0.8, top_p=0.95, top_k=0),
        device=device, seed=seed, graphs=False)
    run_streaming(DS7_SLOTS, DS7_WARMUP_TOKENS, eager_eng)
    eager_runs = [run_streaming(2 * DS7_SLOTS, DS7_NEW_TOKENS, eager_eng)]
    reset_launch_counts()
    steps0 = eng.counters["decode_steps"]
    runs = [run_streaming(2 * DS7_SLOTS, DS7_NEW_TOKENS)
            for _ in range(DS7_RUNS)]
    decode_steps = eng.counters["decode_steps"] - steps0

    # the webui/SSE path: sample() with streamers, consumed on this thread
    ids, text = TokenStreamer(), TextIteratorStreamer(processor)
    out = {}

    streams = StreamerList([ids, text])

    def work():
        try:
            with device_scope(eng.device):
                out["doc"] = pipe.sample(image=fig,
                                         max_new_tokens=DS7_NEW_TOKENS,
                                         on_token=streams.put)
        except BaseException as err:      # to the consumer
            streams.propagate_error(err)
        else:
            streams.end()

    t0 = time.perf_counter()
    worker = threading.Thread(target=work, daemon=True)
    worker.start()
    streamed_text = "".join(text)
    worker.join()
    stages["streamed_sample_s"] = time.perf_counter() - t0
    streamed_ids = list(ids)
    counts = launch_counts()
    eager_runs.append(run_streaming(2 * DS7_SLOTS, DS7_NEW_TOKENS, eager_eng))
    del eager_eng
    code = out["doc"].code
    if processor.decode(streamed_ids, skip_special_tokens=True) != code:
        raise SystemExit("ds7b: the streamed ids do not decode to the "
                         "sampled document")
    if not code.startswith(streamed_text) or not streamed_ids:
        raise SystemExit("ds7b: the streamed text does not spell the "
                         "sampled document")
    if eng.num_active or eng.num_free_pages != free0 - eng.prefix_pages_used:
        raise SystemExit("ds7b: slots or pages still held after the runs")
    if not rehearsal:
        for name in ("flash_attention", "paged_decode", "int8_gemv"):
            if counts[name] <= 0:
                raise SystemExit(f"ds7b never launched {name}")
    result = {"phase": "ds7b", "preset": "tiny-test (ds-7b wiring)"
              if rehearsal else DS7_PRESET,
              "weights": "int8 + fused", "layers": cfg.text.num_hidden_layers,
              "heads": [cfg.text.num_attention_heads,
                        cfg.text.num_key_value_heads, cfg.text.head_dim],
              "slots": DS7_SLOTS, "max_len": DS7_MAX_LEN,
              "decode_block": DS7_BLOCK,
              "sampling": {"temperature": 0.8, "top_p": 0.95},
              "prompt_tokens": len(prompt),
              "weights_bytes": params_nbytes(params),
              "products_nk": shapes, "k5_eligible": k5_eligible,
              "stages_s": stages, "warmup": warm, "runs": runs,
              "ds7b_stream_tok_s": max(r["tokens_per_s"] for r in runs),
              "eager_runs": eager_runs, "graph_stats": dict(eng.graph_stats),
              "graph_pool_bytes": 0 if rehearsal
              else eng.graph_pool_bytes(),
              "decode_steps": decode_steps,
              "streamed_sample": {"tokens": len(streamed_ids),
                                  "code_chars": len(code),
                                  "text_chars": len(streamed_text)},
              "launches": counts}
    if not rehearsal:
        result["max_memory_allocated_bytes"] = \
            torch.cuda.max_memory_allocated()
        result["nvidia_smi"] = nvidia_smi()
    emit(result)
    if not rehearsal:
        # one 32-step block with the 8 slots live, under the profiler
        ros = [eng.start(list(prompt), image_embeds=emb,
                         max_new_tokens=4 * DS7_BLOCK, lazy=True)
               for _ in range(DS7_SLOTS)]
        eng.step()
        t_prof = time.perf_counter()
        prof = profile_call(torch, eng.step,
                            f"ds7b decode block of {DS7_BLOCK} steps, "
                            f"{DS7_SLOTS} live slots")
        prof["profile_s"] = time.perf_counter() - t_prof
        while not all(ro.finished for ro in ros):
            eng.step()
        for ro in ros:
            eng.release(ro)
        emit(dict(prof, model=DS7_PRESET))
    pipe.close()
    del pipe, eng, params, emb
    _free(torch, rehearsal)
    return {"ds7b": counts}


def spec_acceptance_phase(torch, device, rehearsal: bool, seed: int) -> dict:
    """``python -m detikzify_torch.examples.spec_acceptance`` on the card
    (its ``main``): ``run_measurement`` with the committed byte-level BPE
    (``spec_bpe_300.json``) over ``generate_corpus(300, seed=0)``, on the
    JAX package's spec model (4 heads of 32 in fp32, an fp32 page pool:
    K1's fp32 kernel, the fp32 K2 and K4; 60 steps and 8 prompts in the
    rehearsal) overfit for 400 steps, then greedy and T=0.8 speculative
    rates with and without hints over 24 prompts. The loss must fall
    below 1.5 and the hinted greedy rate must exceed the unhinted one.
    Then the ms of a verify step (speculate=4) over the ms of a plain step,
    eight live slots of the same model (random weights: a step's time does
    not depend on them): the break-even rate of ``spec_min_rate`` on the
    card. The example's launches and the step timing's are two paths,
    each counted from 0 just before it and read just after."""
    from detikzify_torch.dataset.synthetic import generate_corpus
    from detikzify_torch.engine import DecodeEngine
    from detikzify_torch.evaluate import spec_acceptance as sa
    from detikzify_torch.evaluate.bpe import ByteLevelBPE
    from detikzify_torch.examples import spec_acceptance as example
    from detikzify_torch.models import convert
    from detikzify_torch.ops import launch_counts, reset_launch_counts
    from detikzify_torch.ops.sampling import SamplingParams

    argv = ["--device", str(device)] + (
        ["--steps", "60", "--eval", "8"] if rehearsal else [])
    reset_launch_counts()
    t0 = time.perf_counter()
    out = example.main(argv)
    measure_s = time.perf_counter() - t0
    counts = launch_counts()

    tok = ByteLevelBPE.from_file()
    cfg = sa.spec_model_config(len(tok))
    params = convert.init_random(cfg, device=device,
                                 dtype=getattr(torch, cfg.dtype), seed=seed)
    prompts = [[cfg.bos_token_id] + tok.encode(c)[:SPEC_PROMPT - 1]
               for c in generate_corpus(8, seed=0)]

    def engine(spec):
        # EOS is the (banned) image token: every slot stays live
        return DecodeEngine(params, cfg, num_slots=8,
                            max_len=cfg.model_max_length, speculate=spec,
                            spec_min_rate=0.0, decode_block=16,
                            eos_token_id=cfg.image_token_id,
                            cache_dtype=getattr(torch, cfg.dtype),
                            sampling=SamplingParams(temperature=0.0),
                            device=device, seed=seed)
    reset_launch_counts()
    plain_ms = _step_ms(torch, engine(0), prompts, rehearsal)
    verify_ms = _step_ms(torch, engine(SPECULATE), prompts, rehearsal)
    step_counts = launch_counts()
    result = {"phase": "spec_acceptance", "vocab": len(tok),
              "measurement": out, "measure_s": measure_s,
              "plain_step_ms": plain_ms, "verify_step_ms": verify_ms,
              "verify_plain_ratio": verify_ms / plain_ms,
              "speculate": SPECULATE, "launches": counts,
              "launches_steps": step_counts,
              "nvidia_smi": None if rehearsal else nvidia_smi()}
    emit(result)
    if not out["overfit_loss"] < 1.5:
        raise SystemExit(f"spec_acceptance: the overfit loss "
                         f"{out['overfit_loss']} is not below 1.5")
    if not out["spec_rate_bpe_t0_hint"] > out["spec_rate_bpe_t0"]:
        raise SystemExit(f"spec_acceptance: hinted greedy drafts do not "
                         f"beat unhinted ones: {out}")
    if (out["head_dim"], out["dtype"]) != (32, "float32"):
        raise SystemExit(f"spec_acceptance ran at {out}, not the JAX "
                         "model's head_dim 32 in float32")
    if not rehearsal:
        # every rate is measured on a speculative engine (K4), the step
        # timing on a plain one too (K2), all of it in fp32
        for name, where in (("flash_attention_f32", counts),
                            ("paged_verify_f32", counts),
                            ("paged_decode_f32", step_counts),
                            ("paged_verify_f32", step_counts)):
            if where[name] <= 0:
                raise SystemExit(f"spec_acceptance never launched {name}")
    del params
    _free(torch, rehearsal)
    return {"spec_acceptance": counts, "spec_acceptance_steps": step_counts}


def mesh_phase(torch, device, rehearsal: bool, seed: int, params, cfg,
               processor) -> dict:
    """The data axis on one card: ``Trainer`` (JAX's ``TrainConfig``
    defaults, ``fsdp=True``) over ``make_mesh()`` of a one-rank process
    group (nccl on ``tcp://127.0.0.1`` at a free port; gloo in the
    rehearsal) against the same ``Trainer`` with no group, each on a copy
    of the train phase's weights: the ``trainer`` phase's 8 figures, micro
    1 x grad_accum 2, 2 steps. Every step's loss within
    ``TRAIN_REF_LOSS_TOL`` relative of the unmeshed one's; the sharded
    model's weights whole again after ``train``. Then
    ``parallel.dryrun.entry()``: the DS-1.3b forward on zero weights. The
    group is destroyed after. The launches are the meshed trainer's alone,
    counted from 0 just before it and read just after."""
    import copy
    import math

    import torch.distributed as dist

    from detikzify_torch.dataset.synthetic import generate_corpus
    from detikzify_torch.ops import launch_counts, reset_launch_counts
    from detikzify_torch.parallel.dryrun import _free_port, entry
    from detikzify_torch.parallel.mesh import make_mesh
    from detikzify_torch.train import TrainConfig, Trainer
    from detikzify_torch.train.data import SketchDataset

    def sync():
        if not rehearsal:
            torch.cuda.synchronize()

    def dataset():
        return SketchDataset([{"image": f, "text": c} for f, c in zip(
            synthetic_figures(8, seed + 21), generate_corpus(8, seed))],
            sketch_ratio=0.5, seed=seed)

    (ROOT / "build").mkdir(exist_ok=True)
    out_dir = tempfile.mkdtemp(prefix="mesh_", dir=ROOT / "build")
    tc = TrainConfig(output_dir=out_dir,
                     epochs=1, micro_batch_size=1, grad_accum=2,
                     max_length=64 if rehearsal else TRAIN_SEQ,
                     sketch_ratio=0.5, logging_steps=1, seed=seed)

    def run(mesh):
        weights = copy.deepcopy(params)
        trainer = Trainer(weights, cfg, processor, dataset(), tc, mesh=mesh,
                          device=device, log_fn=lambda m: None)
        trainer.ckpt.save = lambda *a, **k: None   # no checkpoint here
        losses, step = [], trainer._step_fn

        def recorded(state, batch):
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            return state, metrics
        trainer._step_fn = recorded
        sync()
        t0 = time.perf_counter()
        state = trainer.train(resume=False, max_steps=2)
        sync()
        out = {"losses": losses, "train_s": time.perf_counter() - t0,
               "steps": state.step}
        if not rehearsal:
            out["max_memory_allocated_bytes"] = \
                torch.cuda.max_memory_allocated()
        placement = getattr(weights, "placement", None)
        if placement is not None:
            out["placement"] = {"data": placement.world,
                                "sharded_tensors": len(
                                    placement._sharded()),
                                "whole_after_train": placement.is_full}
        del trainer, state, weights
        _free(torch, rehearsal)
        return out

    try:
        if not rehearsal:
            torch.cuda.reset_peak_memory_stats()
        plain = run(None)
        if not rehearsal:
            torch.cuda.reset_peak_memory_stats()
        dist.init_process_group(
            "gloo" if rehearsal else "nccl",
            init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
            world_size=1)
        try:
            mesh = make_mesh(device=device)
            # the launches of the meshed trainer alone
            reset_launch_counts()
            meshed = run(mesh)
            counts = launch_counts()
            meshed["mesh"] = mesh.shape
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    errs = [abs(a - b) / abs(b) for a, b in zip(meshed["losses"],
                                                plain["losses"])]
    result = {"phase": "mesh", "preset": "tiny-test" if rehearsal
              else TRAIN_PRESET, "backend": "gloo" if rehearsal else "nccl",
              "fsdp": tc.fsdp, "micro_batch": 1, "grad_accum": 2,
              "unmeshed": plain, "meshed": meshed, "loss_rel_err": errs,
              "tolerance": f"loss {TRAIN_REF_LOSS_TOL} relative",
              "launches": counts}
    if not rehearsal:
        fn, args = entry(device)
        logits = fn(*args)
        result["entry"] = {"logits_shape": list(logits.shape),
                           "finite": bool(torch.isfinite(logits).all())}
        del fn, args, logits
        _free(torch, rehearsal)
    emit(result)
    if (len(errs) != 2 or not all(math.isfinite(x) for x in meshed["losses"])
            or max(errs) > TRAIN_REF_LOSS_TOL
            or not meshed.get("placement", {}).get("whole_after_train")):
        raise SystemExit(f"mesh: the meshed trainer disagrees: {result}")
    if not rehearsal:
        if not result["entry"]["finite"]:
            raise SystemExit("mesh: entry()'s forward is not finite")
        if counts["flash_attention"] <= 0:
            raise SystemExit("mesh never launched flash_attention")
    return counts


# --- the tp phase: the mesh's model axis ------------------------------------

class LogitRecorder:
    """Wraps the engine's three forwards (``detikzify.prefill_paged``,
    ``decode_step_paged``, ``decode_verify_step_paged_zerocopy``) and
    ``DecodeEngine._start_wave`` while installed: for each logits row, keyed
    by (``part``, slot, input position), its argmax and top-1 - top-2 gap
    (``<image>`` masked, as sampling bans it), and the row itself for every
    start wave and the first ``keep`` decode or verify calls of a part.
    Everything stays on the device until ``collect``; a later row of a key
    replaces an earlier one (a verify column recomputed from the committed
    tokens)."""

    def __init__(self, torch, image_token_id: int, keep: int):
        self.torch, self.image_token_id, self.keep = torch, image_token_id, keep
        self.part, self._slots = None, None
        self._calls, self._n = [], {}

    def _add(self, slots, pos, logits, always: bool) -> None:
        torch = self.torch
        rows = logits.reshape(-1, logits.shape[-1]).float()
        masked = rows.clone()
        masked[:, self.image_token_id] = -float("inf")
        top = torch.topk(masked, 2, dim=-1)
        n = self._n.get(self.part, 0)
        if not always:
            self._n[self.part] = n + 1
        keep = always or n < self.keep
        self._calls.append((self.part, slots.reshape(-1), pos.reshape(-1),
                            top.indices[:, 0], top.values[:, 0]
                            - top.values[:, 1], rows if keep else None))

    @contextlib.contextmanager
    def installed(self):
        from detikzify_torch.engine import decode as engine_mod
        from detikzify_torch.models import detikzify

        torch = self.torch
        orig = (detikzify.prefill_paged, detikzify.decode_step_paged,
                detikzify.decode_verify_step_paged_zerocopy,
                engine_mod.DecodeEngine._start_wave)

        def start_wave(eng, slots, *a, **kw):
            self._slots = slots
            return orig[3](eng, slots, *a, **kw)

        def prefill(params, cfg, ids, emb, start, seq_len, *a, **kw):
            logits, pool = orig[0](params, cfg, ids, emb, start, seq_len,
                                   *a, **kw)
            self._add(self._slots, start + seq_len - 1, logits, True)
            return logits, pool

        def decode(params, cfg, tokens, positions, *a, **kw):
            _not_capturing(torch)
            logits, pool = orig[1](params, cfg, tokens, positions, *a, **kw)
            self._add(torch.arange(tokens.shape[0], device=tokens.device),
                      positions, logits, False)
            return logits, pool

        def verify(params, cfg, block, start, *a, **kw):
            _not_capturing(torch)
            logits, pool = orig[2](params, cfg, block, start, *a, **kw)
            b, k1 = block.shape
            dev = block.device
            self._add(torch.arange(b, device=dev)[:, None].expand(b, k1),
                      start[:, None] + torch.arange(k1, device=dev)[None],
                      logits, False)
            return logits, pool

        (detikzify.prefill_paged, detikzify.decode_step_paged,
         detikzify.decode_verify_step_paged_zerocopy,
         engine_mod.DecodeEngine._start_wave) = (prefill, decode, verify,
                                                 start_wave)
        try:
            with eager_engines():       # every step through the wrappers
                yield self
        finally:
            (detikzify.prefill_paged, detikzify.decode_step_paged,
             detikzify.decode_verify_step_paged_zerocopy,
             engine_mod.DecodeEngine._start_wave) = orig

    def collect(self):
        """({key: (argmax, gap)}, {key: fp32 row on the host})."""
        top, rows = {}, {}
        for part, slots, pos, arg, gap, full in self._calls:
            keys = [(part, s, p) for s, p in zip(slots.tolist(),
                                                 pos.tolist())]
            for key, a, g in zip(keys, arg.tolist(), gap.tolist()):
                top[key] = (a, g)
            if full is not None:
                full = full.cpu()
                for i, key in enumerate(keys):
                    rows[key] = full[i]
            elif any(key in rows for key in keys):
                for key in keys:            # a newer row without a copy
                    rows.pop(key, None)
        self._calls.clear()
        return top, rows


def tp_legs(torch, device, rehearsal: bool, seed: int, params, processor,
            n_new: int, rec: LogitRecorder, hint=None) -> dict:
    """The tp phase's inference legs on ``params`` (unsharded, or this
    rank's shard), each rollout's tokens keyed by its part:

      * ``sample_batch``: ``DetikzifyPipeline.sample_batch`` of
        ``TP_FIGURES`` figures, greedy, ``n_new`` tokens (K1 on the tower
        and the prefill, K2, K5);
      * ``restore_seed`` / ``restore``: figure 0's prompt and first 8
        tokens continued 8 more, the first 12 stored as a prefix and
        restored for a 16-token continuation;
      * ``burst``: a ``start_many`` of three rows, the stored prefix
        restored beside figure 1's prompt and figure 0's prompt with two
        tokens, 16 tokens each;
      * ``spec`` (its launches counted apart): a speculative engine
        (speculate=4, spec_min_rate=0) on figures 0 and 1, figure 0 hinted
        with ``hint`` (the unsharded run's continuation of it; its own
        when None), ``TP_SPEC_NEW_TOKENS`` tokens (K4).
    """
    from detikzify_torch.infer import DetikzifyPipeline
    from detikzify_torch.ops import launch_counts, reset_launch_counts

    def sync():
        if not rehearsal:
            torch.cuda.synchronize()

    cfg = processor.cfg
    figs = synthetic_figures(TP_FIGURES, seed + 41)
    pipe = DetikzifyPipeline(params, cfg, processor, temperature=0.0,
                             metric="fast", num_slots=8, device=device,
                             seed=seed)
    eng = pipe.engine
    made = []
    make = eng._make_rollout

    def recording_make(*a, **kw):
        ro = make(*a, **kw)
        made.append((rec.part, ro))
        return ro

    eng._make_rollout = recording_make
    out = {"streams": {}, "launches": {}}
    reset_launch_counts()
    sync()
    rec.part = "sample_batch"
    tokens0 = eng.counters["decode_tokens"]
    t0 = time.perf_counter()
    pipe.sample_batch(figs, max_new_tokens=n_new)
    sync()
    out["sample_batch_s"] = time.perf_counter() - t0
    out["decode_tokens"] = eng.counters["decode_tokens"] - tokens0
    out["decode_tokens_per_s"] = out["decode_tokens"] / out["sample_batch_s"]
    # the batch's wall time over its decode steps (its one start wave and
    # the vision pass included)
    out["ms_per_decode_step"] = (1e3 * out["sample_batch_s"]
                                 / max(eng.counters["decode_steps"], 1))
    ro0 = made[0][1]
    prompt0 = list(ro0.token_ids[:ro0.prompt_len])
    full0 = list(ro0.token_ids)
    n0 = len(prompt0)
    if hint is None:        # the unsharded run: its own continuation
        hint = full0[n0:]
    emb = eng.encode_image(processor(images=[pipe.load(f) for f in figs[:2]])
                           .pixel_values)

    rec.part = "restore_seed"
    r = eng.start(full0[:n0 + 8], image_embeds=emb[:1], max_new_tokens=8)
    eng.run()
    seed_ids = list(r.token_ids)
    eng.store_prefix("tp", r, length=n0 + 12)
    eng.release(r)
    rec.part = "restore"
    _, sp = eng.best_prefix(seed_ids[:n0 + 12])
    r = eng.start(seed_ids[:n0 + 12], image_embeds=emb[:1],
                  max_new_tokens=16, prefix=sp)
    eng.run()
    eng.release(r)
    rec.part = "burst"
    prompt1 = list(made[1][1].token_ids[:made[1][1].prompt_len])
    ros = eng.start_many([seed_ids[:n0 + 12], prompt1, full0[:n0 + 2]],
                         image_embeds=torch.cat([emb[:1], emb[1:], emb[:1]]),
                         max_new_tokens=16, prefixes=[sp, None, None])
    eng.run()
    for ro in ros:
        eng.release(ro)
    out["prefix_starts"] = eng.counters["prefix_starts"]
    sync()
    out["launches"]["tp"] = launch_counts()
    del eng._make_rollout
    pipe.close()
    del pipe, eng

    rec.part = "spec"
    reset_launch_counts()
    spec = _engine(torch, params, cfg, device, seed, speculate=SPECULATE,
                   spec_min_rate=0.0)
    make = spec._make_rollout
    spec._make_rollout = recording_make
    t0 = time.perf_counter()
    n_spec = min(TP_SPEC_NEW_TOKENS, n_new)
    ros = [spec.start(prompt0, image_embeds=emb[:1], max_new_tokens=n_spec,
                      hint=hint[:n_spec], lazy=True),
           spec.start(prompt1, image_embeds=emb[1:], max_new_tokens=n_spec,
                      lazy=True)]
    spec.run()
    sync()
    out["spec_s"] = time.perf_counter() - t0
    out["n_new"], out["n_spec"] = n_new, n_spec
    out["spec_counters"] = {k: v for k, v in spec.counters.items()
                            if k.startswith("spec_")}
    out["launches"]["tp_spec"] = launch_counts()
    for ro in ros:
        spec.release(ro)
    del spec._make_rollout, spec, emb
    for part, ro in made:
        out["streams"].setdefault(part, []).append(
            (ro.slot, ro.prompt_len, list(ro.token_ids)))
    if out["prefix_starts"] < 2:
        raise SystemExit(f"tp legs: {out['prefix_starts']} prefix "
                         "restores, expected 2")
    if out["spec_counters"]["spec_steps"] <= 0:
        raise SystemExit("tp legs: the speculative engine never verified")
    return out


def tp_train_run(torch, device, rehearsal: bool, seed: int, mesh) -> dict:
    """The tp phase's training leg: ``Trainer`` (JAX's ``TrainConfig``
    defaults, ``fsdp=True``) on ``detikzify-ds-1.3b`` bf16 weights drawn
    from ``seed``, cut to ``TP_TRAIN_LAYERS`` layers a tower, 8 synthetic
    figures, micro 1 x grad_accum 1 at ``TRAIN_SEQ``, 2 steps; over
    ``mesh`` or unmeshed. Losses, seconds, peak memory."""
    from detikzify_torch.dataset.synthetic import generate_corpus
    from detikzify_torch.models import convert
    from detikzify_torch.processing import ByteTokenizer, DetikzifyProcessor
    from detikzify_torch.train import TrainConfig, Trainer
    from detikzify_torch.train.data import SketchDataset

    cfg = _train_config(rehearsal, None if rehearsal else TP_TRAIN_LAYERS)
    processor = DetikzifyProcessor(smoke_tokenizer(ByteTokenizer, cfg), cfg)
    gen = torch.Generator(device=device).manual_seed(seed + 5)
    params = convert.init_random(cfg, device=device, generator=gen,
                                 dtype=torch.float32 if rehearsal
                                 else torch.bfloat16)
    data = SketchDataset([{"image": f, "text": c} for f, c in zip(
        synthetic_figures(8, seed + 21), generate_corpus(8, seed))],
        sketch_ratio=0.5, seed=seed)
    (ROOT / "build").mkdir(exist_ok=True)
    out_dir = tempfile.mkdtemp(prefix="tp_train_", dir=ROOT / "build")
    tc = TrainConfig(output_dir=out_dir, epochs=1, micro_batch_size=1,
                     grad_accum=1, max_length=64 if rehearsal else TRAIN_SEQ,
                     sketch_ratio=0.5, logging_steps=1, seed=seed)
    try:
        if not rehearsal:
            torch.cuda.reset_peak_memory_stats(device)
        trainer = Trainer(params, cfg, processor, data, tc, mesh=mesh,
                          device=device, log_fn=lambda m: None)
        trainer.ckpt.save = lambda *a, **k: None   # no checkpoint here
        losses, times, step = [], [], trainer._step_fn

        def recorded(state, batch):
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            times.append(time.perf_counter() - t0)
            return state, metrics
        trainer._step_fn = recorded
        trainer.train(resume=False, max_steps=2)
        out = {"losses": losses, "step_s": times,
               "layers": cfg.text.num_hidden_layers}
        if not rehearsal:
            out["max_memory_allocated_bytes"] = \
                torch.cuda.max_memory_allocated(device)
        del trainer
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return out


def tp_reference(torch, device, rehearsal: bool, seed: int, qparams,
                 processor, n_new: int) -> dict:
    """The unsharded runs the tp phase is held against, on the int8 +
    fused weights before they are freed: its legs (recorded) and its
    training leg unmeshed."""
    rec = LogitRecorder(torch, processor.cfg.image_token_id, TP_KEEP_CALLS)
    if not rehearsal:
        torch.cuda.reset_peak_memory_stats()
    with rec.installed():
        legs = tp_legs(torch, device, rehearsal, seed, qparams, processor,
                       n_new, rec)
    legs["top"], legs["rows"] = rec.collect()
    if not rehearsal:
        legs["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    _free(torch, rehearsal)
    return {"legs": legs,
            "train": tp_train_run(torch, device, rehearsal, seed, None)}


def tp_rank_main(args) -> int:
    """One rank of the tp phase (``--tp-rank``): joins the group, loads the
    exported checkpoint int8 on the host, keeps its shard over a
    ``(data=1, model=world)`` mesh on its card, fuses it, runs ``tp_legs``
    recorded, then the training leg over the same mesh, and writes what it
    saw to ``<tp-dir>/rank<r>.pt``."""
    faulthandler.enable(all_threads=True)
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.distributed as dist

    from detikzify_torch.models.load import load_params
    from detikzify_torch.ops import launch_counts, reset_launch_counts
    from detikzify_torch.ops.quant import fuse_projections, params_nbytes
    from detikzify_torch.parallel.mesh import join_group, make_mesh, \
        place_params
    from detikzify_torch.processing import ByteTokenizer, DetikzifyProcessor

    rehearsal = args.cpu_rehearsal
    tp_dir = Path(args.tp_dir)
    inputs = json.loads((tp_dir / "inputs.json").read_text())
    dev = join_group("cpu" if rehearsal else "cuda", args.tp_backend,
                     init_method=args.tp_init, rank=args.tp_rank,
                     world_size=args.tp_world)
    if not rehearsal:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    out = {"rank": args.tp_rank, "device": str(dev)}
    try:
        t0 = time.perf_counter()
        params, cfg = load_params(inputs["export_dir"], quantize=True,
                                  device="cpu",
                                  dtype=torch.float32 if rehearsal
                                  else torch.bfloat16)
        out["host_load_s"] = time.perf_counter() - t0
        # the card is the unsharded reference's until the parent says go
        deadline = time.monotonic() + TP_TIMEOUT_S
        while not (tp_dir / "go.json").exists():
            if time.monotonic() > deadline:
                raise SystemExit("tp rank: no go.json from the parent")
            time.sleep(0.2)
        inputs.update(json.loads((tp_dir / "go.json").read_text()))
        t0 = time.perf_counter()
        mesh = make_mesh(data=1, model=args.tp_world, device=dev)
        params = place_params(params, mesh, identical=True)
        fuse_projections(params)
        if not rehearsal:
            torch.cuda.synchronize(dev)
        out["place_s"] = time.perf_counter() - t0
        out["weights_bytes"] = params_nbytes(params)
        out["heads"] = list(params.text.layers[0].attn.heads)
        processor = DetikzifyProcessor(smoke_tokenizer(ByteTokenizer, cfg),
                                       cfg)
        rec = LogitRecorder(torch, cfg.image_token_id, TP_KEEP_CALLS)
        if not rehearsal:
            torch.cuda.reset_peak_memory_stats(dev)
        with rec.installed():
            legs = tp_legs(torch, dev, rehearsal, inputs["seed"], params,
                           processor, inputs["n_new"], rec,
                           hint=inputs["hint"])
        legs["top"], legs["rows"] = rec.collect()
        if not rehearsal:
            legs["max_memory_allocated_bytes"] = \
                torch.cuda.max_memory_allocated(dev)
        out["legs"] = legs
        del params, rec
        _free(torch, rehearsal)
        reset_launch_counts()
        out["train"] = tp_train_run(
            torch, dev, rehearsal, inputs["seed"],
            make_mesh(data=1, model=args.tp_world, device=dev))
        out["train"]["launches"] = launch_counts()
        # gloo's sum of a bf16 tensor (the collectives carry fp32 either
        # way): whether this build offers it, on this device
        try:
            x = torch.ones(4, dtype=torch.bfloat16, device=dev)
            dist.all_reduce(x)
            out["bf16_all_reduce"] = float(x[0])
        except RuntimeError as exc:
            out["bf16_all_reduce"] = f"refused: {exc}"[:200]
        # one decode step's collectives, each timed over 50 calls: a row-
        # parallel sum of 8 slots' hidden states and the gather of their
        # fp32 logits over the vocabulary
        out["collective_ms"] = {}
        for name, n in (("hidden_sum_8x%d" % cfg.text.hidden_size,
                         cfg.text.hidden_size),
                        ("logits_gather_8x%d" % cfg.text.vocab_size,
                         cfg.text.vocab_size)):
            x = torch.ones((8, n), device=dev)
            dist.all_reduce(x)
            if not rehearsal:
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for _ in range(50):
                dist.all_reduce(x)
            if not rehearsal:
                torch.cuda.synchronize(dev)
            out["collective_ms"][name] = (time.perf_counter() - t0) * 20
        torch.save(out, tp_dir / f"rank{args.tp_rank}.pt")
    finally:
        dist.destroy_process_group()
    return 0


def _tp_compare(torch, want: dict, got: dict) -> dict:
    """Each rollout of ``got`` against the unsharded one of ``want``
    (``spec_greedy``'s rule): they may part only at a near-tie, where the
    unsharded top-1 - top-2 gap is at most tau = 2 max|got - want| over
    the kept rows both computed from the same tokens (up to and at the
    first differing token)."""
    diffs, gaps, same, total = [], [], 0, 0
    for part, streams in want["streams"].items():
        for (slot, plen, w), (_, _, g) in zip(streams, got["streams"][part]):
            n = min(len(w), len(g))
            same += sum(x == y for x, y in zip(w[plen:n], g[plen:n]))
            total += len(w) - plen
            d = next((j for j in range(plen, n) if w[j] != g[j]), None)
            last = (len(w) - 1 if d is None else d) - 1  # input positions
            for p in range(plen - 1, last + 1):
                a = want["rows"].get((part, slot, p))
                b = got["rows"].get((part, slot, p))
                if a is not None and b is not None:
                    diffs.append(float((a - b).abs().max()))
            if d is not None:
                gaps.append({"part": part, "slot": slot,
                             "token_index": d - plen,
                             "top1_top2_gap": want["top"][
                                 (part, slot, d - 1)][1]})
    tau = 2 * max(diffs) if diffs else 0.0
    return {"identical_token_share": same / max(total, 1),
            "matched_rows": len(diffs),
            "max_abs_logits_diff": max(diffs) if diffs else None,
            "tau": tau, "divergences": gaps,
            "ok": bool(diffs) and all(g["top1_top2_gap"] <= tau
                                      for g in gaps)}


@contextlib.contextmanager
def tp_ranks(torch, rehearsal: bool, seed: int, export_dir: str, n_new: int,
             ranks: int = 2):
    """Start the tp phase's ``ranks`` processes (this script with
    ``--tp-rank``): nccl with one rank a card where the machine has as many
    cards, else gloo with every rank on ``cuda:0``. Each loads the export
    int8 on the host at once, beside the unsharded reference, and waits for
    ``tp_phase`` (its ``go.json``) before it touches the card. Every rank
    still running when the block ends is killed."""
    from detikzify_torch.parallel.dryrun import _free_port

    cards = 0 if rehearsal else torch.cuda.device_count()
    backend = "gloo" if rehearsal or cards < ranks else "nccl"
    tp_dir = Path(tempfile.mkdtemp(prefix="tp_", dir=ROOT / "build"))
    (tp_dir / "inputs.json").write_text(json.dumps({
        "export_dir": export_dir, "seed": seed, "n_new": n_new}))
    cmd = [sys.executable, str(ROOT / "chip_smoke.py"), "--tp-dir",
           str(tp_dir), "--tp-init", f"tcp://127.0.0.1:{_free_port()}",
           "--tp-world", str(ranks), "--tp-backend", backend]
    if rehearsal:
        cmd.append("--cpu-rehearsal")
    env = dict(os.environ, OMP_NUM_THREADS="1" if rehearsal else
               os.environ.get("OMP_NUM_THREADS", "4"))
    env.pop("LOCAL_RANK", None)
    run = {"dir": tp_dir, "ranks": ranks, "backend": backend,
           "cards": cards, "procs": [], "logs": []}
    try:
        for r in range(ranks):
            log = open(tp_dir / f"rank{r}.log", "w")
            run["logs"].append(log)
            run["procs"].append(subprocess.Popen(
                cmd + ["--tp-rank", str(r)], cwd=ROOT, env=env,
                stdout=log, stderr=subprocess.STDOUT))
        yield run
    finally:
        for p in run["procs"]:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in run["logs"]:
            log.close()
        shutil.rmtree(tp_dir, ignore_errors=True)


def tp_phase(torch, device, rehearsal: bool, ref: dict, run: dict) -> dict:
    """The mesh's model axis: releases the ranks of ``run`` (``tp_ranks``),
    each of which keeps its tensor-parallel shard of the int8 export at
    full width and depth and runs ``tp_legs`` and ``tp_train_run``
    (``tp_rank_main``), then holds what they saw against ``ref``
    (``tp_reference``). Checks: the first-step logits within
    ``TP_LOGITS_MIN_COSINE`` of the unsharded ones, every rollout equal to
    the unsharded one up to a near-tie (``_tp_compare``), the ranks'
    rollouts identical, K1, K2, K4 and K5 launched on every rank, the
    training losses within ``TRAIN_REF_LOSS_TOL`` of the unmeshed
    ``Trainer``'s."""
    import math

    tp_dir, ranks, procs = run["dir"], run["ranks"], run["procs"]
    cards, backend = run["cards"], run["backend"]
    legs = ref["legs"]
    hint = legs["streams"]["sample_batch"][0]
    t0 = time.perf_counter()
    (tp_dir / "go.tmp").write_text(json.dumps({"hint": hint[2][hint[1]:]}))
    (tp_dir / "go.tmp").rename(tp_dir / "go.json")
    deadline = time.monotonic() + TP_TIMEOUT_S
    while any(p.poll() is None for p in procs):
        if (time.monotonic() > deadline
                or any(p.returncode not in (None, 0) for p in procs)):
            break
        time.sleep(0.5)
    ranks_s = time.perf_counter() - t0
    if any(p.poll() != 0 for p in procs):
        tails = {r: (tp_dir / f"rank{r}.log").read_text()[-3000:]
                 for r in range(ranks)}
        raise SystemExit(f"tp: a rank failed (exit codes "
                         f"{[p.poll() for p in procs]}): {tails}")
    got = [torch.load(tp_dir / f"rank{r}.pt", weights_only=False)
           for r in range(ranks)]

    firsts = sorted({(s, plen - 1) for s, plen, _ in
                     legs["streams"]["sample_batch"]})
    want = torch.stack([legs["rows"][("sample_batch", s, p)]
                        for s, p in firsts])
    have = torch.stack([got[0]["legs"]["rows"][("sample_batch", s, p)]
                        for s, p in firsts])
    logits = _compare_logits(torch, have, want)
    logits["tolerance"] = f"min cosine >= {TP_LOGITS_MIN_COSINE}"
    parity = _tp_compare(torch, legs, got[0]["legs"])
    same_ranks = all(g["legs"]["streams"] == got[0]["legs"]["streams"]
                     for g in got[1:])
    counts = {path: {} for path in ("tp", "tp_spec", "tp_train")}
    per_rank = []
    for g in got:
        lc = dict(g["legs"]["launches"], tp_train=g["train"]["launches"])
        for path, c in lc.items():
            for name, n in c.items():
                counts[path][name] = counts[path].get(name, 0) + n
        per_rank.append({
            "rank": g["rank"], "device": g["device"], "heads": g["heads"],
            "weights_bytes": g["weights_bytes"],
            "host_load_s": g["host_load_s"], "place_s": g["place_s"],
            "sample_batch_s": g["legs"]["sample_batch_s"],
            "decode_tokens_per_s": g["legs"]["decode_tokens_per_s"],
            "ms_per_decode_step": g["legs"]["ms_per_decode_step"],
            "spec_s": g["legs"]["spec_s"],
            "spec_counters": g["legs"]["spec_counters"],
            "max_memory_allocated_bytes": g["legs"].get(
                "max_memory_allocated_bytes"),
            "train": {k: v for k, v in g["train"].items()
                      if k != "launches"},
            "launches": lc, "bf16_all_reduce": g["bf16_all_reduce"],
            "collective_ms": g["collective_ms"]})
    train_want = ref["train"]["losses"]
    train_errs = [abs(a - b) / abs(b) for a, b in
                  zip(got[0]["train"]["losses"], train_want)]
    result = {
        "phase": "tp", "preset": "tiny-test" if rehearsal
        else "detikzify-v2-8b", "weights": "int8 + fused", "ranks": ranks,
        "backend": "gloo" if rehearsal else backend, "cards": cards,
        "figures": TP_FIGURES, "new_tokens": legs["n_new"],
        "spec_new_tokens": legs["n_spec"], "speculate": SPECULATE,
        "ranks_s": ranks_s, "first_step_logits": logits,
        "greedy_parity": {k: v for k, v in parity.items() if k != "ok"},
        "tau_rule": "2 max|TP - unsharded| over the kept rows computed "
                    "from the same tokens",
        "ranks_identical": same_ranks,
        "unsharded": {
            "sample_batch_s": legs["sample_batch_s"],
            "decode_tokens_per_s": legs["decode_tokens_per_s"],
            "ms_per_decode_step": legs["ms_per_decode_step"],
            "spec_s": legs["spec_s"], "spec_counters": legs["spec_counters"],
            "max_memory_allocated_bytes": legs.get(
                "max_memory_allocated_bytes"),
            "train": ref["train"]},
        "per_rank": per_rank,
        "train_loss_rel_err": train_errs,
        "train_tolerance": f"loss {TRAIN_REF_LOSS_TOL} relative",
        "launches": counts}
    emit(result)
    if logits["min_cosine"] < TP_LOGITS_MIN_COSINE:
        raise SystemExit(f"tp: first-step logits off the unsharded ones: "
                         f"{logits}")
    if not parity["ok"]:
        raise SystemExit(f"tp: greedy streams parted from the unsharded "
                         f"ones above a near-tie: {parity}")
    if not same_ranks:
        raise SystemExit("tp: the ranks drew different tokens")
    if (len(train_errs) != 2 or not all(math.isfinite(x) for x in
                                        got[0]["train"]["losses"])
            or max(train_errs) > TRAIN_REF_LOSS_TOL):
        raise SystemExit(f"tp: the tensor-parallel trainer disagrees: "
                         f"{train_errs}")
    if not rehearsal:
        need = {"tp": ("flash_attention", "paged_decode", "int8_gemv"),
                "tp_spec": ("paged_verify", "int8_gemv"),
                "tp_train": ("flash_attention",)}
        for rank in per_rank:
            for path, names in need.items():
                for name in names:
                    if rank["launches"][path].get(name, 0) <= 0:
                        raise SystemExit(f"tp: rank {rank['rank']} never "
                                         f"launched {name} on {path}")
    return counts


def tp_only(torch, device, rehearsal: bool, args) -> int:
    """``--tp-only``: the tp phase alone on a random v2-8b drawn from the
    seed, exported by ``save_pretrained`` and quantized and fused in place
    for the unsharded reference."""
    from detikzify_torch.config import get_config
    from detikzify_torch.models import convert
    from detikzify_torch.models.load import save_pretrained
    from detikzify_torch.ops.quant import fuse_projections, quantize_params
    from detikzify_torch.processing import ByteTokenizer, DetikzifyProcessor

    cfg = get_config("tiny-test" if rehearsal else "detikzify-v2-8b")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = convert.init_random(cfg, device=device, generator=gen,
                                 dtype=torch.float32 if rehearsal
                                 else torch.bfloat16)
    processor = DetikzifyProcessor(smoke_tokenizer(ByteTokenizer, cfg), cfg)
    (ROOT / "build").mkdir(exist_ok=True)
    export_dir = tempfile.mkdtemp(prefix="load_", dir=ROOT / "build")
    try:
        save_pretrained(export_dir, params, cfg)
        fuse_projections(quantize_params(params))
        ref = tp_reference(torch, device, rehearsal, args.seed, params,
                           processor, args.max_new_tokens)
        del params
        _free(torch, rehearsal)
        for ranks in args.tp_ranks:
            with tp_ranks(torch, rehearsal, args.seed, export_dir,
                          args.max_new_tokens, ranks) as run:
                tp_phase(torch, device, rehearsal, ref, run)
    finally:
        shutil.rmtree(export_dir, ignore_errors=True)
    return 0


def verify_real_fp32_checkpoint(torch, device, rehearsal: bool, seed: int,
                                work: str):
    """``VERIFY_REAL_FP32_PRESET`` whole, random bf16 weights from ``seed``,
    written as a v1 checkpoint and its timm tower (``write_v1_checkpoint``)
    under ``work``; in the rehearsal, tiny-test through ``save_pretrained``
    (a tiny timm tower has no config the loader could read). Returns
    (config, checkpoint, tower or None)."""
    from detikzify_torch.config import get_config
    from detikzify_torch.models import convert
    from detikzify_torch.models.load import save_pretrained

    cfg = (get_config("tiny-test") if rehearsal
           else v1_config(False, preset=VERIFY_REAL_FP32_PRESET))
    gen = torch.Generator(device=device).manual_seed(seed + 17)
    params = convert.init_random(cfg, device=device, dtype=torch.bfloat16,
                                 generator=gen)
    ckpt, tower = os.path.join(work, "checkpoint"), None
    if rehearsal:
        save_pretrained(ckpt, params, cfg)
    else:
        tower = os.path.join(work, "tower")
        write_v1_checkpoint(torch, params, cfg, ckpt, tower)
    del params
    _free(torch, rehearsal)
    return cfg, ckpt, tower


def verify_real_phase(torch, device, rehearsal: bool, seed: int, cfg,
                      export_dir: str, max_new_tokens: int) -> dict:
    """``detikzify_torch.tools.verify_real`` in two legs, each a path of its
    own, the smoke tokenizer standing in for each checkpoint's:

    * ``verify_real`` -- the ``load`` phase's v2-8b export (``cfg``) with
      no flag: ``import`` (the fp32 tree on the host), ``serve_load``
      (above 3 B parameters on a card the serve rule quantizes: int8
      weight-only, bf16 cache) and ``eval_smoke`` (``VERIFY_REAL_ITEMS``
      synthetic items: search to the first compilable program, then every
      metric of ``examples.eval``'s ``score``) on those int8 weights. The
      rehearsal's tiny export is under the line and passes ``--quantize``;
    * ``verify_real_fp32`` -- ``VERIFY_REAL_FP32_PRESET``
      (``verify_real_fp32_checkpoint``), no flag: ``import``,
      ``serve_load`` (the fp32 tree on the card, fp32 cache, as the JAX
      runbook serves a checkpoint under 3 B parameters),
      ``spec_acceptance`` (speculate=4) and ``bench`` on it: K1's fp32
      kernel on the tower and the prefill, K4's and K2's fp32 kernels, and
      no int8 product.

    The three reference steps must report ``not_run``."""
    from detikzify_torch.ops import launch_counts, reset_launch_counts
    from detikzify_torch.tools import verify_real

    (ROOT / "build").mkdir(exist_ok=True)
    work = tempfile.mkdtemp(prefix="verify_real_", dir=ROOT / "build")
    tokens = ["--spec-tokens", str(min(VERIFY_REAL_SPEC_TOKENS,
                                       max_new_tokens)),
              "--bench-tokens", str(min(VERIFY_REAL_BENCH_TOKENS,
                                        max_new_tokens))]
    result = {"phase": "verify_real"}
    paths = {}
    try:
        for path in ("verify_real", "verify_real_fp32"):
            if path == "verify_real":
                ckpt, tower, lcfg = export_dir, None, cfg
                flags = ["--quantize"] if rehearsal else []
                steps = ("import", "serve_load", "eval_smoke")
                serve, quantized = ("int8", "bfloat16"), True
                preset = "tiny-test" if rehearsal else "detikzify-v2-8b"
            else:
                t0 = time.perf_counter()
                lcfg, ckpt, tower = verify_real_fp32_checkpoint(
                    torch, device, rehearsal, seed, work)
                result["fp32_export_s"] = time.perf_counter() - t0
                flags = tokens + (["--vision-tower", tower] if tower
                                  else [])
                steps = ("import", "serve_load", "spec_acceptance", "bench")
                serve, quantized = ("fp32", "float32"), False
                preset = ("tiny-test" if rehearsal
                          else VERIFY_REAL_FP32_PRESET)
            _, args = verify_real.parse_args(
                ["--checkpoint", f"{path}={ckpt}", "--device", str(device),
                 "--eval-items", str(VERIFY_REAL_ITEMS), "--workdir", work]
                + flags)
            reset_launch_counts()
            with checkpoint_tokenizer(lcfg,
                                      lcfg.image_seq_len + max_new_tokens):
                t0 = time.perf_counter()
                out = verify_real.verify_checkpoint(path, ckpt, args,
                                                    steps=steps)
                wall = time.perf_counter() - t0
            paths[path] = launch_counts()
            _free(torch, rehearsal)
            verdict = verify_real.verdict_of({path: out})
            result[path] = {"preset": preset, "flags": flags,
                            "steps": {k: v for k, v in out.items()
                                      if isinstance(v, dict)},
                            "verdict": verdict["verdict"], "wall_s": wall,
                            "launches": paths[path]}
            leg = result[path]["steps"]
            got = (leg["serve_load"].get("mode"),
                   leg["serve_load"].get("cache_dtype"))
            n = leg["import"].get("n_params", 0)
            # on the card the rule alone decides: int8 above 3 B, fp32 below
            by_rule = rehearsal or (n > 3_000_000_000) == quantized
            if not (verdict["verdict"] == "pass"
                    and all(leg[s]["ok"] for s in steps)
                    and all(leg[s]["ok"] is None
                            for s in verify_real.REFERENCE_STEPS)
                    and got == serve
                    and leg["import"]["serve_quantized"] == quantized
                    and by_rule):
                emit(result)
                raise SystemExit(f"{path} failed (serve_load {got}, want "
                                 f"{serve}; {n} parameters): "
                                 f"{result[path]}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit(result)
    if not rehearsal:
        counts = paths["verify_real"]
        for name in ("flash_attention", "paged_decode", "int8_gemv"):
            if counts[name] <= 0:
                raise SystemExit(f"verify_real never launched {name}")
        counts = paths["verify_real_fp32"]
        for name in ("flash_attention_f32", "paged_verify_f32",
                     "paged_decode_f32"):
            if counts[name] <= 0:
                raise SystemExit(f"verify_real_fp32 never launched {name}")
        if counts["int8_gemv"] != 0:
            raise SystemExit("verify_real_fp32 launched int8_gemv "
                             f"{counts['int8_gemv']} times")
    return paths


def training_phases(torch, device, rehearsal: bool, seed: int) -> dict:
    """The training reference, then ``train`` (the step and the
    ``Trainer``) and ``pretrain``; the post-training reference, ``grpo`` on
    the same weights, then ``adapter_pretrain`` and ``adapter_train`` on
    ``tikzero-adapter``'s. Each path's launches are counted from 0 just
    before it and read just after."""
    from detikzify_torch.ops import launch_counts, reset_launch_counts

    train_reference_phase(torch, device, rehearsal, seed)
    reset_launch_counts()
    params, cfg, processor = train_phase(torch, device, rehearsal, seed)
    trainer_phase(torch, device, rehearsal, seed, params, cfg, processor)
    paths = {"train": launch_counts()}
    paths["mesh"] = mesh_phase(torch, device, rehearsal, seed, params, cfg,
                               processor)
    reset_launch_counts()
    pretrain_phase(torch, device, rehearsal, seed, params, cfg, processor)
    paths["pretrain"] = launch_counts()
    posttrain_reference_phase(torch, device, rehearsal, seed)
    reset_launch_counts()
    grpo_phase(torch, device, rehearsal, seed, params, cfg, processor)
    paths["grpo"] = launch_counts()
    del params
    _free(torch, rehearsal)
    params, cfg, bundle, processor = tikzero_train_weights(
        torch, device, rehearsal, seed)
    reset_launch_counts()
    adapter_pretrain_phase(torch, device, rehearsal, seed, params, cfg,
                           bundle)
    paths["adapter_pretrain"] = launch_counts()
    reset_launch_counts()
    adapter_train_phase(torch, device, rehearsal, seed, params, cfg, bundle,
                        processor)
    paths["adapter_train"] = launch_counts()
    del params, bundle
    _free(torch, rehearsal)
    if not rehearsal:
        for path, counts in paths.items():
            if counts["flash_attention"] <= 0:
                raise SystemExit(f"{path} never launched flash_attention")
            # GRPO's rollouts decode through the page pool (K2)
            if (counts["paged_decode"] > 0) != (path == "grpo"):
                raise SystemExit(f"{path} launched paged_decode "
                                 f"{counts['paged_decode']} times")
            for name in ("decode_contig", "paged_verify", "int8_gemv"):
                if counts[name] != 0:
                    raise SystemExit(f"{path} launched {name}")
    emit({"phase": "training_launches", **paths})
    return paths


def _has_pygments() -> bool:
    try:
        import pygments  # noqa: F401
    except ImportError:
        return False
    return True


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
    ap.add_argument("--eager", action="store_true",
                    help="build every decode engine with graphs=False (an "
                         "A/B of the whole script against its CUDA graphs; "
                         "the graphs phase keeps its graph runs)")
    ap.add_argument("--tp-ranks", default="2",
                    type=lambda s: [int(x) for x in s.split(",")],
                    help="the tp phase's model axis (nccl with one rank a "
                         "card when the machine has that many cards, else "
                         "gloo on cuda:0); --tp-only takes a list, 2,4")
    ap.add_argument("--tp-only", action="store_true",
                    help="build the kernels, draw a random v2-8b, export "
                         "it and run the tp phase alone (no result line)")
    for flag, kind in (("--tp-rank", int), ("--tp-world", int),
                       ("--tp-dir", str), ("--tp-init", str),
                       ("--tp-backend", str)):     # a rank of the tp phase
        ap.add_argument(flag, type=kind, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.tp_rank is not None:
        return tp_rank_main(args)
    # a crash in native code prints every thread's Python stack
    faulthandler.enable(all_threads=True)

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

    if args.tp_only:
        return tp_only(torch, device, rehearsal, args)
    if args.eager:
        engines = eager_engines()
        engines.__enter__()
    emit({"phase": "engines", "graphs": "off (--eager)" if args.eager
          else "on a card unless a phase builds its engines eagerly"})
    rows = kernel_phase(torch, device, rehearsal, args.iters)
    if args.skip_main:      # a kernel-only run prints no result line
        emit({"kernels": rows})
        return 0
    from detikzify_torch.infer import FakeBackend, set_backend

    reference_phase(torch, device, rehearsal, args.seed)
    reference_phase(torch, device, rehearsal, args.seed, v1=True)
    reference_phase(torch, device, rehearsal, args.seed, tikzero=True)
    clip_reference_phase(torch, device, rehearsal, args.seed)
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
    side = min(SIDE_NEW_TOKENS, args.max_new_tokens)
    paths.update(tikzero_phases(torch, device, rehearsal, args.seed, params,
                                processor, side))
    # export the bf16 weights and load them back int8: what simulate runs;
    # the exported checkpoint stays for the phases that load it through
    # the command-line entry points
    (ROOT / "build").mkdir(exist_ok=True)
    export_dir = tempfile.mkdtemp(prefix="load_", dir=ROOT / "build")
    try:
        paths["load"], qparams = load_phase(torch, device, rehearsal, params,
                                            processor, export_dir)
        del params
        paths["simulate"] = simulate_phase(
            torch, device, rehearsal, args.seed, qparams, processor,
            args.max_new_tokens,
            preset="tiny-test" if rehearsal else "detikzify-v2-8b")
        paths.update(simulate_spec_phase(torch, device, rehearsal, args.seed,
                                         qparams, processor,
                                         args.max_new_tokens))
        paths.update(pipelined_phase(
            torch, device, rehearsal, args.seed, qparams, processor,
            min(PIPE_NEW_TOKENS, 2 * args.max_new_tokens)))
        paths.update(graphs_phase(
            torch, device, rehearsal, args.seed, qparams, processor,
            min(GRAPH_NEW_TOKENS, args.max_new_tokens)))
        paths["serve"] = serve_phase(torch, device, rehearsal, args.seed,
                                     qparams, processor.cfg, side)
        paths.update(evaluate_phase(torch, device, rehearsal, args.seed,
                                    processor.cfg, export_dir, side))
        paths.update(verify_real_phase(torch, device, rehearsal, args.seed,
                                       processor.cfg, export_dir, side))
        paths.update(replicas_phase(torch, device, rehearsal, args.seed,
                                    qparams, processor.cfg, side))
        paths["trace"] = trace_phase(torch, device, rehearsal, args.seed,
                                     qparams, processor)
        tp_new = min(TP_NEW_TOKENS, args.max_new_tokens)
        with tp_ranks(torch, rehearsal, args.seed, export_dir, tp_new,
                      args.tp_ranks[0]) as run:
            tp_ref = tp_reference(torch, device, rehearsal, args.seed,
                                  qparams, processor, tp_new)
            del qparams
            _free(torch, rehearsal)
            paths.update(tp_phase(torch, device, rehearsal, tp_ref, run))
        del tp_ref
        _free(torch, rehearsal)
        paths.update(infer_cli_phase(torch, device, rehearsal, args.seed,
                                     processor.cfg, export_dir, side))
    finally:
        shutil.rmtree(export_dir, ignore_errors=True)
    _free(torch, rehearsal)
    paths["serve_bench"] = serve_bench_phase(torch, device, rehearsal)
    paths.update(spec_acceptance_phase(torch, device, rehearsal, args.seed))
    paths.update(ds7b_phase(torch, device, rehearsal, args.seed))
    paths.update(v1_phases(torch, device, rehearsal, args.seed, side))
    _free(torch, rehearsal)
    k1_backward_phase(torch, device, rehearsal, args.iters)
    paths.update(training_phases(torch, device, rehearsal, args.seed))
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
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    # The result is printed and every process the script started has
    # ended. Skip the interpreter's teardown: it runs the static
    # destructors of the CUDA runtimes (PyTorch's and the one linked into
    # each kernel library) and of the profiler's CUPTI, which the check
    # does not measure and whose order is not fixed.
    os._exit(code)
