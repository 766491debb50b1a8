"""BPE-realistic speculative-decoding acceptance measurement (counterpart
of ``detikzify_tpu/evaluate/spec_acceptance.py``).

Measures ``engine.spec_rate`` under conditions that match real
deployments:

  * a byte-level BPE tokenizer trained on TikZ text (``evaluate.bpe``; the
    committed ``spec_bpe_300.json`` where ``tokenizers`` is absent),
  * a model OVERFIT on a few hundred TikZ programs (so generations are
    locally coherent TikZ, like a trained checkpoint's),
  * greedy (T=0) and reference sampling (T=0.8/top-p 0.95) regimes,
  * with and without cross-rollout hints (the MCTS parent-continuation
    draft source).

On every device the model is the JAX package's exactly: 4 heads of 32 in
fp32, with an fp32 page pool (on the card through K1's fp32 kernel and the
fp32 K2 and K4); the result names the ``head_dim`` and ``dtype`` it ran
at.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import DetikzifyConfig, TextConfig, VisionConfig
from ..dataset.synthetic import generate_corpus
from .bpe import ByteLevelBPE


def train_bpe_tokenizer(corpus: Sequence[str], vocab_size: int = 512
                        ) -> ByteLevelBPE:
    """Byte-level BPE trained on the corpus (the real models' tokenizer
    family), as the port's ``ByteLevelBPE``. Needs the ``tokenizers``
    package (not on the card's machine: there, ``ByteLevelBPE.from_file``
    reads the committed vocabulary)."""
    from tokenizers import (Tokenizer, decoders, models, pre_tokenizers,
                            trainers)

    tok = Tokenizer(models.BPE(unk_token=None))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(
        vocab_size=vocab_size - 3,
        special_tokens=["<pad>", "<s>", "</s>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    tok.train_from_iterator(corpus, trainer)
    model = json.loads(tok.to_str())["model"]
    merges = [tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m)
              for m in model["merges"]]
    return ByteLevelBPE(model["vocab"], merges)


def spec_model_config(vocab_size: int) -> DetikzifyConfig:
    """Small-but-capable decoder for overfitting the corpus: the JAX
    package's, hidden 128, 4 layers of 4 heads of 32, fp32."""
    return DetikzifyConfig(
        vision=VisionConfig(hidden_size=48, intermediate_size=96,
                            num_hidden_layers=2, num_attention_heads=4,
                            image_size=42, patch_size=14),
        text=TextConfig(vocab_size=vocab_size + 1, hidden_size=128,
                        intermediate_size=256, num_hidden_layers=4,
                        num_attention_heads=4, num_key_value_heads=4,
                        max_position_embeddings=1024, rope_theta=10000.0),
        image_token_id=vocab_size,      # unused: text-only overfit
        bos_token_id=1, eos_token_id=2, pad_token_id=0,
        model_max_length=640, dtype="float32")


def overfit(cfg: DetikzifyConfig, token_rows: List[List[int]],
            steps: int = 400, lr: float = 3e-3, batch: int = 8,
            width: int = 128, seed: int = 0, log_fn=None, *,
            params=None, device="cuda", on_loss=None):
    """Overfit a model on packed token rows with Adam (the port's
    ``train.step``: ``AdamW`` with weight decay 0, no clip and a constant
    learning rate is ``optax.adam``); the batches are the JAX function's,
    drawn from ``np.random.default_rng(seed)``. ``params`` (default: random
    from ``seed`` in ``cfg.dtype``) train in place. Returns ``(params,
    last loss)``; ``on_loss(step, loss tensor)`` sees every step's loss."""
    from ..models import convert
    from ..train.step import AdamW, TrainState, make_train_step

    if params is None:
        params = convert.init_random(cfg, device=device,
                                     dtype=getattr(torch, cfg.dtype),
                                     seed=seed)
    dev = next(params.parameters()).device
    for p in params.parameters():
        p.requires_grad_(p.is_floating_point())
    flat: List[int] = []
    for row in token_rows:
        flat.extend([cfg.bos_token_id] + row + [cfg.eos_token_id])
    data = np.asarray(flat, np.int32)
    opt = AdamW(lambda count: lr, b1=0.9, b2=0.999, eps=1e-8,
                weight_decay=0.0, grad_clip=None)
    state = TrainState(params, opt.init(params), 0)
    step = make_train_step(cfg, opt)

    rng = np.random.default_rng(seed)
    n = len(data) - width - 1
    loss = None
    for it in range(steps):
        offs = rng.integers(0, n, (batch,))
        ids = torch.from_numpy(np.stack([data[o:o + width] for o in offs])
                               ).to(dev)
        state, metrics = step(state, {"input_ids": ids, "labels": ids})
        loss = metrics["loss"]
        if on_loss is not None:
            on_loss(it, loss)
        if log_fn and it % 100 == 0:
            log_fn(f"overfit step {it}: loss {float(loss):.3f}")
    for p in params.parameters():
        p.requires_grad_(False)
    return params, float(loss)


def measure_spec_rate(params, cfg: DetikzifyConfig,
                      prompts: List[List[int]],
                      conts: Optional[List[List[int]]] = None,
                      *, temperature: float, speculate: int = 4,
                      max_new: int = 48, num_slots: int = 8,
                      use_hints: bool = False, seed: int = 0) -> float:
    """Run all prompts through a speculative engine on ``params``' device
    with a page pool of the model's dtype (fp32, as the JAX function's);
    returns measured tokens-per-step (1 = no draft accepted, speculate+1 =
    all)."""
    from ..engine import DecodeEngine
    from ..ops.sampling import SamplingParams

    dev = next(params.parameters()).device
    eng = DecodeEngine(
        params, cfg, num_slots=num_slots, max_len=cfg.model_max_length,
        speculate=speculate, spec_min_rate=0.0,
        cache_dtype=getattr(torch, cfg.dtype),
        sampling=SamplingParams(temperature=temperature, top_p=0.95),
        prefix_budget_bytes=1 << 24, device=dev, seed=seed)
    queue = list(range(len(prompts)))
    active = []
    while queue or active:
        while queue and eng.num_free_slots > 0:
            i = queue.pop()
            hint = (conts[i] if use_hints and conts is not None else None)
            active.append(eng.start(list(prompts[i]), max_new_tokens=max_new,
                                    lazy=True, hint=hint))
        eng.step()
        for ro in list(active):
            if ro.finished:
                eng.release(ro)
                active.remove(ro)
    return eng.spec_rate


def run_measurement(tok: Optional[ByteLevelBPE] = None,
                    n_programs: int = 300, steps: int = 400,
                    n_eval: int = 24, log_fn=print, *,
                    device="cuda") -> Dict[str, object]:
    """Full pipeline: corpus -> BPE (``tok``, default the committed
    vocabulary) -> overfit -> acceptance table, on JAX's model (4 heads of
    32 in fp32) on every device."""
    corpus = generate_corpus(n_programs, seed=0)
    tok = tok if tok is not None else ByteLevelBPE.from_file()
    cfg = spec_model_config(len(tok))
    rows = [tok.encode(c, add_special_tokens=False) for c in corpus]
    params, loss = overfit(cfg, rows, steps=steps, log_fn=log_fn,
                           device=device)

    prompts, conts = [], []
    for row in rows[:n_eval]:
        prompts.append([cfg.bos_token_id] + row[:8])
        conts.append(row[8:])
    out: Dict[str, object] = {"overfit_loss": round(loss, 3),
                              "head_dim": cfg.text.head_dim,
                              "dtype": cfg.dtype}
    # JAX's three rates, and the greedy rate with hints beside them
    for name, t, hints in [("spec_rate_bpe_t0", 0.0, False),
                           ("spec_rate_bpe_t0_hint", 0.0, True),
                           ("spec_rate_bpe_t08", 0.8, False),
                           ("spec_rate_bpe_t08_hint", 0.8, True)]:
        rate = measure_spec_rate(params, cfg, prompts, conts,
                                 temperature=t, use_hints=hints)
        out[name] = round(rate, 3)
        if log_fn:
            log_fn(f"{name}: {rate:.2f} tok/step")
    return out
