"""GRPO post-training (RL from SelfSim feedback; counterpart of
``detikzify_tpu/train/grpo.py``).

Reference ``examples/refine.py`` drives trl's ``GRPOTrainer`` with a
SelfSim ``RewardFunc`` (:151-263): group-relative policy optimization where
each figure prompts ``num_generations`` rollouts from the decode engine,
rewards are SelfSim scores of the compiled renders (-1 when uncompilable,
reference :171-185), advantages are group-normalized, and the policy
updates with a clipped surrogate (+ optional KL-to-reference penalty).

The sampling side reuses the inference engine (continuous batching + root
prefix reuse), so generation runs at inference speed; only the scoring
pass and the update are extra.

Where the JAX package relies on immutable arrays, the port copies:
``refine`` trains a copy of the caller's connector and text tower (and of
the tower when it trains too), so the caller's ``params`` stay the t=0
policy, the KL anchor. The engine holds the policy by reference
(``engine.params``) and reads its weights at every step, so each update
reaches the next rollouts.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from ..config import DetikzifyConfig
from ..engine import DecodeEngine
from ..infer.tikz import CompileService
from ..models import detikzify
from ..models.convert import leaves
from ..models.detikzify import Params
from .step import AdamW


@dataclasses.dataclass
class GRPOConfig:
    num_generations: int = 32          # reference refine.py:199
    max_new_tokens: int = 512
    learning_rate: float = 1e-6
    clip_eps: float = 0.2
    beta: float = 0.0                  # KL-to-reference coefficient
    grad_clip: float = 1.0
    strict: bool = False               # treat recoverable errors as fatal
    freeze_encoder: bool = True        # reference refine.py:198-207
    speculate: int = 0                 # n-gram speculative rollout decoding
                                       # (auto bail-out if drafts don't pay)
    updates_per_batch: int = 1         # PPO-style epochs per rollout batch;
                                       # > 1 pins old_logprobs to the
                                       # rollout policy so later epochs use
                                       # the true clipped-ratio objective


class GRPOState(NamedTuple):
    params: nn.Module             # the policy, updated in place by a step
    opt_state: dict
    step: int


def sequence_logprobs(params: Params, cfg: DetikzifyConfig,
                      tokens: torch.Tensor,             # [B, S]
                      pixel_values: Optional[torch.Tensor],
                      completion_mask: torch.Tensor,    # [B, S] True sampled
                      image_embeds: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Per-token logprobs of tokens[t] given tokens[<t]; 0 where masked."""
    logits, _ = detikzify.forward(params, cfg, tokens, pixel_values,
                                  image_embeds=image_embeds)
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    target = tokens[:, 1:].long()
    token_lp = torch.gather(logp, -1, target[..., None])[..., 0]
    return torch.where(completion_mask[:, 1:], token_lp,
                       torch.zeros_like(token_lp))


def make_grpo_step(cfg: DetikzifyConfig, optimizer, gcfg: GRPOConfig):
    """(state, batch) -> (state, metrics). Batch tensors:
    tokens [B,S], completion_mask [B,S], advantages [B], and one of
    pixel_values [B,H,W,C] (grads through the tower) or vision_feats
    [B,N*cf,Dv] (frozen TOWER: features precomputed outside the grad
    graph, but the connector projection applied INSIDE it -- reference
    refine.py:204-205 freezes only ``vision_model``; the connector
    trains); optional old_logprobs [B,S-1] (absent = rollouts came from
    the CURRENT policy, the single-update-per-batch case: ratio is then
    exp(lp - lp.detach()), saving a whole forward pass) and ref_logprobs
    [B,S-1] (required when beta > 0). The step differentiates the
    policy's leaves that require a gradient and hands their gradients to
    ``optimizer.update(params, {tensor: grad}, opt_state)`` (the interface
    of ``step.AdamW``)."""

    def loss_fn(params, batch):
        image_embeds = None
        if "vision_feats" in batch:
            image_embeds = detikzify.connector(
                params, batch["vision_feats"], cfg.concat_factor)
        lp = sequence_logprobs(params, cfg, batch["tokens"],
                               batch.get("pixel_values"),
                               batch["completion_mask"],
                               image_embeds=image_embeds)
        mask = batch["completion_mask"][:, 1:]
        old_lp = batch.get("old_logprobs")
        if old_lp is None:
            old_lp = lp.detach()
        ratio = torch.exp(lp - old_lp)
        adv = batch["advantages"][:, None]
        unclipped = ratio * adv
        clipped = ratio.clamp(1 - gcfg.clip_eps, 1 + gcfg.clip_eps) * adv
        pg = -torch.minimum(unclipped, clipped)
        if gcfg.beta > 0:
            # k3 KL estimator (Schulman): exp(ref-lp) - (ref-lp) - 1
            delta = batch["ref_logprobs"] - lp
            pg = pg + gcfg.beta * (torch.exp(delta) - delta - 1.0)
        denom = mask.sum().clamp(min=1).float()

        def masked_mean(x):
            return torch.where(mask, x, torch.zeros_like(x)).sum() / denom

        # ratio_mean is identically 1 in the implied-old_logprobs path;
        # logp_mean tracks the policy's own confidence either way
        return masked_mean(pg), {"ratio_mean": masked_mean(ratio.detach()),
                                 "logp_mean": masked_mean(lp.detach())}

    def step(state: GRPOState, batch):
        params = state.params
        trained = [p for p in params.parameters() if p.requires_grad]
        if not trained:
            raise ValueError("no parameter requires a gradient")
        loss, aux = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, trained, allow_unused=True)
        # a leaf the loss does not reach has a zero gradient, as in JAX
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, trained)]
        opt_state = optimizer.update(params, dict(zip(trained, grads)),
                                     state.opt_state)
        return (GRPOState(params, opt_state, state.step + 1),
                {"loss": loss.detach(), **aux})

    return step


def make_refine_optimizer(params: Params, gcfg: GRPOConfig) -> AdamW:
    """``refine``'s optimizer: the JAX package's ``optax.chain(
    clip_by_global_norm(grad_clip), adamw(learning_rate))``, under a
    ``multi_transform`` that freezes the vision tower when
    ``freeze_encoder``. As ``optax.adamw``: a constant learning rate,
    weight decay 1e-4, eps 1e-8, moments in the parameters' dtype; the
    clipping norm over the trainable leaves only; a frozen leaf has no
    state and no update. Sets ``requires_grad`` leaf by leaf to match."""
    trainable = None
    if gcfg.freeze_encoder:
        trainable = {}
        for leaf in leaves(params):
            train = not leaf.path.startswith("vision/")
            trainable[leaf.path] = "train" if train else "freeze"
            for t in leaf.tensors:
                t.requires_grad_(train)
    else:
        params.requires_grad_(True)
    lr = gcfg.learning_rate
    return AdamW(lambda count: lr, b1=0.9, b2=0.999, eps=1e-8,
                 weight_decay=1e-4, grad_clip=gcfg.grad_clip, moments=None,
                 trainable=trainable)


class SelfSimReward:
    """Reward = SelfSim(render, input) if compilable else -1
    (reference ``RewardFunc``, refine.py:151-185). Compiles run through the
    async pool and renders score as one batched encoder pass."""

    def __init__(self, metric, compile_service: Optional[CompileService]
                 = None, strict: bool = False, size: int = 420):
        self.metric = metric
        self.compiler = compile_service or CompileService()
        self.strict = strict
        self.size = size

    def __call__(self, images: List, codes: List[str]) -> np.ndarray:
        futures = [self.compiler.submit(code) for code in codes]
        docs = [f.result() for f in futures]
        rewards = np.full((len(codes),), -1.0)
        good = [(i, doc.rasterize(self.size)) for i, doc in enumerate(docs)
                if doc.is_rasterizable
                and not (self.strict and doc.compiled_with_errors)]
        if good:
            idx = [i for i, _ in good]
            renders = [img for _, img in good]
            refs = [images[i] for i in idx]
            rewards[idx] = self.metric.score_batch(renders, refs)
        return rewards


def group_advantages(rewards: np.ndarray, group_size: int) -> np.ndarray:
    """(r - mean_group) / (std_group + eps), per prompt group."""
    grouped = rewards.reshape(-1, group_size)
    mean = grouped.mean(axis=1, keepdims=True)
    std = grouped.std(axis=1, keepdims=True)
    return ((grouped - mean) / (std + 1e-4)).reshape(-1)


def refine(
    params: Params,
    cfg: DetikzifyConfig,
    processor,
    images: List,                       # training figures (PIL)
    reward_fn: Callable,                # (images, codes) -> rewards
    *,
    gcfg: Optional[GRPOConfig] = None,
    engine: Optional[DecodeEngine] = None,
    steps: int = 10,
    prompts_per_step: int = 1,
    seed: int = 0,
    log_fn=print,
) -> Params:
    """Run GRPO for ``steps`` rollout batches; returns the refined policy
    (new ``Params``; the weights of ``params`` are not changed, and with
    ``freeze_encoder`` the two share the vision tower, whose leaves are
    left not requiring a gradient). Runs where ``params`` live; an
    ``engine`` passed in samples from the policy."""
    from ..ops.sampling import SamplingParams
    from ..processing import preprocess_image

    gcfg = gcfg or GRPOConfig()
    g = gcfg.num_generations
    vision = (params.vision if gcfg.freeze_encoder
              else copy.deepcopy(params.vision))
    policy = Params.of(vision, copy.deepcopy(params.connector),
                       copy.deepcopy(params.text))
    device = policy.device
    engine = engine or DecodeEngine(
        policy, cfg, num_slots=min(g, 16),
        max_len=cfg.image_seq_len + 2 + gcfg.max_new_tokens,
        speculate=gcfg.speculate,
        sampling=SamplingParams(), device=device)
    optimizer = make_refine_optimizer(policy, gcfg)
    state = GRPOState(policy, optimizer.init(policy), 0)
    # KL anchor: the t=0 policy, the caller's weights (never trained)
    ref_params = params if gcfg.beta > 0 else None
    step_fn = make_grpo_step(cfg, optimizer, gcfg)

    @torch.no_grad()
    def logprob_fn(p, tokens, completion_mask, image_embeds, pixel_values):
        return sequence_logprobs(p, cfg, tokens, pixel_values,
                                 completion_mask, image_embeds=image_embeds)

    @torch.no_grad()
    def feats_fn(p, px):
        return detikzify.vision_features(p, cfg, px)

    @torch.no_grad()
    def proj_fn(p, f):
        return detikzify.connector(p, f, cfg.concat_factor)

    rng = np.random.default_rng(seed)
    size = cfg.vision.image_size
    # rollouts pad to ONE width for every step (the JAX package's static
    # update shape)
    prompt = [cfg.image_token_id] * cfg.image_seq_len
    width = min(len(prompt) + gcfg.max_new_tokens, engine.max_len - 1)
    pad = cfg.pad_token_id

    for it in range(steps):
        engine.params = state.params   # sample from the CURRENT policy
        batch_imgs = [images[int(rng.integers(len(images)))]
                      for _ in range(prompts_per_step)]
        all_rollouts: List[List[int]] = []
        feats_rows, pixels_rows = [], []
        for p_idx, image in enumerate(batch_imgs):
            pixels = torch.from_numpy(preprocess_image(image, size))[None]
            pixels = pixels.to(device)
            pixels_rows.append(pixels)
            # frozen tower: one vision pass per image serves sampling AND
            # the update; the CONNECTOR projection stays inside the grad
            # graph (reference refine.py:204-205 freezes vision_model
            # only), so rollouts project the features with current params
            feats = feats_fn(state.params, pixels)
            feats_rows.append(feats)
            image_embeds = proj_fn(state.params, feats)

            # --- rollout phase: g generations via continuous batching ---
            rollouts, pending = [], []
            started = 0
            root_prefix = None
            ns = ("grpo", it, p_idx)
            while started < g or pending:
                n = min(engine.num_free_slots, g - started)
                if n > 0:
                    # whole wave in ONE fused start program (start_many)
                    ros = engine.start_many(
                        [list(prompt)] * n, image_embeds=image_embeds,
                        max_new_tokens=gcfg.max_new_tokens,
                        prefix=root_prefix)
                    pending.extend(ros)
                    started += n
                engine.step()
                for ro in list(pending):
                    if ro.finished:
                        if root_prefix is None:
                            root_prefix = engine.store_prefix(
                                ns, ro, length=len(prompt), namespace=ns)
                        rollouts.append(list(ro.token_ids))
                        engine.release(ro)
                        pending.remove(ro)
            engine.drop_namespace(ns)
            all_rollouts.extend(rollouts)

        b = prompts_per_step * g
        codes = [processor.decode(ids[len(prompt):],
                                  skip_special_tokens=True)
                 for ids in all_rollouts]
        imgs_flat = [img for img in batch_imgs for _ in range(g)]
        rewards = np.asarray(reward_fn(imgs_flat, codes), np.float64)
        advantages = group_advantages(rewards, g)

        # --- update phase (one [B, width] shape for all steps) ---
        tokens = np.full((b, width), pad, np.int32)
        comp_mask = np.zeros((b, width), bool)
        for i, ids in enumerate(all_rollouts):
            tokens[i, :len(ids)] = ids
            comp_mask[i, len(prompt):len(ids)] = True
        batch = {
            "tokens": torch.from_numpy(tokens).to(device),
            "completion_mask": torch.from_numpy(comp_mask).to(device),
            "advantages": torch.from_numpy(
                advantages.astype(np.float32)).to(device),
        }
        if gcfg.freeze_encoder:
            # rollouts came from the current policy, so old_logprobs is
            # implied (detached inside the step)
            batch["vision_feats"] = torch.cat(
                [f.expand(g, *f.shape[1:]) for f in feats_rows])
        else:
            batch["pixel_values"] = torch.cat(
                [px.expand(g, *px.shape[1:])
                 for px in pixels_rows])   # grads flow through vision
        if ref_params is not None:
            # KL anchor = the t=0 policy (TRL ref model); its connector
            # projects the SAME frozen features in the frozen case
            ref_embeds = (proj_fn(ref_params, batch["vision_feats"])
                          if gcfg.freeze_encoder else None)
            batch["ref_logprobs"] = logprob_fn(
                ref_params, batch["tokens"], batch["completion_mask"],
                ref_embeds, batch.get("pixel_values"))
        if gcfg.updates_per_batch > 1:
            # pin the rollout policy's logprobs so epochs 2..K optimize
            # the true clipped ratio against it (PPO-style reuse)
            old_embeds = (proj_fn(state.params, batch["vision_feats"])
                          if gcfg.freeze_encoder else None)
            batch["old_logprobs"] = logprob_fn(
                state.params, batch["tokens"], batch["completion_mask"],
                old_embeds, batch.get("pixel_values"))
        for _ in range(max(1, gcfg.updates_per_batch)):
            state, metrics = step_fn(state, batch)
        log_fn(f"grpo step {it}: reward mean {rewards.mean():.4f} "
               f"(max {rewards.max():.4f}), loss "
               f"{float(metrics['loss']):.5f}, ratio "
               f"{float(metrics['ratio_mean']):.5f}")
    state.params.requires_grad_(False)
    return state.params
