#!/usr/bin/env python
"""GRPO post-training entry (counterpart of ``examples/refine.py``;
reference ``examples/refine.py``): refine a trained model with RL from
SelfSim + compiler feedback, then save it with ``save_pretrained``.

    python -m detikzify_torch.examples.refine --model CKPT \
        --dataset DIR --output DIR [--device cuda|cpu]

The dataset is a ``datasets.load_from_disk`` folder, so ``main`` needs
``datasets``."""
import argparse

from detikzify_torch.evaluate import ImageSim
from detikzify_torch.infer import CompileService
from detikzify_torch.models.load import load, save_pretrained
from detikzify_torch.train.grpo import GRPOConfig, SelfSimReward, refine


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Post-train DeTikZify with GRPO (PyTorch/CUDA).")
    p.add_argument("--model", "--base_model", required=True)
    p.add_argument("--dataset", "--datikz", required=True,
                   help="dataset path with figure images")
    p.add_argument("--output", required=True)
    p.add_argument("--steps", "--num_train_steps", type=int, default=100)
    p.add_argument("--num_generations", type=int, default=32)
    p.add_argument("--max_new_tokens", type=int, default=512)
    p.add_argument("--learning_rate", type=float, default=1e-6)
    p.add_argument("--beta", type=float, default=0.0)
    p.add_argument("--strict", action="store_true",
                   help="treat recoverable compile errors as failures")
    p.add_argument("--num_compile_workers", type=int, default=8)
    p.add_argument("--speculate", type=int, default=0,
                   help="speculative rollout decoding draft length")
    p.add_argument("--sketch_ratio", type=float, default=0.5,
                   help="probability of sketchifying training figures")
    p.add_argument("--device", default="cuda",
                   help="device of the weights, rollouts and updates "
                        "('cpu' runs the kernels' plain versions)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    params, cfg, processor = load(args.model, device=args.device)

    import datasets

    from detikzify_torch.data.augment import SketchAugment

    ds = datasets.load_from_disk(args.dataset)
    sketch = SketchAugment()
    import random

    images = [sketch(ex["image"])
              if random.random() < args.sketch_ratio else ex["image"]
              for ex in ds]

    metric = ImageSim.from_detikzify(params, cfg, processor=processor)
    reward = SelfSimReward(
        metric, CompileService(workers=args.num_compile_workers),
        strict=args.strict)
    gcfg = GRPOConfig(num_generations=args.num_generations,
                      max_new_tokens=args.max_new_tokens,
                      learning_rate=args.learning_rate, beta=args.beta,
                      strict=args.strict, speculate=args.speculate)
    refined = refine(params, cfg, processor, images, reward, gcfg=gcfg,
                     steps=args.steps)
    save_pretrained(args.output, refined, cfg)


if __name__ == "__main__":
    main()
