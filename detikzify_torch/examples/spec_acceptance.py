#!/usr/bin/env python
"""Measure BPE-realistic speculative-decoding acceptance (counterpart of
``examples/spec_acceptance.py``).

Reads the committed byte-level BPE vocabulary (no ``tokenizers`` or
``transformers`` needed), overfits a small model on the deterministic
synthetic-TikZ corpus it was trained on, and measures the decode engine's
speculative tokens-per-step at T=0 / T=0.8, with and without MCTS-style
parent-continuation hints. Prints one JSON line, which names the
``head_dim`` and ``dtype`` the model ran at: the JAX package's 4 heads of
32 in fp32, on the card as on the CPU.

    python -m detikzify_torch.examples.spec_acceptance [--device cuda|cpu]
"""
import argparse
import json


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="measure speculative "
                                            "acceptance (PyTorch/CUDA)")
    p.add_argument("--programs", type=int, default=300)
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--eval", type=int, default=24)
    p.add_argument("--device", default="cuda",
                   help="device of the model and the engine ('cpu' runs "
                        "the kernels' plain versions)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import sys

    from detikzify_torch.evaluate.spec_acceptance import run_measurement

    out = run_measurement(n_programs=args.programs, steps=args.steps,
                          n_eval=args.eval, device=args.device,
                          log_fn=lambda m: print(m, file=sys.stderr))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
