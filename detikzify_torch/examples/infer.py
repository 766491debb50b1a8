#!/usr/bin/env python
"""Interactive inference REPL (counterpart of ``examples/infer.py``;
reference ``examples/infer.py``).

Loads a model, reads image paths/URLs from stdin, prints sampled TikZ and
optionally saves the best program:

    python -m detikzify_torch.examples.infer --model CKPT [--mcts] \
        [--device cuda|cpu]
"""
import argparse

from detikzify_torch.infer import DetikzifyPipeline
from detikzify_torch.models.load import load


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="DeTikZify inference "
                                            "(PyTorch/CUDA)")
    p.add_argument("--model", default="detikzify-v2.5-8b")
    p.add_argument("--mcts", action="store_true",
                   help="refine with MCTS instead of one-shot sampling")
    p.add_argument("--timeout", type=int, default=600,
                   help="MCTS budget in seconds")
    p.add_argument("--speculate", type=int, default=0,
                   help="n-gram speculative decoding draft length "
                        "(0 = off; distribution-preserving, auto "
                        "bail-out when drafts do not pay)")
    p.add_argument("--parallelism", type=int, default=8,
                   help="concurrent MCTS expansions (engine slots)")
    p.add_argument("--temperature", type=float, default=None)
    p.add_argument("--top_p", type=float, default=None)
    p.add_argument("--top_k", type=int, default=None)
    p.add_argument("--caption", default=None,
                   help="text condition (TikZero checkpoints)")
    p.add_argument("--output", help="save best program to this .tex path")
    p.add_argument("--device", default="cuda",
                   help="device of the weights and the engine ('cpu' runs "
                        "the kernels' plain versions)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    loaded = load(args.model, device=args.device)
    if len(loaded) == 4:              # TikZero checkpoint with adapter
        params, cfg, aproc, bundle = loaded
        pipeline = DetikzifyPipeline(params, cfg, aproc.processor,
                                     adapter=bundle,
                                     speculate=args.speculate,
                                     device=args.device)
    else:
        params, cfg, processor = loaded
        pipeline = DetikzifyPipeline(params, cfg, processor,
                                     speculate=args.speculate,
                                     device=args.device)
    gen_kwargs = dict(temperature=args.temperature, top_p=args.top_p,
                      top_k=args.top_k)
    print("Enter an image path or URL (Ctrl-D to exit):")
    while True:
        try:
            line = input("> ").strip()
        except EOFError:
            break
        if not line:
            continue
        if args.mcts:
            best = None
            for score, doc in pipeline.simulate(
                    image=line, text=args.caption, timeout=args.timeout,
                    parallelism=args.parallelism, **gen_kwargs):
                print(f"[score {score:+.4f}] "
                      f"{'OK' if doc.is_rasterizable else 'FAIL'}")
                if best is None or score >= best[0]:
                    best = (score, doc)
                if doc.is_rasterizable:
                    break
            doc = best[1] if best else None
        else:
            doc = pipeline.sample(image=line, text=args.caption,
                                  **gen_kwargs)
        if doc is None:
            print("no output")
            continue
        print(doc.code)
        if args.output:
            doc.save(args.output)
            print(f"saved to {args.output}")


if __name__ == "__main__":
    main()
