#!/usr/bin/env python
"""TikZero stage-2: fine-tune the LLM end-to-end with the (frozen) adapter
attached (counterpart of ``examples/tikzero/train.py``; reference
``examples/tikzero/train.py``), optionally conditioning the prompt on
captions (TikZero+ / ``--caption_condition``). The trained model is
written to ``<output>/<basename of --base_model>``.

    python -m detikzify_torch.examples.tikzero.train --base_model CKPT \
        --embedding_model LLAMA --adapter_model DIR --datikz DIR \
        --output DIR [--device cuda|cpu]

The dataset is a ``datasets.load_from_disk`` folder, so ``main`` needs
``datasets``."""
import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="fine-tune a TikZero adapter end-to-end, optionally "
                    "conditioned on captions (PyTorch/CUDA)")
    p.add_argument("--base_model", required=True,
                   help="DeTikZify checkpoint for weights initialization")
    p.add_argument("--embedding_model", default="meta-llama/Llama-3.2-1B",
                   help="adapter embedding model checkpoint (LLaMA 3.x)")
    p.add_argument("--adapter_model", required=True,
                   help="adapter checkpoint from tikzero/pretrain.py")
    p.add_argument("--datikz", default="nllg/datikz-v3",
                   help="path of the DaTikZ dataset (load_from_disk)")
    p.add_argument("--caption_condition", action="store_true",
                   help="also condition the LLM prompt on captions "
                        "(image tokens + caption + <bos> + code)")
    p.add_argument("--output", required=True)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--micro_batch_size", type=int, default=4)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--learning_rate", type=float, default=5e-5)
    p.add_argument("--distributed", action="store_true",
                   help="join the torch.distributed group torchrun "
                        "describes (nccl on the card, gloo on the CPU)")
    p.add_argument("--device", default="cuda",
                   help="device of the weights and the step ('cpu' runs "
                        "the kernels' plain versions)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.distributed:
        from detikzify_torch.parallel.mesh import join_group

        args.device = str(join_group(args.device))

    from detikzify_torch.models.load import (load, load_adapter,
                                             save_pretrained)
    from detikzify_torch.train.adapter import train_adapter_llm

    params, cfg, processor = load(args.base_model, device=args.device)
    params, cfg, aprocessor, bundle = load_adapter(
        params, cfg, processor, args.adapter_model, args.embedding_model,
        device=args.device)

    import datasets

    datikz = datasets.load_from_disk(args.datikz)
    items = [{"image": ex["image"], "caption": ex["caption"],
              "code": ex["code"]} for ex in datikz
             if len(ex.get("caption") or "") > 0]

    trained = train_adapter_llm(
        args.output, params, cfg, aprocessor, bundle, items,
        caption_condition=args.caption_condition,
        batch_size=args.batch_size,
        micro_batch_size=args.micro_batch_size,
        learning_rate=args.learning_rate, epochs=args.epochs)

    out = os.path.join(args.output, os.path.basename(args.base_model))
    save_pretrained(out, trained, cfg)


if __name__ == "__main__":
    main()
