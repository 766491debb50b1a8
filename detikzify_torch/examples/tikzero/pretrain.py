#!/usr/bin/env python
"""TikZero stage-1: pretrain the cross-attention adapter by distillation
(counterpart of ``examples/tikzero/pretrain.py``; reference
``examples/tikzero/pretrain.py``): the caption-conditioned vision tower
(student, captions through the frozen embedding model) learns to match
the plain image tower (teacher) on (image, caption) pairs. The trained
adapter is written to ``<output>/adapter``.

    python -m detikzify_torch.examples.tikzero.pretrain --base_model CKPT \
        --embedding_model LLAMA --dataset DIR --output DIR [--device cpu]

The dataset is a ``datasets.load_from_disk`` folder, so ``main`` needs
``datasets``."""
import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="pretrain a TikZero adapter by distillation "
                    "(PyTorch/CUDA)")
    p.add_argument("--base_model", required=True,
                   help="DeTikZify checkpoint supplying the vision tower")
    p.add_argument("--embedding_model", default="meta-llama/Llama-3.2-1B",
                   help="frozen caption embedding model checkpoint")
    p.add_argument("--dataset", required=True,
                   help="datasets.load_from_disk path with (image, caption)")
    p.add_argument("--output", required=True)
    p.add_argument("--batch_size", type=int, default=512)
    p.add_argument("--micro_batch_size", type=int, default=8)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--mse_loss", action="store_true",
                   help="distill with L2 instead of cosine similarity "
                        "(reference tikzero/pretrain.py --mse_loss)")
    p.add_argument("--distributed", action="store_true",
                   help="join the torch.distributed group torchrun "
                        "describes (nccl on the card, gloo on the CPU)")
    p.add_argument("--device", default="cuda",
                   help="device of the tower, adapter and caption model "
                        "('cpu' runs the kernels' plain versions)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.distributed:
        from detikzify_torch.parallel.mesh import join_group

        args.device = str(join_group(args.device))

    import torch

    from detikzify_torch.config import AdapterConfig
    from detikzify_torch.models import convert
    from detikzify_torch.models.embedding import AdapterBundle
    from detikzify_torch.models.load import (_resolve, load,
                                             load_embedding_model,
                                             load_tokenizer, save_adapter)
    from detikzify_torch.train.adapter import pretrain_adapter

    params, cfg, processor = load(args.base_model, device=args.device)

    # frozen caption embedding model (reference pretrain.py builds the
    # CrossAttentionSiglipVisionModel around it; here it is an explicit
    # bundle of the LLaMA decoder + tokenizer)
    embed_path = _resolve(args.embedding_model)
    embed_params, embed_cfg = load_embedding_model(embed_path,
                                                   device=args.device)

    acfg = cfg.adapter or AdapterConfig(
        embedding_hidden_size=embed_cfg.hidden_size)
    cfg = cfg.replace(adapter=acfg)
    adapter_params = convert.init_random_adapter(
        cfg.vision, acfg, device=args.device, dtype=torch.float32)
    bundle = AdapterBundle(adapter_params=adapter_params, adapter_cfg=acfg,
                           embed_params=embed_params, embed_cfg=embed_cfg,
                           tokenizer=load_tokenizer(embed_path))

    import datasets

    ds = datasets.load_from_disk(args.dataset)
    items = [{"image": ex["image"], "text": ex["caption"]} for ex in ds
             if ex.get("caption")]

    from detikzify_torch.train.adapter.pretrain import DistillLossConfig

    trained = pretrain_adapter(
        args.output, bundle, cfg, params.vision, items,
        batch_size=args.batch_size,
        micro_batch_size=args.micro_batch_size,
        learning_rate=args.learning_rate, epochs=args.epochs,
        loss_cfg=DistillLossConfig(kind="l2") if args.mse_loss else None)
    save_adapter(os.path.join(args.output, "adapter"), trained, acfg)


if __name__ == "__main__":
    main()
