#!/usr/bin/env python
"""Stage-2 fine-tuning entry (counterpart of ``examples/train.py``;
reference ``examples/train.py``). One process on one device, or with
``--distributed`` one process per card under torchrun, the weights and
moments sharded over the mesh's data axis (``parallel.mesh``):

    python -m detikzify_torch.examples.train --base_model CKPT \
        --datikz DIR --output DIR [--device cuda|cpu]
    torchrun --nproc_per_node N -m detikzify_torch.examples.train \
        --distributed --base_model CKPT --datikz DIR --output DIR

The dataset is a ``datasets.load_from_disk`` folder, so ``main`` needs
``datasets``."""
import argparse

from detikzify_torch.models.load import load
from detikzify_torch.parallel.mesh import join_group, make_mesh
from detikzify_torch.train import train


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="fine-tune DeTikZify "
                                            "(PyTorch/CUDA)")
    p.add_argument("--base_model", required=True,
                   help="base checkpoint (projector-pretrained)")
    p.add_argument("--datikz", required=True,
                   help="path to a DaTikZ-style dataset "
                        "(datasets.load_from_disk format with image/code)")
    p.add_argument("--output", required=True)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--micro_batch_size", type=int, default=1)
    p.add_argument("--sketch_ratio", type=float, default=0.5)
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--gradient_checkpointing", action="store_true")
    p.add_argument("--model_axis", type=int, default=1,
                   help="tensor-parallel mesh axis size (only 1 is placed "
                        "yet)")
    p.add_argument("--distributed", action="store_true",
                   help="join the torch.distributed group torchrun "
                        "describes (nccl on the card, gloo on the CPU)")
    p.add_argument("--device", default="cuda",
                   help="device of the weights and the step ('cpu' runs "
                        "the kernels' plain versions)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = args.device
    if args.distributed:
        device = join_group(device)
    params, cfg, processor = load(args.base_model, device=device)

    import datasets

    ds = datasets.load_from_disk(args.datikz)
    items = [{"image": ex["image"], "text": ex["code"],
              "sketches": ex.get("sketches")} for ex in ds]

    train(args.output, params, cfg, processor, items,
          batch_size=args.batch_size,
          micro_batch_size=args.micro_batch_size,
          sketch_ratio=args.sketch_ratio, epochs=args.epochs,
          gradient_checkpointing=args.gradient_checkpointing,
          device=device, mesh=make_mesh(model=args.model_axis,
                                        device=device))


if __name__ == "__main__":
    main()
