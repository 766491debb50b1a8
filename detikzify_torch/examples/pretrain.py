#!/usr/bin/env python
"""Stage-1 projector pretraining entry (counterpart of
``examples/pretrain.py``; reference ``examples/pretrain.py``): caption ->
figure alignment on an ArxivCap-style dataset, training only the modality
projector, which is written to ``<output>/modality_projector.npz``. One
process on one device, or one per card under torchrun with
``--distributed`` (as in ``train``).

    python -m detikzify_torch.examples.pretrain --base_model CKPT \
        --arxivcap DIR --output DIR [--device cuda|cpu]

The dataset is a ``datasets.load_from_disk`` folder, so ``main`` needs
``datasets``."""
import argparse

from detikzify_torch.models.load import load
from detikzify_torch.parallel.mesh import join_group, make_mesh
from detikzify_torch.train import pretrain


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="pretrain modality projector "
                                            "(PyTorch/CUDA)")
    p.add_argument("--base_model", required=True)
    p.add_argument("--arxivcap", required=True,
                   help="dataset path with (image, caption) pairs")
    p.add_argument("--size", type=int, default=1_000_000,
                   help="the amount of figures to use for pretraining "
                        "(reference pretrain.py --size)")
    p.add_argument("--output", required=True)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--micro_batch_size", type=int, default=1)
    p.add_argument("--model_axis", type=int, default=1,
                   help="tensor-parallel mesh axis size: each layer split "
                        "over that many ranks of the group")
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

    ds = datasets.load_from_disk(args.arxivcap)
    items = [{"image": ex["image"], "text": ex["caption"]}
             for ex in ds.select(range(min(args.size, len(ds))))]

    pretrain(args.output, params, cfg, processor, items,
             batch_size=args.batch_size,
             micro_batch_size=args.micro_batch_size, device=device,
             mesh=make_mesh(model=args.model_axis, device=device))


if __name__ == "__main__":
    main()
