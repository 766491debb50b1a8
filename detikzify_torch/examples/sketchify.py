#!/usr/bin/env python
"""Offline sketch synthesis for training data (counterpart of
``examples/sketchify.py``; reference ``examples/sketchify.py``). The
reference drives a diffusers UltraSketch pix2pix model; that stays an
optional backend here (``diffusers`` is imported only when it runs). The
built-in backend is the deterministic ``SketchAugment`` pipeline, on the
host.

    python -m detikzify_torch.examples.sketchify --dataset DIR --output DIR

The dataset is a ``datasets.load_from_disk`` folder, so ``main`` needs
``datasets``."""
import argparse
import os

from detikzify_torch.data.augment import SketchAugment


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="sketchify figure datasets")
    p.add_argument("--dataset", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--variants", type=int, default=2,
                   help="sketch variants per figure")
    p.add_argument("--backend", choices=["augment", "diffusion"],
                   default="augment")
    p.add_argument("--diffusion_model",
                   default="Yakonrus/SDXL_Controlnet_Tile_Realistic_v2")
    return p.parse_args(argv)


def diffusion_sketchify(images, model_name):  # pragma: no cover
    try:
        from diffusers import AutoPipelineForImage2Image
    except ImportError as e:
        raise ImportError("diffusion backend requires `diffusers`") from e
    pipe = AutoPipelineForImage2Image.from_pretrained(model_name)
    for img in images:
        yield pipe(prompt="pencil sketch of a scientific figure",
                   image=img, strength=0.6).images[0]


def main(argv=None):
    args = parse_args(argv)
    import datasets

    ds = datasets.load_from_disk(args.dataset)
    rows = []
    for i, ex in enumerate(ds):
        if args.backend == "augment":
            sketches = [SketchAugment(seed=1000 * i + v)(ex["image"])
                        for v in range(args.variants)]
        else:
            sketches = list(diffusion_sketchify(
                [ex["image"]] * args.variants, args.diffusion_model))
        rows.append({**ex, "sketches": sketches})
    out = datasets.Dataset.from_list(rows)
    os.makedirs(args.output, exist_ok=True)
    out.save_to_disk(args.output)


if __name__ == "__main__":
    main()
