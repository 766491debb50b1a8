#!/usr/bin/env python
"""Benchmark harness (counterpart of ``examples/eval.py``; reference
``examples/eval.py``): evaluate one or more models on a DaTikZ-style test
set with the full metric suite, prediction caching, per-process sharding,
and redacted variants when PDF tooling is available.

    python -m detikzify_torch.examples.eval --path NAME=CKPT \
        --testset DIR [--device cuda|cuda:N|cpu] [--distributed]

``--device cuda`` places one replica on every local card; ``--distributed``
joins the ``torch.distributed`` group that ``torchrun`` describes (one
process per card, each on its ``LOCAL_RANK``'s card) and stripes the test
set across the processes. The test set is a ``datasets.load_from_disk``
folder, so ``main`` needs ``datasets``; ``predict`` and ``score`` take a
list of dicts.
"""
import argparse
import json
import os

from detikzify_torch.evaluate import (CrystalBLEU, ImageSim,
                                      KernelInceptionDistance,
                                      TexEditDistance)
from detikzify_torch.evaluate.harness import (PredictionCache,
                                              gather_interleaved,
                                              generate_until_compilable,
                                              mean_sampling_throughput,
                                              mean_token_efficiency,
                                              shard_indices)
from detikzify_torch.infer import TikzDocument
from detikzify_torch.models.load import load


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="evaluate DeTikZify models "
                                            "(PyTorch/CUDA)")
    p.add_argument("--path", nargs="+", required=True,
                   help="NAME=CHECKPOINT pairs")
    p.add_argument("--testset", required=True,
                   help="dataset path with (image, code) pairs")
    p.add_argument("--cache_dir", default="eval_cache")
    p.add_argument("--timeout", type=int, default=0,
                   help="per-item score-improvement budget (0 = stop at "
                        "first compilable output)")
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--parallelism", type=int, default=8,
                   help="concurrent MCTS expansions per item (engine slots)")
    p.add_argument("--output", default="scores.json")
    p.add_argument("--quantize", action="store_true",
                   help="weight-only int8 model load (host import, int8 "
                        "device placement) -- the single-card path for "
                        "8B-class checkpoints")
    p.add_argument("--clip", default=None,
                   help="SigLIP two-tower checkpoint dir for ClipScore "
                        "(requires a 'caption' column in the testset)")
    p.add_argument("--dreamsim_dino", default=None,
                   help="DINO ViT backbone checkpoint for DreamSim")
    p.add_argument("--dreamsim_clip", default=None,
                   help="CLIP vision backbone checkpoint for DreamSim")
    p.add_argument("--dreamsim_open_clip", default=None,
                   help="OpenCLIP vision backbone checkpoint for DreamSim")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (one replica on every local card), "
                        "'cuda:N' or 'cpu' (the kernels' plain versions)")
    p.add_argument("--distributed", action="store_true",
                   help="join the torch.distributed group torchrun "
                        "describes; one process per card")
    return p.parse_args(argv)


def predict(name, ckpt, testset, cache_dir, timeout, parallelism=8,
            quantize=False, device="cuda"):
    """Striped across processes AND across this host's cards: one model
    replica per device, as the reference places one replica per torchrun
    rank (reference examples/eval.py:110-133). ``device="cuda"`` takes
    every local card, any other device that one alone."""
    from detikzify_torch.parallel.replicas import ReplicaPool

    params, cfg, processor = load(ckpt, quantize=quantize, device=device)
    metric = "model" if timeout else "fast"
    pool = ReplicaPool(params, cfg, processor, metric=metric,
                       devices=None if device == "cuda" else [device])
    os.makedirs(cache_dir, exist_ok=True)
    cache = PredictionCache(os.path.join(cache_dir, f"{name}.jsonl"))
    local, todo = [], []
    for idx in shard_indices(len(testset)):
        key = f"{name}-{idx}"
        hit = cache.get(key)
        if hit is not None:
            local.append((idx, hit))
        else:
            todo.append(idx)

    def run_item(pipe, idx):
        # cache each item as it completes: interrupted runs resume
        result = generate_until_compilable(
            pipe, testset[idx]["image"],
            score_improve=bool(timeout), min_seconds=timeout or 0.0,
            parallelism=parallelism)
        row = {"code": result.best_code, "score": result.best_score,
               "num_programs": result.num_programs,
               "lengths": result.program_lengths,
               "seconds": result.seconds}
        cache.put(f"{name}-{idx}", row)
        return row

    for idx, row in zip(todo, pool.run(run_item, todo)):
        if isinstance(row, Exception):
            raise row
        local.append((idx, row))
    return gather_interleaved(local, len(testset)), params, cfg, processor


def score(name, rows, testset, params, cfg, processor,
          clip_metric=None, dreamsim_metric=None):
    refs = [ex["code"] for ex in testset]
    codes = [row["code"] for row in rows]
    renders, ref_images, pairs, captions = [], [], [], []
    for row, ex in zip(rows, testset):
        doc = TikzDocument(row["code"])
        img = doc.rasterize()
        if img is not None:
            renders.append(img)
            ref_images.append(ex["image"])
            pairs.append((img, ex["image"]))
            captions.append(ex.get("caption", ""))

    out = {
        "CompileSuccessRate": len(renders) / max(len(rows), 1),
        "MeanTokenEfficiency": mean_token_efficiency(
            [row["lengths"] for row in rows]),
        "MeanSamplingThroughput": mean_sampling_throughput(
            [row["num_programs"] for row in rows]),
    }
    # the reference eval harness instantiates ImageSim with its default
    # mode="cos" (reference examples/eval.py:143) rather than the
    # checkpoint-resolved mode the MCTS pipeline uses -- match it so the
    # reported SelfSim column stays on the cosine scale
    selfsim = ImageSim.from_detikzify(params, cfg, processor=processor,
                                      mode="cos")
    if pairs:
        out["SelfSim"] = float(selfsim.score_batch(
            [a for a, _ in pairs], [b for _, b in pairs]).mean())
        kid = KernelInceptionDistance(params.vision, cfg,
                                      subset_size=min(50, len(renders)))
        kid.update(ref_images, real=True)
        kid.update(renders, real=False)
        out["KID"] = kid.compute()[0]
    bleu = CrystalBLEU(refs)
    bleu.update(codes, [[r] for r in refs])
    out["CrystalBLEU"] = bleu.compute()
    eed = TexEditDistance()
    eed.update(codes, [[r] for r in refs])
    out["TexEditDistance"] = eed.compute()

    # full-suite metrics gated on their (separately downloaded) towers,
    # like the reference's lazy [evaluate] extra (examples/eval.py:160-176)
    if dreamsim_metric is not None and pairs:
        for render, ref_img in pairs:
            dreamsim_metric.update(ref_img, render)
        out["DreamSim"] = dreamsim_metric.compute()
        dreamsim_metric.reset()
    if clip_metric is not None and renders and any(captions):
        clip_metric.update(renders, captions)
        out["ClipScore"] = clip_metric.compute()
        clip_metric.reset()

    # redacted variants (rot13 text scrambling; leakage-controlled eval)
    from detikzify_torch.evaluate.harness import redacted_render

    redacted = [(redacted_render(TikzDocument(row["code"]), rot13=True),
                 ex["image"], ex.get("caption", ""))
                for row, ex in zip(rows, testset)]
    redacted = [(r, i, c) for r, i, c in redacted if r is not None]
    if redacted:
        out["SelfSim_redacted"] = float(selfsim.score_batch(
            [r for r, _, _ in redacted],
            [i for _, i, _ in redacted]).mean())
        if dreamsim_metric is not None:
            for r, i, _ in redacted:
                dreamsim_metric.update(i, r)
            out["DreamSim_redacted"] = dreamsim_metric.compute()
            dreamsim_metric.reset()
        if clip_metric is not None and any(c for _, _, c in redacted):
            clip_metric.update([r for r, _, _ in redacted],
                               [c for _, _, c in redacted])
            out["ClipScore_redacted"] = clip_metric.compute()
            clip_metric.reset()
    return out


def main(argv=None):
    args = parse_args(argv)
    device = args.device
    if args.distributed:
        from detikzify_torch.parallel.mesh import join_group

        # torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR/PORT)
        device = str(join_group(device))
    import datasets

    ds = datasets.load_from_disk(args.testset)
    testset = [ex for ex in ds][:args.limit or None]

    clip_metric = dreamsim_metric = None
    if args.clip:
        from detikzify_torch.evaluate import ClipScore

        clip_metric = ClipScore.from_siglip_checkpoint(
            args.clip, device=device)
    if args.dreamsim_dino or args.dreamsim_clip or args.dreamsim_open_clip:
        from detikzify_torch.evaluate.dreamsim_vit import from_checkpoints

        dreamsim_metric = from_checkpoints(
            dino_path=args.dreamsim_dino, clip_path=args.dreamsim_clip,
            open_clip_path=args.dreamsim_open_clip, device=device)

    scores = {}
    for pair in args.path:
        name, ckpt = pair.split("=", 1)
        rows, params, cfg, processor = predict(
            name, ckpt, testset, args.cache_dir, args.timeout,
            parallelism=args.parallelism, quantize=args.quantize,
            device=device)
        scores[name] = score(name, rows, testset, params, cfg, processor,
                             clip_metric=clip_metric,
                             dreamsim_metric=dreamsim_metric)
        print(name, json.dumps(scores[name], indent=2))
    with open(args.output, "w") as f:
        json.dump(scores, f, indent=2)


if __name__ == "__main__":
    main()
