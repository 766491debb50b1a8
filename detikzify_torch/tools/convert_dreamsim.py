#!/usr/bin/env python
"""Convert published DreamSim LoRA-merged checkpoints to the ensemble
format of ``evaluate.dreamsim_vit.load_ensemble`` (counterpart of
``tools/convert_dreamsim.py``; the same ``branchN.npz`` and
``manifest.json`` the JAX tool writes, which either package loads).

The reference metric wraps the ``dreamsim`` package, whose published
ensemble is three LoRA-merged ViT-B/16 towers (DINO + CLIP + OpenCLIP) in
timm/DINO state-dict naming. Once the checkpoint is on disk:

    python -m detikzify_torch.tools.convert_dreamsim \\
        --input <dir-with-merged-pth> --output converted/dreamsim

``--input DIR`` scans for one ``*.pth`` per branch keyword (dino_vitb16 /
clip_vitb16 / open_clip_vitb16); ``--dino/--clip/--open-clip PATH``
override. Each file (a raw state dict or ``{"model": sd, "proj":
tensor}``) is read with ``torch.load(weights_only=True)`` and imported by
``dreamsim_vit.import_dreamsim_merged``. The manifest records each
branch's config, normalization, converted-array sha256 (checked by
``load_ensemble``) and the sha256 of its source file. Conversion runs on
the host. Prints one JSON line with the manifest summary.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _sha256_file(path: str) -> str:
    digest = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            digest.update(chunk)
    return digest.hexdigest()


def find_branch_files(input_dir: str) -> dict:
    """Map branch name -> .pth path by filename keyword (longest keyword
    wins, so open_clip_vitb16 is not claimed by clip_vitb16)."""
    from detikzify_torch.evaluate.dreamsim_vit import ENSEMBLE_BRANCHES

    keywords = sorted((b for b, _ in ENSEMBLE_BRANCHES),
                      key=len, reverse=True)
    out: dict = {}
    for fname in sorted(os.listdir(input_dir)):
        if not fname.endswith((".pth", ".pt", ".bin")):
            continue
        for kw in keywords:
            if kw in fname and kw not in out:
                # open_clip files must not be claimed as plain clip
                if kw == "clip_vitb16" and "open_clip" in fname:
                    continue
                out[kw] = os.path.join(input_dir, fname)
                break
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--input", default=None,
                   help="directory holding the merged .pth files")
    p.add_argument("--dino", default=None)
    p.add_argument("--clip", default=None)
    p.add_argument("--open-clip", dest="open_clip", default=None)
    p.add_argument("--output", required=True,
                   help="converted-ensemble output directory")
    args = p.parse_args(argv)

    from detikzify_torch.evaluate.dreamsim_vit import (
        ENSEMBLE_BRANCHES, from_dreamsim_checkpoint, save_ensemble)

    paths = find_branch_files(args.input) if args.input else {}
    for branch, override in (("dino_vitb16", args.dino),
                             ("clip_vitb16", args.clip),
                             ("open_clip_vitb16", args.open_clip)):
        if override:
            paths[branch] = override
    if not paths:
        p.error("no branch checkpoints found (need --input dir with "
                "*dino_vitb16*/*clip_vitb16*/*open_clip_vitb16* .pth "
                "files, or explicit --dino/--clip/--open-clip)")
    # canonical branch order = the published ensemble's concatenation
    # order (dino, clip, open_clip)
    paths = {branch: paths[branch] for branch, _ in ENSEMBLE_BRANCHES
             if branch in paths}
    for branch, path in paths.items():
        log(f"[convert_dreamsim] {branch}: {path}")

    ds = from_dreamsim_checkpoint(paths, device="cpu")
    manifest = save_ensemble(args.output, ds)
    # provenance: pin the source files this conversion consumed
    for spec, (branch, path) in zip(manifest["branches"], paths.items()):
        spec["source"] = {"branch": branch,
                          "file": os.path.basename(path),
                          "sha256": _sha256_file(path)}
    with open(os.path.join(args.output, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)

    summary = {
        "output": args.output,
        "branches": [
            {"branch": s["source"]["branch"], "file": s["file"],
             "n_params": s["n_params"], "sha256": s["sha256"],
             "source_sha256": s["source"]["sha256"]}
            for s in manifest["branches"]],
    }
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
