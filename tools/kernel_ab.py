#!/usr/bin/env python3
"""Time two builds of the port's kernels K1 and K2 on one card, in turns.

    python3 tools/kernel_ab.py --old DIR [--iters 30]

DIR holds an earlier ``detikzify_torch/csrc`` whose K1 (``flash_attn.cu``)
has the current C interface and whose K2 (``paged_decode.cu`` with
``decode_attn.cuh``) has the one before the split partials (no scratch
argument), for example the sources of an earlier commit unpacked with
``git archive <commit> detikzify_torch/csrc | tar -x``.
Those sources are built with nvcc beside the package's own kernels, each
build is held against the plain version at ``chip_smoke.py``'s K1 and K2
shapes with ``chip_smoke.py``'s tolerance, and both are timed in the order
old, new, new, old (CUDA events, L2 flushed before each launch, median of
``--iters``). Prints the card as nvidia-smi names it, then one JSON line per
shape; exits non-zero if a build disagrees with the plain version or there
is no card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", required=True,
                    help="directory with the earlier csrc sources")
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab.py: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    import chip_smoke as cs
    from detikzify_torch.ops import attention, flash, paged
    from detikzify_torch.ops.cuda import F, I, KERNELS, P, CudaKernel

    old = Path(args.old).resolve()
    old_k1 = CudaKernel("flash_attention_old", old / "flash_attn.cu",
                        "detikzify_flash_attention",
                        [P] * 7 + [I] * 6 + [F, I, I, P])
    old_k2 = CudaKernel("paged_decode_old", old / "paged_decode.cu",
                        "detikzify_paged_decode", [P] * 6 + [I] * 7 + [F, P],
                        headers=[old / "decode_attn.cuh"])
    kernels = [old_k1, old_k2, KERNELS["flash_attention"],
               KERNELS["paged_decode"]]
    started = [(k, k._start_build()) for k in kernels]
    for k, st in started:
        if st is not None:
            k._finish_build(st)
    for k in kernels:
        k._load()

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.nvidia_smi(), flush=True)
    timer = cs.Timer(torch, dev, args.iters)
    gen = torch.Generator(device=dev).manual_seed(1234)
    failed = []

    def report(name, shape, old_fn, new_fn, want, pv_abs, bound):
        row = {"name": name, "shape": shape, **bound}
        for tag, fn in (("old", old_fn), ("new", new_fn)):
            tol = cs.tolerance_check(torch, fn(), want, pv_abs)
            row[f"{tag}_max_err_over_tol"] = tol["max_err_over_tol"]
            if not tol["ok"]:
                failed.append(f"{name} {tag}")
        t = [timer(old_fn), timer(new_fn), timer(new_fn), timer(old_fn)]
        row["old_ms"], row["new_ms"] = [t[0], t[3]], [t[1], t[2]]
        row["speedup"] = (t[0] + t[3]) / (t[1] + t[2])
        cs.emit(row)

    stream = torch.cuda.current_stream(dev).cuda_stream
    for name, b, s, t, nh, nkv, hd, mode in cs.K1_CASES:
        q, k, v, kw, vis = cs.k1_inputs(torch, gen, dev, b, s, t, nh, nkv,
                                        hd, mode)
        per_batch = "q_offsets" in kw

        def old_fn(q=q, k=k, v=v, kw=kw, per_batch=per_batch, s=s, t=t,
                   nh=nh, nkv=nkv, hd=hd, b=b):
            out = torch.empty_like(q)
            old_k1.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), None,
                          kw["q_offsets"].data_ptr() if per_batch else None,
                          kw["kv_limits"].data_ptr() if per_batch else None,
                          b, s, t, nh, nkv, hd, hd ** -0.5, 0,
                          int(per_batch), stream)
            return out

        report(f"flash_attention/{name}",
               {"B": b, "S": s, "T": t, "NH": nh, "NKV": nkv, "Hd": hd,
                "mode": mode},
               old_fn, lambda q=q, k=k, v=v, kw=kw: flash.flash_attention(
                   q, k, v, **kw),
               attention.attend_plain(q, k, v, **kw),
               attention.attend_plain(q, k, v.abs(), **kw),
               cs.bound(2 * (q.numel() * 2 + k.numel() + v.numel()),
                        4 * nh * hd * vis))

    c = cs.K2_CASE
    b, nh, nkv, hd, page, m = (c[x] for x in ("B", "NH", "NKV", "Hd", "page",
                                              "m"))
    n_pages = b * m + 1
    pool_k = torch.randn((n_pages, page, nkv, hd), generator=gen,
                         device=dev).to(torch.bfloat16)
    pool_v = torch.randn((n_pages, page, nkv, hd), generator=gen,
                         device=dev).to(torch.bfloat16)
    perm = torch.randperm(n_pages, generator=gen, device=dev)[:b * m]
    tab = perm.reshape(b, m).to(torch.int32).contiguous()
    lengths = torch.tensor(c["lengths"], dtype=torch.int32, device=dev)
    q = torch.randn((b, nh, hd), generator=gen, device=dev).to(torch.bfloat16)

    def old_k2_fn():
        out = torch.empty_like(q)
        old_k2.launch(q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
                      tab.data_ptr(), lengths.data_ptr(), out.data_ptr(), b,
                      nh, nkv, hd, page, m, tab.stride(0), hd ** -0.5,
                      stream)
        return out

    live = sum(c["lengths"])
    report("paged_decode",
           {"B": b, "NH": nh, "NKV": nkv, "Hd": hd, "page": page, "m": m,
            "lengths": list(c["lengths"])},
           old_k2_fn,
           lambda: paged.decode_attend_paged(q, pool_k, pool_v, tab, lengths),
           paged.decode_attend_paged_plain(q, pool_k, pool_v, tab, lengths),
           paged.decode_attend_paged_plain(q, pool_k, pool_v.abs(), tab,
                                           lengths),
           cs.bound(live * nkv * hd * 2 * 2 + 2 * q.numel() * 2,
                    4 * nh * hd * live))
    if failed:
        print(json.dumps({"ok": False, "disagree": failed}), flush=True)
        return 1
    print(json.dumps({"ok": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
