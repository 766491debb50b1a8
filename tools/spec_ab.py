#!/usr/bin/env python3
"""Time ``simulate()`` on a speculative engine with two builds of K4 (the
verify-window kernel) on one card, in turns, with plain ``simulate()``
before and after as a measure of the host's speed.

    python3 tools/spec_ab.py --old DIR [--max-new-tokens 128]

DIR holds an earlier ``detikzify_torch/csrc`` whose ``paged_verify.cu`` has
the C interface without a scratch argument (the sources before the split
partials, unpacked with ``git archive <commit> detikzify_torch/csrc |
tar -x``). The workload is ``chip_smoke.py``'s ``simulate_spec`` phase:
random ``detikzify-v2-8b`` weights from ``--seed``, int8 + fused,
speculate=4 with every draft class kept on, 16 expansions, parallelism 8,
SelfSim EMD. After one short warm-up run of each it runs plain,
old, new, new, old, plain, each on a fresh engine. The old build is bound
in place of the package's K4 wrapper (``models.llama`` looks the name up
at each call); both are wrapped in the same host timer, so each run also
reports the host time spent inside the K4 wrapper. Prints the card as
nvidia-smi names it, one JSON line per run and a summary line; exits
non-zero if there is no card or a run fails its checks.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", required=True,
                    help="directory with the earlier csrc sources")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-new-tokens", type=int, default=128)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("spec_ab.py: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    import chip_smoke as cs
    from detikzify_torch.config import get_config
    from detikzify_torch.infer import (DetikzifyPipeline, FakeBackend,
                                       set_backend)
    from detikzify_torch.models import convert, llama
    from detikzify_torch.ops import build_all, paged
    from detikzify_torch.ops.cuda import CudaKernel, F, I, P
    from detikzify_torch.ops.quant import fuse_projections, quantize_params
    from detikzify_torch.ops.sampling import SamplingParams
    from detikzify_torch.processing import ByteTokenizer, DetikzifyProcessor

    old = Path(args.old).resolve()
    old_k4 = CudaKernel("paged_verify_old", old / "paged_verify.cu",
                        "detikzify_paged_verify", [P] * 6 + [I] * 8 + [F, P],
                        headers=sorted(old.glob("*.cuh")))
    started = old_k4._start_build()
    build_all()
    if started is not None:
        old_k4._finish_build(started)
    old_k4._load()

    def old_verify(q, pool_k, pool_v, tab, starts, *, scale=None):
        """The wrapper as it was before the split partials: no scratch."""
        b, k1, nh, hd = q.shape
        page, nkv = paged._check_pool("paged_verify", q, pool_k, pool_v,
                                      tab, hd)
        paged._check_rows("paged_verify: starts", starts, b, q.device)
        scale = (hd ** -0.5) if scale is None else float(scale)
        out = torch.empty_like(q)
        old_k4.launch(q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
                      tab.data_ptr(), starts.data_ptr(), out.data_ptr(), b,
                      k1, nh, nkv, hd, page, tab.shape[1], tab.stride(0),
                      scale, paged.stream_handle(q.device))
        return out

    host = {"s": 0.0, "calls": 0}

    def timed(fn):
        def call(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                host["s"] += time.perf_counter() - t
                host["calls"] += 1
        return call

    builds = {"old": timed(old_verify),
              "new": timed(paged.decode_verify_attend_paged)}

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.nvidia_smi(), flush=True)
    cfg = get_config("detikzify-v2-8b")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = convert.init_random(cfg, device=dev, dtype=torch.bfloat16,
                                 generator=gen)
    fuse_projections(quantize_params(params))
    torch.cuda.empty_cache()
    set_backend(FakeBackend())
    processor = DetikzifyProcessor(cs.smoke_tokenizer(ByteTokenizer, cfg),
                                   cfg)
    fig = cs.synthetic_figures(1, args.seed + 1)[0]
    temperature = SamplingParams().temperature

    def run(variant, expansions, max_new_tokens):
        spec = {} if variant == "plain" else dict(speculate=cs.SPECULATE,
                                                  spec_min_rate=0.0)
        if variant != "plain":
            llama.decode_verify_attend_paged = builds[variant]
        cs._free(torch, False)
        eng = cs._engine(torch, params, cfg, dev, args.seed,
                         temperature=temperature, **spec)
        pipe = DetikzifyPipeline(params, cfg, processor, engine=eng,
                                 device=dev, seed=args.seed)
        host.update(s=0.0, calls=0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = list(pipe.simulate(image=fig, expansions=expansions,
                                     parallelism=8,
                                     max_new_tokens=max_new_tokens))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        c = dict(eng.counters)
        pipe.close()
        if len(results) != expansions or eng.num_active:
            raise SystemExit(f"{variant}: simulate yielded {len(results)} "
                             f"results, {eng.num_active} slots active")
        if spec and c["spec_steps"] <= 0:
            raise SystemExit(f"{variant}: no speculative step ran")
        return {"variant": variant, "wall_s": wall_s,
                "rollouts_per_min": expansions / wall_s * 60,
                "decode_tokens": c["decode_tokens"],
                "spec_steps": c.get("spec_steps", 0),
                "k4_calls": host["calls"], "k4_host_ms": host["s"] * 1e3,
                "k4_host_us_per_call": host["s"] * 1e6 / max(host["calls"],
                                                             1)}

    for variant in ("plain", "old", "new"):
        run(variant, 8, 16)
    rows = []
    for variant in ("plain", "old", "new", "new", "old", "plain"):
        rows.append(run(variant, cs.SIM_EXPANSIONS, args.max_new_tokens))
        cs.emit(rows[-1])
    llama.decode_verify_attend_paged = paged.decode_verify_attend_paged

    def mean(variant, key):
        vals = [r[key] for r in rows if r["variant"] == variant]
        return sum(vals) / len(vals)

    cs.emit({"summary": {
        v: {k: mean(v, k) for k in ("rollouts_per_min", "wall_s",
                                    "k4_host_us_per_call")}
        for v in ("plain", "old", "new")},
        "new_over_old_rate": mean("new", "rollouts_per_min")
        / mean("old", "rollouts_per_min")})
    return 0


if __name__ == "__main__":
    sys.exit(main())
