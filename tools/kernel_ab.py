#!/usr/bin/env python3
"""Time two builds of the port's kernels K1-K5 on one card, in turns.

    python3 tools/kernel_ab.py --old DIR [--iters 30] [--only k5|f32]
                               [--profile]

DIR holds an earlier ``detikzify_torch/csrc`` whose K1-K4 have the current
C interfaces and whose K5 (``int8_gemv.cu``) has either the current one
(run at the package's plan) or the one before the split over K (no split
count), for example the sources of an earlier commit unpacked with
``git archive <commit> detikzify_torch/csrc | tar -x``.
Those sources are built with nvcc beside the package's own kernels, each
build is held against the plain version at ``chip_smoke.py``'s shapes with
``chip_smoke.py``'s tolerance, and both are timed in the order old, new,
new, old (CUDA events, L2 flushed before each launch, median of
``--iters``). One more row times K4 with 256-row splits (as "old") against
the package's 128-row build: a copy of ``paged_verify.cu`` with 8 warps per
split block instead of 4, written with copies of its headers to
``build/ab/`` and built from there.

K5 runs at every ``chip_smoke.py`` product (``K5_CASES``) and 1, 8, 40 and
64 rows, with the bf16 ``F.linear`` on the dequantised weight timed beside
both builds; the new kernel is also timed at other split counts where the
package's plan splits K (``alt_ms``). Each K5 row also reports the host time of one call of the
package's K5 wrapper (median over 200 calls, no synchronisation) and, with
``--profile``, each K5 device function's profiled time. Prints the card
as nvidia-smi names it, then one JSON line per shape; exits non-zero if a
build disagrees with the plain version or there is no card.

``--only f32`` times the float32 entry points of K1-K4 instead (DIR's
``detikzify_flash_attention_f32``, ``detikzify_paged_decode_f32``,
``detikzify_paged_verify_f32`` and ``detikzify_decode_contig_f32`` with the
current C interfaces): every float32 row of ``chip_smoke.py``'s kernel
phase is run through the package's wrappers with the old build's handle in
place of the new one, then with the new one, old, new, new, old; each run
holds its build to ``chip_smoke.py``'s fp32 tolerance with its controls,
and each JSON line gives ``old_ms`` and ``new_ms`` beside the row's bound,
plain and SDPA times from the new runs.
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def split256_source(csrc: Path, out: Path) -> Path:
    """Copy K4's source into ``out`` with 8 warps (256 key rows) per split
    block instead of 4, beside copies of the headers it includes; returns
    the copied source."""
    line = "constexpr int WARPS = 4;"
    text = (csrc / "paged_verify.cu").read_text()
    if text.count(line) != 1:
        raise SystemExit(f"kernel_ab.py: {line!r} not found once in "
                         "paged_verify.cu")
    out.mkdir(parents=True, exist_ok=True)
    for h in csrc.glob("*.cuh"):
        shutil.copyfile(h, out / h.name)
    src = out / "paged_verify.cu"
    src.write_text(text.replace(line, "constexpr int WARPS = 8;"))
    return src


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", required=True,
                    help="directory with the earlier csrc sources")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--only", choices=("k5", "f32"),
                    help="time only K5, or only K1-K4's float32 entry "
                         "points")
    ap.add_argument("--profile", action="store_true",
                    help="K5: also the device time of each of its device "
                         "functions under torch.profiler, old and new")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab.py: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    import chip_smoke as cs
    from detikzify_torch.ops import attention, flash, paged
    from detikzify_torch.ops.cuda import (CSRC, KERNELS, CudaKernel, I, P,
                                          split_scratch)

    old = Path(args.old).resolve()
    if args.only == "f32":
        return f32_main(torch, cs, old, args.iters)
    old_headers = sorted(old.glob("*.cuh"))

    def old_kernel(name, source):
        return CudaKernel(name + "_old", old / source, KERNELS[name].symbol,
                          KERNELS[name].argtypes, headers=old_headers)

    # an old K5 with the split over K takes the package's interface and plan
    old_k5_split = "nsplit" in (old / "int8_gemv.cu").read_text()
    old_k5 = CudaKernel("int8_gemv_old", old / "int8_gemv.cu",
                        "detikzify_int8_gemv",
                        KERNELS["int8_gemv"].argtypes if old_k5_split
                        else [P, P, P, P, I, I, I, I, I, P],
                        headers=old_headers)
    kernels = [old_k5, KERNELS["int8_gemv"]]
    if args.only is None:
        old_k1 = old_kernel("flash_attention", "flash_attn.cu")
        old_k2 = old_kernel("paged_decode", "paged_decode.cu")
        old_k3 = old_kernel("decode_contig", "decode_contig.cu")
        old_k4 = old_kernel("paged_verify", "paged_verify.cu")
        src256 = split256_source(CSRC, ROOT / "build" / "ab" / "split256")
        k4_256 = CudaKernel("paged_verify_split256", src256,
                            "detikzify_paged_verify",
                            KERNELS["paged_verify"].argtypes,
                            headers=sorted(src256.parent.glob("*.cuh")))
        kernels += [old_k1, old_k2, old_k3, old_k4, k4_256,
                    *(KERNELS[n] for n in ("flash_attention", "paged_decode",
                                           "decode_contig", "paged_verify"))]
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
    stream = torch.cuda.current_stream(dev).cuda_stream
    failed = []

    def report(name, shape, old_fn, new_fn, want, pv_abs, bound,
               old_tag="old", check=None, extra=None):
        row = {"name": name, "shape": shape, "old": old_tag, **bound}
        for tag, fn in (("old", old_fn), ("new", new_fn)):
            tol = (check(fn()) if check is not None else
                   cs.tolerance_check(torch, fn(), want, pv_abs))
            row[f"{tag}_max_err_over_tol"] = tol["max_err_over_tol"]
            if not tol["ok"]:
                failed.append(f"{name} {tag}")
        t = [timer(old_fn), timer(new_fn), timer(new_fn), timer(old_fn)]
        row["old_ms"], row["new_ms"] = [t[0], t[3]], [t[1], t[2]]
        row["speedup"] = (t[0] + t[3]) / (t[1] + t[2])
        row.update(extra() if extra is not None else {})
        cs.emit(row)

    def rnd(*shape):
        return torch.randn(shape, generator=gen,
                           device=dev).to(torch.bfloat16)

    # K5: the interface before the split over K has no split count
    k5_rows(torch, cs, timer, gen, dev, stream, old_k5, old_k5_split, report,
            failed, args.profile)
    if args.only == "k5":
        return finish(failed)

    # K1: the same C interface in both builds
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

    # K2: the same C interface in both builds
    c = cs.K2_CASE
    b, nh, nkv, hd, page, m = (c[x] for x in ("B", "NH", "NKV", "Hd", "page",
                                              "m"))
    n_pages = b * m + 1
    pool_k, pool_v = rnd(n_pages, page, nkv, hd), rnd(n_pages, page, nkv, hd)
    perm = torch.randperm(n_pages, generator=gen, device=dev)[:b * m]
    tab = perm.reshape(b, m).to(torch.int32).contiguous()
    lengths = torch.tensor(c["lengths"], dtype=torch.int32, device=dev)
    q = rnd(b, nh, hd)

    def old_k2_fn():
        out = torch.empty_like(q)
        scratch = split_scratch(b * nh, m * page, hd, dev)
        old_k2.launch(q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
                      tab.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                      scratch.data_ptr(), scratch.numel(), b, nh, nkv, hd,
                      page, m, tab.stride(0), hd ** -0.5, stream)
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

    # K4: the same C interface in both builds; then 256- against 128-row
    # splits
    c = cs.K4_CASE
    b, k1, nh, nkv, hd, page, m = (c[x] for x in ("B", "K1", "NH", "NKV",
                                                  "Hd", "page", "m"))
    n_pages = b * m + 1
    pool_k, pool_v = rnd(n_pages, page, nkv, hd), rnd(n_pages, page, nkv, hd)
    perm = torch.randperm(n_pages, generator=gen, device=dev)[:b * m]
    tab = perm.reshape(b, m).to(torch.int32).contiguous()
    starts = torch.tensor(c["starts"], dtype=torch.int32, device=dev)
    qv = rnd(b, k1, nh, hd)

    def k4_fn(kernel):
        out = torch.empty_like(qv)
        scratch = split_scratch(b * k1 * nh, m * page, hd, dev)
        kernel.launch(qv.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
                      tab.data_ptr(), starts.data_ptr(), out.data_ptr(),
                      scratch.data_ptr(), scratch.numel(), b, k1, nh, nkv,
                      hd, page, m, tab.stride(0), hd ** -0.5, stream)
        return out

    width = m * page
    rows_read = sum(min(s0 + k1, width) for s0 in c["starts"])
    visible = sum(min(s0 + j + 1, width) for s0 in c["starts"]
                  for j in range(k1))
    k4_args = (qv, pool_k, pool_v, tab, starts)
    k4_shape = {"B": b, "K1": k1, "NH": nh, "NKV": nkv, "Hd": hd,
                "page": page, "m": m, "starts": list(c["starts"])}
    k4_want = paged.decode_verify_attend_paged_plain(*k4_args)
    k4_pv = paged.decode_verify_attend_paged_plain(qv, pool_k, pool_v.abs(),
                                                   tab, starts)
    k4_bound = cs.bound(rows_read * nkv * hd * 2 * 2 + 2 * qv.numel() * 2,
                        4 * nh * hd * visible)
    for name, old_fn, tag in (("paged_verify", lambda: k4_fn(old_k4), "old"),
                              ("paged_verify/split256_vs_128",
                               lambda: k4_fn(k4_256), "split256")):
        report(name, k4_shape, old_fn,
               lambda: paged.decode_verify_attend_paged(*k4_args), k4_want,
               k4_pv, k4_bound, old_tag=tag)

    # K3: the same C interface in both builds; the whole cache and a view
    c = cs.K3_CASE
    b, length, nh, nkv, hd = (c[x] for x in ("B", "L", "NH", "NKV", "Hd"))
    q = rnd(b, nh, hd)
    k_full, v_full = rnd(b, length, nkv, hd), rnd(b, length, nkv, hd)
    for limit in c["limits"]:
        k, v = k_full, v_full
        lens = torch.tensor(c["lengths"], dtype=torch.int32, device=dev)
        if limit is not None:
            k, v, lens = k[:, :limit], v[:, :limit], lens.clamp(max=limit)

        def old_k3_fn(k=k, v=v, lens=lens):
            out = torch.empty_like(q)
            scratch = split_scratch(b * nh, k.shape[1], hd, dev)
            old_k3.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          lens.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                          scratch.numel(), b, nh, nkv, hd, k.shape[1],
                          k.stride(0), hd ** -0.5, stream)
            return out

        live = int(lens.sum())
        report("decode_contig" + ("" if limit is None
                                  else f"/kv_limit{limit}"),
               {"B": b, "L": k.shape[1], "NH": nh, "NKV": nkv, "Hd": hd,
                "lengths": lens.tolist()},
               old_k3_fn,
               lambda k=k, v=v, lens=lens: attention.decode_attend(
                   q, k, v, lens),
               attention.decode_attend_plain(q, k, v, lens),
               attention.decode_attend_plain(q, k, v.abs(), lens),
               cs.bound(live * nkv * hd * 2 * 2 + 2 * q.numel() * 2,
                        4 * nh * hd * live))
    return finish(failed)


# K1-K4's float32 entry points: (module, attribute holding the handle,
# KERNELS name, source file)
F32_HANDLES = (
    ("flash", "KERNEL_F32", "flash_attention_f32", "flash_attn_f32.cu"),
    ("paged", "KERNEL_F32", "paged_decode_f32", "paged_decode.cu"),
    ("paged", "VERIFY_KERNEL_F32", "paged_verify_f32", "paged_verify.cu"),
    ("decode_flash", "KERNEL_F32", "decode_contig_f32", "decode_contig.cu"),
)


def f32_main(torch, cs, old: Path, iters: int) -> int:
    """``--only f32``: every float32 row of the kernel phase, old build
    against new (see the module's docstring). A row whose build disagrees
    with the plain version stops the run (``chip_smoke.py``'s row
    builders raise SystemExit)."""
    from detikzify_torch.ops import decode_flash, flash, paged
    from detikzify_torch.ops.cuda import KERNELS, CudaKernel

    modules = {"flash": flash, "paged": paged, "decode_flash": decode_flash}
    headers = sorted(old.glob("*.cuh"))
    olds = {name: CudaKernel(name + "_old", old / src, KERNELS[name].symbol,
                             KERNELS[name].argtypes, headers=headers)
            for _, _, name, src in F32_HANDLES}
    kernels = list(olds.values()) + [KERNELS[n] for _, _, n, _ in
                                     F32_HANDLES]
    started = [(k, k._start_build()) for k in kernels]
    for k, st in started:
        if st is not None:
            k._finish_build(st)
    for k in kernels:
        k._load()

    def use(which: str) -> None:
        for mod, attr, name, _ in F32_HANDLES:
            setattr(modules[mod], attr,
                    olds[name] if which == "old" else KERNELS[name])

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.nvidia_smi()
    print(smi, flush=True)
    timer = cs.Timer(torch, dev, iters)
    f32 = torch.float32
    runs = [lambda g, c=case, p=prompt, n=lengths: cs.k1_row(
                torch, g, dev, False, timer, c, p, n, f32)
            for case, prompt, lengths, dtype in cs.k1_cases(torch)
            if dtype == f32]
    runs += [lambda g, fn=fn, c=case, n=name: fn(
                 torch, g, dev, False, timer, c, n, f32)
             for fn, case, name in cs.f32_decode_cases()]
    for run in runs:
        got = {}
        for which in ("old", "new", "new", "old"):
            use(which)
            res = run(torch.Generator(device=dev).manual_seed(1234))
            for r in res if isinstance(res, list) else [res]:
                got.setdefault(r["name"], []).append((which, r))
        use("new")
        for name, both in got.items():
            new = [r for w, r in both if w == "new"]
            row = {k: v for k, v in new[0].items()
                   if k not in ("ms", "plain_ms", "library_ms")}
            row.update(
                device=smi,
                old_ms=[r["ms"] for w, r in both if w == "old"],
                new_ms=[r["ms"] for r in new],
                plain_ms=[r["plain_ms"] for r in new],
                library_ms=[r["library_ms"] for r in new],
                old_max_err_over_tol=max(r["max_err_over_tol"]
                                         for w, r in both if w == "old"))
            row["speedup"] = sum(row["old_ms"]) / sum(row["new_ms"])
            cs.emit(row)
    return finish([])


def finish(failed) -> int:
    if failed:
        print(json.dumps({"ok": False, "disagree": failed}), flush=True)
        return 1
    print(json.dumps({"ok": True}), flush=True)
    return 0


def k5_rows(torch, cs, timer, gen, dev, stream, old_k5, old_k5_split,
            report, failed, profile: bool) -> None:
    """K5 old against new at every K5_CASES product and K5_ROWS row count,
    with chip_smoke.py's K5 tolerance, the bf16 F.linear yardstick, the new
    kernel at other split counts where the plan splits, and the wrapper's
    host time a call; with
    ``profile``, the mean device time of each K5 device function a call
    (L2 flushed before each), old and new."""
    import time

    import torch.nn.functional as F

    from detikzify_torch.ops import quant_matmul as qm
    from detikzify_torch.ops.quant import quantize_kernel

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, k, n, out in cs.K5_CASES:
        w = torch.randn((n, k), generator=gen, device=dev) * k ** -0.5
        q, scale = quantize_kernel(w)
        w_bf16 = (q.float() * scale[:, None]).to(torch.bfloat16)
        del w
        out_dtype = torch.float32 if out == "fp32" else torch.bfloat16
        for m in cs.K5_ROWS:
            x = torch.randn((m, k), generator=gen, device=dev,
                            dtype=torch.float32).to(torch.bfloat16)
            plan = qm.gemv_plan(m, n, k, sms)

            def split_fn(splits, kernel=qm.KERNEL, x=x, q=q, scale=scale,
                         m=m):
                y = torch.empty((m, n), dtype=out_dtype, device=dev)
                part = torch.empty(max(1, splits * m * n),
                                   dtype=torch.float32, device=dev)
                kernel.launch(x.data_ptr(), q.data_ptr(), scale.data_ptr(),
                              y.data_ptr(), part.data_ptr(), m, n, k, splits,
                              0, int(out_dtype == torch.float32), stream)
                return y

            def old_fn(x=x, q=q, scale=scale, m=m, plan=plan,
                       split_fn=split_fn):
                if old_k5_split:
                    return split_fn(plan.splits, kernel=old_k5)
                y = torch.empty((m, n), dtype=out_dtype, device=dev)
                old_k5.launch(x.data_ptr(), q.data_ptr(), scale.data_ptr(),
                              y.data_ptr(), m, n, k, 0,
                              int(out_dtype == torch.float32), stream)
                return y

            def new_fn(x=x, q=q, scale=scale):
                return qm.int8_gemv(x, q, scale, out_dtype)

            want = qm.int8_matmul_plain(x, q, scale, out_dtype)
            mag = qm.int8_matmul_plain(x.abs(), q.abs(), scale,
                                       torch.float32)

            def check(got, want=want, mag=mag):
                return cs.k5_tolerance_check(torch, got, want, mag, k,
                                             out_dtype)

            def extra(x=x, plan=plan, split_fn=split_fn, new_fn=new_fn):
                row = {"plan": plan._asdict(),
                       "library_ms": timer(lambda: F.linear(x, w_bf16))}
                row["alt_ms"] = {}
                if plan.splits > 1:     # other split counts, same blocks
                    for s in sorted({1, max(1, plan.splits // 2),
                                     min(k // 128, plan.splits * 2)}):
                        row["alt_ms"][f"splits{s}"] = timer(
                            lambda s=s: split_fn(s))
                        if not check(split_fn(s))["ok"]:
                            failed.append(f"int8_gemv/{name}/rows{m} "
                                          f"splits{s}")
                torch.cuda.synchronize()
                host = []
                for _ in range(200):
                    t0 = time.perf_counter()
                    new_fn()
                    host.append(time.perf_counter() - t0)
                torch.cuda.synchronize()
                host.sort()
                row["wrapper_host_us"] = host[len(host) // 2] * 1e6
                if profile:
                    row["device_us"] = {tag: device_us(torch, timer, fn)
                                        for tag, fn in (("old", old_fn),
                                                        ("new", new_fn))}
                return row

            nbytes = n * k + m * k * 2 + n * 4 + m * n * (
                4 if out == "fp32" else 2)
            report(f"int8_gemv/{name}/rows{m}",
                   {"M": m, "K": k, "N": n, "out": out}, old_fn, new_fn,
                   None, None, cs.bound(nbytes, 2 * m * n * k), check=check,
                   extra=extra)
        del q, scale, w_bf16


def device_us(torch, timer, fn, calls: int = 10) -> dict:
    """Mean device time a call of each int8_gemv device function, over
    ``calls`` calls under torch.profiler, each after the timer's L2 flush."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            timer.flush_buf.zero_()
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None) \
            or getattr(e, "self_cuda_time_total", 0)
        if e.device_type == DeviceType.CUDA and "int8_gemv" in e.key:
            name = "reduce" if "reduce" in e.key else "main"
            out[name] = out.get(name, 0.0) + us / calls
    return out


if __name__ == "__main__":
    sys.exit(main())
