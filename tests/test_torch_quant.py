"""The port's int8 weight-only path against the JAX package, on the CPU.

``ops/quant.py`` (quantize, fuse, host quantize), the plain version of K5
(``int8_matmul_plain``) against JAX ``int8_matmul`` on its XLA branch and
its Pallas kernel in interpret mode, ``params_from_numpy`` of a JAX
``fuse_projections(quantize_params(...))`` tree, and the int8 + fused model
and engine against the JAX ones at ``tiny-test`` in fp32. K5 itself is held
against ``int8_matmul_plain`` on the card (``tests/test_torch_gpu.py``).
"""
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from detikzify_tpu.config import tiny_test_config
from detikzify_tpu.engine import DecodeEngine as JEngine
from detikzify_tpu.models import detikzify as jdet
from detikzify_tpu.ops import quant as jquant
from detikzify_tpu.ops.quant_matmul import int8_matmul as j_int8_matmul
from detikzify_tpu.ops.sampling import SamplingParams as JSampling
from detikzify_torch.config import tiny_test_config as t_tiny_test_config
from detikzify_torch.engine import DecodeEngine as TEngine
from detikzify_torch.models import convert
from detikzify_torch.models import detikzify as tdet
from detikzify_torch.ops import quant as tquant
from detikzify_torch.ops.quant import QuantLinear
from detikzify_torch.ops.quant_matmul import (gemv_plan, int8_gemv_split_plain,
                                              int8_matmul, int8_matmul_plain)
from detikzify_torch.ops.sampling import SamplingParams as TSampling

torch.set_num_threads(1)

TOL = 3e-4


def _numpy(tree):
    return jax.tree.map(np.asarray, tree._asdict())


@pytest.fixture(scope="module")
def trees():
    """(cfg, JAX fp32 params, JAX int8 + fused params, port int8 + fused
    params carried over from the JAX tree)."""
    cfg = tiny_test_config(vocab_size=512)
    jp = jdet.init(jax.random.PRNGKey(3), cfg)
    jq = jquant.fuse_projections(jquant.quantize_params(jp))
    tcfg = t_tiny_test_config(vocab_size=512)
    tq = convert.params_from_numpy(_numpy(jq), tcfg, device="cpu")
    return cfg, tcfg, jp, jq, tq


@pytest.mark.parametrize("shape", [(96, 80), (128, 384)])
def test_quantize_kernel_matches_jax(shape):
    """q equal element for element (both round half to even after one fp32
    division), scale within one fp32 ulp."""
    w = np.random.default_rng(shape[0]).standard_normal(shape).astype(
        np.float32)
    want = jquant.quantize_kernel(jnp.asarray(w))        # [in, out] layout
    q, scale = tquant.quantize_kernel(torch.from_numpy(w.T.copy()))
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(want["q"]).T)
    np.testing.assert_array_max_ulp(scale.numpy(), np.asarray(want["scale"]),
                                    maxulp=1)


@pytest.mark.parametrize("block_elements", [1, 3 * 384, 5 * 384 + 7, 1 << 30])
def test_quantize_kernel_block_does_not_change_result(block_elements):
    """One row per block, blocks of three and five rows (the last one
    partial) and one block for the whole weight give the same bits, and q
    equal to the JAX package's."""
    w = np.random.default_rng(7).standard_normal((97, 384)).astype(
        np.float32)
    tw = torch.from_numpy(w).to(torch.bfloat16)
    q, scale = tquant.quantize_kernel(tw, block_elements)
    wq, wscale = tquant.quantize_kernel(tw, tw.numel())
    assert torch.equal(q, wq) and torch.equal(scale, wscale)
    want = jquant.quantize_kernel(jnp.asarray(tw.float().numpy().T))
    np.testing.assert_array_equal(q.numpy(), np.asarray(want["q"]).T)


def test_quantize_params_structure_matches_jax(trees):
    cfg, tcfg, jp, _, _ = trees
    tp = convert.params_from_numpy(_numpy(jp), tcfg, device="cpu")
    n_fp = tquant.params_nbytes(tp)
    tquant.quantize_params(tp)
    jq = jquant.quantize_params(jp)
    # the JAX keys: text and vision projections, the MAP head, lm_head;
    # not the connector, the patch embedding or the token embedding
    for mod in (tp.text.layers[1].attn.q, tp.text.layers[0].mlp.down,
                tp.vision.layers[1].mlp.fc1, tp.vision.head.attn.o,
                tp.vision.head.mlp.fc2, tp.text.lm_head):
        assert isinstance(mod, QuantLinear)
    for mod in (tp.connector.proj, tp.vision.embeddings.patch):
        assert type(mod) is torch.nn.Linear
    assert tp.text.embed_tokens.dtype == torch.float32
    assert tquant.params_nbytes(tp) < n_fp
    np.testing.assert_array_equal(
        tp.vision.layers[1].attn.v.q.numpy(),
        np.asarray(jq.vision["layers"]["attn"]["v"]["kernel_q"]["q"][1]).T)
    np.testing.assert_array_equal(
        tp.text.lm_head.q.numpy(),
        np.asarray(jq.text["lm_head"]["kernel_q"]["q"]).T)
    # the fp32 scale survives a cast of the model; q stays int8
    tp.to(torch.bfloat16)
    assert tp.text.lm_head.scale.dtype == torch.float32
    assert tp.text.lm_head.q.dtype == torch.int8
    assert tp.text.embed_tokens.dtype == torch.bfloat16


def test_quantize_params_host_matches_device(trees):
    _, tcfg, jp, _, _ = trees
    dev = tquant.quantize_params(
        convert.params_from_numpy(_numpy(jp), tcfg, device="cpu"))
    host = tquant.quantize_params_host(
        convert.params_from_numpy(_numpy(jp), tcfg, device="cpu"))
    for a, b in ((dev.text.layers[0].attn.k, host.text.layers[0].attn.k),
                 (dev.vision.head.mlp.fc1, host.vision.head.mlp.fc1)):
        np.testing.assert_array_equal(a.q.numpy(), b.q.numpy())
        np.testing.assert_allclose(a.scale.numpy(), b.scale.numpy(),
                                   rtol=1e-6)
        np.testing.assert_array_equal(a.bias.numpy() if a.bias is not None
                                      else 0, b.bias.numpy()
                                      if b.bias is not None else 0)


@pytest.mark.parametrize("int8", [False, True])
def test_fuse_projections_exact(trees, int8):
    """Fused and unfused layouts give the same logits; int8 scales
    concatenate, so quantize-then-fuse == fuse-then-quantize."""
    cfg, tcfg, jp, _, _ = trees

    def build():
        p = convert.params_from_numpy(_numpy(jp), tcfg, device="cpu")
        return tquant.quantize_params(p) if int8 else p

    plain, fused = build(), tquant.fuse_projections(build())
    layer = fused.text.layers[1]
    assert hasattr(layer.attn, "qkv") and not hasattr(layer.attn, "q")
    assert hasattr(layer.mlp, "gateup") and not hasattr(layer.mlp, "gate")
    ids = np.full((1, cfg.image_seq_len + 6), cfg.image_token_id, np.int32)
    ids[0, cfg.image_seq_len:] = [cfg.bos_token_id, 5, 6, 7, 8, 9]
    pix = np.random.default_rng(0).standard_normal(
        (1, cfg.vision.image_size, cfg.vision.image_size, 3)).astype(
            np.float32)
    l0, _ = tdet.forward(plain, tcfg, torch.from_numpy(ids),
                         torch.from_numpy(pix))
    l1, _ = tdet.forward(fused, tcfg, torch.from_numpy(ids),
                         torch.from_numpy(pix))
    np.testing.assert_allclose(l1.numpy(), l0.numpy(), atol=1e-5, rtol=1e-4)
    if int8:
        fq = tquant.quantize_params(tquant.fuse_projections(
            convert.params_from_numpy(_numpy(jp), tcfg, device="cpu")))
        for a, b in ((fused.text.layers[0].attn.qkv,
                      fq.text.layers[0].attn.qkv),
                     (fused.text.layers[1].mlp.gateup,
                      fq.text.layers[1].mlp.gateup)):
            np.testing.assert_array_equal(a.q.numpy(), b.q.numpy())
            np.testing.assert_array_equal(a.scale.numpy(), b.scale.numpy())


@pytest.mark.parametrize("rows", [1, 8, 64, 65])
@pytest.mark.parametrize("k,n", [(256, 256), (256, 384), (384, 256),
                                 (384, 384), (256, 272)])
def test_int8_matmul_plain_matches_jax(rows, k, n):
    """The plain version against JAX int8_matmul on its XLA branch and
    through the Pallas kernel in interpret mode (rows 65 and N=272 are
    ineligible: JAX takes its XLA branch there).

    fp32 x, XLA branch: the same fp32 products summed in fp32, so within
    1e-5 of the output's scale. bf16 x (the Pallas kernel computes in bf16
    and writes bf16 whatever x was), XLA branch and Pallas kernel: the same
    exact products, fp32 sums in either order, one rounding to bf16, so at
    most one bf16 ulp (2^-7 relative) apart, and equal nearly everywhere."""
    rng = np.random.default_rng(rows * 1000 + k + n)
    xb = jnp.asarray(rng.standard_normal((rows, k)), jnp.bfloat16)
    x = np.array(xb.astype(jnp.float32))
    qd = jquant.quantize_kernel(jnp.asarray(
        rng.standard_normal((k, n)), jnp.float32))
    xt = torch.from_numpy(x)
    qt = torch.from_numpy(np.asarray(qd["q"]).T.copy())
    st = torch.from_numpy(np.array(qd["scale"]))
    got = int8_matmul_plain(xt, qt, st).numpy()
    assert torch.equal(int8_matmul(xt, qt, st), torch.from_numpy(got))
    want = np.asarray(j_int8_matmul(jnp.asarray(x), qd["q"], qd["scale"]))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    got_b = int8_matmul_plain(xt.to(torch.bfloat16), qt, st).float().numpy()
    for kw in ({}, {"force_pallas": True, "interpret": True}):
        want_b = np.asarray(j_int8_matmul(xb, qd["q"], qd["scale"], **kw)
                            .astype(jnp.float32))
        np.testing.assert_array_less(np.abs(got_b - want_b),
                                     2.0 ** -7 * np.abs(want_b) + 1e-30)
        assert (got_b == want_b).mean() >= 0.99
    # an fp32 output from a bf16 input (the int8 lm_head): no bf16 rounding
    f32 = int8_matmul(xt.to(torch.bfloat16), qt, st,
                      out_dtype=torch.float32)
    assert f32.dtype == torch.float32
    np.testing.assert_allclose(f32.numpy(), got, rtol=0,
                               atol=1e-6 * np.abs(got).max())


def _k5_bound(want, mag, k, out_dtype):
    """K5's tolerance (chip_smoke.py): a bf16 output within 2^-7 |want| +
    K 2^-23 mag (one output rounding, two fp32 sums of K products in
    different orders, worst case); an fp32 output within 2 sqrt(K) 2^-24
    mag, mag = plain(|x|, |q|)."""
    if out_dtype == torch.bfloat16:
        return 2.0 ** -7 * want.abs() + k * 2.0 ** -23 * mag
    return 2 * k ** 0.5 * 2.0 ** -24 * mag


@pytest.mark.parametrize("rows", [1, 8, 40, 64])
@pytest.mark.parametrize("k,splits", [(384, 1), (384, 3), (1152, 4),
                                      (1152, 9)])
def test_int8_gemv_split_matches_plain_and_jax(rows, k, splits):
    """K5's split over K in PyTorch (per-split fp32 partials added in split
    order, then scaled once) against the plain version and JAX int8_matmul,
    on its XLA branch and through the Pallas kernel in interpret mode, with
    K5's tolerance; the fp32 output (the lm_head's) against the plain fp32
    product. One split is the plain product itself."""
    n = 256
    rng = np.random.default_rng(rows * 100 + k + splits)
    xb = jnp.asarray(rng.standard_normal((rows, k)), jnp.bfloat16)
    qd = jquant.quantize_kernel(jnp.asarray(
        rng.standard_normal((k, n)), jnp.float32))
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(
        torch.bfloat16)
    qt = torch.from_numpy(np.asarray(qd["q"]).T.copy())
    st = torch.from_numpy(np.array(qd["scale"]))
    mag = int8_matmul_plain(xt.abs(), qt.abs(), st, torch.float32)
    for out in (torch.bfloat16, torch.float32):
        got = int8_gemv_split_plain(xt, qt, st, splits, out)
        want = int8_matmul_plain(xt, qt, st, out)
        assert got.dtype == out and got.shape == (rows, n)
        if splits == 1:
            assert torch.equal(got, want)
        bound = _k5_bound(want.float(), mag, k, out)
        assert bool(((got.float() - want.float()).abs() <= bound).all())
    got = int8_gemv_split_plain(xt, qt, st, splits).float()
    for kw in ({}, {"force_pallas": True, "interpret": True}):
        want = torch.from_numpy(np.array(
            j_int8_matmul(xb, qd["q"], qd["scale"], **kw).astype(
                jnp.float32)))
        bound = _k5_bound(want, mag, k, torch.bfloat16)
        assert bool(((got - want).abs() <= bound).all())


def _k5_cases():
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    return ([(name, k, n, m) for name, k, n, _ in chip_smoke.K5_CASES
             for m in chip_smoke.K5_ROWS]
            + [(name, k, n, m) for name, k, n, _ in chip_smoke.K5_V1_CASES
               for m in chip_smoke.K5_V1_ROWS])


# the launch K5 gets at each chip_smoke.py product on 132 SMs: (warps
# along K, splits, blocks) at <= 8 rows and above
K5_PLANS = {"qkv": ((8, 1, 384), (1, 5, 240)),
            "o": ((8, 1, 256), (1, 8, 256)),
            "gateup": ((8, 1, 1792), (1, 1, 224)),
            "down": ((8, 1, 256), (1, 8, 256)),
            "lm_head": ((8, 1, 8016), (1, 1, 1002)),
            "map_head_q_o": ((8, 1, 72), (1, 9, 81)),
            # TinyLlama's fused products (the v1 family), at <= 8 rows only
            "v1_qkv": ((8, 1, 160), None), "v1_o": ((8, 1, 128), None),
            "v1_gateup": ((8, 1, 704), None), "v1_down": ((8, 1, 128), None)}


@pytest.mark.parametrize("name,k,n,m", _k5_cases())
def test_gemv_plan_at_chip_smoke_shapes(name, k, n, m):
    """The wrapper's host-side plan: ceil(M / 8) tiles of 8 rows; narrow
    blocks (16 channels, 8 warps along K, never split) up to 8 rows; wide
    blocks (128 channels) above, K split where they are fewer than the
    SMs, so that 2 blocks an SM fill the card, each split at least one
    128-wide chunk; fp32 scratch of splits * M * N partials when split."""
    plan = gemv_plan(m, n, k, 132)
    assert plan.n_tiles == -(-m // 8)
    warps_k, splits, blocks = K5_PLANS[name][m > 8]
    assert (plan.warps_k, plan.splits, plan.blocks) == (warps_k, splits,
                                                        blocks)
    assert plan.scratch == (splits * m * n if splits > 1 else 0)
    assert 1 <= plan.splits <= k // 128
    if plan.splits > 1:
        assert plan.blocks <= 2 * 132


def test_params_from_numpy_int8_fused_tree(trees):
    _, _, _, jq, tq = trees
    lj = jq.text["layers"]
    for i in range(2):
        qkv = tq.text.layers[i].attn.qkv
        assert isinstance(qkv, QuantLinear)
        np.testing.assert_array_equal(
            qkv.q.numpy(), np.asarray(lj["attn"]["qkv"]["kernel_q"]["q"][i]).T)
        np.testing.assert_array_equal(
            qkv.scale.numpy(),
            np.asarray(lj["attn"]["qkv"]["kernel_q"]["scale"][i]))
        gu = tq.text.layers[i].mlp.gateup
        np.testing.assert_array_equal(
            gu.q.numpy(), np.asarray(lj["mlp"]["gateup"]["kernel_q"]["q"][i]).T)
    assert isinstance(tq.vision.layers[0].attn.q, QuantLinear)
    np.testing.assert_array_equal(
        tq.vision.layers[0].attn.q.bias.numpy(),
        np.asarray(jq.vision["layers"]["attn"]["q"]["bias"][0]))


def test_int8_fused_forward_matches_jax(trees):
    """Logits of the int8 + fused model within 3e-4 of JAX, with the
    vision tower (int8 too) in the loop."""
    cfg, tcfg, _, jq, tq = trees
    rng = np.random.default_rng(4)
    ids = np.full((2, cfg.image_seq_len + 7), cfg.image_token_id, np.int32)
    ids[:, cfg.image_seq_len] = cfg.bos_token_id
    ids[:, cfg.image_seq_len + 1:] = rng.integers(0, 500, (2, 6))
    size = cfg.vision.image_size
    pix = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    want, _ = jdet.forward(jq, cfg, jnp.asarray(ids), jnp.asarray(pix),
                           attn_impl="xla")
    got, _ = tdet.forward(tq, tcfg, torch.from_numpy(ids),
                          torch.from_numpy(pix))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_int8_engine_greedy_matches_jax(trees):
    """The engine's greedy streams on the int8 + fused tree equal the JAX
    engine's: a fresh start, an image prompt, and a burst of two."""
    cfg, tcfg, _, jq, tq = trees
    kw = dict(num_slots=3, max_len=128, page_size=16)
    jeng = JEngine(jq, cfg, cache_dtype=jnp.float32,
                   sampling=JSampling(temperature=0.0), **kw)
    teng = TEngine(tq, tcfg, cache_dtype=torch.float32,
                   sampling=TSampling(temperature=0.0), device="cpu", **kw)
    size = cfg.vision.image_size
    pix = np.random.default_rng(5).standard_normal(
        (1, size, size, 3)).astype(np.float32)
    image_prompt = [cfg.image_token_id] * cfg.image_seq_len + [
        cfg.bos_token_id]

    def run(eng, emb):
        out = []
        for prompt, e in (([cfg.bos_token_id, 5, 6, 7], None),
                          (image_prompt, emb)):
            ro = eng.start(prompt, image_embeds=e, max_new_tokens=12)
            while not ro.finished:
                eng.step()
            out.append(list(ro.token_ids))
            eng.release(ro)
        ros = eng.start_many([[cfg.bos_token_id, 9], [cfg.bos_token_id, 11,
                                                      12]],
                             max_new_tokens=10)
        while not all(ro.finished for ro in ros):
            eng.step()
        out.extend(list(ro.token_ids) for ro in ros)
        for ro in ros:
            eng.release(ro)
        return out

    want = run(jeng, jeng.encode_image(jnp.asarray(pix)))
    got = run(teng, teng.encode_image(pix))
    assert got == want
    assert all(len(s) > 3 for s in got)


def test_quant_block_ab_tool_runs():
    """``tools/quant_block_ab.py`` at ``tiny-test`` on the CPU: every
    block size gives the whole pass's bits, and the model total counts
    each projection shape of the preset."""
    import json
    import subprocess

    root = Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, str(root / "tools" / "quant_block_ab.py"),
         "--preset", "tiny-test", "--blocks", "64,4096,0"],
        capture_output=True, text=True, check=True, cwd=root).stdout
    lines = [json.loads(line) for line in out.splitlines()]
    rows = [d for d in lines if "shape" in d]
    assert rows and all(d["same_bits"] for d in rows)
    assert lines[-1]["same_bits"] and set(lines[-1]["model_total_s"]) == {
        "64", "4096", "0"}
    cfg = t_tiny_test_config(vocab_size=512)
    n_quantized = len(tquant._targets(
        tdet.Params(cfg, device="meta"), tquant.QUANT_KEYS))
    assert sum(d["count"] for d in rows) == n_quantized
