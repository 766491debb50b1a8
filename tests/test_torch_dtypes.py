"""Every dtype and head width the JAX package feeds its attention kernels,
on the CPU: the port's plain versions of K1-K4 (and the split arithmetic
that the fp32 CUDA kernels follow) against the JAX package at float32 and
head_dim 32, 16 and 12; ClipScore's default dtype; the spec-acceptance
model's config on every device.

Bound: 1e-5 absolute on attention outputs (``CLAUDE.md``'s fp32
invariant; outputs are averages of N(0, 1) values, so of order 1).
"""
import inspect

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from detikzify_tpu.evaluate import clipscore as jclip
from detikzify_tpu.evaluate import spec_acceptance as jspec
from detikzify_tpu.ops.attention import attend_xla
from detikzify_tpu.ops.attention import decode_attend as jdecode_attend
from detikzify_tpu.ops.flash import flash_attention as jflash
from detikzify_tpu.ops.paged import decode_attend_paged as jdecode_paged
from detikzify_tpu.ops.paged import decode_verify_attend_paged as jverify
from detikzify_torch.evaluate import clipscore as tclip
from detikzify_torch.evaluate import spec_acceptance as tspec
from detikzify_torch.ops import attention as tattention
from detikzify_torch.ops import flash as tflash
from detikzify_torch.ops import paged as tpaged

torch.set_num_threads(1)

ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _k1_inputs(rng, b, s, t, nh, nkv, hd, mode):
    """fp32 q, k, v from the seed and the mask keywords of ``mode``: a key
    mask with one fully masked row, causal, or the per-batch window with a
    restored row and a zero key limit."""
    q = rng.standard_normal((b, s, nh, hd)).astype(np.float32)
    k = rng.standard_normal((b, t, nkv, hd)).astype(np.float32)
    v = rng.standard_normal((b, t, nkv, hd)).astype(np.float32)
    kw = {}
    if mode == "causal":
        kw["causal"] = True
    elif mode == "mask":
        mask = np.ones((b, t), bool)
        mask[0, 7:] = False
        mask[1, :] = False                 # fully masked: a uniform average
        kw["kv_mask"] = mask
    elif mode == "window":
        kw["q_offsets"] = np.array([0, 5, 9], np.int32)[:b]
        kw["kv_limits"] = np.array([min(t, 20), 0, t], np.int32)[:b]
    return q, k, v, kw


@pytest.mark.parametrize("mode", ["full", "causal", "mask", "window"])
@pytest.mark.parametrize("hd", [32, 16, 12])
def test_k1_fp32_head_widths_match_pallas_and_xla(hd, mode):
    """The plain K1 (``attend_plain``, through the wrapper) and the
    split-key arithmetic at fp32 against the Pallas kernel in interpret
    mode and ``attend_xla``, at the spec model's head_dim 32 and
    tiny-test's 16 and 12, with every mask kind. A query row that sees no
    key is held against ``attend_xla`` alone: JAX's Pallas kernel averages
    such a row over its key tile padded to 128 rows, where ``attend_xla``
    (and the port, on both devices) averages over the T real keys."""
    b, s, t, nh, nkv = 3, 17, 40, 4, 2
    q, k, v, kw = _k1_inputs(np.random.default_rng(hd), b, s, t, nh, nkv, hd,
                             mode)
    jkw = {n: jnp.asarray(x) for n, x in kw.items() if n != "causal"}
    jkw["causal"] = kw.get("causal", False)
    xla = np.asarray(attend_xla(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), **jkw))
    pallas = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), interpret=True, **jkw))
    tkw = {n: (_t(x) if isinstance(x, np.ndarray) else x)
           for n, x in kw.items()}
    got = tflash.flash_attention(_t(q), _t(k), _t(v), **tkw)
    assert got.dtype == torch.float32
    split = tflash.attend_split_plain(_t(q), _t(k), _t(v), split=16, **tkw)
    sees = _sees_a_key(b, s, t, kw)                # [B, S]
    assert sees.any() and (mode in ("mask", "window")) == (~sees).any()
    for out in (got.numpy(), split.numpy()):
        np.testing.assert_allclose(out, xla, atol=ATOL, rtol=0)
        np.testing.assert_allclose(out[sees], pallas[sees], atol=ATOL,
                                   rtol=0)


def _sees_a_key(b, s, t, kw):
    """[B, S] bool: query row i of batch row b sees at least one key."""
    vis = np.ones((b, s, t), bool)
    if "kv_mask" in kw:
        vis &= kw["kv_mask"][:, None, :]
    ti, si = np.arange(t)[None, None, :], np.arange(s)[None, :, None]
    if kw.get("causal"):
        vis &= ti <= si + (t - s)
    if "q_offsets" in kw:
        vis &= ti <= kw["q_offsets"][:, None, None] + si
        vis &= ti < kw["kv_limits"][:, None, None]
    return vis.any(axis=-1)


def _pool(rng, n_pages, page, nkv, hd, b, m):
    pk = rng.standard_normal((n_pages, page, nkv, hd)).astype(np.float32)
    pv = rng.standard_normal((n_pages, page, nkv, hd)).astype(np.float32)
    tab = rng.permutation(n_pages)[:b * m].reshape(b, m).astype(np.int32)
    return pk, pv, tab


@pytest.mark.parametrize("nh,nkv", [(4, 4), (8, 2)])
def test_k2_k3_fp32_hd32_match_xla(nh, nkv):
    """K2's plain version and its split arithmetic over an fp32 pool at
    head_dim 32 (the spec model's MHA and a GQA group of 4), and K3's over
    the gathered contiguous cache and a kv_limit view of it, against the
    JAX XLA decode paths (JAX sends head_dim 32 to XLA)."""
    rng = np.random.default_rng(nh)
    b, hd, page, m = 4, 32, 16, 5
    pk, pv, tab = _pool(rng, b * m + 2, page, nkv, hd, b, m)
    q = rng.standard_normal((b, nh, hd)).astype(np.float32)
    lengths = np.array([1, 17, 48, m * page], np.int32)
    want = np.asarray(jdecode_paged(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(tab),
        jnp.asarray(lengths), implementation="xla"))
    args = (_t(q), _t(pk), _t(pv), _t(tab), _t(lengths))
    for got in (tpaged.decode_attend_paged(*args),
                tpaged.decode_attend_paged_split(*args, split=32)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)

    kc, vc = tpaged.gather_pages(_t(pk), _t(tab)), tpaged.gather_pages(
        _t(pv), _t(tab))
    for limit in (None, 40):
        k = kc if limit is None else kc[:, :limit]
        v = vc if limit is None else vc[:, :limit]
        lens = lengths if limit is None else np.minimum(lengths, limit)
        want = np.asarray(jdecode_attend(
            jnp.asarray(q), jnp.asarray(k.numpy()), jnp.asarray(v.numpy()),
            jnp.asarray(lens), implementation="xla"))
        for got in (tattention.decode_attend(_t(q), k, v, _t(lens)),
                    tpaged.decode_attend_contiguous_split(
                        _t(q), k, v, _t(lens), split=32)):
            np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("nh,nkv", [(4, 4), (8, 2)])
def test_k4_fp32_hd32_matches_xla(nh, nkv):
    """K4's plain version and its split arithmetic over an fp32 pool at
    head_dim 32: the verify window of speculate=4 with a dead slot (start 0)
    and one past the table's edge, against the JAX gather + masked XLA
    path."""
    rng = np.random.default_rng(10 + nh)
    b, k1, hd, page, m = 4, 5, 32, 16, 4
    pk, pv, tab = _pool(rng, b * m + 2, page, nkv, hd, b, m)
    q = rng.standard_normal((b, k1, nh, hd)).astype(np.float32)
    starts = np.array([0, 9, 30, m * page - 2], np.int32)
    want = np.asarray(jverify(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(tab),
        jnp.asarray(starts), implementation="xla"))
    args = (_t(q), _t(pk), _t(pv), _t(tab), _t(starts))
    for got in (tpaged.decode_verify_attend_paged(*args),
                tpaged.decode_verify_attend_paged_split(*args, split=32)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_clipscore_defaults_to_float32_like_jax():
    """``from_siglip_checkpoint`` builds fp32 towers unless asked for
    another dtype, on every device, as the JAX metric does."""
    tdef = inspect.signature(tclip.ClipScore.from_siglip_checkpoint
                             ).parameters["dtype"].default
    jdef = inspect.signature(jclip.ClipScore.from_siglip_checkpoint
                             ).parameters["dtype"].default
    assert tdef is torch.float32 and jdef is jnp.float32


def test_clipscore_checkpoint_towers_are_float32(tmp_path, monkeypatch):
    """A SigLIP checkpoint loaded without a dtype gives fp32 towers whose
    weights are the file's: the default the card now runs too."""
    import transformers

    from detikzify_torch.config import VisionConfig
    from detikzify_torch.models import convert
    from detikzify_torch.models import load as mload

    cfg = VisionConfig(hidden_size=48, intermediate_size=96,
                       num_hidden_layers=1, num_attention_heads=4,
                       image_size=42, patch_size=14)
    gen = torch.Generator().manual_seed(0)
    towers = mload.SiglipTowers(
        convert.init_random_siglip_vision(cfg, device="cpu",
                                          dtype=torch.float32, generator=gen),
        convert.init_random_siglip_text(cfg, 64, 16, device="cpu",
                                        dtype=torch.float32, generator=gen),
        cfg, cfg, 2.3, -10.0)
    mload.save_siglip_towers(str(tmp_path), towers)

    class Tok:
        eos_token_id, pad_token_id = 1, 1

        def encode(self, text, add_special_tokens=False):
            return [2 + ord(c) % 60 for c in text]

    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        lambda path: Tok())
    metric = tclip.ClipScore.from_siglip_checkpoint(str(tmp_path),
                                                    device="cpu")
    assert {p.dtype for p in metric.vision_params.parameters()} \
        == {p.dtype for p in metric.text_params.parameters()} \
        == {torch.float32}
    torch.testing.assert_close(metric.vision_params.state_dict(),
                               towers.vision.state_dict(), rtol=0, atol=0)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_spec_measurement_model_is_jax_on_every_device(device, monkeypatch):
    """``run_measurement`` builds the JAX package's spec model (4 heads of
    32 in fp32) whatever the device; the result names head_dim 32 and
    float32. The overfit and the rate measurement are stubbed: only the
    config they are handed is checked."""
    seen = {}

    def overfit(cfg, rows, steps, log_fn, device):
        seen["cfg"], seen["device"] = cfg, device
        return None, 0.5

    monkeypatch.setattr(tspec, "overfit", overfit)
    monkeypatch.setattr(tspec, "measure_spec_rate",
                        lambda *a, **kw: 1.0)
    out = tspec.run_measurement(n_programs=4, steps=1, n_eval=2,
                                log_fn=None, device=device)
    cfg = seen["cfg"]
    tok_len = cfg.text.vocab_size - 1
    want = jspec.spec_model_config(tok_len)
    assert seen["device"] == device
    assert (cfg.text.num_attention_heads, cfg.text.num_key_value_heads,
            cfg.text.head_dim, cfg.dtype) == (4, 4, 32, "float32")
    for name in ("hidden_size", "intermediate_size", "num_hidden_layers",
                 "num_attention_heads", "num_key_value_heads", "vocab_size",
                 "rope_theta"):
        assert getattr(cfg.text, name) == getattr(want.text, name), name
    assert cfg.dtype == want.dtype
    assert (out["head_dim"], out["dtype"]) == (32, "float32")


# ---------------------------------------------------------------------------
# why K1's fp32 kernel may run 3xTF32 on the tensor cores: its products,
# emulated here bit for bit in their rounding, stay within the card check's
# bound (chip_smoke.py's F32_TOL) of the fp32 plain version, and a single
# TF32 pass does not
# ---------------------------------------------------------------------------

F32_TOL = 2.0 ** -16


def _tf32(x):
    """fp32 ``x`` rounded to TF32 (10 mantissa bits) to nearest, ties away
    from zero: ``cvt.rna.tf32.f32``."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _mm(a, b, passes):
    """a @ b in fp32 from TF32 operands: one pass (hi hi) or the kernel's
    three (lo hi + hi lo + hi hi, hi = tf32(x), lo = tf32(x - hi)). Each
    TF32 product is exact in fp32; the sums are fp32."""
    ah, bh = _tf32(a), _tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _attend_tf32(q, k, v, passes):
    """One head of softmax(q k^T / sqrt(hd)) v, [S, hd] over [T, hd], with
    both products as K1's fp32 kernel takes them; softmax in fp32."""
    s = _mm(q * np.float32(q.shape[-1] ** -0.5), k.T, passes)
    p = np.exp(s - s.max(-1, keepdims=True)).astype(np.float32)
    return _mm(p, v, passes) / p.sum(-1, keepdims=True)


@pytest.mark.parametrize("s,t,hd", [(729, 729, 72),    # clip_vision_f32
                                    (301, 301, 128)])  # v2 at head_dim 128
def test_three_tf32_passes_hold_the_fp32_bound(s, t, hd):
    """3xTF32 attention is within 2^-16 (|v|-weighted mass + |out|) of the
    fp32 plain version at ClipScore's vision head shape and at head_dim
    128; one TF32 pass fails that bound by far."""
    rng = np.random.default_rng(hd)
    q = rng.standard_normal((s, hd)).astype(np.float32)
    k = rng.standard_normal((t, hd)).astype(np.float32)
    v = rng.standard_normal((t, hd)).astype(np.float32)
    qt, kt, vt = (_t(x)[None, :, None] for x in (q, k, v))
    want = tattention.attend_plain(qt, kt, vt)[0, :, 0].numpy()
    pv_abs = tattention.attend_plain(qt, kt, vt.abs())[0, :, 0].numpy()
    bound = F32_TOL * (pv_abs + np.abs(want))
    three = np.abs(_attend_tf32(q, k, v, 3) - want) / bound
    one = np.abs(_attend_tf32(q, k, v, 1) - want) / bound
    assert three.max() <= 0.25, three.max()
    assert one.max() >= 8.0, one.max()
