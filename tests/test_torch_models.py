"""The port's models against the JAX package, on the CPU in fp32.

One ``detikzify.init(PRNGKey(0), tiny-test)`` parameter tree is carried to
the port with ``params_from_numpy``; the same numpy inputs go through both.
Logits agree within 3e-4 (the bound the JAX suite holds against
transformers); the paged prefill/decode pair is held at the tolerances of
``tests/test_paged.py``.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from detikzify_tpu.config import tiny_test_config
from detikzify_tpu.models import detikzify as jdet
from detikzify_tpu.models import llama as jllama
from detikzify_tpu.models import siglip as jsiglip
from detikzify_torch.config import tiny_test_config as t_tiny_test_config
from detikzify_torch.models import convert
from detikzify_torch.models import detikzify as tdet
from detikzify_torch.models import llama as tllama
from detikzify_torch.models import siglip as tsiglip

torch.set_num_threads(1)

TOL = 3e-4


@pytest.fixture(scope="module")
def models():
    cfg = tiny_test_config()
    jparams = jdet.init(jax.random.PRNGKey(0), cfg)
    tree = jax.tree.map(np.asarray, jparams._asdict())
    tcfg = t_tiny_test_config()
    tparams = convert.params_from_numpy(tree, tcfg, device="cpu")
    return cfg, jparams, tcfg, tparams


def _pixels(cfg, b, seed):
    rng = np.random.default_rng(seed)
    size = cfg.vision.image_size
    return rng.standard_normal((b, size, size, 3)).astype(np.float32)


def test_config_copy_matches_jax():
    from detikzify_tpu.config import PRESETS as JP
    from detikzify_torch.config import PRESETS as TP

    assert sorted(JP) == sorted(TP)
    for name in JP:
        assert JP[name].to_dict() == TP[name].to_dict()


def test_params_from_numpy_layout(models):
    cfg, jparams, _, tparams = models
    jq = np.asarray(jparams.text["layers"]["attn"]["q"]["kernel"][1])
    np.testing.assert_array_equal(
        tparams.text.layers[1].attn.q.weight.numpy(), jq.T)
    assert not any(p.requires_grad for p in tparams.parameters())


def test_siglip_apply_matches_jax(models):
    cfg, jparams, tcfg, tparams = models
    pix = _pixels(cfg, 2, 0)
    want = jsiglip.apply(jparams.vision, cfg.vision, jnp.asarray(pix),
                         attn_impl="xla")
    got = tsiglip.apply(tparams.vision, tcfg.vision, torch.from_numpy(pix))
    for key in ("last_hidden_state", "pooler_output"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=TOL, rtol=TOL)


def test_patchify_matches_jax(models):
    cfg = models[0]
    pix = _pixels(cfg, 1, 1)
    np.testing.assert_array_equal(
        tsiglip.patchify(torch.from_numpy(pix), 14).numpy(),
        np.asarray(jsiglip.patchify(jnp.asarray(pix), 14)))


def test_llama_forward_matches_jax(models):
    cfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 500, (2, 11)).astype(np.int32)
    mask = np.ones((2, 11), bool)
    mask[1, 8:] = False
    emb_j = jllama.embed(jparams.text, jnp.asarray(ids))
    emb_t = tllama.embed(tparams.text, torch.from_numpy(ids))
    for m in (None, mask):
        want = jllama.forward(jparams.text, cfg.text, emb_j,
                              attention_mask=None if m is None
                              else jnp.asarray(m), attn_impl="xla")
        got = tllama.forward(tparams.text, tcfg.text, emb_t,
                             attention_mask=None if m is None
                             else torch.from_numpy(m))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=TOL)


def test_rope_llama3_scaling_matches_jax():
    from detikzify_tpu.models.layers import rope_inv_freq as j_inv
    from detikzify_torch.models.layers import rope_inv_freq as t_inv

    scaling = {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
               "high_freq_factor": 4.0,
               "original_max_position_embeddings": 8192}
    np.testing.assert_allclose(t_inv(128, 500000.0, scaling).numpy(),
                               np.asarray(j_inv(128, 500000.0, scaling)),
                               rtol=1e-6)


def test_detikzify_forward_logits_and_loss_match_jax(models):
    cfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(3)
    n_img = cfg.image_seq_len
    ids = np.concatenate(
        [np.full((2, n_img), cfg.image_token_id, np.int32),
         np.full((2, 1), cfg.bos_token_id, np.int32),
         rng.integers(0, 256, (2, 9)).astype(np.int32)], axis=1)
    labels = np.where(ids == cfg.image_token_id, -100, ids).astype(np.int32)
    mask = np.ones(ids.shape, bool)
    mask[1, -3:] = False
    pix = _pixels(cfg, 2, 4)
    want_logits, want_loss = jdet.forward(
        jparams, cfg, jnp.asarray(ids), jnp.asarray(pix),
        attention_mask=jnp.asarray(mask), labels=jnp.asarray(labels),
        attn_impl="xla")
    got_logits, got_loss = tdet.forward(
        tparams, tcfg, torch.from_numpy(ids), torch.from_numpy(pix),
        attention_mask=torch.from_numpy(mask),
        labels=torch.from_numpy(labels))
    assert got_logits.dtype == torch.float32
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               atol=TOL, rtol=TOL)
    assert abs(float(got_loss) - float(want_loss)) < TOL


def test_merge_inputs_with_offsets_matches_jax(models):
    cfg, _, tcfg, _ = models
    rng = np.random.default_rng(5)
    it = cfg.image_token_id
    ids = np.asarray([[it, it, 5, it, 7], [3, it, it, 9, 9]], np.int32)
    emb = rng.standard_normal((2, 5, 8)).astype(np.float32)
    img = rng.standard_normal((2, 6, 8)).astype(np.float32)
    offs = np.asarray([0, 3], np.int32)
    want = jdet.merge_inputs(cfg, jnp.asarray(ids), jnp.asarray(emb),
                             jnp.asarray(img), jnp.asarray(offs))
    got = tdet.merge_inputs(tcfg, torch.from_numpy(ids),
                            torch.from_numpy(emb), torch.from_numpy(img),
                            torch.from_numpy(offs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# paged prefill + zero-copy decode against the JAX pair (test_paged.py)
# ---------------------------------------------------------------------------

PAGE, M_CAP, TRASH_ROW, B = 8, 8, 61, 2


def _paged_pair(models, n_pages):
    cfg, jparams, tcfg, tparams = models
    jpool = jllama.init_paged_cache(cfg.text, n_pages, PAGE, jnp.float32)
    tpool = tllama.init_paged_cache(tcfg.text, n_pages, PAGE, torch.float32,
                                    device="cpu")
    return jpool, tpool


def _check_pool(tpool, jpool):
    np.testing.assert_allclose(tpool.k.numpy(), np.asarray(jpool.k),
                               atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(tpool.v.numpy(), np.asarray(jpool.v),
                               atol=1e-5, rtol=1e-4)


def test_prefill_then_decode_paged_matches_jax(models):
    cfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(0)
    jpool, tpool = _paged_pair(models, 18)
    ids = rng.integers(0, 500, (B, 13)).astype(np.int32)
    seq = np.asarray([13, 9], np.int32)
    start = np.zeros((B,), np.int32)
    tabs = rng.permutation(16).reshape(B, M_CAP).astype(np.int32)
    jh, jpool = jllama.prefill_paged(
        jparams.text, cfg.text, jllama.embed(jparams.text, jnp.asarray(ids)),
        jnp.asarray(start), jnp.asarray(seq), jpool,
        jnp.zeros((B, 0), jnp.int32), jnp.asarray(tabs),
        jnp.asarray(start), trash_row=TRASH_ROW, trash_page=17,
        attn_impl="xla")
    th, tpool = tllama.prefill_paged(
        tparams.text, tcfg.text,
        tllama.embed(tparams.text, torch.from_numpy(ids)),
        torch.from_numpy(start), torch.from_numpy(seq), tpool,
        torch.zeros((B, 0), dtype=torch.int32), torch.from_numpy(tabs),
        torch.from_numpy(start), trash_row=TRASH_ROW, trash_page=17)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5,
                               rtol=1e-4)
    _check_pool(tpool, jpool)

    positions = np.asarray([13, 9], np.int32)
    for step in range(5):
        tok = rng.integers(0, 500, (B,)).astype(np.int32)
        jh, jpool = jdet.decode_step_paged(
            jparams, cfg, jnp.asarray(tok), jnp.asarray(positions), jpool,
            jnp.asarray(tabs), kv_pages=4, trash_row=TRASH_ROW,
            trash_page=17, attn_impl="xla")
        th, tpool = tdet.decode_step_paged(
            tparams, tcfg, torch.from_numpy(tok), torch.from_numpy(positions),
            tpool, torch.from_numpy(tabs), kv_pages=4, trash_row=TRASH_ROW,
            trash_page=17)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=TOL,
                                   rtol=TOL)
        positions = positions + 1
    _check_pool(tpool, jpool)


def test_prefix_restore_tail_prefill_matches_jax(models):
    """Shared ancestor page + COW boundary + tail prefill, both packages."""
    cfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(1)
    full = rng.integers(0, 500, (1, 21)).astype(np.int32)
    plen = 13
    jpool, tpool = _paged_pair(models, 24)
    anc = np.arange(M_CAP, dtype=np.int32)[None]
    child = np.asarray([[0] + list(range(8, 15))], np.int32)
    calls = [
        (full[:, :plen], [0], [plen], np.zeros((1, 0), np.int32), anc, [0]),
        (full[:, plen:], [plen], [21 - plen], anc[:, :2], child, [8]),
    ]
    for ids, start, seq, read, write, cow in calls:
        i32 = lambda x: np.asarray(x, np.int32)    # noqa: E731
        jh, jpool = jllama.prefill_paged(
            jparams.text, cfg.text,
            jllama.embed(jparams.text, jnp.asarray(ids)),
            jnp.asarray(i32(start)), jnp.asarray(i32(seq)), jpool,
            jnp.asarray(read), jnp.asarray(write), jnp.asarray(i32(cow)),
            trash_row=TRASH_ROW, trash_page=23, attn_impl="xla")
        th, tpool = tllama.prefill_paged(
            tparams.text, tcfg.text,
            tllama.embed(tparams.text, torch.from_numpy(ids)),
            torch.from_numpy(i32(start)), torch.from_numpy(i32(seq)), tpool,
            torch.from_numpy(read), torch.from_numpy(write),
            torch.from_numpy(i32(cow)), trash_row=TRASH_ROW, trash_page=23)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5,
                                   rtol=1e-4)
    _check_pool(tpool, jpool)


def test_trash_rows_never_dereference_table(models):
    """Writes at rows >= trash_row land on the trash page, so a stale table
    full of another slot's pages is never written through."""
    _, _, tcfg, tparams = models
    pool = tllama.init_paged_cache(tcfg.text, 10, PAGE, torch.float32,
                                   device="cpu")
    victim = torch.arange(8, dtype=torch.int32)[None]
    before = pool.k[:, :8].clone()
    e = tllama.embed(tparams.text, torch.tensor([3]))
    _, pool = tllama.decode_step_paged(
        tparams.text, tcfg.text, e, torch.tensor([TRASH_ROW]), pool, victim,
        trash_row=TRASH_ROW, trash_page=9)
    assert torch.equal(pool.k[:, :8], before)
    assert float(pool.k[:, 9].abs().sum()) > 0


def test_init_random_scales_and_device():
    tcfg = t_tiny_test_config()
    gen = torch.Generator().manual_seed(0)
    p1 = convert.init_random(tcfg, device="cpu", dtype=torch.float32,
                             generator=gen)
    p2 = convert.init_random(tcfg, device="cpu", dtype=torch.float32,
                             generator=torch.Generator().manual_seed(0))
    for a, b in zip(p1.parameters(), p2.parameters()):
        assert torch.equal(a, b)
    w = p1.text.layers[0].mlp.down.weight
    assert abs(float(w.std()) - w.shape[1] ** -0.5) < 0.3 * w.shape[1] ** -0.5
    assert float(p1.text.norm.scale.min()) == 1.0
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            convert.init_random(tcfg)            # default device is cuda


# ---------------------------------------------------------------------------
# contiguous KVCache: prefill / decode_step / decode_verify_step against JAX
# (mirrors tests/test_models_parity.py:104,140 and tests/test_paged.py:32)
# ---------------------------------------------------------------------------

def _contig_pair(models, batch, max_len):
    cfg, _, tcfg, _ = models
    return (jllama.init_cache(cfg.text, batch, max_len, jnp.float32),
            tllama.init_cache(tcfg.text, batch, max_len, torch.float32,
                              device="cpu"))


def _check_cache(tcache, jcache):
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k),
                               atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(tcache.v.numpy(), np.asarray(jcache.v),
                               atol=1e-5, rtol=1e-4)


def _i32(x):
    return np.asarray(x, np.int32)


@pytest.mark.parametrize("kv_limit", [None, 24])
def test_prefill_decode_contiguous_matches_jax(models, kv_limit):
    """Contiguous prefill then decode steps (K1 window, K3's plain version)
    == JAX, logits within 3e-4, and == the full causal forward."""
    cfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(8)
    ids = rng.integers(0, 500, (2, 14)).astype(np.int32)
    jcache, tcache = _contig_pair(models, 2, 32)
    prefix = 8
    start, seq = _i32([0, 0]), _i32([prefix, prefix])
    jl, jcache = jdet.prefill(jparams, cfg, jnp.asarray(ids[:, :prefix]),
                              None, jnp.asarray(start), jnp.asarray(seq),
                              jcache, attn_impl="xla")
    tl, tcache = tdet.prefill(tparams, tcfg, torch.from_numpy(ids[:, :prefix]),
                              None, torch.from_numpy(start),
                              torch.from_numpy(seq), tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    full, _ = tdet.forward(tparams, tcfg, torch.from_numpy(ids))
    for i in range(prefix, ids.shape[1]):
        pos = _i32([i, i])
        jl, jcache = jdet.decode_step(jparams, cfg, jnp.asarray(ids[:, i]),
                                      jnp.asarray(pos), jcache,
                                      kv_limit=kv_limit, attn_impl="xla")
        tl, tcache = tdet.decode_step(tparams, tcfg,
                                      torch.from_numpy(ids[:, i]),
                                      torch.from_numpy(pos), tcache,
                                      kv_limit=kv_limit)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=TOL)
        np.testing.assert_allclose(tl.numpy(), full[:, i].numpy(), atol=TOL,
                                   rtol=TOL)
    _check_cache(tcache, jcache)


def test_prefill_with_offset_matches_jax(models):
    """Prefix restore + tail prefill at an offset == JAX == the full
    forward's logits over the tail."""
    cfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(9)
    ids = rng.integers(0, 500, (1, 14)).astype(np.int32)
    full, _ = tdet.forward(tparams, tcfg, torch.from_numpy(ids))
    jcache, tcache = _contig_pair(models, 1, 32)
    jemb = jllama.embed(jparams.text, jnp.asarray(ids))
    temb = tllama.embed(tparams.text, torch.from_numpy(ids))
    for lo, hi in ((0, 6), (6, 14)):
        jh, jcache = jllama.prefill(jparams.text, cfg.text, jemb[:, lo:hi],
                                    jnp.asarray(_i32([lo])),
                                    jnp.asarray(_i32([hi - lo])), jcache,
                                    attn_impl="xla")
        th, tcache = tllama.prefill(tparams.text, tcfg.text, temb[:, lo:hi],
                                    torch.from_numpy(_i32([lo])),
                                    torch.from_numpy(_i32([hi - lo])),
                                    tcache)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=TOL,
                                   rtol=TOL)
    logits = tllama.unembed(tparams.text, th)
    np.testing.assert_allclose(logits.numpy(), full[:, 6:].numpy(),
                               atol=TOL, rtol=TOL)
    _check_cache(tcache, jcache)


def test_contiguous_writes_clamp_like_jax(models):
    """``dynamic_update_slice`` clamps its start into the cache: a decode
    write at the last row, one past it, and a prefill block that would run
    past the end all land where JAX puts them."""
    cfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(10)
    t = 16
    jcache, tcache = _contig_pair(models, 2, t)
    ids = rng.integers(0, 500, (2, 6)).astype(np.int32)
    start, seq = _i32([3, t - 4]), _i32([6, 6])     # row 1 runs past the end
    jl, jcache = jdet.prefill(jparams, cfg, jnp.asarray(ids), None,
                              jnp.asarray(start), jnp.asarray(seq), jcache,
                              attn_impl="xla")
    tl, tcache = tdet.prefill(tparams, tcfg, torch.from_numpy(ids), None,
                              torch.from_numpy(start), torch.from_numpy(seq),
                              tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    _check_cache(tcache, jcache)
    assert float(tcache.k[:, 1, t - 1].abs().sum()) > 0    # the last row
    for pos in (_i32([t - 1, t - 1]), _i32([t - 1, t])):   # last, one past
        tok = rng.integers(0, 500, (2,)).astype(np.int32)
        jl, jcache = jdet.decode_step(jparams, cfg, jnp.asarray(tok),
                                      jnp.asarray(pos), jcache,
                                      attn_impl="xla")
        tl, tcache = tdet.decode_step(tparams, tcfg, torch.from_numpy(tok),
                                      torch.from_numpy(pos), tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=TOL)
        _check_cache(tcache, jcache)


def test_decode_verify_step_matches_jax(models):
    """The contiguous verify forward: [B, K+1, V] fp32 logits == JAX, and
    column j == a decode step at the same position."""
    cfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(11)
    ids = rng.integers(0, 500, (2, 12)).astype(np.int32)
    jcache, tcache = _contig_pair(models, 2, 32)
    seq = _i32([7, 5])
    args = (_i32([0, 0]), seq)
    _, jcache = jdet.prefill(jparams, cfg, jnp.asarray(ids[:, :7]), None,
                             *map(jnp.asarray, args), jcache, attn_impl="xla")
    _, tcache = tdet.prefill(tparams, tcfg, torch.from_numpy(ids[:, :7]),
                             None, *map(torch.from_numpy, args), tcache)
    block = rng.integers(0, 500, (2, 4)).astype(np.int32)
    jl, jcache = jdet.decode_verify_step(jparams, cfg, jnp.asarray(block),
                                         jnp.asarray(seq), jcache,
                                         attn_impl="xla")
    tl, tcache = tdet.decode_verify_step(tparams, tcfg,
                                         torch.from_numpy(block),
                                         torch.from_numpy(seq), tcache)
    assert tl.shape == (2, 4, 512) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    _check_cache(tcache, jcache)
    dl, _ = tdet.decode_step(tparams, tcfg, torch.from_numpy(block[:, 0]),
                             torch.from_numpy(seq), tcache)
    np.testing.assert_allclose(tl[:, 0].numpy(), dl.numpy(), atol=TOL,
                               rtol=TOL)


def test_verify_step_paged_zerocopy_matches_jax(models):
    """Zero-copy verify over the page pool (K4's plain version) == JAX:
    logits and pool, with one dead slot whose writes must all land on the
    trash page, and one live slot whose window reaches the trash rows."""
    cfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(12)
    b, k1 = 3, 4
    jpool, tpool = _paged_pair(models, 26)
    tabs = rng.permutation(24).reshape(b, M_CAP).astype(np.int32)
    ids = rng.integers(0, 500, (b, 20)).astype(np.int32)
    seq = _i32([20, 11, 20])
    start = _i32([0, 0, 0])
    empty = np.zeros((b, 0), np.int32)
    _, jpool = jllama.prefill_paged(
        jparams.text, cfg.text, jllama.embed(jparams.text, jnp.asarray(ids)),
        jnp.asarray(start), jnp.asarray(seq), jpool, jnp.asarray(empty),
        jnp.asarray(tabs), jnp.asarray(start), trash_row=TRASH_ROW,
        trash_page=25, attn_impl="xla")
    _, tpool = tllama.prefill_paged(
        tparams.text, tcfg.text,
        tllama.embed(tparams.text, torch.from_numpy(ids)),
        torch.from_numpy(start), torch.from_numpy(seq), tpool,
        torch.from_numpy(empty), torch.from_numpy(tabs),
        torch.from_numpy(start), trash_row=TRASH_ROW, trash_page=25)
    _check_pool(tpool, jpool)
    before = tpool.k[:, tabs[1]].clone()
    block = rng.integers(0, 500, (b, k1)).astype(np.int32)
    vstart = _i32([20, 0, TRASH_ROW - 2])     # slot 1 dead: start clamped
    dead = np.asarray([False, True, False])
    kw = dict(kv_pages=M_CAP, trash_row=TRASH_ROW, trash_page=25)
    jl, jpool = jdet.decode_verify_step_paged_zerocopy(
        jparams, cfg, jnp.asarray(block), jnp.asarray(vstart), jpool,
        jnp.asarray(tabs), dead=jnp.asarray(dead), **kw)
    tl, tpool = tdet.decode_verify_step_paged_zerocopy(
        tparams, tcfg, torch.from_numpy(block), torch.from_numpy(vstart),
        tpool, torch.from_numpy(tabs), dead=torch.from_numpy(dead), **kw)
    assert tl.shape == (b, k1, 512) and tl.dtype == torch.float32
    ok = ~dead
    np.testing.assert_allclose(tl.numpy()[ok], np.asarray(jl)[ok], atol=TOL,
                               rtol=TOL)
    assert bool(torch.isfinite(tl).all())
    assert torch.equal(tpool.k[:, tabs[1]], before)   # dead slot: no writes
    # live rows match; the trash page is written by several rows at once
    keep = [p for p in range(26) if p != 25]
    np.testing.assert_allclose(tpool.k[:, keep].numpy(),
                               np.asarray(jpool.k)[:, keep], atol=1e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(tpool.v[:, keep].numpy(),
                               np.asarray(jpool.v)[:, keep], atol=1e-5,
                               rtol=1e-4)


def test_prefill_decode_paged_matches_contiguous(models):
    """The port's paged pair (page tables, trash routing) == its contiguous
    pair on the same tokens, hidden states within the tolerances of
    tests/test_paged.py:32."""
    _, _, tcfg, tparams = models
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 500, (B, 13)).astype(np.int32)
    start, seq = _i32([0, 0]), _i32([13, 9])
    cache = tllama.init_cache(tcfg.text, B, M_CAP * PAGE, torch.float32,
                              device="cpu")
    pool = tllama.init_paged_cache(tcfg.text, 18, PAGE, torch.float32,
                                   device="cpu")
    tabs = torch.from_numpy(rng.permutation(16).reshape(B, M_CAP).astype(
        np.int32))
    emb = tllama.embed(tparams.text, torch.from_numpy(ids))
    h_ref, cache = tllama.prefill(tparams.text, tcfg.text, emb,
                                  torch.from_numpy(start),
                                  torch.from_numpy(seq), cache)
    h_pg, pool = tllama.prefill_paged(
        tparams.text, tcfg.text, emb, torch.from_numpy(start),
        torch.from_numpy(seq), pool, torch.zeros((B, 0), dtype=torch.int32),
        tabs, torch.from_numpy(start), trash_row=TRASH_ROW, trash_page=17)
    np.testing.assert_allclose(h_pg.numpy(), h_ref.numpy(), atol=1e-5,
                               rtol=1e-4)
    positions = torch.from_numpy(_i32([13, 9]))
    for _ in range(6):
        e = tllama.embed(tparams.text, torch.from_numpy(
            rng.integers(0, 500, (B,)).astype(np.int32)))
        h1, cache = tllama.decode_step(tparams.text, tcfg.text, e, positions,
                                       cache)
        h2, pool = tllama.decode_step_paged(
            tparams.text, tcfg.text, e, positions, pool, tabs,
            trash_row=TRASH_ROW, trash_page=17)
        np.testing.assert_allclose(h2.numpy(), h1.numpy(), atol=1e-5,
                                   rtol=1e-4)
        positions = positions + 1
