"""The port's kernel modules against the JAX package, on the CPU.

K1 (``detikzify_torch.ops.flash``), K2 and K4 (``detikzify_torch.ops.paged``)
and K3 (``detikzify_torch.ops.attention.decode_attend``) take their plain
PyTorch versions for CPU tensors; these are held against the Pallas kernels
run in interpret mode and against the JAX XLA paths, at the tolerances of
``tests/test_kernels.py`` (fp32). Sampling is held
exactly on greedy rows and on the warped candidate logits, and by support
on sampled rows (threefry and Philox draw different bits).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from detikzify_tpu.ops import sampling as jsampling
from detikzify_tpu.ops.attention import attend_xla, decode_attend
from detikzify_tpu.ops.decode_flash import decode_attend_pallas
from detikzify_tpu.ops.flash import flash_attention as jflash
from detikzify_tpu.ops.paged import (decode_attend_paged_pallas,
                                     decode_verify_attend_paged,
                                     decode_verify_attend_paged_pallas,
                                     gather_pages)
from detikzify_torch.ops import attention as tattention
from detikzify_torch.ops import flash as tflash
from detikzify_torch.ops import paged as tpaged
from detikzify_torch.ops import sampling as tsampling

torch.set_num_threads(1)

ATOL, RTOL = 2e-5, 2e-4


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _qkv(rng, b, s, t, nh, nkv, hd):
    return (rng.standard_normal((b, s, nh, hd)).astype(np.float32),
            rng.standard_normal((b, t, nkv, hd)).astype(np.float32),
            rng.standard_normal((b, t, nkv, hd)).astype(np.float32))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [
    (2, 36, 4, 2, 24),     # vision-ish: unaligned seq + head dim, GQA
    (1, 130, 8, 2, 64),    # decoder-ish: GQA 4:1
    (1, 20, 2, 2, 72),     # SigLIP head_dim 72
])
def test_flash_plain_matches_pallas_and_xla(causal, shape):
    b, s, nh, nkv, hd = shape
    q, k, v = _qkv(np.random.default_rng(0), b, s, s, nh, nkv, hd)
    want = np.asarray(attend_xla(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal))
    pallas = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal,
                               interpret=True))
    got = tflash.flash_attention(_t(q), _t(k), _t(v), causal=causal).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=RTOL)


def test_flash_plain_kv_mask():
    rng = np.random.default_rng(1)
    q, k, v = _qkv(rng, 2, 8, 24, 4, 4, 32)
    mask = np.zeros((2, 24), bool)
    mask[0, :10] = True
    mask[1, :17] = True
    want = attend_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      kv_mask=jnp.asarray(mask))
    pallas = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    kv_mask=jnp.asarray(mask), interpret=True)
    got = tflash.flash_attention(_t(q), _t(k), _t(v),
                                 kv_mask=_t(mask)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=ATOL,
                               rtol=RTOL)


def test_flash_plain_offsets_window():
    """Per-batch offset-prefill window (the engine's prefix-restore mask)."""
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, 2, 8, 32, 4, 2, 32)
    offs = np.asarray([0, 10], np.int32)
    lims = np.asarray([6, 18], np.int32)
    want = np.asarray(attend_xla(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), q_offsets=jnp.asarray(offs),
                                 kv_limits=jnp.asarray(lims)))
    pallas = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), q_offsets=jnp.asarray(offs),
                               kv_limits=jnp.asarray(lims), interpret=True))
    got = tflash.flash_attention(_t(q), _t(k), _t(v), q_offsets=_t(offs),
                                 kv_limits=_t(lims)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    # rows beyond slot 0's 6 valid queries differ only in padding
    np.testing.assert_allclose(got[0, :6], pallas[0, :6], atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(got[1], pallas[1], atol=ATOL, rtol=RTOL)


def test_flash_plain_single_query_map_head():
    """S=1 against T keys (the SigLIP MAP head's probe query)."""
    rng = np.random.default_rng(4)
    q, k, v = _qkv(rng, 3, 1, 45, 4, 4, 24)
    want = np.asarray(attend_xla(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v)))
    pallas = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), interpret=True))
    got = tflash.flash_attention(_t(q), _t(k), _t(v)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=RTOL)


def test_flash_wrapper_rejects_kv_limits_without_offsets():
    q, k, v = _qkv(np.random.default_rng(0), 1, 4, 4, 2, 2, 8)
    with pytest.raises(ValueError, match="q_offsets"):
        tflash.flash_attention(_t(q), _t(k), _t(v),
                               kv_limits=torch.tensor([2], dtype=torch.int32))


@pytest.mark.parametrize("nh,nkv,hd", [(8, 8, 64), (8, 2, 64), (4, 4, 128)])
def test_paged_plain_matches_pallas(nh, nkv, hd):
    """K2's plain version (gather + contiguous decode) == the Pallas paged
    kernel and the JAX contiguous decode on a shuffled page pool."""
    rng = np.random.default_rng(11)
    b, page, m, P = 3, 128, 4, 16
    pool_k = rng.standard_normal((P, page, nkv, hd)).astype(np.float32)
    pool_v = rng.standard_normal((P, page, nkv, hd)).astype(np.float32)
    tab = np.stack([rng.permutation(P)[:m] for _ in range(b)]).astype(
        np.int32)
    q = rng.standard_normal((b, nh, hd)).astype(np.float32)
    lengths = np.asarray([page * m, 37, 200], np.int32)

    jk, jv, jt = jnp.asarray(pool_k), jnp.asarray(pool_v), jnp.asarray(tab)
    want = np.asarray(decode_attend(jnp.asarray(q), gather_pages(jk, jt),
                                    gather_pages(jv, jt),
                                    jnp.asarray(lengths),
                                    implementation="xla"))
    pallas = np.asarray(decode_attend_paged_pallas(
        jnp.asarray(q), jk, jv, jt, jnp.asarray(lengths), interpret=True))
    got = tpaged.decode_attend_paged(_t(q), _t(pool_k), _t(pool_v), _t(tab),
                                     _t(lengths)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(got, pallas, atol=2e-5, rtol=1e-4)
    # a column slice of a wider table (the engine's kv_pages window)
    wide = np.concatenate([tab, np.zeros((b, 3), np.int32)], axis=1)
    got_w = tpaged.decode_attend_paged(_t(q), _t(pool_k), _t(pool_v),
                                       _t(wide)[:, :m], _t(lengths)).numpy()
    np.testing.assert_array_equal(got_w, got)


# tiny-test's decoder heads (4 query, 2 KV, head_dim 16) on a 64-row page
TINY_NH, TINY_NKV, TINY_HD, TINY_PAGE, TINY_M = 4, 2, 16, 64, 4


@pytest.mark.parametrize("split", [64, tpaged.SPLIT_ROWS, 256])
def test_paged_split_merge_matches_plain(split):
    """K2's split-and-merge arithmetic (``decode_attend_paged_split``, the
    kernel's blocks of ``split`` rows merged by ``merge_partials``) equals
    the plain version in fp32 within 1e-6: lengths whose later splits lie
    wholly past them (1, 65, 130), exactly one split, the full table
    (m * page) and one above it (clamped to m * page)."""
    rng = np.random.default_rng(21)
    nh, nkv, hd, page, m = TINY_NH, TINY_NKV, TINY_HD, TINY_PAGE, TINY_M
    n_pages = 8 * m + 2
    pool_k = rng.standard_normal((n_pages, page, nkv, hd)).astype(np.float32)
    pool_v = rng.standard_normal((n_pages, page, nkv, hd)).astype(np.float32)
    lengths = np.asarray([1, 65, 130, split, 64, m * page, m * page + 5,
                          255], np.int32)
    b = len(lengths)
    tab = np.stack([rng.permutation(n_pages)[:m] for _ in range(b)]).astype(
        np.int32)
    q = rng.standard_normal((b, nh, hd)).astype(np.float32)
    args = (_t(q), _t(pool_k), _t(pool_v), _t(tab), _t(lengths))
    want = tpaged.decode_attend_paged_plain(*args).numpy()
    got = tpaged.decode_attend_paged_split(*args, split=split).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # and the plain version itself against JAX's (clamped) contiguous decode
    jl = np.minimum(lengths, m * page)
    jk, jv, jt = jnp.asarray(pool_k), jnp.asarray(pool_v), jnp.asarray(tab)
    ref = np.asarray(decode_attend(jnp.asarray(q), gather_pages(jk, jt),
                                   gather_pages(jv, jt), jnp.asarray(jl),
                                   implementation="xla"))
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-5)


def test_merge_partials_ignores_dead_splits():
    """A split marked dead (max -inf) adds nothing, whatever its sum and
    accumulator hold; the live ones merge as one softmax."""
    rng = np.random.default_rng(22)
    x = torch.from_numpy(rng.standard_normal((3, 10)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((10, 5)).astype(np.float32))
    want = torch.softmax(x, -1) @ v
    halves = [x[:, :6], x[:, 6:]]
    m = torch.stack([h.amax(-1) for h in halves] + [torch.full((3,),
                                                               float("-inf"))],
                    -1)
    p = [torch.exp(h - h.amax(-1, keepdim=True)) for h in halves]
    l = torch.stack([pi.sum(-1) for pi in p] + [torch.full((3,), 7.0)], -1)
    acc = torch.stack([p[0] @ v[:6], p[1] @ v[6:],
                       torch.full((3, 5), float("nan"))], -2)
    got = tpaged.merge_partials(m, l, acc)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("mode", ["full", "causal", "mask", "window"])
@pytest.mark.parametrize("s", [1, 2, tflash.SMALL_S])
def test_flash_split_keys_matches_plain(mode, s):
    """K1's small-S path (keys split in blocks of ``split_keys(T)``,
    partials merged by ``merge_partials``) equals ``attend_plain`` in fp32
    within 1e-6, at tiny-test's vision heads (4 heads, head_dim 12) over 150
    keys (three blocks of 64, the last ragged): no mask, causal, a key mask
    with a fully masked row (which averages V uniformly), and the per-batch
    window with a zero limit."""
    rng = np.random.default_rng(23 + s)
    b, t, nh, nkv, hd = 3, 150, 4, 4, 12
    q, k, v = _qkv(rng, b, s, t, nh, nkv, hd)
    kw = {}
    if mode == "causal":
        kw["causal"] = True
    elif mode == "mask":
        mask = np.ones((b, t), bool)
        mask[0, 70:] = False
        mask[1, :] = False
        kw["kv_mask"] = _t(mask)
    elif mode == "window":
        kw["q_offsets"] = _t(np.asarray([0, 3, 100], np.int32))
        kw["kv_limits"] = _t(np.asarray([40, 0, 140], np.int32))
    assert tflash.split_keys(t) == 64
    want = tflash.attend_split_plain(_t(q), _t(k), _t(v), **kw).numpy()
    got = tflash.flash_attention(_t(q), _t(k), _t(v), **kw).numpy()
    np.testing.assert_allclose(want, got, atol=1e-6, rtol=0)
    if mode == "mask":      # the fully masked row: the mean of V
        np.testing.assert_allclose(
            want[1], np.broadcast_to(v[1].mean(0), want[1].shape),
            atol=1e-6, rtol=0)


@pytest.mark.parametrize("nh,nkv,hd,L", [(8, 2, 64, 512), (4, 4, 48, 300),
                                         (8, 2, 128, 512)])
def test_decode_contiguous_plain_matches_pallas(nh, nkv, hd, L):
    """K3's plain version (``decode_attend`` on CPU tensors) == the Pallas
    length-clamped kernel in interpret mode and the JAX XLA path; also on a
    ``[:, :kv_limit]`` view of the cache with lengths clamped to it (the
    contiguous ``decode_step``)."""
    rng = np.random.default_rng(2)
    b = 3
    q = rng.standard_normal((b, nh, hd)).astype(np.float32)
    k = rng.standard_normal((b, L, nkv, hd)).astype(np.float32)
    v = rng.standard_normal((b, L, nkv, hd)).astype(np.float32)
    lengths = np.asarray([5, L // 2, L], np.int32)
    args = [jnp.asarray(x) for x in (q, k, v, lengths)]
    want = np.asarray(decode_attend(*args, implementation="xla"))
    pallas = np.asarray(decode_attend_pallas(*args, interpret=True))
    got = tattention.decode_attend(_t(q), _t(k), _t(v), _t(lengths)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(got, pallas, atol=3e-5, rtol=3e-4)
    lim = 200
    clamped = np.minimum(lengths, lim)
    pallas_v = np.asarray(decode_attend_pallas(
        args[0], args[1][:, :lim], args[2][:, :lim], jnp.asarray(clamped),
        interpret=True))
    got_v = tattention.decode_attend(_t(q), _t(k)[:, :lim], _t(v)[:, :lim],
                                     _t(clamped)).numpy()
    np.testing.assert_allclose(got_v, pallas_v, atol=3e-5, rtol=3e-4)


def _verify_case(rng, b, k1, nh, nkv, hd, page, m, n_pages):
    pool_k = rng.standard_normal((n_pages, page, nkv, hd)).astype(np.float32)
    pool_v = rng.standard_normal((n_pages, page, nkv, hd)).astype(np.float32)
    tab = np.stack([rng.permutation(n_pages)[:m] for _ in range(b)]).astype(
        np.int32)
    q = rng.standard_normal((b, k1, nh, hd)).astype(np.float32)
    return q, pool_k, pool_v, tab


def _verify_dense(q, pool_k, pool_v, tab, starts, page):
    """Dense reference: row j of slot b attends gathered rows below
    min(starts[b] + j + 1, m * page)."""
    b, k1, nh, hd = q.shape
    groups = nh // pool_k.shape[2]
    kg = np.repeat(np.asarray(gather_pages(jnp.asarray(pool_k),
                                           jnp.asarray(tab))), groups, 2)
    vg = np.repeat(np.asarray(gather_pages(jnp.asarray(pool_v),
                                           jnp.asarray(tab))), groups, 2)
    want = np.zeros_like(q)
    for i in range(b):
        for j in range(k1):
            lim = min(int(starts[i]) + j + 1, tab.shape[1] * page)
            logits = np.einsum("nh,pnh->np", q[i, j], kg[i, :lim]) * hd ** -0.5
            p = np.exp(logits - logits.max(-1, keepdims=True))
            p /= p.sum(-1, keepdims=True)
            want[i, j] = np.einsum("np,pnh->nh", p, vg[i, :lim])
    return want


@pytest.mark.parametrize("nh,nkv,hd", [(8, 2, 64), (4, 4, 128)])
def test_paged_verify_plain_matches_pallas(nh, nkv, hd):
    """K4's plain version == the Pallas verify-window kernel in interpret
    mode, the JAX XLA path and a dense reference (tests/test_kernels.py:243),
    including a dead slot (start 0); also through a column slice of a wider
    table."""
    rng = np.random.default_rng(7)
    b, k1, page, m, n_pages = 4, 5, 128, 4, 16
    q, pool_k, pool_v, tab = _verify_case(rng, b, k1, nh, nkv, hd, page, m,
                                          n_pages)
    starts = np.asarray([0, 37, m * page - k1, 0], np.int32)
    args = [jnp.asarray(x) for x in (q, pool_k, pool_v, tab, starts)]
    want = _verify_dense(q, pool_k, pool_v, tab, starts, page)
    xla = np.asarray(decode_verify_attend_paged(*args, implementation="xla"))
    pallas = np.asarray(decode_verify_attend_paged_pallas(*args,
                                                          interpret=True))
    got = tpaged.decode_verify_attend_paged(
        *[_t(x) for x in (q, pool_k, pool_v, tab, starts)]).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(got, xla, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(got, pallas, atol=1e-5, rtol=1e-4)
    wide = np.concatenate([tab, np.zeros((b, 2), np.int32)], axis=1)
    got_w = tpaged.decode_verify_attend_paged(
        _t(q), _t(pool_k), _t(pool_v), _t(wide)[:, :m], _t(starts)).numpy()
    np.testing.assert_array_equal(got_w, got)


def test_paged_verify_plain_clamps_to_table_edge():
    """starts near the table edge (start + K1 > m * page): the window is
    clamped to the m pages of the table, as the Pallas kernel clamps it
    (tests/test_kernels.py:288)."""
    rng = np.random.default_rng(11)
    b, k1, page, m, n_pages = 2, 5, 128, 3, 8
    q, pool_k, pool_v, tab = _verify_case(rng, b, k1, 4, 4, 64, page, m,
                                          n_pages)
    starts = np.asarray([m * page - 1, m * page - k1 + 1], np.int32)
    args = [jnp.asarray(x) for x in (q, pool_k, pool_v, tab, starts)]
    want = _verify_dense(q, pool_k, pool_v, tab, starts, page)
    pallas = np.asarray(decode_verify_attend_paged_pallas(*args,
                                                          interpret=True))
    got = tpaged.decode_verify_attend_paged(
        *[_t(x) for x in (q, pool_k, pool_v, tab, starts)]).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(got, pallas, atol=1e-5, rtol=1e-4)


def _verify_split_starts(split, page, m, k1):
    """Starts that put K4's window on the split edges: crossing a boundary
    (rows split-2 .. split+2), row 0's limit exactly on a split's first row
    (start split-1), a dead slot (start 0), a slot clamped at the table
    edge (start + K1 > m * page), a window ending on a boundary, and one
    inside a split."""
    return np.asarray([split - 2, split - 1, 0, m * page - 2, split - k1,
                       split + 17], np.int32)


@pytest.mark.parametrize("nh,nkv,hd", [(TINY_NH, TINY_NKV, TINY_HD),
                                       (8, 2, 32), (16, 2, 16)])
@pytest.mark.parametrize("split", [64, tpaged.SPLIT_ROWS])
def test_verify_split_merge_matches_plain(split, nh, nkv, hd):
    """K4's split-and-merge arithmetic with a key limit per query row
    (``decode_verify_attend_paged_split``) equals the plain version in fp32
    within 1e-6 at every split edge of the window; (16, 2) gives 40 query
    rows per KV head, more than one pass of the kernel."""
    rng = np.random.default_rng(31 + split + hd)
    k1, page, m = 5, TINY_PAGE, TINY_M
    starts = _verify_split_starts(split, page, m, k1)
    b = len(starts)
    q, pool_k, pool_v, tab = _verify_case(rng, b, k1, nh, nkv, hd, page, m,
                                          b * m + 2)
    args = [_t(x) for x in (q, pool_k, pool_v, tab, starts)]
    want = tpaged.decode_verify_attend_paged_plain(*args).numpy()
    got = tpaged.decode_verify_attend_paged_split(*args, split=split).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        got, _verify_dense(q, pool_k, pool_v, tab, starts, page), atol=1e-6,
        rtol=1e-5)


def test_verify_split_row_sees_nothing_of_a_live_split():
    """Row 0 of a window starting at split - 1 sees keys [0, split) and
    nothing of the next split, which is live for rows 1..K1-1: that split's
    keys, however large their scores, must not reach row 0."""
    rng = np.random.default_rng(33)
    k1, split, page, m = 5, 64, TINY_PAGE, TINY_M
    q, pool_k, pool_v, tab = _verify_case(rng, 1, k1, 4, 2, 16, page, m,
                                          m + 1)
    # keys of split 1 aligned with row 0's query, and huge values there
    pid = tab[0, split // page]
    pool_k[pid, :, :, :] = 50 * q[0, 0, ::2][None]
    pool_v[pid] = 1e4
    starts = np.asarray([split - 1], np.int32)
    args = [_t(x) for x in (q, pool_k, pool_v, tab, starts)]
    got = tpaged.decode_verify_attend_paged_split(*args, split=split).numpy()
    want = tpaged.decode_verify_attend_paged_plain(*args).numpy()
    np.testing.assert_allclose(got[0, 0], want[0, 0], atol=1e-6, rtol=0)
    assert np.abs(got[0, 0]).max() < 10         # nothing of the 1e4 rows
    assert np.abs(got[0, 1:]).max() > 100       # the later rows see them


@pytest.mark.parametrize("nh,nkv,hd", [(8, 2, 64), (4, 4, 128)])
def test_verify_split_matches_pallas(nh, nkv, hd):
    """K4's split arithmetic == the Pallas verify-window kernel in
    interpret mode, with a window across a split boundary, row 0's limit on
    a boundary, a dead slot and a slot at the table edge."""
    rng = np.random.default_rng(34)
    k1, page, m = 5, 128, 4
    starts = np.asarray([126, 127, 0, m * page - 2], np.int32)
    b = len(starts)
    q, pool_k, pool_v, tab = _verify_case(rng, b, k1, nh, nkv, hd, page, m,
                                          b * m + 1)
    pallas = np.asarray(decode_verify_attend_paged_pallas(
        *[jnp.asarray(x) for x in (q, pool_k, pool_v, tab, starts)],
        interpret=True))
    got = tpaged.decode_verify_attend_paged_split(
        *[_t(x) for x in (q, pool_k, pool_v, tab, starts)]).numpy()
    np.testing.assert_allclose(got, pallas, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("nh,nkv,hd", [(8, 2, 64), (TINY_NH, TINY_NKV,
                                                     TINY_HD), (8, 8, 128)])
@pytest.mark.parametrize("limit", [None, 200])
def test_decode_contig_split_matches_plain(nh, nkv, hd, limit):
    """K3's split arithmetic (``decode_attend_contiguous_split``, the body
    K2 shares) equals the plain version in fp32 within 1e-6 at lengths 1,
    127, 128, 129 and L over a 300-row cache (a ragged last split), and on a
    ``[:, :kv_limit]`` view with lengths clamped to it."""
    rng = np.random.default_rng(35 + hd)
    L = 300
    lengths = np.asarray([1, 127, 128, 129, L], np.int32)
    b = len(lengths)
    q = _t(rng.standard_normal((b, nh, hd)).astype(np.float32))
    k = _t(rng.standard_normal((b, L, nkv, hd)).astype(np.float32))
    v = _t(rng.standard_normal((b, L, nkv, hd)).astype(np.float32))
    lens = _t(lengths)
    if limit is not None:
        k, v, lens = k[:, :limit], v[:, :limit], lens.clamp(max=limit)
        assert not k.is_contiguous()
    want = tattention.decode_attend_plain(q, k, v, lens).numpy()
    got = tpaged.decode_attend_contiguous_split(q, k, v, lens).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def _tsample(logits, seed=0, **kw):
    gen = torch.Generator().manual_seed(seed)
    return tsampling.sample(torch.as_tensor(logits), gen, **kw)


def test_sampling_greedy_and_bans_match_jax():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((6, 300)).astype(np.float32)
    banned = (int(logits[0].argmax()), 7)
    want = jsampling.sample(jnp.asarray(logits), jax.random.PRNGKey(0),
                            params=jsampling.SamplingParams(temperature=0.0),
                            banned_tokens=banned)
    got = _tsample(logits, params=tsampling.SamplingParams(temperature=0.0),
                   banned_tokens=banned)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert banned[0] not in got.tolist()


def test_sampling_eos_suppression_first_step_only():
    logits = np.full((2, 8), -5.0, np.float32)
    logits[:, 3] = 10.0   # eos dominant
    for is_first in ([True, False], [False, True]):
        want = jsampling.sample(
            jnp.asarray(logits), jax.random.PRNGKey(0),
            params=jsampling.SamplingParams(temperature=0.0),
            suppress_begin_tokens=(3,), is_first=jnp.asarray(is_first))
        got = _tsample(logits,
                       params=tsampling.SamplingParams(temperature=0.0),
                       suppress_begin_tokens=(3,),
                       is_first=torch.tensor(is_first))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert [t == 3 for t in got.tolist()] == [not f for f in is_first]


@pytest.mark.parametrize("temperature,top_p,top_k", [
    (0.8, 0.95, 0), (1.0, 0.5, 0), (1.0, 1.0, 2), (0.7, 0.9, 5),
    (0.0, 0.95, 0), (1.3, 0.0, 0)])
def test_warp_candidate_logits_match_jax(temperature, top_p, top_k):
    """The warped candidate set (temperature -> top-k -> top-p in the top
    `candidates`) is identical, value for value, per row."""
    rng = np.random.default_rng(6)
    b, v, cand = 4, 200, 64
    logits = (rng.standard_normal((b, v)) * 3).astype(np.float32)
    temp = np.full((b,), temperature, np.float32)
    temp[0] = 0.0                                     # one greedy row
    tp = np.full((b,), top_p, np.float32)
    tk = np.full((b,), top_k, np.int32)
    jl, ji, jg = jsampling._warp(jnp.asarray(logits), jnp.asarray(temp),
                                 jnp.asarray(tp), jnp.asarray(tk), cand)
    tl, ti, tg = tsampling._warp(_t(logits), _t(temp), _t(tp), _t(tk), cand)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-6,
                               atol=0)
    # the kept set is exactly the same
    np.testing.assert_array_equal(tl.numpy() > -1e29, np.asarray(jl) > -1e29)


def test_sampling_top_p_support():
    # one dominant token: with top_p=0.5 only it survives
    logits = np.full((1, 16), -10.0, np.float32)
    logits[0, 7] = 10.0
    params = tsampling.SamplingParams(temperature=1.0, top_p=0.5)
    assert {int(_tsample(logits, seed, params=params)[0])
            for seed in range(20)} == {7}


def test_sampling_top_k_support_matches_jax():
    logits = np.linspace(0, 3, 8)[None].astype(np.float32)
    params_t = tsampling.SamplingParams(temperature=1.0, top_p=1.0, top_k=2)
    params_j = jsampling.SamplingParams(temperature=1.0, top_p=1.0, top_k=2)
    got = {int(_tsample(logits, seed, params=params_t)[0])
           for seed in range(40)}
    want = {int(jsampling.sample(jnp.asarray(logits),
                                 jax.random.PRNGKey(seed),
                                 params=params_j)[0]) for seed in range(40)}
    assert got == want == {6, 7}


def test_sampling_distribution_matches_softmax():
    """Sampled draws follow the warped distribution (by frequency)."""
    logits = np.log(np.asarray([[0.5, 0.3, 0.2]], np.float32))
    params = tsampling.SamplingParams(temperature=1.0, top_p=1.0)
    draws = _tsample(np.repeat(logits, 4000, 0), seed=3,
                     params=params).numpy()
    freq = np.bincount(draws, minlength=3) / len(draws)
    np.testing.assert_allclose(freq, [0.5, 0.3, 0.2], atol=0.03)
