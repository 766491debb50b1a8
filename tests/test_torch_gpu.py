"""Kernels K1-K5 against their plain versions on a CUDA card.

Marked ``gpu``: they need a card, nvcc and sm_90a, and skip elsewhere (the
CPU suite holds the plain versions against the JAX package instead). Run
them on the card with ``python -m pytest tests/test_torch_gpu.py -m gpu
--noconftest``. ``chip_smoke.py`` runs the same holds at the main path's
full shapes.
"""
import pytest
import torch

from detikzify_torch.models import llama
from detikzify_torch.ops import attention, flash, paged, quant_matmul
from detikzify_torch.ops.quant import QuantLinear, quantize_kernel

pytestmark = pytest.mark.gpu

BF16_U = 2.0 ** -8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _within(got, want, pv_abs) -> bool:
    """Both sides round the output to bf16 once and round probabilities to
    bf16 at different points, each at most u times the mass that reaches
    the element: |diff| <= 2u (pv_abs + |want|), pv_abs the plain version
    run on |v|."""
    err = (got.float() - want.float()).abs()
    bound = 2 * BF16_U * (pv_abs.float() + want.float().abs())
    return bool(torch.isfinite(got.float()).all()) and bool(
        (err <= bound).all())


def _close(got, want, pv_abs):
    assert _within(got, want, pv_abs), float(
        (got.float() - want.float()).abs().max())


def _rnd(gen, dev, *shape):
    return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)


@pytest.mark.parametrize("b,s,t,nh,nkv,hd,mode", [
    (2, 900, 900, 16, 16, 72, "full"),
    (2, 1, 900, 16, 16, 72, "full"),
    (1, 130, 130, 8, 2, 64, "causal"),
    (2, 64, 96, 4, 4, 128, "mask"),
    (3, 512, 640, 32, 8, 128, "window"),
])
def test_flash_kernel_matches_plain(cuda, b, s, t, nh, nkv, hd, mode):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (_rnd(gen, cuda, b, s, nh, hd), _rnd(gen, cuda, b, t, nkv, hd),
               _rnd(gen, cuda, b, t, nkv, hd))
    kw = {}
    if mode == "causal":
        kw["causal"] = True
    elif mode == "mask":
        mask = torch.ones((b, t), dtype=torch.bool, device=cuda)
        mask[0, 40:] = False
        mask[1, :] = False                 # fully masked row: uniform average
        kw["kv_mask"] = mask
    elif mode == "window":
        kw["q_offsets"] = torch.tensor([0, 0, 128], dtype=torch.int32,
                                       device=cuda)
        kw["kv_limits"] = torch.tensor([300, 0, 428], dtype=torch.int32,
                                       device=cuda)
    before = flash.KERNEL.launches
    got = flash.flash_attention(q, k, v, **kw)
    assert flash.KERNEL.launches == before + 1
    _close(got, attention.attend_plain(q, k, v, **kw),
           attention.attend_plain(q, k, v.abs(), **kw))


@pytest.mark.parametrize("nh,nkv,hd", [(32, 8, 128), (8, 8, 64), (32, 4, 64)])
def test_paged_kernel_matches_plain(cuda, nh, nkv, hd):
    gen = torch.Generator(device=cuda).manual_seed(1)
    b, page, m = 5, 128, 6
    n_pages = b * m + 3
    pool_k = _rnd(gen, cuda, n_pages, page, nkv, hd)
    pool_v = _rnd(gen, cuda, n_pages, page, nkv, hd)
    tab = torch.randperm(n_pages, generator=gen, device=cuda)[:b * m]
    tab = tab.reshape(b, m).to(torch.int32)
    wide = torch.cat([tab, tab[:, :2]], dim=1)      # engine tables are wider
    lengths = torch.tensor([1, 64, 300, 700, m * page], dtype=torch.int32,
                           device=cuda)
    q = _rnd(gen, cuda, b, nh, hd)
    got = paged.decode_attend_paged(q, pool_k, pool_v, wide[:, :m], lengths)
    want = paged.decode_attend_paged_plain(q, pool_k, pool_v, tab, lengths)
    _close(got, want, paged.decode_attend_paged_plain(
        q, pool_k, pool_v.abs(), tab, lengths))


def _k1_case_inputs(gen, dev, s, hd, mode):
    """Three batch rows at S queries over T = S + 70 keys (or 900 for the
    vision shape), SigLIP heads at head_dim 72, GQA 8:2 at 64 and 128.
    "mask" has a fully masked row (uniform average), "window" a zero key
    limit."""
    b, t = 3, (900 if s == 900 else s + 70)
    nh, nkv = (16, 16) if hd == 72 else (8, 2)
    q, k, v = (_rnd(gen, dev, b, s, nh, hd), _rnd(gen, dev, b, t, nkv, hd),
               _rnd(gen, dev, b, t, nkv, hd))
    kw = {}
    if mode == "causal":
        kw["causal"] = True
    elif mode == "mask":
        mask = torch.ones((b, t), dtype=torch.bool, device=dev)
        mask[0, 40:] = False
        mask[1, :] = False
        kw["kv_mask"] = mask
    elif mode == "window":
        kw["q_offsets"] = torch.tensor([0, 5, 0], dtype=torch.int32,
                                       device=dev)
        kw["kv_limits"] = torch.tensor([min(t, 300), 0, t],
                                       dtype=torch.int32, device=dev)
    return q, k, v, kw


@pytest.mark.parametrize("mode", ["full", "causal", "mask", "window"])
@pytest.mark.parametrize("hd", [64, 72, 128])
@pytest.mark.parametrize("s", [1, 2, 16, 17, 63, 64, 65, 129, 900])
def test_flash_kernel_paths_match_plain(cuda, s, hd, mode):
    """Both paths of K1 (split keys for S <= 16, wgmma tiles above), at the
    tile edges of S, with every mask kind; one launch counted per call."""
    gen = torch.Generator(device=cuda).manual_seed(s * 7 + hd)
    q, k, v, kw = _k1_case_inputs(gen, cuda, s, hd, mode)
    before = flash.KERNEL.launches
    got = flash.flash_attention(q, k, v, **kw)
    assert flash.KERNEL.launches == before + 1
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    _close(got, attention.attend_plain(q, k, v, **kw),
           attention.attend_plain(q, k, v.abs(), **kw))


# K2's length edges around its 64-row chunks and 256-row splits, at m = 4
# pages of 128 rows: the full table and one past it (clamped)
K2_LENGTHS = (1, 63, 64, 65, 255, 256, 257, 512, 517)


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("b", [1, 8])
def test_paged_kernel_split_edges(cuda, b, g, hd):
    """K2 at every length edge, read through a column slice of a wider
    table; one launch counted per call, and a repeated call gives the same
    bits (the merge sums splits in a fixed order)."""
    gen = torch.Generator(device=cuda).manual_seed(b * 100 + g * 10 + hd)
    nkv, page, m = 4, 128, 4
    nh = g * nkv
    n_pages = b * (m + 2) + 3
    pool_k = _rnd(gen, cuda, n_pages, page, nkv, hd)
    pool_v = _rnd(gen, cuda, n_pages, page, nkv, hd)
    perm = torch.randperm(n_pages, generator=gen, device=cuda)
    wide = perm[:b * (m + 2)].reshape(b, m + 2).to(torch.int32)
    tab = wide[:, :m]
    q = _rnd(gen, cuda, b, nh, hd)
    for start in range(0, len(K2_LENGTHS), b):
        picked = [K2_LENGTHS[(start + i) % len(K2_LENGTHS)] for i in range(b)]
        lengths = torch.tensor(picked, dtype=torch.int32, device=cuda)
        before = paged.KERNEL.launches
        got = paged.decode_attend_paged(q, pool_k, pool_v, tab, lengths)
        assert paged.KERNEL.launches == before + 1
        again = paged.decode_attend_paged(q, pool_k, pool_v, tab, lengths)
        assert torch.equal(got, again)
        want = paged.decode_attend_paged_plain(q, pool_k, pool_v,
                                               tab.contiguous(), lengths)
        _close(got, want, paged.decode_attend_paged_plain(
            q, pool_k, pool_v.abs(), tab.contiguous(), lengths))


def _verify_inputs(gen, dev, b, k1, nh, nkv, hd, page, m):
    n_pages = b * m + 2
    pool_k = _rnd(gen, dev, n_pages, page, nkv, hd)
    pool_v = _rnd(gen, dev, n_pages, page, nkv, hd)
    tab = torch.randperm(n_pages, generator=gen, device=dev)[:b * m]
    tab = tab.reshape(b, m).to(torch.int32)
    return _rnd(gen, dev, b, k1, nh, hd), pool_k, pool_v, tab


@pytest.mark.parametrize("b,k1,nh,nkv,hd,page,m", [
    (4, 5, 8, 2, 64, 64, 5),
    (3, 3, 4, 4, 128, 128, 3),
    (8, 5, 32, 8, 128, 128, 16),       # v2-8b, speculate=4
    (2, 8, 16, 2, 128, 128, 4),        # 64 query rows per KV head
])
def test_paged_verify_kernel_matches_plain(cuda, b, k1, nh, nkv, hd, page,
                                           m):
    """K4 against its plain version, with a dead slot (start 0), a slot
    whose window runs past the table edge (start + K1 > m * page), and a
    column slice of a wider table; then at the split edges: windows across
    a split boundary and row 0's limit on a split's first row. One launch
    counted per call, and a repeated call gives the same bits (the merge
    sums splits in a fixed order). Control: the plain version with every
    causal limit one row later (start + 1) must fail the tolerance."""
    gen = torch.Generator(device=cuda).manual_seed(b + k1 + hd)
    q, pool_k, pool_v, tab = _verify_inputs(gen, cuda, b, k1, nh, nkv, hd,
                                            page, m)
    edge = m * page - k1 + 2
    starts = torch.randint(1, m * page - k1, (b,), generator=gen,
                           device=cuda).to(torch.int32)
    starts[0], starts[-1] = 0, edge
    split = paged.SPLIT_ROWS
    # windows across a boundary, row 0's limit on one, a window ending on
    # one, and the dead and edge slots again
    edges = [split - 2, split - 1, split - k1, 2 * split - 3, 2 * split - 1,
             0, edge]
    edge_sets = [[edges[(i + j) % len(edges)] for j in range(b)]
                 for i in range(0, len(edges), b)]
    wide = torch.cat([tab, tab[:, :2]], dim=1)
    for n, picked in enumerate([starts.tolist()] + edge_sets):
        starts = torch.tensor(picked, dtype=torch.int32, device=cuda)
        before = paged.VERIFY_KERNEL.launches
        got = paged.decode_verify_attend_paged(q, pool_k, pool_v,
                                               wide[:, :m], starts)
        assert paged.VERIFY_KERNEL.launches == before + 1
        assert got.shape == q.shape and got.dtype == torch.bfloat16
        again = paged.decode_verify_attend_paged(q, pool_k, pool_v,
                                                 wide[:, :m], starts)
        assert torch.equal(got, again)
        want = paged.decode_verify_attend_paged_plain(q, pool_k, pool_v, tab,
                                                      starts)
        pv_abs = paged.decode_verify_attend_paged_plain(
            q, pool_k, pool_v.abs(), tab, starts)
        _close(got, want, pv_abs)
        if n == 0:
            late = paged.decode_verify_attend_paged_plain(
                q, pool_k, pool_v, tab, starts + 1)
            assert not _within(got, late, pv_abs)


@pytest.mark.parametrize("b,nh,nkv,hd,L,limit", [
    (3, 8, 2, 64, 512, None),
    (5, 32, 8, 128, 700, None),
    (8, 32, 8, 128, 2048, None),       # v2-8b, the full cache
    (8, 32, 8, 128, 2048, 1024),       # v2-8b, a kv_limit view in place
])
def test_decode_contig_kernel_matches_plain(cuda, b, nh, nkv, hd, L, limit):
    """K3 (through ``ops.attention.decode_attend``) against its plain
    version, on the full cache and on a ``[:, :kv_limit]`` view read in
    place with lengths clamped to it; then at lengths 1, 127, 128 and 129
    (around the first 128-row split). One launch counted per call, and a
    repeated call gives the same bits. Control: the plain version reading
    one 64-row block short must fail the tolerance."""
    from detikzify_torch.ops import decode_flash

    gen = torch.Generator(device=cuda).manual_seed(b + L)
    q = _rnd(gen, cuda, b, nh, hd)
    k, v = _rnd(gen, cuda, b, L, nkv, hd), _rnd(gen, cuda, b, L, nkv, hd)
    lengths = torch.randint(65, L + 1, (b,), generator=gen,
                            device=cuda).to(torch.int32)
    lengths[0] = L
    if limit is not None:
        k, v = k[:, :limit], v[:, :limit]
        lengths = lengths.clamp(max=limit)
        assert not k.is_contiguous()
    edges = torch.tensor([(1, 127, 128, 129)[i % 4] for i in range(b)],
                         dtype=torch.int32, device=cuda)
    for n, lens in enumerate((lengths, edges)):
        before = decode_flash.KERNEL.launches
        got = attention.decode_attend(q, k, v, lens)
        assert decode_flash.KERNEL.launches == before + 1
        assert torch.equal(got, attention.decode_attend(q, k, v, lens))
        want = attention.decode_attend_plain(q, k, v, lens)
        pv_abs = attention.decode_attend_plain(q, k, v.abs(), lens)
        _close(got, want, pv_abs)
        if n == 0:
            short = attention.decode_attend_plain(q, k, v, lens - 64)
            assert not _within(got, short, pv_abs)


def test_decode_contig_kernel_long_cache(cuda):
    """K3 over a cache longer than 256 splits of 128 rows (33,000 rows,
    259 splits): the merge stages the split weights in two chunks, and
    lengths on either side of the chunk edge (32,768 rows) and at L hold
    against the plain version."""
    from detikzify_torch.ops import decode_flash

    gen = torch.Generator(device=cuda).manual_seed(11)
    b, nh, nkv, hd, L = 3, 8, 2, 64, 33000
    q = _rnd(gen, cuda, b, nh, hd)
    k, v = _rnd(gen, cuda, b, L, nkv, hd), _rnd(gen, cuda, b, L, nkv, hd)
    lengths = torch.tensor([32768, 32769, L], dtype=torch.int32, device=cuda)
    before = decode_flash.KERNEL.launches
    got = attention.decode_attend(q, k, v, lengths)
    assert decode_flash.KERNEL.launches == before + 1
    _close(got, attention.decode_attend_plain(q, k, v, lengths),
           attention.decode_attend_plain(q, k, v.abs(), lengths))


# (K, N) of every K5 product on the int8 v2-8b path: fused qkv, o, fused
# gateup, down, lm_head (fp32 out), the MAP head's q and o
K5_SHAPES = [(4096, 6144, "bf16"), (4096, 4096, "bf16"),
             (4096, 28672, "bf16"), (14336, 4096, "bf16"),
             (4096, 128256, "fp32"), (1152, 1152, "bf16")]


def _k5_inputs(gen, dev, rows, k, n, x_dtype=torch.bfloat16):
    x = torch.randn((rows, k), generator=gen, device=dev).to(x_dtype)
    w = torch.randn((n, k), generator=gen, device=dev) * k ** -0.5
    q, scale = quantize_kernel(w)
    return x, q, scale


def _k5_bound(x, q, scale, out_dtype):
    """The plain product and the elementwise bound on |kernel - plain|,
    with mag = plain(|x|, |q|). A bf16 output: 2^-7 |plain| (one rounding
    of the output, a whole ulp when the two sums fall on either side of a
    rounding boundary) + K 2^-23 mag (two fp32 sums of K terms in different
    orders, worst case). An fp32 output: 2 sqrt(K) 2^-24 mag, the
    random-walk size of the two sums' rounding errors, tight enough that an
    output rounded through bf16 fails it."""
    want = quant_matmul.int8_matmul_plain(x, q, scale, out_dtype).float()
    mag = quant_matmul.int8_matmul_plain(x.abs(), q.abs(), scale,
                                         torch.float32)
    k = x.shape[1]
    if out_dtype == torch.bfloat16:
        return want, 2.0 ** -7 * want.abs() + k * 2.0 ** -23 * mag
    return want, 2 * k ** 0.5 * 2.0 ** -24 * mag


def _k5_close(got, x, q, scale, out_dtype):
    want, bound = _k5_bound(x, q, scale, out_dtype)
    err = (got.float() - want).abs()
    assert bool(torch.isfinite(got.float()).all())
    assert bool((err <= bound).all()), float((err / bound).max())


# narrow blocks (1, 8) and every tile count of the wide kernel, 2 to 8
# (10, 20, 25, 40, 48, 50 and 56, 64), split (qkv, o, down, MAP) or not
@pytest.mark.parametrize("rows", [1, 8, 10, 20, 25, 40, 48, 50, 56, 64])
@pytest.mark.parametrize("k,n,out", K5_SHAPES)
def test_int8_gemv_matches_plain(cuda, rows, k, n, out):
    gen = torch.Generator(device=cuda).manual_seed(rows + k + n)
    x, q, scale = _k5_inputs(gen, cuda, rows, k, n)
    out_dtype = torch.float32 if out == "fp32" else torch.bfloat16
    before = quant_matmul.KERNEL.launches
    got = quant_matmul.int8_matmul(x, q, scale, out_dtype)
    assert quant_matmul.KERNEL.launches == before + 1
    assert got.dtype == out_dtype and got.shape == (rows, n)
    _k5_close(got, x, q, scale, out_dtype)
    if out_dtype == torch.float32:
        # control: the fp32 bound refuses the same output rounded to bf16
        want, bound = _k5_bound(x, q, scale, out_dtype)
        assert bool(((got.to(torch.bfloat16).float() - want).abs()
                     > bound).any())


@pytest.mark.parametrize("rows", [8, 40])
@pytest.mark.parametrize("k,n,out", [(4096, 4096, "bf16"),
                                     (4096, 28672, "bf16"),
                                     (4096, 128256, "fp32")])
def test_int8_gemv_repeat_is_bit_identical(cuda, rows, k, n, out):
    """Split partials (o at 40 rows, in the reduce kernel), unsplit wide
    blocks (gateup, lm_head at 40 rows) and the 8 warps of a narrow block
    (8 rows) meet in a fixed order, so two launches on the same inputs
    agree bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    x, q, scale = _k5_inputs(gen, cuda, rows, k, n)
    out_dtype = torch.float32 if out == "fp32" else torch.bfloat16
    first = quant_matmul.int8_gemv(x, q, scale, out_dtype)
    for _ in range(3):
        assert torch.equal(quant_matmul.int8_gemv(x, q, scale, out_dtype),
                           first)


@pytest.mark.parametrize("rows", [5, 40])
@pytest.mark.parametrize("k,n", [(4096, 4096), (4096, 28672), (1152, 1152)])
def test_int8_gemv_reads_only_its_rows(cuda, rows, k, n):
    """Rows taken from a 64-row buffer whose other rows hold 1e30: the
    kernel (40 rows: 5 tiles of 8 in wide blocks; 5 rows: one tile in
    narrow blocks) reads none of them, split or not."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    buf, q, scale = _k5_inputs(gen, cuda, 64, k, n)
    buf[rows:] = 1e30
    x = buf[:rows]
    assert quant_matmul.gemv_plan(rows, n, k, 132).n_tiles == -(-rows // 8)
    got = quant_matmul.int8_gemv(x, q, scale)
    _k5_close(got, x, q, scale, torch.bfloat16)


@pytest.mark.parametrize("rows", [3, 64])
def test_int8_gemv_fp32_input_matches_plain(cuda, rows):
    gen = torch.Generator(device=cuda).manual_seed(5)
    x, q, scale = _k5_inputs(gen, cuda, rows, 1152, 1152, torch.float32)
    got = quant_matmul.int8_gemv(x, q, scale)
    _k5_close(got, x, q, scale, torch.float32)


def test_unembed_logits_not_rounded_through_bf16(cuda):
    """At the v2-8b head (4096 x 128256, bf16 weights, 8 rows) the old
    ``F.linear(h, W).float()`` rounds the logits to bf16; ``unembed`` now
    stays within fp32-accumulation error, sqrt(K) 2^-23 plain(|h|, |W|), of
    an fp32 product on the CPU. The int8 head is K5 with an fp32 output."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    d, vocab = 4096, 128256
    h = torch.randn((8, d), generator=gen, device=cuda).to(torch.bfloat16)
    w = (torch.randn((vocab, d), generator=gen, device=cuda)
         * d ** -0.5).to(torch.bfloat16)
    head = torch.nn.Module()
    head.lm_head = torch.nn.Linear(d, vocab, bias=False, device="meta")
    head.lm_head.weight = torch.nn.Parameter(w, requires_grad=False)
    hc, wc = h.float().cpu(), w.float().cpu()
    want = hc @ wc.t()
    bound = d ** 0.5 * 2.0 ** -23 * (hc.abs() @ wc.abs().t())
    before = (torch.nn.functional.linear(h, w).float().cpu() - want).abs()
    assert bool((before > bound).any())          # the fault it repairs
    got = llama.unembed(head, h)
    assert got.dtype == torch.float32
    assert bool(((got.cpu() - want).abs() <= bound).all())
    qh = QuantLinear(d, vocab, device=cuda)
    qh.q, qh.scale = quantize_kernel(w)
    head.lm_head = qh
    before = quant_matmul.KERNEL.launches
    got = llama.unembed(head, h)
    assert quant_matmul.KERNEL.launches == before + 1
    _k5_close(got, h, qh.q, qh.scale, torch.float32)


def test_wrappers_raise_instead_of_falling_back(cuda):
    qh16 = torch.zeros((1, 4, 2, 24), dtype=torch.float16, device=cuda)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        flash.flash_attention(qh16, qh16, qh16)          # fp16: refused
    qh = torch.zeros((1, 4, 2, 96), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="Hd must be one of"):
        flash.flash_attention(qh, qh, qh)                # no bf16 tile for 96
    for hd in (30, 132):        # fp32: a multiple of 4 up to 128
        qf = torch.zeros((1, 4, 2, hd), device=cuda)
        with pytest.raises(ValueError, match="multiple of 4 up to 128"):
            flash.flash_attention(qf, qf, qf)
    qf = torch.zeros((1, 4, 2, 32), device=cuda)
    with pytest.raises(ValueError, match="one dtype"):
        flash.flash_attention(qf, qf.to(torch.bfloat16), qf)
    qb = torch.zeros((1, 2, 96), dtype=torch.bfloat16, device=cuda)
    pool = torch.zeros((2, 128, 2, 96), dtype=torch.bfloat16, device=cuda)
    tab = torch.zeros((1, 1), dtype=torch.int32, device=cuda)
    lengths = torch.ones((1,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        paged.decode_attend_paged(qb, pool, pool, tab, lengths)
    with pytest.raises(ValueError, match="head_dim"):   # fp32: 32, 64, 128
        paged.decode_attend_paged(qb.float(), pool.float(), pool.float(),
                                  tab, lengths)
    q32 = torch.zeros((1, 2, 32), dtype=torch.float16, device=cuda)
    pool32 = torch.zeros((2, 128, 2, 32), dtype=torch.float16, device=cuda)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        paged.decode_attend_paged(q32, pool32, pool32, tab, lengths)
    with pytest.raises(ValueError, match="one dtype"):
        paged.decode_attend_paged(q32.float(), pool32.to(torch.bfloat16),
                                  pool32.to(torch.bfloat16), tab, lengths)
    qv = torch.zeros((1, 9, 8, 128), dtype=torch.bfloat16, device=cuda)
    pool = torch.zeros((2, 128, 8, 128), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="K1 <= 8"):
        paged.decode_verify_attend_paged(qv, pool, pool, tab, lengths)
    with pytest.raises(ValueError, match="K1 <= 8"):
        paged.decode_verify_attend_paged(qv.float(), pool.float(),
                                         pool.float(), tab, lengths)
    kc = torch.zeros((1, 64, 2, 96), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        attention.decode_attend(qb, kc, kc, lengths)
    with pytest.raises(ValueError, match="head_dim"):
        attention.decode_attend(qb.float(), kc.float(), kc.float(), lengths)
    kc = torch.zeros((1, 64, 2, 128), dtype=torch.bfloat16, device=cuda)
    qc = torch.zeros((1, 4, 128), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="strides"):
        attention.decode_attend(qc, kc.transpose(1, 2), kc.transpose(1, 2),
                                lengths)
    q8 = torch.zeros((256, 256), dtype=torch.int8, device=cuda)
    scale = torch.ones((256,), device=cuda)
    xh = torch.zeros((4, 256), dtype=torch.float16, device=cuda)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        quant_matmul.int8_gemv(xh, q8, scale)            # fp16: refused
    xb = torch.zeros((4, 256), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="int8"):
        quant_matmul.int8_gemv(xb, q8.float(), scale)    # not int8
    # an eligible product on the card launches K5 or raises, never the
    # plain version: a refused launch (K not a multiple of 128) is an error
    with pytest.raises(RuntimeError, match="CUDA error"):
        quant_matmul.KERNEL.launch(
            xb.data_ptr(), q8.data_ptr(), scale.data_ptr(), xb.data_ptr(),
            None, 4, 256, 200, 1, 0, 0, paged.stream_handle(cuda))


# ---------------------------------------------------------------------------
# K1-K4 at float32 and head_dim 32 (the spec model's, ClipScore's fp32
# towers, tiny-test's 12 and 16)
# ---------------------------------------------------------------------------

F32_TOL = 2.0 ** -16


def _close_f32(got, want, pv_abs):
    """fp32 kernel against fp32 plain version: |diff| <= 2^-16 (pv_abs +
    |want|) elementwise (chip_smoke.py's F32_TOL); an output rounded
    through bf16 must fail the same bound."""
    assert got.dtype == torch.float32
    bound = F32_TOL * (pv_abs + want.abs())
    err = (got - want).abs()
    assert bool(torch.isfinite(got).all())
    assert bool((err <= bound).all()), float((err / bound).max())
    rounded = got.to(torch.bfloat16).float()
    assert not bool(((rounded - want).abs() <= bound).all())


@pytest.mark.parametrize("mode", ["full", "causal", "mask", "window"])
@pytest.mark.parametrize("hd", [4, 12, 16, 32, 36, 72, 128])
@pytest.mark.parametrize("s", [1, 16, 17, 65, 729])
def test_flash_kernel_fp32_matches_plain(cuda, s, hd, mode):
    """K1's fp32 kernel at every mask kind, at S <= 16 over a few keys and
    on its 64-row tiles, at head dims that are not multiples of 8 or 32
    (tiled at 32, 64, 72 or 128 with zero pad columns) and at the tower's
    729 rows; one launch of the fp32 handle a call, none of the bf16 one."""
    gen = torch.Generator(device=cuda).manual_seed(s * 11 + hd)
    # the masks and head layout of the bf16 cases, at this head_dim in fp32
    q, k, v, kw = _k1_case_inputs(gen, cuda, s, 72 if hd == 72 else 64, mode)
    b, t = q.shape[0], k.shape[1]
    nh, nkv = q.shape[2], k.shape[2]
    q = torch.randn((b, s, nh, hd), generator=gen, device=cuda)
    k = torch.randn((b, t, nkv, hd), generator=gen, device=cuda)
    v = torch.randn((b, t, nkv, hd), generator=gen, device=cuda)
    before = (flash.KERNEL_F32.launches, flash.KERNEL.launches)
    got = flash.flash_attention(q, k, v, **kw)
    assert (flash.KERNEL_F32.launches, flash.KERNEL.launches) == (
        before[0] + 1, before[1])
    assert got.shape == q.shape
    _close_f32(got, attention.attend_plain(q, k, v, **kw),
               attention.attend_plain(q, k, v.abs(), **kw))


@pytest.mark.parametrize("mode", ["full", "causal", "mask", "window"])
@pytest.mark.parametrize("s", [1, 16, 17, 65, 130])
def test_flash_kernel_bf16_head_dim_32(cuda, s, mode):
    """K1's bf16 kernel at head_dim 32 (tiled at 64 on the wgmma path,
    and on the split-key path at S <= 16), every mask kind."""
    gen = torch.Generator(device=cuda).manual_seed(s * 13)
    q, k, v, kw = _k1_case_inputs(gen, cuda, s, 64, mode)
    b, t, nh, nkv = q.shape[0], k.shape[1], q.shape[2], k.shape[2]
    q, k, v = (_rnd(gen, cuda, b, s, nh, 32), _rnd(gen, cuda, b, t, nkv, 32),
               _rnd(gen, cuda, b, t, nkv, 32))
    before = flash.KERNEL.launches
    got = flash.flash_attention(q, k, v, **kw)
    assert flash.KERNEL.launches == before + 1
    assert got.shape == q.shape
    _close(got, attention.attend_plain(q, k, v, **kw),
           attention.attend_plain(q, k, v.abs(), **kw))


def _pool_case(gen, dev, dtype, b, nh, nkv, hd, page, m):
    n_pages = b * m + 3
    pk = torch.randn((n_pages, page, nkv, hd), generator=gen,
                     device=dev).to(dtype)
    pv = torch.randn((n_pages, page, nkv, hd), generator=gen,
                     device=dev).to(dtype)
    tab = torch.randperm(n_pages, generator=gen, device=dev)[:b * m]
    return pk, pv, tab.reshape(b, m).to(torch.int32)


def _check(dtype, got, want, pv_abs):
    if dtype == torch.float32:
        _close_f32(got, want, pv_abs)
    else:
        _close(got, want, pv_abs)


@pytest.mark.parametrize("dtype,hd", [(torch.float32, 32),
                                      (torch.float32, 64),
                                      (torch.float32, 128),
                                      (torch.bfloat16, 32)])
@pytest.mark.parametrize("nh,nkv", [(4, 4), (8, 2), (32, 32), (32, 8),
                                    (16, 2)])
def test_decode_kernels_fp32_and_head_dim_32(cuda, nh, nkv, dtype, hd):
    """K2, K4 and K3 over fp32 pools and caches at head_dim 32, 64 and 128
    and over bf16 ones at head_dim 32 (MHA, GQA 4 as v2-8b's, 8 and DS-7b's
    32 heads), lengths across the 128-row splits, a dead verify slot and
    one past the table's edge; each call launches its own dtype's handle
    once."""
    from detikzify_torch.ops import decode_flash

    gen = torch.Generator(device=cuda).manual_seed(nh * 7 + hd)
    b, page, m = 5, 128, 5
    pk, pv, tab = _pool_case(gen, cuda, dtype, b, nh, nkv, hd, page, m)
    f32 = dtype == torch.float32
    k2 = paged.KERNEL_F32 if f32 else paged.KERNEL
    k4 = paged.VERIFY_KERNEL_F32 if f32 else paged.VERIFY_KERNEL
    k3 = decode_flash.KERNEL_F32 if f32 else decode_flash.KERNEL

    lengths = torch.tensor([1, 57, 300, 517, m * page], dtype=torch.int32,
                           device=cuda)
    q = torch.randn((b, nh, hd), generator=gen, device=cuda).to(dtype)
    before = k2.launches
    got = paged.decode_attend_paged(q, pk, pv, tab, lengths)
    assert k2.launches == before + 1 and got.dtype == dtype
    _check(dtype, got, paged.decode_attend_paged_plain(q, pk, pv, tab,
                                                       lengths),
           paged.decode_attend_paged_plain(q, pk, pv.abs(), tab, lengths))

    if (nh // nkv) * 5 <= paged.MAX_VERIFY_ROWS:
        starts = torch.tensor([0, 52, 300, 512, m * page - 3],
                              dtype=torch.int32, device=cuda)
        qv = torch.randn((b, 5, nh, hd), generator=gen,
                         device=cuda).to(dtype)
        before = k4.launches
        got = paged.decode_verify_attend_paged(qv, pk, pv, tab, starts)
        assert k4.launches == before + 1 and got.dtype == dtype
        _check(dtype, got, paged.decode_verify_attend_paged_plain(
            qv, pk, pv, tab, starts), paged.decode_verify_attend_paged_plain(
            qv, pk, pv.abs(), tab, starts))

    kc, vc = paged.gather_pages(pk, tab), paged.gather_pages(pv, tab)
    for limit in (None, 384):
        kk = kc if limit is None else kc[:, :limit]
        vv = vc if limit is None else vc[:, :limit]
        before = k3.launches
        got = attention.decode_attend(q, kk, vv, lengths)
        assert k3.launches == before + 1 and got.dtype == dtype
        _check(dtype, got, attention.decode_attend_plain(q, kk, vv, lengths),
               attention.decode_attend_plain(q, kk, vv.abs(), lengths))


# ---------------------------------------------------------------------------
# the Hopper redesign of the float32 kernels: K1's 3xTF32 tiles and its
# cluster path at S <= 16, the decode body's ring and its one-split launch
# ---------------------------------------------------------------------------

def _f32_k1_inputs(gen, dev, b, s, t, nh, nkv, hd, mode):
    """fp32 q, k, v and the mask of ``mode``: "mask" leaves the second row
    no key (a uniform average over the T keys), "window" gives it a zero
    key limit and the first a prefix offset."""
    q = torch.randn((b, s, nh, hd), generator=gen, device=dev)
    k = torch.randn((b, t, nkv, hd), generator=gen, device=dev)
    v = torch.randn((b, t, nkv, hd), generator=gen, device=dev)
    kw = {}
    if mode == "causal":
        kw["causal"] = True
    elif mode == "mask":
        mask = torch.ones((b, t), dtype=torch.bool, device=dev)
        mask[0, t // 3:] = False
        if b > 1:
            mask[1, :] = False
        kw["kv_mask"] = mask
    elif mode == "window":
        kw["q_offsets"] = torch.tensor([128] + [0] * (b - 1),
                                       dtype=torch.int32, device=dev)
        kw["kv_limits"] = torch.tensor([min(t, 300)] + [0] * (b - 1),
                                       dtype=torch.int32, device=dev)
    return q, k, v, kw


def _k1_f32_hold(q, k, v, kw):
    before = (flash.KERNEL_F32.launches, flash.KERNEL.launches)
    got = flash.flash_attention(q, k, v, **kw)
    assert (flash.KERNEL_F32.launches, flash.KERNEL.launches) == (
        before[0] + 1, before[1])
    assert got.shape == q.shape
    want = attention.attend_plain(q, k, v, **kw)
    pv_abs = attention.attend_plain(q, k, v.abs(), **kw)
    _close_f32(got, want, pv_abs)
    return want, pv_abs


@pytest.mark.parametrize("mode", ["full", "causal", "mask", "window"])
@pytest.mark.parametrize("t", [729, 900])
@pytest.mark.parametrize("s", [1, 3, 16])
def test_flash_kernel_fp32_cluster_path(cuda, s, t, mode):
    """K1 fp32 at S <= 16 splits the 729 or 900 keys of the MAP head's
    tower over a cluster of 8 blocks and merges their fp32 partials: every
    mask kind, a row with no visible key, SigLIP's 16 heads of 72."""
    gen = torch.Generator(device=cuda).manual_seed(s * 31 + t)
    _k1_f32_hold(*_f32_k1_inputs(gen, cuda, 2, s, t, 16, 16, 72, mode))


@pytest.mark.parametrize("b,s,t,nh,nkv,hd,mode,prompt", [
    (8, 64, 64, 16, 16, 72, "full", None),      # ClipScore's text tower
    (4, 729, 729, 16, 16, 72, "full", None),    # its vision tower
    (4, 1, 729, 16, 16, 72, "full", None),      # its MAP head
    (8, 128, 128, 4, 4, 32, "causal", None),    # the spec model's training
    (1, 16, 144, 4, 4, 32, "window", 9),        # its prefill window
    (1, 729, 729, 16, 16, 72, "full", None),    # DS-1.3b's tower in fp32
    (1, 256, 384, 16, 16, 128, "window", 243),  # its prefill window
    (8, 256, 384, 16, 16, 128, "window", 243),  # a wave of 8 rollouts
])
def test_flash_kernel_fp32_kernel_phase_shapes(cuda, b, s, t, nh, nkv, hd,
                                               mode, prompt):
    """K1 fp32 at every fp32 shape of chip_smoke.py's kernel phase; the
    plain version with one TF32 pass for its products fails the bound the
    kernel's 3xTF32 meets."""
    import chip_smoke

    gen = torch.Generator(device=cuda).manual_seed(b * s + hd)
    q, k, v, kw = _f32_k1_inputs(gen, cuda, b, s, t, nh, nkv, hd, mode)
    if mode == "window":              # fresh prompts, as the engine starts
        kw = {"q_offsets": torch.zeros(b, dtype=torch.int32, device=cuda),
              "kv_limits": torch.full((b,), prompt, dtype=torch.int32,
                                      device=cuda)}
    want, pv_abs = _k1_f32_hold(q, k, v, kw)
    one_pass = chip_smoke.tf32_plain(torch, attention.attend_plain, q, k, v,
                                     **kw)
    bound = F32_TOL * (pv_abs + want.abs())
    assert not bool(((one_pass - want).abs() <= bound).all())


def _device_functions(fn, split_kernel):
    """The names of the device functions ``fn`` launches, from a profile
    that holds ``split_kernel`` (the profiler can lose a launch's device
    events, as it did for a function loaded lazily in the profiled call:
    ``fn`` runs once first, and the profile is taken again, up to three
    times, until the split kernel is in it)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = " ".join(e.name for e in prof.events())
        if split_kernel in names:
            return names
    raise AssertionError(f"no {split_kernel} in three profiles: {names}")


@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("nh,nkv", [(4, 4), (32, 8), (8, 1)])
@pytest.mark.parametrize("page,m", [(64, 2), (128, 1)])
def test_decode_kernels_fp32_one_split_no_merge(cuda, page, m, nh, nkv, hd):
    """Where every slot's keys fit one 128-row split (the spec model's one
    page), the fp32 K2, K4 and K3 write their output from the split kernel
    and launch no merge; the result holds against the plain versions."""
    from detikzify_torch.ops import decode_flash

    gen = torch.Generator(device=cuda).manual_seed(nh * 5 + hd + page)
    b = 6
    pk, pv, tab = _pool_case(gen, cuda, torch.float32, b, nh, nkv, hd, page,
                             m)
    lengths = torch.tensor([1, 9, 16, 57, 100, 128], dtype=torch.int32,
                           device=cuda)
    q = torch.randn((b, nh, hd), generator=gen, device=cuda)
    run = lambda: paged.decode_attend_paged(q, pk, pv, tab, lengths)  # noqa
    assert "merge_kernel" not in _device_functions(run, "paged_split_kernel")
    _close_f32(run(), paged.decode_attend_paged_plain(q, pk, pv, tab,
                                                      lengths),
               paged.decode_attend_paged_plain(q, pk, pv.abs(), tab,
                                               lengths))
    if (nh // nkv) * 5 <= paged.MAX_VERIFY_ROWS:
        starts = torch.tensor([0, 4, 11, 52, 95, 123], dtype=torch.int32,
                              device=cuda)
        qv = torch.randn((b, 5, nh, hd), generator=gen, device=cuda)
        run = lambda: paged.decode_verify_attend_paged(  # noqa
            qv, pk, pv, tab, starts)
        assert "merge_kernel" not in _device_functions(run,
                                                       "verify_split_kernel")
        _close_f32(run(), paged.decode_verify_attend_paged_plain(
            qv, pk, pv, tab, starts), paged.decode_verify_attend_paged_plain(
            qv, pk, pv.abs(), tab, starts))
    kc, vc = paged.gather_pages(pk, tab), paged.gather_pages(pv, tab)
    before = decode_flash.KERNEL_F32.launches
    run = lambda: attention.decode_attend(q, kc, vc, lengths)  # noqa
    assert "merge_kernel" not in _device_functions(run, "contig_split_kernel")
    assert decode_flash.KERNEL_F32.launches > before
    _close_f32(run(), attention.decode_attend_plain(q, kc, vc, lengths),
               attention.decode_attend_plain(q, kc, vc.abs(), lengths))


# ---------------------------------------------------------------------------
# the v1 family's shapes (detikzify-tl-1.1b: the timm SigLIP tower at 384 px,
# 729 patches; TinyLlama, head_dim 64, 32 query heads over 4 KV heads)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,s,t,nh,nkv,hd,mode", [
    (3, 729, 729, 16, 16, 72, "full"),      # the tower: a last partial tile
    (3, 1, 729, 16, 16, 72, "full"),        # its MAP head
    (3, 256, 384, 32, 4, 64, "window"),     # a 243-token prefill window
])
def test_flash_kernel_v1_shapes(cuda, b, s, t, nh, nkv, hd, mode):
    gen = torch.Generator(device=cuda).manual_seed(21)
    q, k, v = (_rnd(gen, cuda, b, s, nh, hd), _rnd(gen, cuda, b, t, nkv, hd),
               _rnd(gen, cuda, b, t, nkv, hd))
    kw = {}
    if mode == "window":
        kw["q_offsets"] = torch.tensor([0, 0, 128], dtype=torch.int32,
                                       device=cuda)
        kw["kv_limits"] = torch.tensor([243, 243, 128 + 243],
                                       dtype=torch.int32, device=cuda)
    before = flash.KERNEL.launches
    got = flash.flash_attention(q, k, v, **kw)
    assert flash.KERNEL.launches == before + 1
    _close(got, attention.attend_plain(q, k, v, **kw),
           attention.attend_plain(q, k, v.abs(), **kw))


def test_paged_kernel_v1_eight_rows_per_kv_head(cuda):
    """K2 at its limit of 8 query rows per KV head (32 over 4), head_dim
    64, page 128, lengths 243-2048 over 16-page tables."""
    gen = torch.Generator(device=cuda).manual_seed(22)
    b, nh, nkv, hd, page, m = 8, 32, 4, 64, 128, 16
    n_pages = b * m + 1
    pool_k = _rnd(gen, cuda, n_pages, page, nkv, hd)
    pool_v = _rnd(gen, cuda, n_pages, page, nkv, hd)
    tab = torch.randperm(n_pages, generator=gen, device=cuda)[:b * m]
    tab = tab.reshape(b, m).to(torch.int32).contiguous()
    lengths = torch.tensor([243, 517, 800, 1024, 1311, 1600, 1900, 2048],
                           dtype=torch.int32, device=cuda)
    q = _rnd(gen, cuda, b, nh, hd)
    before = paged.KERNEL.launches
    got = paged.decode_attend_paged(q, pool_k, pool_v, tab, lengths)
    assert paged.KERNEL.launches == before + 1
    _close(got, paged.decode_attend_paged_plain(q, pool_k, pool_v, tab,
                                                lengths),
           paged.decode_attend_paged_plain(q, pool_k, pool_v.abs(), tab,
                                           lengths))


# TinyLlama's fused products: qkv, o, gateup, down
K5_V1_SHAPES = [(2048, 2560), (2048, 2048), (2048, 11264), (5632, 2048)]


@pytest.mark.parametrize("rows", [1, 8])
@pytest.mark.parametrize("k,n", K5_V1_SHAPES)
def test_int8_gemv_v1_shapes(cuda, rows, k, n):
    gen = torch.Generator(device=cuda).manual_seed(rows + k + n)
    x, q, scale = _k5_inputs(gen, cuda, rows, k, n)
    before = quant_matmul.KERNEL.launches
    got = quant_matmul.int8_matmul(x, q, scale)
    assert quant_matmul.KERNEL.launches == before + 1
    _k5_close(got, x, q, scale, torch.bfloat16)


def test_v1_lm_head_takes_the_plain_product(cuda):
    """TinyLlama's lm_head (N = 32002, not a multiple of 128) is outside
    K5's eligibility rule: the plain dequant product, as the JAX package
    leaves it to XLA, launching no kernel."""
    gen = torch.Generator(device=cuda).manual_seed(23)
    x, q, scale = _k5_inputs(gen, cuda, 8, 2048, 32002)
    before = quant_matmul.KERNEL.launches
    got = quant_matmul.int8_matmul(x, q, scale, torch.float32)
    assert quant_matmul.KERNEL.launches == before
    assert torch.equal(got, quant_matmul.int8_matmul_plain(
        x, q, scale, torch.float32))


def test_quantize_kernel_card_matches_host(cuda):
    """Quantization on the card equals the host's bit for bit: q equal,
    scale bit-identical (both divide in IEEE fp32; a division by the
    Python number 127 on the card went through its reciprocal and moved
    scales by an ulp and q by one at rounding boundaries)."""
    gen = torch.Generator(device=cuda).manual_seed(24)
    w = (torch.randn((4096, 1152), generator=gen, device=cuda)
         * 1152 ** -0.5).to(torch.bfloat16)
    q, scale = quantize_kernel(w)
    hq, hscale = quantize_kernel(w.cpu())
    assert torch.equal(q.cpu(), hq)
    assert torch.equal(scale.cpu().view(torch.int32), hscale.view(torch.int32))


# ---------------------------------------------------------------------------
# the TikZero adapter's shapes: the gated cross-attention (900 patch queries
# over a short, right-padded caption, 16/16 heads at Hd 72) and the caption
# model's causal pass with a key mask (Llama-3.2-1B: 32/8 heads at Hd 64)
# ---------------------------------------------------------------------------

def _length_mask(dev, t, lengths):
    return (torch.arange(t, device=dev)[None, :]
            < torch.tensor(lengths, device=dev)[:, None]).contiguous()


@pytest.mark.parametrize("lengths", [(1, 17, 64), (17, 64)])
def test_flash_kernel_cross_attention_shape(cuda, lengths):
    """K1 at the cross-attention shape: keys far fewer than one tile of
    query rows, rows of different lengths in one batch (1, 17 and 64 keys
    of 64)."""
    gen = torch.Generator(device=cuda).manual_seed(25)
    b, t = len(lengths), 64
    q, k, v = (_rnd(gen, cuda, b, 900, 16, 72), _rnd(gen, cuda, b, t, 16, 72),
               _rnd(gen, cuda, b, t, 16, 72))
    mask = _length_mask(cuda, t, lengths)
    before = flash.KERNEL.launches
    got = flash.flash_attention(q, k, v, kv_mask=mask)
    assert flash.KERNEL.launches == before + 1
    _close(got, attention.attend_plain(q, k, v, kv_mask=mask),
           attention.attend_plain(q, k, v.abs(), kv_mask=mask))


@pytest.mark.parametrize("s", [1, 900])
def test_flash_kernel_fully_masked_cross_row(cuda, s):
    """A batch row whose caption keys are all masked averages V uniformly,
    as the plain version and the JAX kernel do (their finite sentinel)."""
    gen = torch.Generator(device=cuda).manual_seed(26)
    q, k, v = (_rnd(gen, cuda, 2, s, 16, 72), _rnd(gen, cuda, 2, 64, 16, 72),
               _rnd(gen, cuda, 2, 64, 16, 72))
    mask = _length_mask(cuda, 64, (0, 23))
    got = flash.flash_attention(q, k, v, kv_mask=mask)
    want = attention.attend_plain(q, k, v, kv_mask=mask)
    _close(got, want, attention.attend_plain(q, k, v.abs(), kv_mask=mask))
    mean = v[0].float().mean(dim=0)                      # [16, 72]
    assert torch.allclose(got[0].float(), mean.expand_as(got[0]).float(),
                          atol=2 * BF16_U * float(v.abs().max()))


@pytest.mark.parametrize("t,lengths", [(64, (23, 64)), (15, (15, 6)),
                                       (130, (130, 77))])
def test_flash_kernel_caption_model_shape(cuda, t, lengths):
    """K1 at the caption model's shape: causal with a key-padding mask
    (right padding), 32 query heads over 8 KV heads at Hd 64, on the
    tiled path (64, 130 tokens) and the split-key path (15)."""
    gen = torch.Generator(device=cuda).manual_seed(27)
    b = len(lengths)
    q, k, v = (_rnd(gen, cuda, b, t, 32, 64), _rnd(gen, cuda, b, t, 8, 64),
               _rnd(gen, cuda, b, t, 8, 64))
    mask = _length_mask(cuda, t, lengths)
    kw = dict(causal=True, kv_mask=mask)
    got = flash.flash_attention(q, k, v, **kw)
    _close(got, attention.attend_plain(q, k, v, **kw),
           attention.attend_plain(q, k, v.abs(), **kw))


def test_adapter_encoder_pass_matches_cpu(cuda):
    """A caption-conditioned encoder pass at SigLIP-so400m's widths (2
    layers, each with its cross-attention block) and a 2-layer caption
    model at Hd 64: bf16 on the card (K1 for the tower, the blocks and
    the caption model) against fp32 plain versions on the host CPU,
    cosine >= 0.999, with K1 launched."""
    import copy

    from detikzify_torch.config import AdapterConfig, TextConfig, get_config
    from detikzify_torch.models import convert, detikzify
    from detikzify_torch.models.embedding import AdapterBundle
    from detikzify_torch.processing import ByteTokenizer

    base = get_config("tikzero-adapter")
    cfg = base.replace(vision=base.vision.replace(num_hidden_layers=2),
                       text=base.text.replace(num_hidden_layers=1,
                                              vocab_size=512))
    ecfg = TextConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2)
    acfg = AdapterConfig(embedding_hidden_size=256)
    cpu = torch.device("cpu")
    g = torch.Generator().manual_seed(28)
    ref = dict(
        params=convert.init_random(cfg, device=cpu, dtype=torch.float32,
                                   generator=g),
        adapter=convert.init_random_adapter(cfg.vision, acfg, device=cpu,
                                            dtype=torch.float32,
                                            generator=g),
        embed=convert.init_random_llama(ecfg, device=cpu,
                                        dtype=torch.float32, generator=g))
    with torch.no_grad():
        for blk in ref["adapter"].layers:
            blk.attn_gate.fill_(0.5)
            blk.mlp_gate.fill_(-0.5)
    dut = {k: copy.deepcopy(v).to(cuda, torch.bfloat16)
           for k, v in ref.items()}
    pix = torch.randn((1, 420, 420, 3), generator=g)
    outs = []
    for side, dev in ((dut, cuda), (ref, cpu)):
        bundle = AdapterBundle(side["adapter"], acfg, side["embed"], ecfg,
                               ByteTokenizer(), max_length=64)
        with torch.inference_mode():
            ai = bundle.adapter_inputs(["a red square", "caption"])
            ai = ai._replace(cross_states=ai.cross_states[:1],
                             cross_mask=ai.cross_mask[:1])
            before = flash.KERNEL.launches
            outs.append(detikzify.encode_image(
                side["params"], cfg, pix.to(dev), adapter=ai).float().cpu())
            if dev == cuda:
                assert flash.KERNEL.launches - before == 2 * 2 + 1
    got, want = outs
    assert torch.isfinite(got).all()
    cos = torch.nn.functional.cosine_similarity(got.flatten(1),
                                                want.flatten(1))
    assert float(cos.min()) >= 0.999, float(cos.min())


def test_server_launches_kernels_from_its_scheduler_thread(cuda):
    """The port's HTTP server on the card (v2-8b widths, 2 + 2 layers): a
    greedy sampling request is decoded on the scheduler thread, which
    launches K1 and K2 (their counts rise), and returns the code of a
    direct sample() on the same pipeline, with no failed request."""
    import base64
    import io
    import json
    import threading
    import urllib.request

    from PIL import Image, ImageDraw

    from detikzify_torch.config import get_config
    from detikzify_torch.infer import (DetikzifyPipeline, FakeBackend,
                                       set_backend)
    from detikzify_torch.models import convert
    from detikzify_torch.ops.cuda import KERNELS
    from detikzify_torch.processing import ByteTokenizer, DetikzifyProcessor
    from detikzify_torch.serve import make_server

    base = get_config("detikzify-v2-8b")
    cfg = base.replace(vision=base.vision.replace(num_hidden_layers=2),
                       text=base.text.replace(num_hidden_layers=2))

    class LetterTokenizer(ByteTokenizer):
        # ids above the bytes decode to letters, so the code is not empty
        def decode(self, token_ids, skip_special_tokens=False):
            return super().decode([
                t if t < 256 or t in self.all_special_ids else 97 + t % 26
                for t in token_ids], skip_special_tokens)

    tok = LetterTokenizer(vocab_size=cfg.text.vocab_size,
                          image_token_id=cfg.image_token_id,
                          bos_token_id=cfg.bos_token_id,
                          eos_token_id=cfg.eos_token_id,
                          pad_token_id=cfg.pad_token_id,
                          model_max_length=1024)
    params = convert.init_random(
        cfg, device=cuda, dtype=torch.bfloat16,
        generator=torch.Generator(device=cuda).manual_seed(3))
    set_backend(FakeBackend())
    pipe = DetikzifyPipeline(params, cfg, DetikzifyProcessor(tok, cfg),
                             num_slots=4, max_len=1024, metric="fast",
                             device=cuda)
    httpd, inference = make_server(pipe, port=0, batch_window_s=0.05)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        img = Image.new("RGB", (200, 120), "white")
        ImageDraw.Draw(img).ellipse([20, 20, 180, 100], outline="blue",
                                    width=3)
        want = pipe.sample(image=img, temperature=0.0,
                           max_new_tokens=24).code
        buf = io.BytesIO()
        img.save(buf, format="PNG")
        before = {k: KERNELS[k].launches
                  for k in ("flash_attention", "paged_decode")}
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/v1/generate",
            data=json.dumps({"image": base64.b64encode(
                buf.getvalue()).decode(), "temperature": 0.0,
                "max_new_tokens": 24}).encode())
        with urllib.request.urlopen(req, timeout=300) as resp:
            assert resp.status == 200
            body = json.loads(resp.read())
        for k, n in before.items():
            assert KERNELS[k].launches > n, k
        assert body["code"] == want and want
        assert inference.requests["failed"] == 0
    finally:
        httpd.shutdown()
        inference.stop()
        httpd.server_close()
        pipe.close()
        set_backend(None)
    assert not inference._thread.is_alive()


# ---------------------------------------------------------------------------
# the evaluation suite on the card
# ---------------------------------------------------------------------------

def _siglip_cfg():
    from detikzify_torch.config import VisionConfig

    # so400m's widths (16 heads at Hd 72), 2 layers, a 224-px image
    return VisionConfig(hidden_size=1152, intermediate_size=4304,
                        num_hidden_layers=2, num_attention_heads=16,
                        image_size=224, patch_size=14)


def test_clip_text_tower_on_card_matches_plain(cuda):
    """ClipScore's text tower on the card (bf16, K1 in each layer) against
    the same weights on the CPU (fp32, plain versions)."""
    import copy

    from detikzify_torch.models import convert, siglip

    cfg = _siglip_cfg()
    ref = convert.init_random_siglip_text(cfg, device="cpu",
                                          dtype=torch.float32, seed=0)
    dut = copy.deepcopy(ref).to(cuda, torch.bfloat16)
    ids = torch.randint(0, 32000, (8, 64),
                        generator=torch.Generator().manual_seed(1))
    before = flash.KERNEL.launches
    with torch.inference_mode():
        got = siglip.apply_text(dut, cfg, ids.to(cuda))["pooler_output"]
        want = siglip.apply_text(ref, cfg, ids)["pooler_output"]
    assert flash.KERNEL.launches == before + cfg.num_hidden_layers
    cos = torch.nn.functional.cosine_similarity(got.float().cpu(), want,
                                                dim=-1)
    assert float(cos.min()) >= 0.999


def test_clipscore_refuses_fp32_towers_on_card(cuda):
    """ClipScore's fp32 towers (the JAX metric's type) no longer raise on
    the card: each layer runs K1's fp32 kernel and the pooled output
    agrees with the CPU's fp32 plain versions. A tower in a dtype no kernel
    takes (fp16) is still refused, not sent to the plain version."""
    import copy

    from detikzify_torch.models import convert, siglip

    cfg = _siglip_cfg()
    ref = convert.init_random_siglip_text(cfg, device="cpu",
                                          dtype=torch.float32, seed=0)
    text = copy.deepcopy(ref).to(cuda)
    ids = torch.randint(0, 32000, (4, 64),
                        generator=torch.Generator().manual_seed(2))
    before = flash.KERNEL_F32.launches
    with torch.inference_mode():
        got = siglip.apply_text(text, cfg, ids.to(cuda))["pooler_output"]
        want = siglip.apply_text(ref, cfg, ids)["pooler_output"]
    assert flash.KERNEL_F32.launches == before + cfg.num_hidden_layers
    assert got.dtype == torch.float32
    cos = torch.nn.functional.cosine_similarity(got.cpu(), want, dim=-1)
    assert float(cos.min()) >= 0.9999
    half = copy.deepcopy(ref).to(cuda, torch.float16)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        siglip.apply_text(half, cfg.replace(num_hidden_layers=1),
                          ids[:, :8].to(cuda))


def test_kid_features_on_card_match_cpu(cuda):
    import copy

    import numpy as np
    from PIL import Image, ImageDraw

    from detikzify_torch.evaluate.kid import KernelInceptionDistance
    from detikzify_torch.models import convert

    cfg = _siglip_cfg()
    ref = convert.init_random_siglip_vision(cfg, device="cpu",
                                            dtype=torch.float32, seed=2)
    dut = copy.deepcopy(ref).to(cuda, torch.bfloat16)
    images = []
    for i in range(4):
        img = Image.new("RGB", (200, 150), "white")
        ImageDraw.Draw(img).ellipse([10 + 9 * i, 20, 180, 130 - 7 * i],
                                    outline="black", width=3)
        images.append(img)
    before = flash.KERNEL.launches
    got = KernelInceptionDistance(dut, cfg)._features(images)
    assert flash.KERNEL.launches > before
    want = KernelInceptionDistance(ref, cfg)._features(images)
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1)
                                  * np.linalg.norm(want, axis=-1))
    assert got.dtype == np.float64 and float(cos.min()) >= 0.999


def test_native_library_builds_and_loads(cuda):
    from detikzify_torch import native
    from detikzify_torch.evaluate.eed import (_extended_edit_distance_py,
                                              extended_edit_distance)

    assert native.available(), native.lib_path()
    h, r = list("\\draw (0,0) -- (1,1);"), list("\\fill (0,0) circle;")
    assert extended_edit_distance(h, r) == _extended_edit_distance_py(h, r)


@pytest.mark.parametrize("b,s,t,nh,nkv,hd,causal,lengths", [
    (2, 640, 640, 16, 16, 128, True, (640, 523)),     # the decoder's step
    (2, 900, 900, 16, 16, 72, False, None),            # the tower's
    (2, 129, 200, 8, 2, 64, True, (200, 150)),         # GQA, S < T
    # adapter distillation's cross-attention: 900 patches over 8 captions
    # padded to 64 tokens
    (8, 900, 64, 16, 16, 72, False, (64, 58, 51, 47, 40, 33, 26, 17)),
])
def test_flash_attention_backward_on_card_matches_plain(cuda, b, s, t, nh,
                                                        nkv, hd, causal,
                                                        lengths):
    """K1's Function on the card: forward by K1, backward by the plain
    version recomputed, within 2^-8 of each gradient's largest value of
    autograd through ``attend_plain``; a backward without the causal mask
    (or, without causality, the key mask) falls outside."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    q, k, v = (_rnd(gen, cuda, b, s, nh, hd), _rnd(gen, cuda, b, t, nkv, hd),
               _rnd(gen, cuda, b, t, nkv, hd))
    dout = _rnd(gen, cuda, b, s, nh, hd)
    kw = {"causal": causal}
    if lengths:
        kw["kv_mask"] = (torch.arange(t, device=cuda)[None, :] < torch.tensor(
            lengths, device=cuda)[:, None]).contiguous()

    def grads(fn, **over):
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        out = fn(*leaves, **dict(kw, **over))
        return out, torch.autograd.grad(out, leaves, dout)

    before = flash.KERNEL.launches
    out, got = grads(flash.flash_attention)
    assert flash.KERNEL.launches == before + 1
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    _, want = grads(attention.attend_plain)

    def within(a, b):
        return all(float((x.float() - y.float()).abs().max())
                   <= 2.0 ** -8 * float(y.float().abs().max())
                   for x, y in zip(a, b))

    assert within(got, want)
    if causal:
        _, mutant = grads(attention.attend_plain, causal=False)
        assert not within(mutant, want)
    elif lengths:
        _, mutant = grads(attention.attend_plain, kv_mask=None)
        assert not within(mutant, want)


def test_unembed_backward_on_card(cuda):
    """The fp32-output product of the logits has a hand-written backward on
    the card (``torch.mm(..., out_dtype)`` has none): its gradients within
    bf16 rounding of an fp32 autograd reference."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = _rnd(gen, cuda, 64, 256)
    w = _rnd(gen, cuda, 1000, 256)
    g = torch.randn((64, 1000), generator=gen, device=cuda)
    xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = quant_matmul.matmul_f32(xl, wl)
    assert y.dtype == torch.float32
    dx, dw = torch.autograd.grad(y, (xl, wl), g)
    xf, wf = x.float().requires_grad_(), w.float().requires_grad_()
    rx, rw = torch.autograd.grad(xf @ wf.t(), (xf, wf), g)
    for got, want in ((dx, rx), (dw, rw)):
        assert got.dtype == torch.bfloat16
        err = float((got.float() - want).abs().max())
        assert err <= 2.0 ** -6 * float(want.abs().max()), err


def test_paged_kernel_ds13_sixteen_slots(cuda):
    """K2 at serve_bench's engine: DeepSeek-1.3B's 16/16 heads of 128 over
    16 slots of 6 pages of 128, lengths from the 301-token prompt to the
    640-row limit."""
    gen = torch.Generator(device=cuda).manual_seed(23)
    b, nh, nkv, hd, page, m = 16, 16, 16, 128, 128, 6
    n_pages = b * m + 1
    pool_k = _rnd(gen, cuda, n_pages, page, nkv, hd)
    pool_v = _rnd(gen, cuda, n_pages, page, nkv, hd)
    tab = torch.randperm(n_pages, generator=gen, device=cuda)[:b * m]
    tab = tab.reshape(b, m).to(torch.int32).contiguous()
    lengths = torch.tensor([301 + (640 - 301) * i // 15 for i in range(b)],
                           dtype=torch.int32, device=cuda)
    q = _rnd(gen, cuda, b, nh, hd)
    before = paged.KERNEL.launches
    got = paged.decode_attend_paged(q, pool_k, pool_v, tab, lengths)
    assert paged.KERNEL.launches == before + 1
    _close(got, paged.decode_attend_paged_plain(q, pool_k, pool_v, tab,
                                                lengths),
           paged.decode_attend_paged_plain(q, pool_k, pool_v.abs(), tab,
                                           lengths))


# DeepSeek-1.3B's fused products (qkv, o, gateup, down) at serve_bench's 16
# slots, and v2-8b's unfused k/v and gate/up, which examples/eval.py's
# predict runs (its quantized load does not fuse), at 8
@pytest.mark.parametrize("rows,k,n", [
    (16, 2048, 6144), (16, 2048, 2048), (16, 2048, 11008), (16, 5504, 2048),
    (8, 4096, 1024), (8, 4096, 14336)])
def test_int8_gemv_serve_bench_and_eval_shapes(cuda, rows, k, n):
    gen = torch.Generator(device=cuda).manual_seed(rows + k + n)
    x, q, scale = _k5_inputs(gen, cuda, rows, k, n)
    before = quant_matmul.KERNEL.launches
    got = quant_matmul.int8_matmul(x, q, scale)
    assert quant_matmul.KERNEL.launches == before + 1
    _k5_close(got, x, q, scale, torch.bfloat16)


def test_ds13_lm_head_takes_the_plain_product(cuda):
    """DeepSeek-1.3B's lm_head (N = 32258, not a multiple of 128) is
    outside K5's eligibility rule in both packages: no launch."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    x, q, scale = _k5_inputs(gen, cuda, 16, 2048, 32258)
    before = quant_matmul.KERNEL.launches
    got = quant_matmul.int8_matmul(x, q, scale, torch.float32)
    assert quant_matmul.KERNEL.launches == before
    want = quant_matmul.int8_matmul_plain(x, q, scale, torch.float32)
    assert torch.equal(got, want)


def test_two_replicas_share_one_card(cuda):
    """``ReplicaPool(devices=["cuda:0", "cuda:0"])`` at v2-8b widths, 2 + 2
    layers, int8 + fused: both replicas hold the same weight tensors and
    their own page pools on the card; the workers launch K1, K2 and K5;
    greedy samples equal a single pipeline's, whichever replica served
    them."""
    from PIL import Image, ImageDraw

    from detikzify_torch.config import get_config
    from detikzify_torch.infer import DetikzifyPipeline
    from detikzify_torch.models import convert
    from detikzify_torch.ops.cuda import launch_counts, reset_launch_counts
    from detikzify_torch.ops.quant import fuse_projections, quantize_params
    from detikzify_torch.parallel import ReplicaPool
    from detikzify_torch.processing import ByteTokenizer, DetikzifyProcessor

    base = get_config("detikzify-v2-8b")
    cfg = base.replace(vision=base.vision.replace(num_hidden_layers=2),
                       text=base.text.replace(num_hidden_layers=2))
    params = fuse_projections(quantize_params(convert.init_random(
        cfg, device=cuda, dtype=torch.bfloat16)))
    tok = ByteTokenizer(vocab_size=cfg.text.vocab_size,
                        image_token_id=cfg.image_token_id,
                        bos_token_id=cfg.bos_token_id,
                        eos_token_id=cfg.eos_token_id,
                        model_max_length=cfg.image_seq_len + 32)
    processor = DetikzifyProcessor(tok, cfg)
    figs = []
    for i in range(4):
        img = Image.new("RGB", (300, 200), "white")
        ImageDraw.Draw(img).rectangle([10 + 9 * i, 10, 250, 150 - 7 * i],
                                      outline="black", width=3)
        figs.append(img)
    single = DetikzifyPipeline(params, cfg, processor, metric="fast",
                               temperature=0.0, device=cuda)
    with torch.inference_mode():
        want = [single.sample(image=f).code for f in figs]
    single.close()
    pool = ReplicaPool(params, cfg, processor, devices=["cuda:0", "cuda:0"],
                       metric="fast", temperature=0.0)
    try:
        engines = [p.engine for p in pool.pipelines]
        assert all(e.params is params for e in engines)
        assert engines[0].cache.k.data_ptr() != engines[1].cache.k.data_ptr()
        assert all(e.cache.k.device == cuda for e in engines)
        reset_launch_counts()
        docs = pool.map_sample(figs)
        torch.cuda.synchronize()
        counts = launch_counts()
    finally:
        pool.close()
    assert [d.code for d in docs] == want
    steps = sum(e.counters["decode_steps"] for e in engines)
    assert counts["paged_decode"] == steps * cfg.text.num_hidden_layers > 0
    assert counts["flash_attention"] > 0 and counts["int8_gemv"] > 0


def test_pipelined_dispatch_never_waits_and_matches_eager(cuda):
    """``DecodeEngine(pipelined=True)`` at ``tiny-test``'s shape with the
    decoder at 2 heads of 64 in bf16: no pipelined ``_dispatch`` waits on
    the device (``set_sync_debug_mode("error")`` raises on any such wait),
    and its greedy streams equal the eager engine's (one page bound in
    both: the same K2 split)."""
    from detikzify_torch.config import tiny_test_config
    from detikzify_torch.engine import DecodeEngine
    from detikzify_torch.models import convert
    from detikzify_torch.ops.sampling import SamplingParams

    cfg = tiny_test_config(vocab_size=512)
    cfg = cfg.replace(text=cfg.text.replace(
        hidden_size=128, intermediate_size=256, num_attention_heads=2,
        num_key_value_heads=2))
    params = convert.init_random(cfg, device=cuda, dtype=torch.bfloat16)
    prompts = [[cfg.bos_token_id] + [5 + i] * (3 + i) for i in range(4)]
    outs = []
    for pipelined in (False, True):
        eng = DecodeEngine(params, cfg, num_slots=4, max_len=256,
                           decode_block=8, pipelined=pipelined,
                           sampling=SamplingParams(temperature=0.0),
                           device=cuda)
        if pipelined:
            dispatch = eng._dispatch

            def checked(k, dispatch=dispatch):
                torch.cuda.set_sync_debug_mode("error")
                try:
                    dispatch(k)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            eng._dispatch = checked
        ros = [eng.start(p, max_new_tokens=40, lazy=True) for p in prompts]
        eng.run()
        outs.append([list(r.token_ids) for r in ros])
        assert eng.counters["decode_dispatches"] > 2
    assert outs[0] == outs[1]


# --- the mesh's model axis on one card ----------------------------------------

_TP_WORKER = r'''
import json
import sys

import torch

sys.path.insert(0, sys.argv[1])
import chip_smoke
from detikzify_torch.config import DetikzifyConfig, TextConfig, VisionConfig
from detikzify_torch.engine import DecodeEngine
from detikzify_torch.models import convert
from detikzify_torch.ops import launch_counts, reset_launch_counts
from detikzify_torch.ops.quant import fuse_projections, quantize_params
from detikzify_torch.ops.sampling import SamplingParams
from detikzify_torch.parallel.mesh import join_group, make_mesh, place_params

root, init, rank, weights, out = sys.argv[1:6]
rank = int(rank)
dev = join_group("cuda", "gloo", init_method=init, rank=rank, world_size=2)
# every kernel's limits at m = 2: heads of 64, K and N multiples of 128
cfg = DetikzifyConfig(
    vision=VisionConfig(hidden_size=128, intermediate_size=256,
                        num_hidden_layers=2, num_attention_heads=2,
                        image_size=42, patch_size=14),
    text=TextConfig(vocab_size=1024, hidden_size=256, intermediate_size=512,
                    num_hidden_layers=2, num_attention_heads=4,
                    num_key_value_heads=2, max_position_embeddings=1024,
                    rope_theta=10000.0),
    image_token_id=1021, bos_token_id=1022, eos_token_id=1023,
    pad_token_id=0, concat_factor=3, model_max_length=256)


def model():
    p = convert.init_random(cfg, device=dev, dtype=torch.bfloat16, seed=11)
    return quantize_params(p) if weights == "int8" else p


def run(params, rec):
    prompt = [cfg.image_token_id] * cfg.image_seq_len + [cfg.bos_token_id]
    emb = torch.randn((2, cfg.image_seq_len, cfg.text.hidden_size),
                      generator=torch.Generator(device=dev).manual_seed(3),
                      device=dev).to(torch.bfloat16)
    out = {"streams": {}}
    reset_launch_counts()
    with rec.installed():
        for part, spec in (("plain", 0), ("spec", 4)):
            rec.part = part
            eng = DecodeEngine(params, cfg, num_slots=2, max_len=256,
                               speculate=spec, spec_min_rate=0.0,
                               sampling=SamplingParams(temperature=0.0),
                               device=dev)
            ros = eng.start_many([prompt + [5, 6, 7], prompt + [9]],
                                 image_embeds=emb, max_new_tokens=24)
            eng.run()
            out["streams"][part] = [(r.slot, r.prompt_len, list(r.token_ids))
                                    for r in ros]
    torch.cuda.synchronize(dev)
    out["launches"] = launch_counts()
    out["top"], out["rows"] = rec.collect()
    return out


def recorder():
    return chip_smoke.LogitRecorder(torch, cfg.image_token_id, 8)


base = model()
if weights == "int8":
    fuse_projections(base)
want = run(base, recorder())
del base
tp = place_params(model(), make_mesh(data=1, model=2, device=dev),
                  identical=True)
if weights == "int8":
    fuse_projections(tp)
got = run(tp, recorder())
first = sorted({(part, s, n - 1) for part, st in want["streams"].items()
                for s, n, _ in st})
a = torch.stack([want["rows"][k] for k in first])
b = torch.stack([got["rows"][k] for k in first])
cmp = chip_smoke._tp_compare(torch, want, got)
json.dump({"cosine": float(torch.nn.functional.cosine_similarity(
               a, b, dim=-1).min()),
           "parity_ok": cmp["ok"], "tau": cmp["tau"],
           "divergences": cmp["divergences"],
           "streams": got["streams"], "launches": got["launches"],
           "heads": list(tp.text.layers[0].attn.heads)},
          open(out, "w"))
torch.distributed.destroy_process_group()
'''


@pytest.mark.parametrize("weights", ["bf16", "int8"])
def test_tensor_parallel_ranks_on_one_card(cuda, tmp_path, weights):
    """Two gloo ranks on ``cuda:0`` over a (data=1, model=2) mesh at a
    small shape every kernel takes: the first-step logits within cosine
    0.999 of the unsharded model, its greedy plain and speculative streams
    equal up to a near-tie (``chip_smoke.py``'s tau rule), the ranks'
    streams identical, and K1, K2, K4 and K5 (int8) launched on each."""
    import json
    import os
    import socket
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=root)
    env.pop("LOCAL_RANK", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _TP_WORKER, root, f"tcp://127.0.0.1:{port}",
         str(r), weights, str(tmp_path / f"rank{r}.json")], env=env,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        for p in procs:
            p.wait(timeout=300)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p in procs:
        assert p.returncode == 0, p.stderr.read()[-3000:]
    got = [json.load(open(tmp_path / f"rank{r}.json")) for r in range(2)]
    assert got[0]["streams"] == got[1]["streams"]
    for g in got:
        assert g["heads"] == [2, 1]
        assert g["cosine"] >= 0.999
        assert g["parity_ok"], (g["tau"], g["divergences"])
        names = ["flash_attention", "paged_decode", "paged_verify"]
        if weights == "int8":
            names.append("int8_gemv")
        assert all(g["launches"][n] > 0 for n in names), g["launches"]


# --- decode blocks as CUDA graphs ---------------------------------------------

def _graph_model(cuda):
    """``tiny-test``'s shape with the decoder at 2 heads of 64, int8 +
    fused (K2, K4 and K5 inside every block; the lm_head's N 512 takes
    K5), and four prompts."""
    from detikzify_torch.config import tiny_test_config
    from detikzify_torch.models import convert
    from detikzify_torch.ops.quant import fuse_projections, quantize_params

    cfg = tiny_test_config(vocab_size=512)
    cfg = cfg.replace(text=cfg.text.replace(
        hidden_size=128, intermediate_size=256, num_attention_heads=2,
        num_key_value_heads=2))
    params = fuse_projections(quantize_params(convert.init_random(
        cfg, device=cuda, dtype=torch.bfloat16)))
    prompts = [[cfg.bos_token_id] + [5 + i] * (3 + i) for i in range(4)]
    return cfg, params, prompts


def _graph_engine(cfg, params, cuda, graphs, temperature=0.0, **kw):
    from detikzify_torch.engine import DecodeEngine
    from detikzify_torch.ops.sampling import SamplingParams

    return DecodeEngine(params, cfg, num_slots=4, max_len=256,
                        decode_block=8, graphs=graphs, device=cuda, seed=3,
                        sampling=SamplingParams(temperature=temperature),
                        **kw)


def _graph_run(eng, prompts, new=40):
    from detikzify_torch.ops.cuda import launch_counts, reset_launch_counts

    reset_launch_counts()
    ros = [eng.start(p, max_new_tokens=new, lazy=True) for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    return [list(r.token_ids) for r in ros], launch_counts()


@pytest.mark.parametrize("spec", [0, 4])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_graph_engine_matches_eager(cuda, spec, temperature):
    """A graph engine and an eager one (``graphs=False``) with the same
    seed: equal streams token for token, greedy and sampled (the sampling
    generator is registered with every graph, so a replay draws from the
    same Philox offsets as the eager block), equal launches of every
    kernel (each replay adds the capture's tally), equal counters; every
    block after its key's first call is one replay."""
    cfg, params, prompts = _graph_model(cuda)
    kw = dict(speculate=spec, spec_min_rate=0.0) if spec else {}
    out = {}
    for graphs in (False, True):
        eng = _graph_engine(cfg, params, cuda, graphs, temperature, **kw)
        assert eng.graphs is graphs
        out[graphs] = _graph_run(eng, prompts) + (dict(eng.counters),
                                                  dict(eng.graph_stats))
    (s0, c0, n0, _), (s1, c1, n1, g1) = out[False], out[True]
    assert s1 == s0
    assert c1 == c0
    assert c1["paged_verify" if spec else "paged_decode"] > 0
    assert c1["int8_gemv"] > 0
    assert n1 == n0
    assert g1["captures"] >= 1 and g1["replays"] >= 1
    assert n1["decode_dispatches"] == g1["captures"] + g1["replays"]


def test_capture_leaves_engine_state_unchanged(cuda):
    """A capture runs nothing: the pool (its trash page aside, which any
    frozen slot may write), tokens, positions, histories and the sampling
    generator's state are what they were before it; a replay then
    advances them."""
    import functools

    cfg, params, prompts = _graph_model(cuda)
    eng = _graph_engine(cfg, params, cuda, True, 0.8, speculate=4,
                        spec_min_rate=0.0)
    for p in prompts:
        eng.start(p, max_new_tokens=40, lazy=True)
    eng.step()
    eng._upload(eng._active_dev, eng._active)
    eng._upload(eng._samp_dev, eng._samp_host)
    torch.cuda.synchronize()
    trash = eng._trash_page

    def snapshot():
        keep = [i for i in range(eng.cache.k.shape[1]) if i != trash]
        return {"k": eng.cache.k[:, keep].clone(),
                "v": eng.cache.v[:, keep].clone(),
                "tok": eng._tok_dev.clone(), "pos": eng._pos_dev.clone(),
                "buf": eng._buf_dev.clone(), "hint": eng._hint_dev.clone(),
                "gen": eng.generator.get_state().clone()}

    before = snapshot()
    prog = eng._capture(functools.partial(eng._decode_many_spec, 2, 2))
    torch.cuda.synchronize()
    after = snapshot()
    for name in before:
        assert torch.equal(before[name], after[name]), name
    prog()
    torch.cuda.synchronize()
    moved = snapshot()
    assert not torch.equal(moved["pos"], before["pos"])
    assert not torch.equal(moved["gen"], before["gen"])


def test_capture_pauses_garbage_collection(cuda):
    """A dead graph engine lives on in its reference cycles until the
    cyclic collector runs, and a collection inside another engine's
    capture would destroy its graphs there and invalidate that capture.
    Every capture runs with the collector paused and restores it after;
    the engine still gives the stream it gives alone."""
    import gc

    cfg, params, prompts = _graph_model(cuda)
    alone = _graph_run(_graph_engine(cfg, params, cuda, True), prompts)[0]
    dead = _graph_engine(cfg, params, cuda, True)
    _graph_run(dead, prompts)
    assert dead.graph_stats["captures"] >= 1
    del dead                 # garbage in its cycles until a collection
    eng = _graph_engine(cfg, params, cuda, True)
    block, seen = eng._decode_many, []

    def probed(*args):
        if torch.cuda.is_current_stream_capturing():
            seen.append(gc.isenabled())
        return block(*args)

    eng._decode_many = probed
    enabled = gc.isenabled()
    gc.enable()
    try:
        got = _graph_run(eng, prompts)[0]
        assert gc.isenabled()
    finally:
        if not enabled:
            gc.disable()
    assert seen and not any(seen)
    assert len(seen) == eng.graph_stats["captures"]
    assert got == alone


def test_capture_beside_another_threads_launches(cuda):
    """One thread's engine captures its graphs while another thread's
    eager engine launches the same kernels: both finish with the streams
    they give alone."""
    import threading

    cfg, params, prompts = _graph_model(cuda)
    alone = {g: _graph_run(_graph_engine(cfg, params, cuda, g), prompts)[0]
             for g in (False, True)}
    got, errors = {}, []
    start = threading.Barrier(2)

    def drive(graphs):
        try:
            eng = _graph_engine(cfg, params, cuda, graphs)
            ros = [eng.start(p, max_new_tokens=40, lazy=True)
                   for p in prompts]
            start.wait(timeout=60)
            eng.run()
            torch.cuda.synchronize()
            got[graphs] = [list(r.token_ids) for r in ros]
        except BaseException as err:      # to the test's thread
            errors.append(err)

    threads = [threading.Thread(target=drive, args=(g,))
               for g in (False, True)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors, errors
    assert got == alone


def test_model_axis_engine_refuses_graphs(cuda):
    """An engine whose weights are placed over a model axis decodes
    eagerly by default and raises when asked for graphs (its gloo
    collectives cannot be captured)."""
    import types

    cfg, params, _ = _graph_model(cuda)
    params.placement = types.SimpleNamespace(
        mesh=types.SimpleNamespace(shape={"data": 1, "model": 2}))
    try:
        with pytest.raises(ValueError, match="model axis"):
            _graph_engine(cfg, params, cuda, True)
        assert _graph_engine(cfg, params, cuda, None).graphs is False
    finally:
        del params.placement
