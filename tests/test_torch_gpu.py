"""Kernels K1 and K2 against their plain versions on a CUDA card.

Marked ``gpu``: they need a card, nvcc and sm_90a, and skip elsewhere (the
CPU suite holds the plain versions against the JAX package instead). Run
them on the card with ``python -m pytest tests/test_torch_gpu.py -m gpu
--noconftest``. ``chip_smoke.py`` runs the same holds at the main path's
full shapes.
"""
import pytest
import torch

from detikzify_torch.ops import attention, flash, paged

pytestmark = pytest.mark.gpu

BF16_U = 2.0 ** -8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _close(got, want, pv_abs):
    """Both sides round the output to bf16 once and round probabilities to
    bf16 at different points, each at most u times the mass that reaches
    the element: |diff| <= 2u (pv_abs + |want|), pv_abs the plain version
    run on |v|."""
    err = (got.float() - want.float()).abs()
    bound = 2 * BF16_U * (pv_abs.float() + want.float().abs())
    assert bool(torch.isfinite(got.float()).all())
    assert bool((err <= bound).all()), float(err.max())


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


def test_wrappers_raise_instead_of_falling_back(cuda):
    q = torch.zeros((1, 4, 2, 24), device=cuda)          # fp32: refused
    with pytest.raises(ValueError, match="bfloat16"):
        flash.flash_attention(q, q, q)
    qh = torch.zeros((1, 4, 2, 96), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="Hd must be one of"):
        flash.flash_attention(qh, qh, qh)                # no tile for 96
    qb = torch.zeros((1, 2, 96), dtype=torch.bfloat16, device=cuda)
    pool = torch.zeros((2, 128, 2, 96), dtype=torch.bfloat16, device=cuda)
    tab = torch.zeros((1, 1), dtype=torch.int32, device=cuda)
    lengths = torch.ones((1,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        paged.decode_attend_paged(qb, pool, pool, tab, lengths)
