"""The port's SelfSim (``evaluate/imagesim.py``) against the JAX package, on
the CPU in fp32 at ``tiny-test``.

Sinkhorn EMD within 1e-5 of JAX on a random cost; ``ImageSim`` scores in
every mode within 1e-4 of JAX on the same tower weights and the same
``FakeBackend`` renders; batched wave scoring equal to per-image scoring;
the reference-feature LRU is hit on the second call.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from detikzify_tpu.config import tiny_test_config
from detikzify_tpu.evaluate.imagesim import ImageSim as JImageSim
from detikzify_tpu.evaluate.imagesim import sinkhorn_emd2 as j_sinkhorn
from detikzify_tpu.infer.tikz import FakeBackend
from detikzify_tpu.models import detikzify as jdet
from detikzify_torch.config import tiny_test_config as t_tiny_test_config
from detikzify_torch.evaluate import ImageSim as TImageSim
from detikzify_torch.evaluate import sinkhorn_emd2 as t_sinkhorn
from detikzify_torch.models import convert
from detikzify_torch.ops.quant import fuse_projections, quantize_params

torch.set_num_threads(1)

MODES = ("cos", "cos_avg", "emd")


@pytest.fixture(scope="module")
def towers():
    cfg = tiny_test_config()
    jp = jdet.init(jax.random.PRNGKey(11), cfg)
    tcfg = t_tiny_test_config()
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp._asdict()),
                                   tcfg, device="cpu")
    return cfg, jp, tcfg, tp


def _bundle(tcfg):
    """A random TikZero adapter (gates at sigmoid 0.5) and a 2-layer
    caption model at ``tcfg``'s widths."""
    from detikzify_torch.config import AdapterConfig, TextConfig
    from detikzify_torch.models import convert as tconvert
    from detikzify_torch.models.embedding import AdapterBundle
    from detikzify_torch.processing import ByteTokenizer

    acfg = AdapterConfig(embedding_hidden_size=32, num_attention_heads=4)
    ecfg = TextConfig(vocab_size=512, hidden_size=32, intermediate_size=64,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, rope_theta=10000.0)
    return AdapterBundle(
        adapter_params=tconvert.init_random_adapter(
            tcfg.vision, acfg, device="cpu", dtype=torch.float32, seed=1),
        adapter_cfg=acfg,
        embed_params=tconvert.init_random_llama(ecfg, device="cpu",
                                                dtype=torch.float32, seed=2),
        embed_cfg=ecfg,
        tokenizer=ByteTokenizer(), max_length=32)


@pytest.fixture(scope="module")
def renders():
    """FakeBackend renders of a few programs, plus a reference figure."""
    backend = FakeBackend(size=96)
    codes = [f"\\draw ({i},0) -- ({i + 1},{i % 3});" for i in range(5)]
    return [backend._render(c) for c in codes]


def test_sinkhorn_emd2_matches_jax():
    cost = np.random.default_rng(0).uniform(0, 2, (2, 30, 40)).astype(
        np.float32)
    want = np.asarray(j_sinkhorn(jnp.asarray(cost)))
    got = t_sinkhorn(torch.from_numpy(cost)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", MODES)
def test_imagesim_scores_match_jax(towers, renders, mode):
    cfg, jp, tcfg, tp = towers
    jsim = JImageSim.from_detikzify(jp, cfg, mode=mode)
    tsim = TImageSim.from_detikzify(tp, tcfg, mode=mode)
    ref = renders[0]
    for img in renders[1:3]:
        assert tsim.score(img, ref) == pytest.approx(jsim.score(img, ref),
                                                     abs=1e-4)
    want = jsim.score_against(renders[1:], ref)
    got = tsim.score_against(renders[1:], ref)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    pairs = tsim.score_batch(renders[1:3], renders[3:5])
    np.testing.assert_allclose(
        pairs, jsim.score_batch(renders[1:3], renders[3:5]), rtol=0,
        atol=1e-4)


def test_imagesim_int8_tower_matches_jax(towers, renders):
    """An int8 tower (the simulate path's weights) scores like the JAX
    package's int8 tower."""
    from detikzify_tpu.ops.quant import quantize_params as jquantize

    cfg, jp, tcfg, _ = towers
    jq = jquantize(jp)
    tq = fuse_projections(quantize_params(convert.params_from_numpy(
        jax.tree.map(np.asarray, jp._asdict()), tcfg, device="cpu")))
    jsim = JImageSim.from_detikzify(jq, cfg, mode="emd")
    tsim = TImageSim.from_detikzify(tq, tcfg, mode="emd")
    np.testing.assert_allclose(
        tsim.score_against(renders[1:4], renders[0]),
        jsim.score_against(renders[1:4], renders[0]), rtol=0, atol=1e-4)


def test_wave_scores_equal_per_image_scores(towers, renders):
    _, _, tcfg, tp = towers
    sim = TImageSim.from_detikzify(tp, tcfg, mode="emd")
    ref = renders[0]
    dev, k = sim.score_against_async(renders[1:], ref)
    assert k == 4 and dev.shape[0] == 4          # bucket of 4: no padding
    dev3, k3 = sim.score_against_async(renders[1:4], ref)
    assert k3 == 3 and dev3.shape[0] == 4        # padded to the bucket
    singles = [sim.score(img, ref) for img in renders[1:]]
    np.testing.assert_allclose(dev[:k].numpy(), singles, rtol=0, atol=1e-5)
    np.testing.assert_allclose(dev3[:k3].numpy(), singles[:3], rtol=0,
                               atol=1e-5)


def test_feature_lru_hit_on_second_call(towers, renders):
    _, _, tcfg, tp = towers
    sim = TImageSim.from_detikzify(tp, tcfg, mode="cos")
    calls = []
    embed = sim.embed
    sim.embed = lambda pixels: calls.append(pixels.shape[0]) or embed(pixels)
    a = sim.features(renders[0])
    assert calls == [1]
    b = sim.features(renders[0])
    assert calls == [1] and b is a               # served from the LRU
    sim.score_against(renders[1:3], renders[0])
    assert calls == [1, 2]                        # only the renders encode
    for img in renders[1:] + renders[:1]:
        sim.features(img)
    assert len(sim._feature_cache) == 5


def test_imagesim_state_and_mode_resolution(towers, renders):
    _, _, tcfg, tp = towers
    sim = TImageSim.from_detikzify(tp, tcfg)
    assert sim.mode == "cos"                  # tiny-test declares "cos"
    v2 = tcfg.replace(pooling_mode=None)
    assert TImageSim.from_detikzify(tp, v2).mode == "emd"   # the v2 default
    with pytest.raises(RuntimeError):
        sim.compute()
    sim.update(renders[0], renders[0])
    sim.update(renders[1], renders[0])
    assert sim.compute() == pytest.approx(
        (sim.score(renders[0], renders[0]) + sim.score(renders[1],
                                                       renders[0])) / 2)
    assert sim.score(renders[0], renders[0]) == pytest.approx(1.0, abs=1e-5)
    sim.reset()
    with pytest.raises(RuntimeError):
        sim.compute()
    # a caption needs an adapter; with one, features(img, text) differ
    # from features(img) and are memoised per (image, text)
    with pytest.raises(ValueError, match="adapter"):
        sim.features(renders[0], text="a caption")
    csim = TImageSim.from_detikzify(tp, tcfg, adapter=_bundle(tcfg))
    plain = csim.features(renders[0])
    cond = csim.features(renders[0], text="a caption")
    assert cond.shape == plain.shape
    assert float((cond - plain).abs().max()) > 1e-4
    assert csim.features(renders[0], text="a caption") is cond
    other = csim.features(renders[0], text="another caption")
    assert other is not cond and not torch.equal(other, cond)
    assert csim.features(renders[0]) is plain
    assert len(csim._feature_cache) == 3
