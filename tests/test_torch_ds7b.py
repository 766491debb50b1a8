"""Tracked configuration #3 (DS-7b int8 streaming decode, ``bench.py``'s
``seven_bench``) at tiny size on the CPU: a model wired as DS-7b (MHA with
as many KV heads as heads, the v1 tower and projector, int8 + fused
projections, an lm_head whose N is not a multiple of 128, so that
``int8_matmul`` takes its dequantized branch), decoded by the port's
engine and the JAX package's from the same weights (carried across by
``models/convert.py``) under greedy sampling, with more rollouts than
slots, each started lazily with an ``on_token`` consumer.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from detikzify_tpu.config import tiny_test_config
from detikzify_tpu.engine import DecodeEngine as JEngine
from detikzify_tpu.models import detikzify as jdet
from detikzify_tpu.ops import quant as jquant
from detikzify_tpu.ops.sampling import SamplingParams as JSampling
from detikzify_torch.config import tiny_test_config as t_tiny_test_config
from detikzify_torch.engine import DecodeEngine as TEngine
from detikzify_torch.models import convert
from detikzify_torch.ops.quant import QuantLinear
from detikzify_torch.ops.sampling import SamplingParams as TSampling

torch.set_num_threads(1)

VOCAB = 500          # lm_head N = 500: not a multiple of 128
SLOTS, MAX_LEN, PAGE, BLOCK = 4, 128, 16, 8
ROLLOUTS, NEW_TOKENS = 6, 20


def _ds7b_wiring(cfg):
    """tiny-test as DS-7b is wired: MHA, v1 (a biased projector, SelfSim
    pinned to cos)."""
    return cfg.replace(
        text=cfg.text.replace(
            num_key_value_heads=cfg.text.num_attention_heads),
        is_v1=True, projector_bias=True, pooling_mode="cos")


@pytest.fixture(scope="module")
def models():
    """(JAX cfg, port cfg, JAX int8 + fused params, port int8 + fused params
    from the same arrays)."""
    jcfg = _ds7b_wiring(tiny_test_config(vocab_size=VOCAB))
    tcfg = _ds7b_wiring(t_tiny_test_config(vocab_size=VOCAB))
    jq = jquant.fuse_projections(jquant.quantize_params(
        jdet.init(jax.random.PRNGKey(7), jcfg)))
    tq = convert.params_from_numpy(jax.tree.map(np.asarray, jq._asdict()),
                                   tcfg, device="cpu")
    return jcfg, tcfg, jq, tq


def test_ds7b_wiring(models):
    """MHA, v1, every decoder product int8 and fused, and an lm_head
    outside K5's eligibility rule (N not a multiple of 128)."""
    jcfg, tcfg, _, tq = models
    assert tcfg.is_v1 and tcfg.text.num_key_value_heads \
        == tcfg.text.num_attention_heads == jcfg.text.num_key_value_heads
    layer = tq.text.layers[0]
    for mod in (layer.attn.qkv, layer.attn.o, layer.mlp.gateup,
                layer.mlp.down, tq.text.lm_head):
        assert isinstance(mod, QuantLinear)
    assert tq.text.lm_head.q.shape[0] % 128 != 0
    assert tq.connector is not None


def _stream(eng, prompt, emb):
    """ROLLOUTS rollouts over SLOTS slots, each started lazily with a
    consumer as slots free up, as seven_bench drives them. Returns (what
    each consumer saw, each rollout's new tokens)."""
    streams = [[] for _ in range(ROLLOUTS)]
    results, started, active = {}, 0, []
    while started < ROLLOUTS or active:
        while started < ROLLOUTS and eng.num_free_slots > 0:
            active.append((started, eng.start(
                list(prompt), image_embeds=emb, max_new_tokens=NEW_TOKENS,
                lazy=True, on_token=streams[started].append)))
            started += 1
        eng.step()
        for i, ro in list(active):
            if ro.finished:
                results[i] = list(ro.token_ids[ro.prompt_len:])
                eng.release(ro)
                active.remove((i, ro))
    return streams, [results[i] for i in range(ROLLOUTS)]


def test_ds7b_streams_match_rollouts_and_jax(models):
    """Under greedy decoding every consumer sees exactly its rollout's
    tokens, on both engines, and the port's streams equal the JAX
    engine's."""
    jcfg, tcfg, jq, tq = models
    kw = dict(num_slots=SLOTS, max_len=MAX_LEN, page_size=PAGE,
              decode_block=BLOCK)
    jeng = JEngine(jq, jcfg, cache_dtype=jnp.float32,
                   sampling=JSampling(temperature=0.0), **kw)
    teng = TEngine(tq, tcfg, cache_dtype=torch.float32,
                   sampling=TSampling(temperature=0.0), device="cpu", **kw)
    size = jcfg.vision.image_size
    pix = np.random.default_rng(8).standard_normal(
        (1, size, size, 3)).astype(np.float32)
    prompt = [jcfg.image_token_id] * jcfg.image_seq_len + [jcfg.bos_token_id]

    want_streams, want = _stream(jeng, prompt,
                                 jeng.encode_image(jnp.asarray(pix)))
    got_streams, got = _stream(teng, prompt, teng.encode_image(pix))
    assert got_streams == got and want_streams == want
    assert got == want
    assert all(len(t) > 3 for t in got)
    assert teng.num_active == 0 and teng.num_free_slots == SLOTS
