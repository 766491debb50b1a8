"""The mesh's model axis (tensor parallelism) against the JAX package, on
the CPU: port ranks are gloo processes, JAX runs in this process on its 8
virtual CPU devices (``tests/conftest.py``), both at ``tiny-test`` in fp32.

  * placement: for m = 2 and 4, each rank's shard of every leaf equals the
    addressable shard of JAX's ``shard_params`` on a ``(data=1, model=m)``
    mesh (``NamedSharding.devices_indices_map``), except where the port
    departs on purpose, which is checked as such: the biases of column-
    parallel layers (JAX stores them whole, ``P()``; a rank computes with
    its slice) and, at m = 4, the text tower's k and v (NKV 2 < m: JAX cuts
    inside a head, a rank holds the whole KV head its query head reads,
    shared with the other rank that reads it);
  * forward: the logits of ``detikzify.forward`` over m = 2 within 3e-4
    (the fp32 logit bound) of JAX's on its ``(data=1, model=2)`` mesh and
    of JAX's unsharded run;
  * the three engine legs of ``__graft_entry__.py``'s dry run (decode with
    a prefix stored and restored, a ``start_many`` burst with mixed
    prefixes, the speculative engine with a hinted row) at their sizes:
    every rank's greedy streams equal JAX's engine over its TP mesh; at
    m = 4 (shared KV heads) equal the port's unsharded engine;
  * sampling (temperature 0.8): the ranks draw the same tokens (the
    gathered logits are the same bits on every rank and each rank's
    generator has the same seed);
  * int8 + fused: each rank's int8 ``qkv`` and ``gateup`` equal the fusion
    of its slices of the whole quantized model bit for bit, its logits
    within 3e-4 of the unsharded int8 port;
  * ``DetikzifyPipeline.sample()`` with ``FakeBackend`` over the shards
    gives the unsharded pipeline's greedy program on every rank;
  * the collectives: ``enter``, ``reduce`` and ``gather`` forward and
    backward, built on ``all_reduce`` alone; the guards (heads that do not
    split, fused weights placed, an engine over a data axis);
  * ``dryrun_multi_device(4)`` prints the train line and the three TP
    lines.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from detikzify_tpu.config import tiny_test_config
from detikzify_tpu.engine import DecodeEngine as JEngine
from detikzify_tpu.models import detikzify as jdet
from detikzify_tpu.ops.sampling import SamplingParams as JSampling
from detikzify_tpu.parallel import mesh as jmesh
from detikzify_torch.parallel import tp as ttp

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 3e-4

_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from detikzify_torch.config import tiny_test_config
    from detikzify_torch.models import convert, detikzify
    from detikzify_torch.parallel import dryrun
    from detikzify_torch.parallel import mesh as tmesh

    torch.set_num_threads(1)
    rank, world, init, data, out, case = sys.argv[1:7]
    rank, world = int(rank), int(world)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    cfg = tiny_test_config(vocab_size=512)
    src = np.load(data)
    tree = {}
    for key in src.files:
        if key.startswith("p/"):
            node = tree
            *ks, last = key[2:].split("/")
            for k in ks:
                node = node.setdefault(k, {})
            node[last] = src[key]
    inputs = {k[2:]: src[k] for k in src.files if k.startswith("i/")}
    res = {}

    def placed(quant=False):
        params = convert.params_from_numpy(tree, cfg, device="cpu")
        if quant:
            from detikzify_torch.ops.quant import quantize_params
            quantize_params(params)
        return tmesh.place_params(
            params, tmesh.make_mesh(data=1, model=world, device="cpu"),
            identical=True)

    if case == "place":
        params = placed()
        # this rank's shard of each leaf, laid out as JAX lays the leaf
        for leaf in convert.leaves(params):
            arrs = [(t.t() if leaf.transposed else t).detach().numpy()
                    for t in leaf.tensors]
            res["p/" + leaf.path] = (np.stack(arrs) if leaf.stacked
                                     else arrs[0])
        res["heads"] = np.asarray(params.text.layers[0].attn.heads
                                  + (params.vision.layers[0].attn.heads,))
        # and the whole leaves rebuilt from every rank's shard
        def flat(node, prefix=""):
            for k, v in node.items():
                if isinstance(v, dict):
                    yield from flat(v, f"{prefix}{k}/")
                else:
                    yield prefix + k, v
        for k, v in flat(convert.params_to_numpy(params)):
            res["w/" + k] = v
    elif case == "forward":
        params = placed()
        ids = torch.from_numpy(inputs["ids"])
        px = torch.from_numpy(inputs["pixels"])
        res["logits"] = detikzify.forward(params, cfg, ids, px)[0].numpy()
    elif case == "legs":
        params = placed()
        base = convert.params_from_numpy(tree, cfg, device="cpu")
        for name, leg in dryrun.TP_LEGS:
            res[name] = np.asarray([t for stream in leg(params, cfg)
                                    for t in stream + [-1]])
            want = leg(base, cfg)
            res[name + "_base"] = np.asarray(
                [t for stream in want for t in stream + [-1]])
    elif case == "sampling":
        from detikzify_torch.engine import DecodeEngine
        from detikzify_torch.ops.sampling import SamplingParams
        params = placed()
        eng = DecodeEngine(params, cfg, num_slots=2, max_len=64,
                           cache_dtype=torch.float32, device="cpu", seed=3,
                           sampling=SamplingParams(temperature=0.8))
        ros = eng.start_many([[cfg.bos_token_id, 5, 6, 7],
                              [cfg.bos_token_id, 9]], max_new_tokens=12)
        eng.run()
        res["streams"] = np.asarray([t for ro in ros
                                     for t in list(ro.token_ids) + [-1]])
    elif case == "int8":
        from detikzify_torch.ops.quant import (fuse_projections,
                                               quantize_params)
        params = fuse_projections(placed(quant=True))
        for i, lp in enumerate(params.text.layers):
            res[f"qkv/{i}"] = lp.attn.qkv.q.numpy()
            res[f"qkv_scale/{i}"] = lp.attn.qkv.scale.numpy()
            res[f"gateup/{i}"] = lp.mlp.gateup.q.numpy()
        ids = torch.from_numpy(inputs["ids"])
        px = torch.from_numpy(inputs["pixels"])
        res["logits"] = detikzify.forward(params, cfg, ids, px)[0].numpy()
        base = fuse_projections(quantize_params(
            convert.params_from_numpy(tree, cfg, device="cpu")))
        res["base_logits"] = detikzify.forward(base, cfg, ids, px)[0].numpy()
        try:    # the whole of a rank's fusion is not a leaf of the model
            convert.params_to_numpy(params)
            res["fused_whole_raises"] = np.asarray(False)
        except ValueError:
            res["fused_whole_raises"] = np.asarray(True)
    elif case == "sample":
        from PIL import Image, ImageDraw
        from detikzify_torch.infer import (DetikzifyPipeline, FakeBackend,
                                           set_backend)
        from detikzify_torch.processing import (ByteTokenizer,
                                                DetikzifyProcessor)
        set_backend(FakeBackend())
        tok = ByteTokenizer(vocab_size=512,
                            image_token_id=cfg.image_token_id,
                            bos_token_id=cfg.bos_token_id,
                            eos_token_id=cfg.eos_token_id,
                            model_max_length=64)
        img = Image.new("RGB", (60, 40), "white")
        ImageDraw.Draw(img).rectangle([5, 5, 50, 30], outline="black")
        codes = []
        for params in (placed(),
                       convert.params_from_numpy(tree, cfg, device="cpu")):
            pipe = DetikzifyPipeline(params, cfg,
                                     DetikzifyProcessor(tok, cfg),
                                     temperature=0.0, metric="fast",
                                     num_slots=2, device="cpu")
            doc = pipe.sample(image=img, max_new_tokens=16)
            codes.append(doc.code)
            res["tokens" if len(codes) == 1 else "base_tokens"] = \\
                np.frombuffer(doc.code.encode(), np.uint8)
            pipe.close()
        res["same"] = np.asarray(codes[0] == codes[1])
    elif case == "guards":
        from detikzify_torch.ops.quant import fuse_projections
        params = fuse_projections(
            convert.params_from_numpy(tree, cfg, device="cpu"))
        try:
            tmesh.place_params(params, tmesh.make_mesh(
                data=1, model=world, device="cpu"), identical=True)
            res["fused_raises"] = np.asarray(False)
        except ValueError as exc:
            res["fused_raises"] = np.asarray("fuse_projections" in str(exc))
        # the collectives: forward and backward of enter, reduce, gather
        from detikzify_torch.parallel.tp import TensorParallel
        tpg = TensorParallel(None, rank, world)
        x = torch.arange(6.0).reshape(2, 3).requires_grad_(True)
        y = tpg.enter(x) * (rank + 1)
        y.sum().backward()
        res["enter_grad"] = x.grad.numpy()
        x = (torch.arange(6.0).reshape(2, 3) * (rank + 1)).requires_grad_()
        y = tpg.reduce(x)
        res["reduce_fwd"] = y.detach().numpy()
        (y * torch.arange(6.0).reshape(2, 3)).sum().backward()
        res["reduce_grad"] = x.grad.numpy()
        x = torch.full((2, 2), float(rank), requires_grad=True)
        y = tpg.gather(x)
        res["gather_fwd"] = y.detach().numpy()
        (y * torch.arange(2.0 * 2 * world).reshape(2, -1)).sum().backward()
        res["gather_grad"] = x.grad.numpy()
        xb = torch.full((3,), 1.5 + rank, dtype=torch.bfloat16)
        res["reduce_bf16"] = tpg.all_reduce(xb).float().numpy()
    dist.barrier()
    dist.destroy_process_group()
    np.savez(out + f".{rank}.npz", **res)
""")


def _start(tmp_path, world, data, case, tag):
    """``world`` gloo processes of ``case`` (started, not awaited)."""
    init = f"file://{tmp_path / ('rendezvous_' + tag)}"
    out = str(tmp_path / tag)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    env.pop("LOCAL_RANK", None)
    return out, [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(world), init, data, out,
         case], cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True) for r in range(world)]


def _collect(out, procs):
    """Each rank's results once every process of a case has ended."""
    try:
        for p in procs:
            p.wait(timeout=240)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p in procs:
        assert p.returncode == 0, p.stderr.read()[-3000:]
    got = []
    for r in range(len(procs)):
        with np.load(f"{out}.{r}.npz") as f:
            got.append({k: f[k] for k in f.files})
    return got


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    cfg = tiny_test_config(vocab_size=512)
    jparams = jdet.init(jax.random.PRNGKey(0), cfg)
    tree = _flat(jax.tree.map(np.asarray, jparams._asdict()))
    rng = np.random.default_rng(5)
    ids = np.full((2, cfg.image_seq_len + 7), cfg.image_token_id, np.int64)
    ids[:, cfg.image_seq_len] = cfg.bos_token_id
    ids[:, cfg.image_seq_len + 1:] = rng.integers(5, 500, (2, 6))
    size = cfg.vision.image_size
    pixels = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    data = str(tmp / "data.npz")
    np.savez(data, **{"p/" + k: v for k, v in tree.items()},
             **{"i/ids": ids, "i/pixels": pixels})
    return cfg, jparams, tree, ids, pixels, data, tmp


@pytest.fixture(scope="module")
def runs(shared):
    """Every worker case, run once for the module, all at once."""
    cfg, jparams, tree, ids, pixels, data, tmp = shared
    started = {(world, case): _start(tmp, world, data, case,
                                     f"{case}{world}")
               for world, case in ((2, "place"), (4, "place"),
                                   (2, "forward"), (2, "legs"), (4, "legs"),
                                   (2, "sampling"), (2, "int8"),
                                   (2, "sample"), (2, "guards"))}
    return {key: _collect(*val) for key, val in started.items()}


# --- placement --------------------------------------------------------------

def _port_range(path, m, r, n_out, cfg):
    """The port's range of rank ``r`` on the model dimension of a leaf
    whose model dimension has ``n_out`` entries (whole heads for q/k/v)."""
    text = path.startswith("text/")
    c = cfg.text if text else cfg.vision
    nh = c.num_attention_heads
    nkv = c.num_key_value_heads if text else nh
    (q0, q1), (k0, k1) = ttp.head_range(r, m, nh, nkv)
    hd = n_out // (nkv if ("attn/k/" in path or "attn/v/" in path)
                   else nh) if "attn/" in path else None
    if "attn/q/" in path or "attn/o/" in path:
        return q0 * hd, q1 * hd
    if "attn/k/" in path or "attn/v/" in path:
        return k0 * hd, k1 * hd
    return r * n_out // m, (r + 1) * n_out // m


COL_BIASES = ("vision/layers/attn/q/bias", "vision/layers/attn/k/bias",
              "vision/layers/attn/v/bias", "vision/layers/mlp/fc1/bias",
              "vision/head/attn/q/bias", "vision/head/attn/k/bias",
              "vision/head/attn/v/bias", "vision/head/mlp/fc1/bias")


@pytest.mark.parametrize("m", [2, 4])
def test_placement_matches_jax_shards(shared, runs, m):
    cfg, jparams, tree, *_ = shared
    mesh = jmesh.make_mesh(data=1, model=m, devices=jax.devices()[:m])
    shardings = {jmesh._path_str(p): s for p, s in
                 jax.tree_util.tree_flatten_with_path(
                     jmesh.shard_params(jparams, mesh))[0]}
    got = runs[(m, "place")]
    departures = set()
    for path, whole in tree.items():
        sh = shardings[path]
        idx = sh.devices_indices_map(whole.shape)
        spec = tuple(sh.spec) + (None,) * (whole.ndim - len(sh.spec))
        for r in range(m):
            mine = got[r]["p/" + path]
            want = whole[idx[mesh.devices[0, r]]]
            if "model" in spec:
                dim = spec.index("model")
                lo, hi = _port_range(path, m, r, whole.shape[dim], cfg)
                # the port's part of the whole, and JAX's inside it
                np.testing.assert_array_equal(
                    mine, np.take(whole, range(lo, hi), axis=dim),
                    err_msg=path)
                sl = idx[mesh.devices[0, r]][dim]
                assert lo <= (sl.start or 0) and \
                    (sl.stop or whole.shape[dim]) <= hi, path
                if mine.shape != want.shape:
                    departures.add(path)
                continue
            if path in COL_BIASES:     # whole in JAX, sliced for compute
                kernel = path[:-len("bias")] + "kernel"
                lo, hi = _port_range(kernel, m, r, whole.shape[-1], cfg)
                np.testing.assert_array_equal(mine, whole[..., lo:hi],
                                              err_msg=path)
                np.testing.assert_array_equal(want, whole)
                departures.add(path)
                continue
            np.testing.assert_array_equal(mine, want, err_msg=path)
        # and the whole leaves rebuilt from the shards, on every rank
        for r in range(m):
            np.testing.assert_array_equal(got[r]["w/" + path], whole,
                                          err_msg=path)
    kv = {"text/layers/attn/k/kernel", "text/layers/attn/v/kernel"}
    assert departures == set(COL_BIASES) | (kv if m == 4 else set())
    nkv = max(cfg.text.num_key_value_heads // m, 1)
    for r in range(m):
        assert list(got[r]["heads"]) == [cfg.text.num_attention_heads // m,
                                         nkv,
                                         cfg.vision.num_attention_heads // m]


def test_head_range_splits_whole_heads_and_raises_otherwise():
    # GQA 32/8 over 2: query heads [16r, 16r+16) read KV heads [4r, 4r+4)
    assert ttp.head_range(1, 2, 32, 8) == ((16, 32), (4, 8))
    # fewer KV heads than ranks: ranks 0 and 1 share KV head 0
    assert ttp.head_range(0, 4, 4, 2) == ((0, 1), (0, 1))
    assert ttp.head_range(1, 4, 4, 2) == ((1, 2), (0, 1))
    with pytest.raises(ValueError, match="do not split"):
        ttp.head_range(0, 3, 16, 16)
    with pytest.raises(ValueError, match="KV groups"):
        ttp.head_range(0, 2, 12, 3)     # 6 query heads a rank, groups of 4
    with pytest.raises(ValueError, match="KV groups"):
        ttp.head_range(0, 8, 24, 3)     # 3 query heads a rank, groups of 8


# --- forward ----------------------------------------------------------------

def test_tp_forward_logits_match_jax(shared, runs):
    cfg, jparams, tree, ids, pixels, *_ = shared
    mesh = jmesh.make_mesh(data=1, model=2, devices=jax.devices()[:2])
    with mesh:
        placed = jmesh.place_params(jparams, mesh)
        sharded = np.asarray(jdet.forward(placed, cfg, jnp.asarray(ids),
                                          jnp.asarray(pixels),
                                          attn_impl="xla")[0])
    plain = np.asarray(jdet.forward(jparams, cfg, jnp.asarray(ids),
                                    jnp.asarray(pixels), attn_impl="xla")[0])
    for r in runs[(2, "forward")]:
        np.testing.assert_allclose(r["logits"], sharded, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(r["logits"], plain, atol=TOL, rtol=TOL)


# --- the three engine legs of the dry run ------------------------------------

def _jax_legs(params, cfg):
    """``__graft_entry__.py``'s three TP legs on the JAX engine."""
    prompt = [cfg.bos_token_id, 5, 6, 7]

    def engine(**kw):
        return JEngine(params, cfg, max_len=64, cache_dtype=jnp.float32,
                       sampling=JSampling(temperature=0.0), **kw)

    eng = engine(num_slots=2)
    ro = eng.start(list(prompt), max_new_tokens=10)
    eng.run()
    toks = list(ro.token_ids)
    eng.store_prefix("node", ro, length=len(prompt) + 3)
    eng.release(ro)
    _, sp = eng.best_prefix(toks[:len(prompt) + 3])
    r2 = eng.start(toks[:len(prompt) + 3], max_new_tokens=4, prefix=sp)
    eng.run()
    decode = [toks, list(r2.token_ids)]

    eng = engine(num_slots=4)
    ro = eng.start(list(prompt), max_new_tokens=8)
    eng.run()
    toks = list(ro.token_ids)
    eng.store_prefix("n0", ro, length=len(prompt) + 4)
    eng.release(ro)
    _, sp = eng.best_prefix(toks[:len(prompt) + 4])
    ros = eng.start_many(
        [toks[:len(prompt) + 4], list(prompt), toks[:len(prompt) + 2]],
        max_new_tokens=5, prefixes=[sp, None, None])
    eng.run()
    assert eng.counters["prefix_starts"] >= 1
    burst = [list(r.token_ids) for r in ros]

    eng = engine(num_slots=2, speculate=2, spec_min_rate=0.0,
                 decode_block=4)
    r1 = eng.start(list(prompt), max_new_tokens=10, lazy=True)
    r2 = eng.start(list(prompt) + [9], max_new_tokens=10, lazy=True,
                   hint=[5, 6, 7, 8])
    eng.run()
    assert eng.counters["spec_steps"] > 0
    spec = [list(r1.token_ids), list(r2.token_ids)]
    return {"decode": decode, "burst": burst, "spec": spec}


@pytest.fixture(scope="module")
def jax_legs(shared):
    cfg, jparams, *_ = shared
    mesh = jmesh.make_mesh(data=1, model=2, devices=jax.devices()[:2])
    with mesh:
        return _jax_legs(jmesh.place_params(jparams, mesh), cfg)


def _flat_streams(streams):
    return [t for s in streams for t in list(s) + [-1]]


@pytest.mark.parametrize("leg", ["decode", "burst", "spec"])
def test_tp_engine_legs_match_jax_tp_engine(runs, jax_legs, leg):
    want = _flat_streams(jax_legs[leg])
    for r in runs[(2, "legs")]:
        assert r[leg].tolist() == want
        assert r[leg + "_base"].tolist() == want


@pytest.mark.parametrize("leg", ["decode", "burst", "spec"])
def test_tp_engine_legs_with_shared_kv_heads(runs, leg):
    """m = 4 at NKV 2: ranks share KV heads; streams equal the unsharded
    port's."""
    for r in runs[(4, "legs")]:
        assert r[leg].tolist() == r[leg + "_base"].tolist()
        assert len(r[leg]) > 8


def test_tp_sampling_ranks_draw_the_same_tokens(runs):
    a, b = runs[(2, "sampling")]
    assert a["streams"].tolist() == b["streams"].tolist()
    assert len(a["streams"]) > 2 * 4 + 2


# --- int8 + fused ------------------------------------------------------------

def test_tp_int8_fused_shards_and_logits(shared, runs):
    """Each rank fuses its own slices: its int8 ``qkv`` is [q_r; k_r; v_r]
    of the whole quantized weights (per-channel scales survive the cut),
    ``gateup`` [gate_r; up_r]; the logits within 3e-4 of the unsharded
    int8 port."""
    from detikzify_torch.config import tiny_test_config as t_cfg
    from detikzify_torch.models import convert
    from detikzify_torch.ops.quant import quantize_params

    cfg, _, tree, *_ = shared
    whole = quantize_params(convert.params_from_numpy(
        {k: v for k, v in _nest(tree).items()}, t_cfg(vocab_size=512),
        device="cpu"))
    hd = cfg.text.head_dim
    inter = cfg.text.intermediate_size
    for r, got in enumerate(runs[(2, "int8")]):
        (q0, q1), (k0, k1) = ttp.head_range(r, 2, cfg.text.num_attention_heads,
                                            cfg.text.num_key_value_heads)
        for i, lp in enumerate(whole.text.layers):
            a = lp.attn
            want = torch.cat([a.q.q[q0 * hd:q1 * hd], a.k.q[k0 * hd:k1 * hd],
                              a.v.q[k0 * hd:k1 * hd]])
            np.testing.assert_array_equal(got[f"qkv/{i}"], want.numpy())
            np.testing.assert_array_equal(
                got[f"qkv_scale/{i}"],
                torch.cat([a.q.scale[q0 * hd:q1 * hd],
                           a.k.scale[k0 * hd:k1 * hd],
                           a.v.scale[k0 * hd:k1 * hd]]).numpy())
            n = inter // 2
            want = torch.cat([lp.mlp.gate.q[r * n:(r + 1) * n],
                              lp.mlp.up.q[r * n:(r + 1) * n]])
            np.testing.assert_array_equal(got[f"gateup/{i}"], want.numpy())
        np.testing.assert_allclose(got["logits"], got["base_logits"],
                                   atol=TOL, rtol=TOL)
        assert bool(got["fused_whole_raises"])


def _nest(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        *ks, last = key.split("/")
        for k in ks:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


# --- the pipeline --------------------------------------------------------------

def test_tp_pipeline_sample_gives_the_unsharded_program(runs):
    for r in runs[(2, "sample")]:
        assert bool(r["same"])
        assert r["tokens"].tolist() == r["base_tokens"].tolist()
    a, b = runs[(2, "sample")]
    assert a["tokens"].tolist() == b["tokens"].tolist()


# --- collectives and guards ------------------------------------------------------

def test_tp_collectives_forward_and_backward(runs):
    world = 2
    for r, got in enumerate(runs[(2, "guards")]):
        x = np.arange(6.0).reshape(2, 3)
        # enter: identity; backward sums the ranks' cotangents (1 + 2)
        np.testing.assert_array_equal(got["enter_grad"], np.full((2, 3), 3.0))
        # reduce: the sum over the ranks; backward the identity
        np.testing.assert_array_equal(got["reduce_fwd"], x * 3)
        np.testing.assert_array_equal(got["reduce_grad"], x)
        # gather: ranks' columns side by side; backward takes this rank's
        np.testing.assert_array_equal(
            got["gather_fwd"],
            np.repeat(np.arange(float(world)), 2)[None].repeat(2, 0))
        g = np.arange(2.0 * 2 * world).reshape(2, -1)
        np.testing.assert_array_equal(got["gather_grad"],
                                      g[:, 2 * r:2 * r + 2])
        # a bf16 sum carried in fp32: 1.5 + 2.5 exactly
        np.testing.assert_array_equal(got["reduce_bf16"], np.full(3, 4.0))


def test_tp_placement_refuses_fused_weights(runs):
    for got in runs[(2, "guards")]:
        assert bool(got["fused_raises"])


def test_engine_refuses_a_placement_with_a_data_axis():
    """A JAX engine on a (data > 1) mesh repeats the same work on every
    row: the port's points to ReplicaPool instead."""
    from detikzify_torch.config import tiny_test_config as t_cfg
    from detikzify_torch.engine import DecodeEngine
    from detikzify_torch.models import convert
    from detikzify_torch.parallel import mesh as tmesh

    cfg = t_cfg(vocab_size=512)
    params = convert.init_random(cfg, device="cpu", dtype=torch.float32)

    class Meshed:                       # a placement's mesh, no group
        mesh = tmesh.Mesh(2, 1, "cpu")

    params.placement = Meshed()
    with pytest.raises(ValueError, match="ReplicaPool"):
        DecodeEngine(params, cfg, num_slots=2, max_len=64, device="cpu")
    with pytest.raises(ValueError, match="torch.distributed group"):
        tmesh.place_params(convert.init_random(cfg, device="cpu",
                                               dtype=torch.float32),
                           tmesh.Mesh(1, 2, "cpu"))


def test_dryrun_multi_device_four_processes(capfd):
    """``parallel.dryrun``: the training step over a (data=2, model=2)
    mesh of four gloo processes, then the JAX dry run's three TP legs over
    two, then two replicas."""
    from detikzify_torch.parallel import dryrun

    dryrun.dryrun_multi_device(4)
    out = capfd.readouterr().out
    assert "dryrun_multi_device(4): ok, loss=" in out
    assert "mesh={'data': 2, 'model': 2}" in out
    for line in ("TP decode token-match ok (10 new tokens, prefix restore "
                 "ok)",
                 "TP burst start_many token-match ok (mixed prefixes, 3 "
                 "rows)",
                 "TP speculative decode token-match ok (hinted + unhinted "
                 "rows)",
                 "replica-parallel 2-engine gather ok (4 items over 2 "
                 "devices)"):
        assert f"dryrun_multi_device(4): {line}" in out
