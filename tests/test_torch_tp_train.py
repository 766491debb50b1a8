"""Training over a ``(data, model)`` mesh against the JAX package, on the
CPU: port ranks are gloo processes, JAX runs in this process on its
virtual CPU devices, both at ``tiny-test`` in fp32.

  * four ranks on a ``(data=2, model=2)`` mesh run two fp32 AdamW steps
    with ``grad_accum=2``, FSDP over ``data`` of each rank's tensor-
    parallel shard, with remat (``tests/multiproc_worker.py``'s mesh): the
    losses within 1e-5 of JAX's step over its own 2 x 2 mesh, every leaf
    within 1e-5 of its largest, the global gradient norm within 1e-5
    relative of the port's unsharded step. The vision key bias is held to
    |w| <= 2 lr (its exact gradient is zero; ``test_torch_mesh.py``);
  * a ``quant8`` run on the same mesh against the port's unsharded
    ``quant8`` step: the losses within 1e-5; the weights and the 8-bit
    moments are not bit for bit, as they are over the data axis alone:
    the tensor-parallel sums round differently in their last bits, and an
    e4m3 moment can then round one step apart (2^-3 of itself), which
    moves that element's update by a fraction of the learning rate. So
    every weight is held within 1e-5 of its leaf's largest plus lr / 4,
    at most 1 in 1000 of a leaf's weights beyond 1e-5 of its largest plus
    lr / 1000, and every moment within one e4m3 step (2^-3 of its
    magnitude, or 2^-9 of its block's scale for a subnormal code), at most
    1 in 100 of its codes apart;
  * ``Trainer`` with ``TrainConfig(model_axis=2)`` over the four ranks
    gives the unmeshed ``Trainer``'s losses within 1e-5 and its leaves
    within 1e-4 of each leaf's largest (its batches are one row a
    micro-batch: some vision biases' gradients are small enough that
    Adam's normalisation lifts their last-bit differences to 1e-5 of the
    leaf);
  * a checkpoint saved by eight ranks on a 4 x 2 mesh (FSDP, quant8, one
    step) restores into eight on a 2 x 4 mesh (where two ranks share each
    KV head), as ``tests/test_train.py``'s cross-mesh restore: whole
    weights and 8-bit moments equal bit for bit, the saved file's too.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import jax
import pytest
import torch

from detikzify_tpu.config import tiny_test_config
from detikzify_tpu.models import detikzify as jdet
from detikzify_tpu.parallel import mesh as jmesh
from detikzify_tpu.train import step as jstep
from detikzify_torch.config import tiny_test_config as t_tiny_test_config
from detikzify_torch.models import convert
from detikzify_torch.train import step as tstep

torch.set_num_threads(1)
LR = 1e-4
ZERO_GRAD = "vision/layers/attn/k/bias"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from detikzify_torch.config import tiny_test_config
    from detikzify_torch.models import convert
    from detikzify_torch.parallel import mesh as tmesh
    from detikzify_torch.train import step as tstep
    from detikzify_torch.train.checkpoint import Checkpointer

    torch.set_num_threads(1)
    LR = 1e-4
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
    batch = {k[2:]: src[k] for k in src.files if k.startswith("b/")}
    res = {}

    def flat(node, prefix=""):
        for k, v in node.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}/")
            else:
                yield prefix + k, v

    def run(mesh, moments, steps=2, remat=False):
        params = convert.params_from_numpy(tree, cfg, device="cpu")
        params = tmesh.place_params(params, mesh, fsdp=True)
        opt = tstep.make_optimizer(LR, total_steps=4,
                                   trainable=tstep.trainable_mask(params,
                                                                  "all"),
                                   moment_dtype=moments)
        state = tstep.init_state(params, opt)
        step = tstep.make_train_step(cfg, opt, grad_accum=2, remat=remat)
        mine = {k: torch.from_numpy(tmesh.local_rows(v, mesh))
                for k, v in batch.items()}
        losses, norms = [], []
        for _ in range(steps):
            state, m = step(state, mine)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        return state, losses, norms

    def moments(state):
        leaves = {l.path: l for l in convert.leaves(state.params)}
        whole = state.params.placement.gather_state(state.opt_state, leaves)
        for path, st in whole["moments"].items():
            for k, v in st.items():
                yield f"{path}/{k}", v.float().numpy()

    if case == "steps":
        mesh = tmesh.make_mesh(data=2, model=2, device="cpu")
        for name, mom, remat in (("fp32", None, True),
                                 ("q8", "quant8", False)):
            state, losses, norms = run(mesh, mom, remat=remat)
            res[name + "/losses"] = np.asarray(losses)
            res[name + "/norms"] = np.asarray(norms)
            for k, v in flat(convert.params_to_numpy(state.params)):
                res[f"{name}/p/{k}"] = v
            if mom:
                for k, v in moments(state):
                    res[f"{name}/m/{k}"] = v
        # an engine over a data axis repeats the work: it refuses
        from detikzify_torch.engine import DecodeEngine
        try:
            DecodeEngine(state.params, cfg, num_slots=2, max_len=64,
                         device="cpu")
            res["engine_refused"] = np.asarray(False)
        except ValueError:
            res["engine_refused"] = np.asarray(True)
    elif case == "trainer":
        from PIL import Image
        from detikzify_torch.processing import (ByteTokenizer,
                                                DetikzifyProcessor)
        from detikzify_torch.train import TrainConfig, Trainer
        tok = ByteTokenizer(vocab_size=512,
                            image_token_id=cfg.image_token_id,
                            bos_token_id=cfg.bos_token_id,
                            eos_token_id=cfg.eos_token_id,
                            model_max_length=64)
        items = []
        for i in range(4):      # noise: no near-zero gradient for Adam
            img = Image.fromarray(np.random.default_rng(i).integers(
                0, 256, (40, 60, 3), dtype=np.uint8))   # to amplify
            items.append({"image": img,
                          "text": f"\\\\draw (0,{i}) -- (1,{i});"})
        losses = []
        tc = TrainConfig(output_dir=out + ".trainer", micro_batch_size=1,
                         grad_accum=2, epochs=1, max_length=64,
                         sketch_ratio=0.0, logging_steps=1,
                         model_axis=2)
        params = convert.params_from_numpy(tree, cfg, device="cpu")
        trainer = Trainer(params, cfg, DetikzifyProcessor(tok, cfg), items,
                          tc, log_fn=lambda m: None)
        step = trainer._step_fn

        def recorded(state, rows):
            state, metrics = step(state, rows)
            losses.append(float(metrics["loss"]))
            return state, metrics
        trainer._step_fn = recorded
        trainer.train(resume=False)
        res["mesh"] = np.asarray([trainer.mesh.shape["data"],
                                  trainer.mesh.shape["model"]])
        res["losses"] = np.asarray(losses)
        for k, v in flat(convert.params_to_numpy(trainer.state.params)):
            res["p/" + k] = v
    elif case == "save":
        mesh = tmesh.make_mesh(data=4, model=2, device="cpu")
        state, _, _ = run(mesh, "quant8", steps=1)
        Checkpointer(out + ".ckpt").save(1, state, {"mesh": "4x2"})
        for k, v in flat(convert.params_to_numpy(state.params)):
            res["p/" + k] = v
        for k, v in moments(state):
            res["m/" + k] = v
    else:                                   # restore into a 2 x 4 mesh
        mesh = tmesh.make_mesh(data=2, model=4, device="cpu")
        params = convert.init_random(cfg, device="cpu", dtype=torch.float32,
                                     seed=7)
        params = tmesh.place_params(params, mesh, fsdp=True)
        opt = tstep.make_optimizer(1e-3, total_steps=4,
                                   trainable=tstep.trainable_mask(params,
                                                                  "all"),
                                   moment_dtype="quant8")
        state, meta = Checkpointer(case).restore_latest(
            tstep.init_state(params, opt))
        res["meta"] = np.asarray([meta["mesh"] == "4x2"])
        res["step"] = np.asarray([state.step])
        res["heads"] = np.asarray(params.text.layers[0].attn.heads)
        for k, v in flat(convert.params_to_numpy(state.params)):
            res["p/" + k] = v
        for k, v in moments(state):
            res["m/" + k] = v
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        np.savez(out, **res)
""")


def _start(tmp_path, world, data, case, tag):
    init = f"file://{tmp_path / ('rendezvous_' + tag)}"
    out = str(tmp_path / f"{tag}.npz")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    env.pop("LOCAL_RANK", None)
    return out, [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(world), init, data, out,
         case], cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True) for r in range(world)]


def _collect(out, procs):
    try:
        for p in procs:
            p.wait(timeout=240)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p in procs:
        assert p.returncode == 0, p.stderr.read()[-3000:]
    with np.load(out) as f:
        return {k: f[k] for k in f.files}


def _batch(cfg, rows):
    """``rows`` rows of image tokens, BOS and text, each padded with -100
    labels at its own length (``test_torch_mesh.py``'s batch)."""
    rng = np.random.default_rng(3)
    seq = cfg.image_seq_len + 12
    ids = np.full((rows, seq), cfg.image_token_id, np.int32)
    ids[:, cfg.image_seq_len] = cfg.bos_token_id
    ids[:, cfg.image_seq_len + 1:] = rng.integers(5, 500, (rows, 11))
    labels = np.where(ids == cfg.image_token_id, -100, ids)
    for r in range(rows):
        labels[r, seq - 1 - 3 * r:] = -100
    pixels = rng.standard_normal(
        (rows, cfg.vision.image_size, cfg.vision.image_size, 3)
    ).astype(np.float32)
    return {"input_ids": ids, "labels": labels, "pixel_values": pixels}


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
    tmp = tmp_path_factory.mktemp("tp_train")
    cfg = tiny_test_config(vocab_size=512)
    jparams = jdet.init(jax.random.PRNGKey(0), cfg)
    tree = jax.tree.map(np.asarray, jparams._asdict())
    batch = _batch(cfg, 4)
    data = str(tmp / "data.npz")
    np.savez(data, **{"p/" + k: v for k, v in _flat(tree).items()},
             **{"b/" + k: v for k, v in batch.items()})
    return cfg, jparams, tree, batch, data, tmp


@pytest.fixture(scope="module")
def runs(shared):
    """The 2 x 2 steps, the trainer and the 4 x 2 save at once; then the
    2 x 4 restore of that save."""
    cfg, jparams, tree, batch, data, tmp = shared
    started = {case: _start(tmp, world, data, case, case)
               for world, case in ((4, "steps"), (4, "trainer"),
                                   (8, "save"))}
    out = {case: _collect(*val) for case, val in started.items()}
    ckpt = str(tmp / "save.npz.ckpt")
    out["restore"] = _collect(*_start(tmp, 8, data, ckpt, "restore"))
    out["ckpt"] = ckpt
    return out


def _jax_steps(cfg, jparams, batch):
    """Two fp32 AdamW steps over a (data=2, model=2) mesh, FSDP."""
    mesh = jmesh.make_mesh(data=2, model=2, devices=jax.devices()[:4])
    with mesh:
        params = jmesh.place_params(jparams, mesh, fsdp=True)
        opt = jstep.make_optimizer(
            LR, total_steps=4,
            trainable=jstep.trainable_mask(params, "all"))
        state = jstep.init_state(params, opt)
        step = jax.jit(jstep.make_train_step(cfg, opt, grad_accum=2,
                                             attn_impl="xla"))
        b = {k: jax.device_put(v, jmesh.data_sharding(mesh, v.ndim))
             for k, v in batch.items()}
        losses = []
        for _ in range(2):
            state, m = step(state, b)
            losses.append(float(m["loss"]))
    return losses, _flat(jax.tree.map(np.asarray, state.params._asdict()))


def _port_steps(tree, batch, moments):
    """The port's unsharded step: (losses, norms, whole leaves, moments)."""
    tcfg = t_tiny_test_config(vocab_size=512)
    params = convert.params_from_numpy(tree, tcfg, device="cpu")
    opt = tstep.make_optimizer(
        LR, total_steps=4, trainable=tstep.trainable_mask(params, "all"),
        moment_dtype=moments)
    state = tstep.init_state(params, opt)
    step = tstep.make_train_step(tcfg, opt, grad_accum=2)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    losses, norms = [], []
    for _ in range(2):
        state, m = step(state, tb)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    mom = {f"{path}/{k}": v.float().numpy()
           for path, st in state.opt_state["moments"].items()
           for k, v in st.items()} if moments == "quant8" else None
    return losses, norms, _flat(convert.params_to_numpy(state.params)), mom


def test_tp_fsdp_steps_match_jax_on_a_2x2_mesh(shared, runs):
    cfg, jparams, tree, batch, *_ = shared
    got = runs["steps"]
    want_losses, want = _jax_steps(cfg, jparams, batch)
    np.testing.assert_allclose(got["fp32/losses"], want_losses, rtol=0,
                               atol=1e-5)
    for k, w in want.items():
        g = got["fp32/p/" + k]
        if k == ZERO_GRAD:
            assert max(np.abs(g).max(), np.abs(w).max()) <= 2 * LR
            continue
        scale = max(float(np.abs(w).max()), 1e-6)
        assert float(np.abs(g - w).max()) <= 1e-5 * scale, k
    # the weights moved (the second update runs at a learning rate > 0)
    assert any(float(np.abs(got["fp32/p/" + k] - v).max()) > LR / 2
               for k, v in _flat(tree).items())


def test_tp_grad_norm_matches_the_unsharded_step(shared, runs):
    """The global norm counts each tensor-parallel cut once (a shared KV
    head on its owner), over both axes."""
    _, _, tree, batch, *_ = shared
    _, norms, _, _ = _port_steps(tree, batch, None)
    np.testing.assert_allclose(runs["steps"]["fp32/norms"], norms,
                               rtol=1e-5)


def test_tp_quant8_steps_match_the_unsharded_quant8_step(shared, runs):
    _, _, tree, batch, *_ = shared
    got = runs["steps"]
    losses, _, want, mom = _port_steps(tree, batch, "quant8")
    np.testing.assert_allclose(got["q8/losses"], losses, rtol=0, atol=1e-5)
    for k, w in want.items():
        g = got["q8/p/" + k]
        if k == ZERO_GRAD:
            assert max(np.abs(g).max(), np.abs(w).max()) <= 2 * LR
            continue
        err = np.abs(g - w)
        scale = 1e-5 * max(float(np.abs(w).max()), 1e-6)
        assert float(err.max()) <= scale + LR / 4, k
        assert np.mean(err > scale + LR / 1000) <= 1e-3, k
    codes = 0
    for k, w in mom.items():
        g = got["q8/m/" + k]
        assert g.shape == w.shape, k
        if k.startswith(ZERO_GRAD) or k.endswith("s"):
            continue                       # scales: held through the codes
        path = k.rsplit("/", 1)[0]
        sk = k[:-1] + "s"                  # mq -> ms, vq -> vs
        a = g * got["q8/m/" + sk][:, None]
        b = w * mom[sk][:, None]
        # one e4m3 step: 2^-3 of a normal code, 2^-9 of the block's scale
        # for a subnormal one
        step = np.maximum(2.0 ** -3 * np.maximum(np.abs(a), np.abs(b)),
                          2.0 ** -9 * mom[sk][:, None])
        assert bool(np.all(np.abs(a - b) <= step * (1 + 1e-6))), k
        assert np.mean(g != w) <= 1e-2, (path, np.mean(g != w))
        codes += g.size
    assert codes > 0


def test_tp_trainer_with_a_model_axis(shared, runs):
    """``TrainConfig(model_axis=2)`` over four ranks places the weights on
    a (data=2, model=2) mesh and trains as the unmeshed ``Trainer``."""
    from PIL import Image

    from detikzify_torch.processing import ByteTokenizer, DetikzifyProcessor
    from detikzify_torch.train import TrainConfig, Trainer

    cfg, _, tree, _, _, tmp = shared
    tcfg = t_tiny_test_config(vocab_size=512)
    tok = ByteTokenizer(vocab_size=512, image_token_id=tcfg.image_token_id,
                        bos_token_id=tcfg.bos_token_id,
                        eos_token_id=tcfg.eos_token_id, model_max_length=64)
    items = []
    for i in range(4):
        img = Image.fromarray(np.random.default_rng(i).integers(
            0, 256, (40, 60, 3), dtype=np.uint8))
        items.append({"image": img, "text": f"\\draw (0,{i}) -- (1,{i});"})
    want = []
    tc = TrainConfig(output_dir=str(tmp / "plain_trainer"),
                     micro_batch_size=1, grad_accum=2, epochs=1,
                     max_length=64, sketch_ratio=0.0, logging_steps=1)
    trainer = Trainer(convert.params_from_numpy(tree, tcfg, device="cpu"),
                      tcfg, DetikzifyProcessor(tok, tcfg), items, tc,
                      device="cpu", log_fn=lambda m: None)
    step = trainer._step_fn

    def recorded(state, rows):
        state, metrics = step(state, rows)
        want.append(float(metrics["loss"]))
        return state, metrics
    trainer._step_fn = recorded
    trainer.train(resume=False)
    got = runs["trainer"]
    assert got["mesh"].tolist() == [2, 2]
    assert len(want) == 2
    np.testing.assert_allclose(got["losses"], want, rtol=0, atol=1e-5)
    whole = _flat(convert.params_to_numpy(trainer.state.params))
    for k, w in whole.items():
        if k == ZERO_GRAD:
            continue
        scale = max(float(np.abs(w).max()), 1e-6)
        assert float(np.abs(got["p/" + k] - w).max()) <= 1e-4 * scale, k


def test_tp_checkpoint_saved_on_4x2_restores_into_2x4(runs):
    saved, back = runs["save"], runs["restore"]
    assert back["meta"][0] and back["step"][0] == 1
    # two ranks share each of tiny-test's two KV heads at m = 4
    assert back["heads"].tolist() == [1, 1]
    n = 0
    for k, v in saved.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
        n += k.startswith("m/")
    assert n > 0
    whole = torch.load(os.path.join(runs["ckpt"], "checkpoint-1",
                                    "state.pt"), weights_only=True)
    for path, st in whole["opt_state"]["moments"].items():
        for k, v in st.items():
            np.testing.assert_array_equal(back[f"m/{path}/{k}"],
                                          v.float().numpy())
    tcfg = t_tiny_test_config(vocab_size=512)
    params = convert.init_random(tcfg, device="cpu", dtype=torch.float32)
    params.load_state_dict(whole["params"])
    for k, v in _flat(convert.params_to_numpy(params)).items():
        np.testing.assert_array_equal(back["p/" + k], v, err_msg=k)


def test_tp_engine_refuses_a_data_axis(runs):
    assert bool(runs["steps"]["engine_refused"])
