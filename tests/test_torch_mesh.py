"""The port's mesh and its sharded training against the JAX package, on
the CPU.

  * ``param_spec`` equals JAX's on every leaf of ``tiny-test``,
    ``detikzify-ds-1.3b`` and ``detikzify-v2-8b`` (shapes from
    ``jax.eval_shape``), with ``fsdp`` on and off; ``shard_params``'s
    divisibility guard equals JAX's on a ``(data=2, model=1)`` mesh;
  * two gloo processes run two fp32 AdamW steps of ``tiny-test`` with
    ``grad_accum=2`` (each micro-batch split over the ranks, its rows
    padded unequally): FSDP (with remat) and plain data parallel both give
    JAX's loss
    within 1e-5 and its leaves within 1e-5 relative (of each leaf's
    largest), JAX's step running over a ``(data=2, model=1)`` mesh on its
    virtual devices. The vision key bias is held apart: its exact gradient
    is zero (it shifts a softmax row by a constant), so Adam normalises
    rounding noise into a +-lr step in either package (JAX's own
    one-device and mesh steps differ there by 1.7x the leaf's largest);
    it is held to |w| <= 2 lr. A ``quant8`` FSDP run's 8-bit moments and
    weights equal the port's unsharded step bit for bit. FSDP holds at
    most two of the four layers whole at once beside the tensors outside
    the layers; when a rank has no label token it keeps the whole model
    for the step and equals data parallel;
  * a checkpoint saved by four FSDP ranks restores into two, weights and
    8-bit moments whole and equal.

The model axis is held in ``tests/test_torch_tp.py`` (placement, forward,
engine, pipeline) and ``tests/test_torch_tp_train.py`` (training and the
4 x 2 -> 2 x 4 restore).
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import jax
import pytest
import torch

from detikzify_tpu.config import get_config as j_get_config
from detikzify_tpu.config import tiny_test_config
from detikzify_tpu.models import detikzify as jdet
from detikzify_tpu.parallel import mesh as jmesh
from detikzify_tpu.train import step as jstep
from detikzify_torch.config import tiny_test_config as t_tiny_test_config
from detikzify_torch.models import convert
from detikzify_torch.parallel import mesh as tmesh
from detikzify_torch.train import step as tstep

torch.set_num_threads(1)
LR = 1e-4                     # the workers' learning rate
ZERO_GRAD = "vision/layers/attn/k/bias"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("preset", ["tiny-test", "detikzify-ds-1.3b",
                                    "detikzify-v2-8b"])
def test_param_spec_matches_jax(preset, fsdp):
    cfg = (tiny_test_config(vocab_size=512) if preset == "tiny-test"
           else j_get_config(preset))
    shapes = jax.eval_shape(lambda: jdet.init(jax.random.PRNGKey(0), cfg))
    n = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        p = jmesh._path_str(path)
        want = tuple(jmesh.param_spec(p, leaf.shape, fsdp))
        assert tmesh.param_spec(p, tuple(leaf.shape), fsdp) == want, p
        n += 1
    assert n > 20


def test_shard_params_guard_matches_jax():
    """The divisibility guard, leaf for leaf, against JAX's ``shard_params``
    on a (data=2, model=1) mesh of virtual devices; the port's leaves are
    laid out by ``leaf_shape`` as JAX lays them."""
    cfg = tiny_test_config(vocab_size=512)
    jparams = jdet.init(jax.random.PRNGKey(0), cfg)
    tparams = convert.params_from_numpy(
        jax.tree.map(np.asarray, jparams._asdict()),
        t_tiny_test_config(vocab_size=512), device="cpu")
    jm = jmesh.make_mesh(data=2, model=1, devices=jax.devices()[:2])
    for fsdp in (False, True):
        js = jmesh.shard_params(jparams, jm, fsdp)
        want = {jmesh._path_str(p): tuple(s.spec)
                for p, s in jax.tree_util.tree_flatten_with_path(js)[0]}
        got = tmesh.shard_params(tparams, tmesh.Mesh(2, 1, "cpu"), fsdp)
        assert got == want
        shapes = {leaf.path: tmesh.leaf_shape(leaf)
                  for leaf in convert.leaves(tparams)}
        for p, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]:
            assert shapes[jmesh._path_str(p)] == leaf.shape


def test_make_mesh_without_a_group_is_one_device():
    mesh = tmesh.make_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1}
    assert not mesh.distributed and mesh.coordinate("data") == 0
    rows = np.arange(12).reshape(6, 2)
    np.testing.assert_array_equal(tmesh.local_rows(rows, mesh), rows)
    assert tmesh.data_sharding(mesh, 3).spec == ("data", None, None)
    assert tmesh.replicated(mesh).spec == ()


# --- processes of a gloo group ---------------------------------------------

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

    # the most elements of sharded tensors whole at once during a step
    peak = [0]
    gather = tmesh.Placement._gather

    def probe(self, entries):
        gather(self, entries)
        peak[0] = max(peak[0], sum(e.full.numel() for e in self._owned()
                                   if e.whole))
    tmesh.Placement._gather = probe

    def sizes(params):
        pl = params.placement
        units = [m.fsdp_unit.entries for m in params.modules()
                 if hasattr(m, "fsdp_unit")]
        n = lambda es: sum(e.full.numel() for e in es)  # noqa: E731
        return np.asarray([peak[0], n(pl._owned()), n(pl._root),
                           max(n(u) for u in units), len(units)])

    def run(fsdp, moments, steps=2, remat=False, rows=batch):
        params = convert.params_from_numpy(tree, cfg, device="cpu")
        mesh = tmesh.make_mesh(device="cpu")
        params = tmesh.place_params(params, mesh, fsdp=fsdp)
        opt = tstep.make_optimizer(LR, total_steps=4,
                                   trainable=tstep.trainable_mask(params,
                                                                  "all"),
                                   moment_dtype=moments)
        state = tstep.init_state(params, opt)
        step = tstep.make_train_step(cfg, opt, grad_accum=2, remat=remat)
        mine = {k: torch.from_numpy(tmesh.local_rows(v, mesh))
                for k, v in rows.items()}
        peak[0] = 0
        losses = []
        for _ in range(steps):
            state, m = step(state, mine)
            losses.append(float(m["loss"]))
        return state, losses, opt

    def flat(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}/")
            else:
                yield prefix + k, v

    if case == "steps":
        # micro-batch 1 (rank 1's rows) without a label token: rank 1 runs
        # no part, so the FSDP step keeps the whole model for the step
        unlabelled = dict(batch, labels=batch["labels"].copy())
        unlabelled["labels"][2:] = -100
        for name, fsdp, moments, remat, rows in (
                ("fsdp", True, None, True, batch),
                ("dp", False, None, False, batch),
                ("q8", True, "quant8", False, batch),
                ("fsdp_whole", True, None, False, unlabelled),
                ("dp_whole", False, None, False, unlabelled)):
            state, losses, opt = run(fsdp, moments, remat=remat, rows=rows)
            res[name + "/losses"] = np.asarray(losses)
            if fsdp:
                res[name + "/sizes"] = sizes(state.params)
            for k, v in flat(convert.params_to_numpy(state.params), ""):
                res[f"{name}/p/{k}"] = v
            if name == "q8":
                leaves = {l.path: l for l in convert.leaves(state.params)}
                whole = state.params.placement.gather_state(state.opt_state,
                                                            leaves)
                for path, st in whole["moments"].items():
                    for k, v in st.items():
                        res[f"q8/m/{path}/{k}"] = v.float().numpy()
    elif case == "save":
        state, losses, opt = run(True, "quant8", steps=1)
        Checkpointer(out + ".ckpt").save(1, state, {"mesh": f"{world}x1"})
        for k, v in flat(convert.params_to_numpy(state.params), ""):
            res["p/" + k] = v
    else:                                   # restore into this world
        params = convert.init_random(cfg, device="cpu", dtype=torch.float32,
                                     seed=7)
        params = tmesh.place_params(params, tmesh.make_mesh(device="cpu"),
                                    fsdp=True)
        opt = tstep.make_optimizer(1e-3, total_steps=4,
                                   trainable=tstep.trainable_mask(params,
                                                                  "all"),
                                   moment_dtype="quant8")
        ck = Checkpointer(case)
        state, meta = ck.restore_latest(tstep.init_state(params, opt))
        res["meta"] = np.asarray([meta["mesh"] == "4x1"])
        res["step"] = np.asarray([state.step])
        lo, hi = params.placement.block_range(
            next(iter(state.opt_state["moments"].values()))["mq"].shape[0]
            * world)
        res["rows"] = np.asarray([hi - lo])
        for k, v in flat(convert.params_to_numpy(state.params), ""):
            res["p/" + k] = v
        leaves = {l.path: l for l in convert.leaves(state.params)}
        whole = params.placement.gather_state(state.opt_state, leaves)
        for path, st in whole["moments"].items():
            for k, v in st.items():
                res[f"m/{path}/{k}"] = v.float().numpy()
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        np.savez(out, **res)
""")


def _ranks(tmp_path, world, data, case, tag):
    init = f"file://{tmp_path / ('rendezvous_' + tag)}"
    out = str(tmp_path / f"{tag}.npz")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    env.pop("LOCAL_RANK", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(world), init, data, out,
         case], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    try:
        for p in procs:
            p.wait(timeout=120)
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
    labels at its own length, so the ranks' label-token counts differ."""
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
    tmp = tmp_path_factory.mktemp("mesh")
    cfg = tiny_test_config(vocab_size=512)
    jparams = jdet.init(jax.random.PRNGKey(0), cfg)
    tree = jax.tree.map(np.asarray, jparams._asdict())
    batch = _batch(cfg, 4)
    data = str(tmp / "data.npz")
    np.savez(data, **{"p/" + k: v for k, v in _flat(tree).items()},
             **{"b/" + k: v for k, v in batch.items()})
    return cfg, jparams, tree, batch, data, tmp


def _jax_steps(cfg, jparams, batch):
    """Two fp32 AdamW steps over a (data=2, model=1) mesh, FSDP."""
    mesh = jmesh.make_mesh(data=2, model=1, devices=jax.devices()[:2])
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


def test_two_process_fsdp_and_dp_steps_match_jax(shared):
    cfg, jparams, tree, batch, data, tmp = shared
    got = _ranks(tmp, 2, data, "steps", "steps")
    want_losses, want = _jax_steps(cfg, jparams, batch)
    for name in ("fsdp", "dp"):
        np.testing.assert_allclose(got[name + "/losses"], want_losses,
                                   rtol=0, atol=1e-5)
        for k, w in want.items():
            g = got[f"{name}/p/{k}"]
            if k == ZERO_GRAD:
                assert max(np.abs(g).max(), np.abs(w).max()) <= 2 * LR
                continue
            scale = max(float(np.abs(w).max()), 1e-6)
            assert float(np.abs(g - w).max()) <= 1e-5 * scale, (name, k)
    # the weights moved (the second update runs at a learning rate > 0)
    assert any(float(np.abs(got["fsdp/p/" + k] - v).max()) > LR / 2
               for k, v in _flat(tree).items())
    # FSDP held at most two layers whole beside the tensors outside the
    # layers (a layer's backward gathers it just before the next one's
    # ends), with and without remat; with a rank that runs no part, the
    # whole model (and the same update as data parallel)
    for name in ("fsdp", "q8"):
        peak, owned, root, unit, n_units = got[name + "/sizes"]
        assert n_units == 4 and peak <= root + 2 * unit < owned, name
    assert got["fsdp_whole/sizes"][0] == got["fsdp_whole/sizes"][1]
    np.testing.assert_allclose(got["fsdp_whole/losses"],
                               got["dp_whole/losses"], rtol=1e-6)
    for k in _flat(tree):
        w = got["dp_whole/p/" + k]
        scale = max(float(np.abs(w).max()), 1e-6)
        assert float(np.abs(got["fsdp_whole/p/" + k] - w).max()) \
            <= 1e-6 * scale, k

    # quant8 FSDP == the port's unsharded step, bit for bit
    tcfg = t_tiny_test_config(vocab_size=512)
    params = convert.params_from_numpy(tree, tcfg, device="cpu")
    opt = tstep.make_optimizer(
        LR, total_steps=4, trainable=tstep.trainable_mask(params, "all"),
        moment_dtype="quant8")
    state = tstep.init_state(params, opt)
    step = tstep.make_train_step(tcfg, opt, grad_accum=2)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for i in range(2):
        state, m = step(state, tb)
        assert abs(float(m["loss"]) - got["q8/losses"][i]) <= 1e-6
    for k, v in _flat(convert.params_to_numpy(state.params)).items():
        np.testing.assert_array_equal(got["q8/p/" + k], v, err_msg=k)
    for path, st in state.opt_state["moments"].items():
        for k, v in st.items():
            np.testing.assert_array_equal(got[f"q8/m/{path}/{k}"],
                                          v.float().numpy(),
                                          err_msg=f"{path}/{k}")


def test_checkpoint_restore_from_four_ranks_into_two(shared):
    """Saved by a data=4 FSDP mesh (quant8 moments, one step), restored by
    a data=2 one: whole weights and moments equal, each rank holding its
    run of blocks."""
    cfg, jparams, tree, batch, data, tmp = shared
    saved = _ranks(tmp, 4, data, "save", "save")
    ckpt_dir = str(tmp / "save.npz.ckpt")
    assert os.path.exists(os.path.join(ckpt_dir, "checkpoint-1",
                                       "meta.json"))
    back = _ranks(tmp, 2, data, ckpt_dir, "restore")
    assert back["meta"][0] and back["step"][0] == 1
    for k, v in saved.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    whole = torch.load(os.path.join(ckpt_dir, "checkpoint-1", "state.pt"),
                       weights_only=True)
    n = 0
    for path, st in whole["opt_state"]["moments"].items():
        for k, v in st.items():
            np.testing.assert_array_equal(back[f"m/{path}/{k}"],
                                          v.float().numpy())
            n += 1
    assert n > 0


def test_trainer_global_batch_must_divide_the_data_axis():
    """As JAX's ``Trainer``: micro 1 x accum 3 over a data axis of 2
    raises before any step."""
    from detikzify_torch.processing import ByteTokenizer, DetikzifyProcessor
    from detikzify_torch.train import TrainConfig, Trainer

    cfg = t_tiny_test_config(vocab_size=512)
    params = convert.init_random(cfg, device="cpu", dtype=torch.float32)
    tok = ByteTokenizer(vocab_size=512, image_token_id=cfg.image_token_id,
                        bos_token_id=cfg.bos_token_id,
                        eos_token_id=cfg.eos_token_id, model_max_length=64)
    tc = TrainConfig(output_dir="unused", micro_batch_size=1, grad_accum=3)
    assert tc.fsdp is True and tc.model_axis == 1
    with pytest.raises(ValueError, match="data axis"):
        Trainer(params, cfg, DetikzifyProcessor(tok, cfg), [], tc,
                mesh=tmesh.Mesh(2, 1, "cpu"))


def test_dryrun_multi_device_two_processes(capfd):
    """``parallel.dryrun``: a grad_accum=2 FSDP step over two gloo
    processes with a finite loss, then a two-replica ``ReplicaPool``
    gathering 4 items."""
    from detikzify_torch.parallel import dryrun

    dryrun.dryrun_multi_device(2)
    out = capfd.readouterr().out
    assert "dryrun_multi_device(2): ok, loss=" in out
    assert "gather ok (4 items over 2 devices)" in out
