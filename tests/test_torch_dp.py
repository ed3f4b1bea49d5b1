"""The port's data-parallel train step against the JAX package's, on the CPU.

``make_train_step(mesh=, mode="dp_shard_map")`` on one spawned gloo group
of world 2 (the ``file://`` store and time limit of
``tests/test_torch_distributed.py``) against the JAX package's
``dp_shard_map`` step on 2 forced CPU devices, for each gradient
compression (None, "bf16", "int8"): tinyllama at smoke size, 2 steps of a
global batch of 8 from the JAX package's seed-0 init (its checkpoint,
restored by the port).  The same group holds ``_compress_grads`` to the
JAX package's on the same per-rank gradients (``jax.vmap`` with an axis
name stands for the devices), and checks an elastic restore: the state
saved at world 2 is restored at world 2 (the DP step) and at world 1 (the
plain step), and each next loss equals the JAX package's restored step's.
gloo sums bf16 tensors itself (one rounding of two addends, as XLA's sum),
so the bf16 route casts nothing.

Tolerances: ``_compress_grads`` on the same inputs within 1e-6 (the sums
and each rank's error feedback); the runs' losses, grad norms and
learning rates within 1e-5 and rank 0's error feedback within 1e-6; the
parameters within 1e-5 on all but 0.1% of each tensor's elements and
within 1e-4 on every one.  The few elements past 1e-5 (at most 2 of 8,192
in a tensor, 3.4e-5 at most, when this file was written) have a gradient
near AdamW's eps (1e-8), where the update g / (|g| + eps) turns the two
frameworks' last-bit gradient differences into a visible share of lr.
"""

import dataclasses
import importlib
import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as torch_mp  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.analysis import gate  # noqa: E402
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.checkpoint.elastic import ShardedState, reshard_params, reshard_state  # noqa: E402
from repro_torch.data.pipeline import TokenPipeline  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh  # noqa: E402
from repro_torch.models.convert import jax_key  # noqa: E402
from repro_torch.sharding import specs as tspecs  # noqa: E402

jtrain = importlib.import_module("repro.training.train_loop")
ttrain = importlib.import_module("repro_torch.training.train_loop")

ARCH = "tinyllama_1p1b"
MODES = (None, "bf16", "int8")
WORLD = 2
STEPS = 2
BATCH, SEQ, PIPE_SEED = 8, 16, 3
LOSS_TOL = 1e-5
EF_TOL = 1e-6
COMPRESS_TOL = 1e-6
PARAM_TOL = 1e-5  # on all but PARAM_OUTLIERS of each tensor's elements
PARAM_OUTLIERS = 1e-3
PARAM_ATOL = 1e-4  # on every element
SPAWN_TIMEOUT_S = 240


def _tcfg(mod, comp):
    return mod.TrainConfig(peak_lr=3e-3, warmup_steps=1, total_steps=12, compression=comp)


JAX_RUN = """
import json
from repro.checkpoint import restore_checkpoint, save_checkpoint
from repro.configs import smoke_config
from repro.data.pipeline import TokenPipeline
from repro.training.train_loop import TrainConfig, init_train_state, make_train_step
out = {out!r}
mesh = make_mesh((2,), ("data",))
cfg = smoke_config({arch!r})
pipe = TokenPipeline(cfg.vocab_size, {seq}, {batch}, seed={seed})
batch = lambda s: tuple(jnp.asarray(a) for a in pipe.batch_at(s))
res = {{}}
for comp in (None, "bf16", "int8"):
    tag = str(comp)
    tcfg = TrainConfig(peak_lr=3e-3, warmup_steps=1, total_steps=12, compression=comp)
    with mesh:
        state = init_train_state(cfg, tcfg, jax.random.key(0))
        save_checkpoint(f"{{out}}/jax_init_{{tag}}", 0, state)
        step = make_train_step(cfg, tcfg, mesh=mesh, mode="dp_shard_map", donate=False)
        rows = []
        for s in range({steps}):
            state, m = step(state, *batch(s), None)
            rows.append({{k: float(v) for k, v in m.items()}})
        save_checkpoint(f"{{out}}/jax_final_{{tag}}", {steps} - 1, state)
        like = init_train_state(cfg, tcfg, jax.random.key(0))
        restored, _, _ = restore_checkpoint(f"{{out}}/jax_final_{{tag}}", like)
        _, m_dp = step(restored, *batch({steps}), None)
        _, m_plain = make_train_step(cfg, tcfg, donate=False)(restored, *batch({steps}))
    res[tag] = {{"steps": rows, "elastic_dp": float(m_dp["loss"]),
                "elastic_plain": float(m_plain["loss"])}}
json.dump(res, open(f"{{out}}/jax.json", "w"))
print("JAX OK")
"""


def _compress_inputs(cfg, seed=11):
    """Per-rank gradients and error feedback for ``_compress_grads``: a
    list of tensors a rank, in ``named_parameters`` order."""
    from repro_torch.models.model import Model

    names = [n for n, _ in Model(cfg, device="meta").named_parameters()]
    shapes = [tuple(p.shape) for _, p in Model(cfg, device="meta").named_parameters()]
    rng = np.random.default_rng(seed)
    grads = [[(rng.standard_normal(s) * rng.uniform(1e-4, 1e-1)).astype(np.float32) for s in shapes]
             for _ in range(WORLD)]
    ef = [[(rng.standard_normal(s) * 1e-4).astype(np.float32) for s in shapes] for _ in range(WORLD)]
    return names, grads, ef


def _dp_worker(rank, world, out):
    cfg = tconfigs.smoke_config(ARCH)
    mesh = make_host_mesh(device_type="cpu")
    assert tuple(mesh.mesh.shape) == (world, 1) and mesh.mesh_dim_names == ("data", "model")
    pipe = TokenPipeline(cfg.vocab_size, SEQ, BATCH, seed=PIPE_SEED)  # the global batch

    def batch(s):
        return [torch.from_numpy(a).long() for a in pipe.batch_at(s)]

    res = {}
    names, grads, ef = _compress_inputs(cfg)
    groups = ttrain._leaf_groups(names)
    for comp in MODES:
        mine_ef = [torch.from_numpy(e.copy()) for e in ef[rank]]
        summed, new_ef = ttrain._compress_grads([torch.from_numpy(g) for g in grads[rank]],
                                                mine_ef, comp, groups)
        np.savez(os.path.join(out, f"compress_{comp}_{rank}.npz"),
                 **{f"g{i}": t.numpy() for i, t in enumerate(summed)},
                 **{f"e{i}": t.numpy() for i, t in enumerate(new_ef)})
    for comp in MODES:
        tag = str(comp)
        tcfg = _tcfg(ttrain, comp)
        state = ttrain.init_train_state(cfg, tcfg, seed=1, device="cpu")
        state, _, _ = restore_checkpoint(os.path.join(out, f"jax_init_{tag}"), state)
        state = reshard_state(state, cfg, mesh)
        step = ttrain.make_train_step(cfg, tcfg, mesh=mesh, mode="dp_shard_map")
        ttrain.reset_dp_stats()
        rows = []
        for s in range(STEPS):
            state, m = step(state, *batch(s))
            rows.append({k: float(v) for k, v in m.items()})
        stats = dict(ttrain.DP_STATS)
        final = os.path.join(out, f"port_final_{tag}")
        if rank == 0:
            save_checkpoint(final, STEPS - 1, state)
        np.savez(os.path.join(out, f"ef_{tag}_{rank}.npz"),
                 *[e.numpy() for e in state.error_feedback])
        dist.barrier()
        # elastic: the world-2 checkpoint at world 2 (DP step) and at world 1 (plain step)
        restored, _, _ = restore_checkpoint(final, ttrain.init_train_state(cfg, tcfg, seed=2,
                                                                           device="cpu"))
        _, m_dp = step(reshard_state(restored, cfg, mesh), *batch(STEPS))
        row = {"steps": rows, "stats": stats, "elastic_dp": float(m_dp["loss"])}
        if rank == 0:
            restored, _, _ = restore_checkpoint(final, ttrain.init_train_state(cfg, tcfg, seed=2,
                                                                               device="cpu"))
            _, m_plain = ttrain.make_train_step(cfg, tcfg)(restored, *batch(STEPS))
            row["elastic_plain"] = float(m_plain["loss"])
        res[tag] = row
    tokens, labels = batch(0)
    try:
        step(state, tokens[:3], labels[:3])
    except ValueError as e:
        res["odd_batch"] = str(e)
    # ZeRO-1 at data 2: each rank keeps its layer of AdamW's state; the DP step refuses it
    zcfg = tconfigs.smoke_config("mixtral_8x7b")
    zcfg = dataclasses.replace(zcfg, zero1=True)
    zstate = ttrain.init_train_state(zcfg, _tcfg(ttrain, None), seed=0, device="cpu")
    sharded = reshard_state(zstate, zcfg, mesh)
    assert isinstance(sharded, ShardedState)
    res["zero1_layers"] = sorted({int(n.split(".")[1]) for n, t in sharded.opt.master.items()
                                  if n.startswith("layers.") and t is not None})
    res["zero1_params_whole"] = all(t is not None and t.shape == p.shape for (n, p), t in zip(
        zstate.params.named_parameters(), sharded.params.values()))
    zstep = ttrain.make_train_step(zcfg, _tcfg(ttrain, None), mesh=mesh, mode="dp_shard_map")
    gathered, m = zstep(sharded, *batch(0))
    res["zero1_step"] = [float(m["loss"]), float(m["grad_norm"])]
    whole = ttrain.init_train_state(zcfg, _tcfg(ttrain, None), seed=0, device="cpu")
    _, m = zstep(whole, *batch(0))
    res["zero1_whole_step"] = [float(m["loss"]), float(m["grad_norm"])]
    res["zero1_gathered_whole"] = isinstance(gathered, ttrain.TrainState) and all(
        torch.equal(a, b) for a, b in zip(gathered.params.parameters(), whole.params.parameters()))
    # a model axis of 2: each rank keeps its column block of the head-split projections
    tp_mesh = make_host_mesh(model=2, device_type="cpu")
    tp_state = ttrain.init_train_state(cfg, _tcfg(ttrain, None), seed=0, device="cpu")
    blocks = reshard_params(tp_state.params, cfg, tp_mesh)
    named = {n: p.detach() for n, p in tp_state.params.named_parameters()}
    half = named["layers.0.attn.wq"].shape[1] // world
    res["tp_blocks"] = {
        "wq": torch.equal(blocks["layers.0.attn.wq"],
                          named["layers.0.attn.wq"][:, rank * half:(rank + 1) * half]),
        "wo": torch.equal(blocks["layers.1.attn.wo"],
                          named["layers.1.attn.wo"][rank * half:(rank + 1) * half]),
        "embed_whole": torch.equal(blocks["embed"], named["embed"]),  # 503 rows do not split
    }
    res["tp_state_sharded"] = isinstance(reshard_state(tp_state, cfg, tp_mesh), ShardedState)
    with open(os.path.join(out, f"port_{rank}.json"), "w") as f:
        json.dump(res, f)


def _rank_main(rank, world, store, fn, *args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def _spawn(fn, nprocs, store, *args):
    ctx = torch_mp.start_processes(_rank_main, args=(nprocs, store, fn) + args, nprocs=nprocs,
                                   join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise AssertionError(f"ranks still running after {SPAWN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


@pytest.fixture(scope="module")
def runs(tmp_path_factory, multi_device_host):
    """The JAX package's runs on 2 forced devices, then the port's on 2
    gloo ranks (which start from the JAX package's init checkpoints)."""
    out = str(tmp_path_factory.mktemp("dp"))
    multi_device_host(JAX_RUN.format(out=out, arch=ARCH, seq=SEQ, batch=BATCH,
                                           seed=PIPE_SEED, steps=STEPS), devices=WORLD,
                            timeout=600)
    _spawn(_dp_worker, WORLD, os.path.join(out, "store"), out)
    with open(os.path.join(out, "jax.json")) as f:
        jax_res = json.load(f)
    port = []
    for r in range(WORLD):
        with open(os.path.join(out, f"port_{r}.json")) as f:
            port.append(json.load(f))
    return out, jax_res, port


def _jax_compress(grads, ef, comp, names):
    """The JAX package's ``_compress_grads`` over a vmapped axis of the
    ranks' stacked trees: (sums, every rank's new error feedback)."""
    from repro_torch.models.convert import LayerStack, jax_tree

    def stacked(per_rank):  # (world, ...) leaves of the JAX tree
        trees = [jax_tree(names, arrs) for arrs in per_rank]

        def leaf(*xs):
            return np.stack([np.stack(x.parts) if isinstance(x, LayerStack) else x for x in xs])
        return jax.tree.map(leaf, *trees, is_leaf=lambda x: isinstance(x, LayerStack))

    fn = jax.vmap(lambda g, e: jtrain._compress_grads(g, e, comp, "d"), axis_name="d")
    summed, new_ef = fn(stacked(grads), stacked(ef))
    return jax.tree.map(np.asarray, summed), jax.tree.map(np.asarray, new_ef)


def _rank_leaf(tree, name, rank):
    """A rank's array of the port's tensor ``name`` in a tree whose leaves
    lead with the ranks' axis."""
    keys, layer = jax_key(name)
    for key in keys:
        tree = tree[key]
    return tree[rank] if layer is None else tree[rank][layer]


@pytest.mark.parametrize("comp", MODES)
def test_compress_grads_matches_jax(runs, comp):
    """``_compress_grads`` on the same per-rank gradients and error
    feedback: the sums (every rank the same) and each rank's new error
    feedback equal the JAX package's; the int8 scale is a JAX leaf's
    (a layer leaf's over every layer)."""
    out, _, _ = runs
    cfg = tconfigs.smoke_config(ARCH)
    names, grads, ef = _compress_inputs(cfg)
    summed, new_ef = _jax_compress(grads, ef, comp, names)
    for rank in range(WORLD):
        got = np.load(os.path.join(out, f"compress_{comp}_{rank}.npz"))
        for i, name in enumerate(names):
            np.testing.assert_allclose(got[f"g{i}"], _rank_leaf(summed, name, rank),
                                       atol=COMPRESS_TOL, rtol=0, err_msg=name)
            want_ef = _rank_leaf(new_ef, name, rank) if comp == "int8" else ef[rank][i]
            np.testing.assert_allclose(got[f"e{i}"], want_ef, atol=EF_TOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("comp", MODES)
def test_dp_step_matches_jax(runs, comp):
    """Two DP steps at world 2: every step's loss (averaged over the
    ranks), grad norm and lr against the JAX package's; the parameters
    (rank 0's checkpoint against the JAX package's); rank 0's error
    feedback against the JAX checkpoint's (device 0's); both ranks the
    same parameters; the collectives' calls and bytes."""
    out, jax_res, port = runs
    tag = str(comp)
    for r in range(WORLD):
        for got, want in zip(port[r][tag]["steps"], jax_res[tag]["steps"], strict=True):
            for key in ("loss", "grad_norm", "lr", "moe_dropped"):
                np.testing.assert_allclose(got[key], want[key], atol=LOSS_TOL, rtol=LOSS_TOL,
                                           err_msg=f"{tag} rank {r} {key}")
    cfg = tconfigs.smoke_config(ARCH)
    tcfg = _tcfg(ttrain, comp)
    mine, _, _ = restore_checkpoint(os.path.join(out, f"port_final_{tag}"),
                                    ttrain.init_train_state(cfg, tcfg, seed=5, device="cpu"))
    theirs, _, _ = restore_checkpoint(os.path.join(out, f"jax_final_{tag}"),
                                      ttrain.init_train_state(cfg, tcfg, seed=6, device="cpu"))
    assert int(mine.opt.step) == int(theirs.opt.step) == STEPS
    for (name, a), b in zip(mine.params.named_parameters(), theirs.params.parameters(),
                            strict=True):
        diff = np.abs(a.detach().numpy() - b.detach().numpy())
        assert diff.max() <= PARAM_ATOL, (tag, name, diff.max())
        assert (diff > PARAM_TOL).mean() <= PARAM_OUTLIERS, (tag, name, (diff > PARAM_TOL).sum())
    ef0 = np.load(os.path.join(out, f"ef_{tag}_0.npz"))
    assert len(ef0.files) == (len(mine.error_feedback) if comp == "int8" else 0)
    for i, e in enumerate(theirs.error_feedback):
        np.testing.assert_allclose(ef0[f"arr_{i}"], e.numpy(), atol=EF_TOL, rtol=0)
    n_params = sum(p.numel() for p in mine.params.parameters())
    n_leaves = len(ttrain._leaf_groups([n for n, _ in mine.params.named_parameters()]))
    wire = {"None": 4 * n_params, "bf16": 2 * n_params, "int8": 4 * n_params + 4 * n_leaves}[tag]
    calls = {"None": 2, "bf16": 2, "int8": 3}[tag]
    assert port[0][tag]["stats"] == {"calls": STEPS * calls, "bytes": STEPS * (wire + 8)}


@pytest.mark.parametrize("comp", MODES)
def test_elastic_restore_across_world_sizes(runs, comp):
    """The world-2 checkpoint restored at world 2 (DP step) and at world 1
    (plain step): finite next losses equal to the JAX package's restored
    steps' and to each other."""
    _, jax_res, port = runs
    tag = str(comp)
    want = jax_res[tag]
    for r in range(WORLD):
        got = port[r][tag]["elastic_dp"]
        assert np.isfinite(got)
        np.testing.assert_allclose(got, want["elastic_dp"], atol=LOSS_TOL, rtol=LOSS_TOL)
    np.testing.assert_allclose(port[0][tag]["elastic_plain"], want["elastic_plain"],
                               atol=LOSS_TOL, rtol=LOSS_TOL)
    np.testing.assert_allclose(port[0][tag]["elastic_plain"], port[0][tag]["elastic_dp"],
                               atol=LOSS_TOL, rtol=LOSS_TOL)


def test_meshes_and_sharded_states_at_world_one():
    """``make_host_mesh`` and ``make_production_mesh`` over a world-1 gloo
    group; ``reshard_state`` keeps a state whole (the same tensors) at
    world 1 and the DP step takes it; a ZeRO-1 state on a (1, 1) mesh is
    whole too; the DP step gathers a ``ShardedState`` whole and rejects a
    mesh that is not the whole group; the pjit step at world 1 is the
    plain step, and steps a whole state in place without giving its model
    a tensor-parallel context."""
    cfg = tconfigs.smoke_config(ARCH)
    tcfg = _tcfg(ttrain, None)
    with pytest.raises(RuntimeError, match="process group"):
        make_host_mesh(device_type="cpu")
    with gate.world1_group("cpu"):
        mesh = make_host_mesh(model=4, device_type="cpu")
        assert tuple(mesh.mesh.shape) == (1, 1) and mesh.mesh_dim_names == ("data", "model")
        for multi_pod, ranks in ((False, 256), (True, 512)):
            with pytest.raises(ValueError, match=f"needs {ranks} ranks"):
                make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        state = ttrain.init_train_state(cfg, tcfg, seed=0, device="cpu")
        master0 = state.opt.master[0]
        placed = reshard_state(state, cfg, mesh)
        assert placed.params is state.params and placed.opt.master[0] is master0
        blocks = reshard_params(state.params, cfg, mesh)
        assert all(torch.equal(blocks[n], p) for n, p in state.params.named_parameters())
        step = ttrain.make_train_step(cfg, tcfg, mesh=mesh, mode="dp_shard_map")
        tokens, labels = (torch.from_numpy(a).long()
                          for a in TokenPipeline(cfg.vocab_size, SEQ, 4, seed=1).batch_at(0))
        _, m = step(placed, tokens, labels)
        plain = ttrain.init_train_state(cfg, tcfg, seed=0, device="cpu")
        _, m_plain = ttrain.make_train_step(cfg, tcfg)(plain, tokens, labels)
        for key in ("loss", "grad_norm"):
            assert float(m[key]) == float(m_plain[key])
        # a state cut into (here whole) blocks by the specs: the DP step gathers it
        fresh = ttrain.init_train_state(cfg, tcfg, seed=0, device="cpu")
        names = [n for n, _ in fresh.params.named_parameters()]
        specs = tspecs.state_specs(cfg, mesh)
        blocks = ShardedState(
            dict(zip(names, (p.detach() for p in fresh.params.parameters()))),
            fresh.opt._replace(master=dict(zip(names, fresh.opt.master)),
                               mu=dict(zip(names, fresh.opt.mu)), nu=dict(zip(names, fresh.opt.nu))),
            {}, specs, {"data": 0, "model": 0})
        _, m_blocks = step(blocks, tokens, labels)
        pjit = ttrain.init_train_state(cfg, tcfg, seed=0, device="cpu")
        stepped, m_pjit = ttrain.make_train_step(cfg, tcfg, mesh=mesh)(pjit, tokens, labels)
        # a whole state is stepped in place, as by the plain step, through a
        # tensor-parallel model of the step's own: the caller's gets no context
        assert stepped.params is pjit.params and int(stepped.opt.step) == 1
        assert not hasattr(pjit.params, "tp")
        for key in ("loss", "grad_norm"):
            assert float(m_blocks[key]) == float(m_plain[key])
            assert abs(float(m_pjit[key]) - float(m_plain[key])) <= LOSS_TOL
        with pytest.raises(ValueError, match="unknown mode"):
            ttrain.make_train_step(cfg, tcfg, mesh=mesh, mode="tp")


def test_zero1_state_is_split_by_layer_and_refused(runs):
    """mixtral with ZeRO-1 at data 2: ``reshard_state`` keeps each rank's
    parameters whole and, of AdamW's layer state, its own layer (layer i
    on the rank whose data coordinate is i // (L / 2)); the DP step no
    longer refuses that sharded state: it gathers it whole (the JAX
    package's ``in_specs=P()``), and its step is the whole state's step
    (the same loss and grad norm, the same parameters after)."""
    _, _, port = runs
    for rank in range(WORLD):
        assert port[rank]["zero1_layers"] == [rank]
        assert port[rank]["zero1_params_whole"]
        assert port[rank]["zero1_step"] == port[rank]["zero1_whole_step"]
        assert port[rank]["zero1_gathered_whole"]


def test_model_axis_splits_the_head_projections(runs):
    """At (data 1, model 2) ``reshard_params`` gives each rank its block of
    ``wq``'s columns and ``wo``'s rows (the heads), keeps a vocab of 503
    rows whole, and ``reshard_state`` returns a ``ShardedState``."""
    _, _, port = runs
    for rank in range(WORLD):
        assert port[rank]["tp_blocks"] == {"wq": True, "wo": True, "embed_whole": True}
        assert port[rank]["tp_state_sharded"]


def test_dp_step_refuses_a_batch_that_does_not_split(runs):
    _, _, port = runs
    for rank in range(WORLD):
        assert "a global batch of 3 does not split over 2 ranks" in port[rank]["odd_batch"]
