"""The port's tensor-parallel LM training and serving against the JAX package's, on the CPU.

One spawned gloo group of 4 ranks, mesh (data 2, model 2), runs every
check; the JAX package's sharded steps run first, on 4 forced CPU devices
in a subprocess (as ``tests/test_torch_dp.py``'s ``JAX_RUN``), and save
their seed-0 init checkpoints, which the port restores, so both sides
start from the same weights.  Configs (``CONFIGS``): each of the six
families at smoke size with ``d_model=64, head_dim=16`` (the JAX
package's ``test_pjit_train_step_all_families_small_mesh``);
tinyllama with a vocab of 512, so that the embedding and the head split
over the model axis (smoke's 503 rows do not); hymba with 5 heads and one
kv head of 16 and one SSM head of 64, so that every head-split weight
cuts a head in two (``_maybe`` splits H·hd, not H).

Checked per config: one ``make_train_step(mode="pjit")`` step's loss (1e-5)
and every parameter after it (``test_torch_dp.py``'s rule: 1e-5 on all but
0.1% of each tensor, 1e-4 on every element; the port's blocks gathered by
``elastic.gather_state``); the sharded prefill's logits and one sharded
decode step's with ``seq_shard`` False and True from the same cache
(1e-4).  Then qwen3 with ``dp_only``, ``zero1`` and both against the
unsharded JAX step (1e-5); ``dp_shard_map`` on a ZeRO-1 ``ShardedState``
(gathered whole) against the JAX package's ``dp_shard_map`` step; and
tinyllama's pjit state at (2, 2), saved, restored at (4, 1) and at world
1 and stepped, each loss against the JAX package's same chain.  The
spec functions of the tensor-parallel step and of sharded serving are
held to the JAX package's over ``AbstractMesh``.
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
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as torch_mp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.sharding import specs as jspecs  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint import elastic  # noqa: E402
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.convert import jax_key  # noqa: E402
from repro_torch.serving import serve_loop as tserve  # noqa: E402
from repro_torch.sharding import specs as tspecs  # noqa: E402
from repro_torch.sharding import tp  # noqa: E402

ttrain = importlib.import_module("repro_torch.training.train_loop")

WORLD, MESH = 4, (2, 2)
# tag -> (arch, config overrides)
CONFIGS = {
    "tinyllama": ("tinyllama_1p1b", {}),
    "mixtral": ("mixtral_8x7b", {}),
    "mamba2": ("mamba2_1p3b", {}),
    "hymba": ("hymba_1p5b", {}),
    "seamless": ("seamless_m4t_medium", {}),
    "internvl2": ("internvl2_2b", {}),
    "vocab512": ("tinyllama_1p1b", {"vocab_size": 512}),
    "midhead": ("hymba_1p5b", {"n_heads": 5, "n_kv_heads": 1, "ssm_head_dim": 64}),
}
VARIANTS = {"dp_only": {"sharding_strategy": "dp_only"},
            "dp_only_zero1": {"sharding_strategy": "dp_only", "zero1": True},
            "zero1": {"zero1": True}}
VARIANT_ARCH = "qwen3_1p7b"
ELASTIC = "tinyllama"
BATCH, SEQ = 8, 16
SERVE_BATCH, PROMPT, ROOM = 4, 12, 4
LOSS_TOL = 1e-5
LOGIT_TOL = 1e-4
PARAM_TOL, PARAM_OUTLIERS, PARAM_ATOL = 1e-5, 1e-3, 1e-4
SPAWN_TIMEOUT_S = 240


def _overrides(extra):
    return {"d_model": 64, "head_dim": 16, **extra}


def _tcfg(mod):
    return mod.TrainConfig(peak_lr=1e-3, warmup_steps=1, total_steps=5)


JAX_RUN = """
import dataclasses, json
from jax.sharding import NamedSharding
from repro.checkpoint import restore_checkpoint, save_checkpoint
from repro.checkpoint.elastic import reshard_state
from repro.configs import smoke_config
from repro.models import model as M
from repro.serving.serve_loop import make_prefill_fn, make_serve_step
from repro.sharding import specs as SP
from repro.training.train_loop import TrainConfig, init_train_state, make_train_step
out = {out!r}
configs = {configs!r}
variants = {variants!r}
mesh = make_mesh((2, 2), ("data", "model"))
tcfg = TrainConfig(peak_lr=1e-3, warmup_steps=1, total_steps=5)
B, S, SB, P, R = {batch}, {seq}, {serve_batch}, {prompt}, {room}
rng = np.random.default_rng(0)
res = {{}}

def inputs(cfg, tag):
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labs = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    prompt = rng.integers(0, cfg.vocab_size, (SB, P)).astype(np.int32)
    arrs = dict(toks=toks, labs=labs, prompt=prompt)
    if cfg.frontend is not None:
        flen = S if cfg.family == "encdec" else cfg.frontend_len
        arrs["fe"] = (rng.standard_normal((B, flen, cfg.d_model)) * 0.1).astype(np.float32)
        pflen = P if cfg.family == "encdec" else cfg.frontend_len
        arrs["pfe"] = (rng.standard_normal((SB, pflen, cfg.d_model)) * 0.1).astype(np.float32)
    np.savez(f"{{out}}/inputs_{{tag}}.npz", **arrs)
    return arrs

def args_of(cfg, a, fe_key="fe"):
    extra = (jnp.asarray(a[fe_key]),) if cfg.frontend is not None else ()
    return extra

for tag, (arch, over) in configs.items():
    cfg = dataclasses.replace(smoke_config(arch), **over)
    a = inputs(cfg, tag)
    row = {{}}
    with mesh:
        st0 = init_train_state(cfg, tcfg, jax.random.key(0))
        save_checkpoint(f"{{out}}/init_{{tag}}", 0, st0)
        st = reshard_state(st0, cfg, mesh)
        step = make_train_step(cfg, tcfg, mesh=mesh, mode="pjit", donate=False)
        st, m = step(st, jnp.asarray(a["toks"]), jnp.asarray(a["labs"]), *args_of(cfg, a))
        row["loss"] = float(m["loss"])
        row["grad_norm"] = float(m["grad_norm"])
        save_checkpoint(f"{{out}}/final_{{tag}}", 1, st)
        params = st0.params
        prompt = jnp.asarray(a["prompt"])
        pfe = args_of(cfg, a, "pfe")
        lg, _ = make_prefill_fn(cfg, mesh, SB, P + R)(params, prompt, *pfe)
        row["prefill"] = np.asarray(lg).tolist()
        ref_lg, state = M.prefill(cfg, params, prompt, *pfe, max_len=P + R)
        nxt = np.asarray(jnp.argmax(ref_lg, -1)[:, None].astype(jnp.int32))
        host = jax.tree.map(np.asarray, state)
        for seq in (False, True):
            cache = jax.device_put(jax.tree.map(jnp.asarray, host),
                                   SP._named(mesh, SP.decode_state_specs(cfg, mesh, SB, seq_shard=seq)))
            lg, _ = make_serve_step(cfg, mesh=mesh, batch=SB, seq_shard=seq)(params, nxt, cache)
            row[f"decode_{{seq}}"] = np.asarray(lg).tolist()
    if tag == {elastic!r}:
        for shape, axes, name in (((4, 1), ("data", "model"), "4x1"), ((1,), ("data",), "1")):
            mesh_b = make_mesh(shape, axes)
            with mesh_b:
                like = init_train_state(cfg, tcfg, jax.random.key(0))
                restored, _, _ = restore_checkpoint(f"{{out}}/final_{{tag}}", like)
                restored = reshard_state(restored, cfg, mesh_b)
                step_b = make_train_step(cfg, tcfg, mesh=mesh_b, mode="pjit", donate=False)
                _, m = step_b(restored, jnp.asarray(a["toks"]), jnp.asarray(a["labs"]))
                row[f"elastic_{{name}}"] = float(m["loss"])
        with mesh:  # dp_shard_map over every axis, from the seed-0 state
            step = make_train_step(cfg, tcfg, mesh=mesh, mode="dp_shard_map", donate=False)
            st, m = step(st0, jnp.asarray(a["toks"]), jnp.asarray(a["labs"]), None)
            row["dp_loss"] = float(m["loss"])
            save_checkpoint(f"{{out}}/dp_{{tag}}", 1, st)
    res[tag] = row

cfg = smoke_config({variant_arch!r})
a = inputs(cfg, "variants")
st0 = init_train_state(cfg, tcfg, jax.random.key(0))
save_checkpoint(f"{{out}}/init_variants", 0, st0)
st, m = make_train_step(cfg, tcfg, donate=False)(st0, jnp.asarray(a["toks"]), jnp.asarray(a["labs"]))
save_checkpoint(f"{{out}}/final_variants", 1, st)
res["variants"] = {{"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}}
json.dump(res, open(f"{{out}}/jax.json", "w"))
print("JAX OK")
"""


def _port_cfg(arch, over):
    return dataclasses.replace(tconfigs.smoke_config(arch), **over)


def _load(out, tag):
    with np.load(os.path.join(out, f"inputs_{tag}.npz")) as f:
        return {k: torch.from_numpy(f[k]) for k in f.files}


def _restored(out, name, cfg, tcfg):
    state = ttrain.init_train_state(cfg, tcfg, seed=1, device="cpu")
    return restore_checkpoint(os.path.join(out, name), state)[0]


def _param_diffs(a, b):
    """Per tensor: (max abs diff, count past PARAM_TOL, elements)."""
    out = {}
    for (name, x), y in zip(a.params.named_parameters(), b.params.parameters(), strict=True):
        d = np.abs(x.detach().numpy() - y.detach().numpy())
        out[name] = [float(d.max()), int((d > PARAM_TOL).sum()), int(d.size)]
    return out


def _same_state(a, b):
    """Whether two whole states hold equal parameters, masters and moments."""
    pairs = list(zip(a.params.parameters(), b.params.parameters(), strict=True))
    for x, y in (a.opt.master, b.opt.master), (a.opt.mu, b.opt.mu), (a.opt.nu, b.opt.nu):
        pairs += zip(x, y, strict=True)
    return all(torch.equal(x, y) for x, y in pairs) and int(a.opt.step) == int(b.opt.step)


def _fe(cfg, arrs, key):
    return arrs[key] if cfg.frontend is not None else None


def _tp_worker(rank, world, out):
    mesh = make_host_mesh(model=MESH[1], device_type="cpu")
    res = {"stats": {}}
    for tag, (arch, extra) in CONFIGS.items():
        cfg = _port_cfg(arch, _overrides(extra))
        tcfg = _tcfg(ttrain)
        a = _load(out, tag)
        toks, labs = a["toks"].long(), a["labs"].long()
        state = _restored(out, f"init_{tag}", cfg, tcfg)
        placed = elastic.reshard_state(state, cfg, mesh)
        step = ttrain.make_train_step(cfg, tcfg, mesh=mesh, mode="pjit")
        tp.reset_stats()
        placed, m = step(placed, toks, labs, _fe(cfg, a, "fe"))
        row = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
               "sharded": isinstance(placed, elastic.ShardedState),
               "collectives": {k: dict(v) for k, v in tp.STATS.items()},
               "state_untouched": _same_state(state, _restored(out, f"init_{tag}", cfg, tcfg))}
        whole = elastic.gather_state(placed, cfg, mesh)
        theirs = _restored(out, f"final_{tag}", cfg, tcfg)
        row["params"] = _param_diffs(whole, theirs)
        if rank == 0 and tag == ELASTIC:
            save_checkpoint(os.path.join(out, "port_2x2"), 1, whole)
        # serving: the port's sharded prefill, then one decode step from the
        # unsharded prefill's cache placed per seq_shard
        model = state.params.requires_grad_(False)
        tm = tserve.shard_model(cfg, model, mesh)
        pfe = () if cfg.frontend is None else (a["pfe"],)
        prompt = a["prompt"].long()
        lg, _ = tserve.make_prefill_fn(cfg, mesh, SERVE_BATCH, PROMPT + ROOM)(tm, prompt, *pfe)
        row["prefill"] = tserve.gather_logits(cfg, mesh, SERVE_BATCH, lg).tolist()
        ref_lg, ref_state = tmodel.prefill(cfg, model, prompt, *pfe, max_len=PROMPT + ROOM)
        nxt = ref_lg.argmax(dim=-1, keepdim=True)
        for seq in (False, True):
            cache = tserve.place_state(cfg, mesh, SERVE_BATCH, ref_state, seq)
            if cache.kv is not None:
                row[f"kv_{seq}"] = [list(cache.kv.k.shape), cache.kv.seq_axis is not None]
            lg, _ = tserve.make_serve_step(cfg, mesh, SERVE_BATCH, seq)(tm, nxt, cache)
            row[f"decode_{seq}"] = tserve.gather_logits(cfg, mesh, SERVE_BATCH, lg).tolist()
        if tag == ELASTIC:
            dist.barrier()
            mesh_b = init_device_mesh("cpu", (4, 1), mesh_dim_names=("data", "model"))
            restored = elastic.reshard_state(_restored(out, "port_2x2", cfg, tcfg), cfg, mesh_b)
            row["elastic_4x1_whole"] = not isinstance(restored, elastic.ShardedState)
            _, m = ttrain.make_train_step(cfg, tcfg, mesh=mesh_b, mode="pjit")(restored, toks, labs)
            row["elastic_4x1"] = float(m["loss"])
            if rank == 0:
                _, m = ttrain.make_train_step(cfg, tcfg)(_restored(out, "port_2x2", cfg, tcfg),
                                                         toks, labs)
                row["elastic_1"] = float(m["loss"])
            # dp_shard_map on a ZeRO-1 state: gathered whole, then the DP step
            zcfg = dataclasses.replace(cfg, zero1=True)
            zstate = elastic.reshard_state(_restored(out, f"init_{tag}", zcfg, tcfg), zcfg, mesh)
            row["zero1_sharded"] = isinstance(zstate, elastic.ShardedState)
            dp_step = ttrain.make_train_step(zcfg, tcfg, mesh=mesh, mode="dp_shard_map")
            zstate, m = dp_step(zstate, toks, labs)
            row["dp_loss"] = float(m["loss"])
            row["dp_params"] = _param_diffs(zstate, _restored(out, f"dp_{tag}", cfg, tcfg))
        res[tag] = row
    base = tconfigs.smoke_config(VARIANT_ARCH)
    a = _load(out, "variants")
    for name, change in VARIANTS.items():
        cfg = dataclasses.replace(base, **change)
        tcfg = _tcfg(ttrain)
        placed = elastic.reshard_state(_restored(out, "init_variants", cfg, tcfg), cfg, mesh)
        placed, m = ttrain.make_train_step(cfg, tcfg, mesh=mesh, mode="pjit")(
            placed, a["toks"].long(), a["labs"].long())
        whole = (elastic.gather_state(placed, cfg, mesh)
                 if isinstance(placed, elastic.ShardedState) else placed)
        res[name] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                     "params": _param_diffs(whole, _restored(out, "final_variants", cfg, tcfg))}
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
    """The JAX package's runs on 4 forced devices, then the port's on 4
    gloo ranks from the JAX package's init checkpoints."""
    out = str(tmp_path_factory.mktemp("tp"))
    jax_configs = {tag: (arch, _overrides(extra)) for tag, (arch, extra) in CONFIGS.items()}
    multi_device_host(JAX_RUN.format(
        out=out, configs=jax_configs, variants=VARIANTS, batch=BATCH, seq=SEQ,
        serve_batch=SERVE_BATCH, prompt=PROMPT, room=ROOM, elastic=ELASTIC,
        variant_arch=VARIANT_ARCH), devices=WORLD, timeout=600)
    _spawn(_tp_worker, WORLD, os.path.join(out, "store"), out)
    with open(os.path.join(out, "jax.json")) as f:
        jax_res = json.load(f)
    port = []
    for r in range(WORLD):
        with open(os.path.join(out, f"port_{r}.json")) as f:
            port.append(json.load(f))
    return jax_res, port


def _check_params(diffs, tag):
    for name, (worst, past, size) in diffs.items():
        assert worst <= PARAM_ATOL, (tag, name, worst)
        assert past <= PARAM_OUTLIERS * size, (tag, name, past, size)


@pytest.mark.parametrize("tag", list(CONFIGS))
def test_pjit_step_matches_jax(runs, tag):
    """One pjit step at (data 2, model 2): every rank's loss and grad norm
    against the JAX package's, every parameter of the gathered state
    against its; the state is sharded (the model axis splits something
    in every config), the collectives ran, and the whole state that
    ``reshard_state`` cut is as it was (every block is a copy)."""
    jax_res, port = runs
    for r in range(WORLD):
        got = port[r][tag]
        np.testing.assert_allclose(got["loss"], jax_res[tag]["loss"], atol=LOSS_TOL, rtol=LOSS_TOL)
        np.testing.assert_allclose(got["grad_norm"], jax_res[tag]["grad_norm"], atol=LOSS_TOL,
                                   rtol=LOSS_TOL)
        assert got["sharded"] and got["state_untouched"], tag
        assert got["collectives"]["all_reduce"]["calls"] > 0, tag
        _check_params(got["params"], tag)


@pytest.mark.parametrize("tag", list(CONFIGS))
def test_sharded_serving_matches_jax(runs, tag):
    """The sharded prefill's logits, and one sharded decode step's from the
    same cache laid out head-sharded and sequence-sharded, gathered,
    against the JAX package's sharded steps (1e-4); the cache is this
    rank's block (its kv heads, or its half of the slots)."""
    jax_res, port = runs
    cfg = _port_cfg(CONFIGS[tag][0], _overrides(CONFIGS[tag][1]))
    for r in range(WORLD):
        got = port[r][tag]
        for key in ("prefill", "decode_False", "decode_True"):
            np.testing.assert_allclose(np.array(got[key]), np.array(jax_res[tag][key]),
                                       atol=LOGIT_TOL, rtol=0, err_msg=f"{tag} {key} rank {r}")
        if cfg.has_attention:
            C = PROMPT + ROOM if cfg.sliding_window is None else min(PROMPT + ROOM,
                                                                     cfg.sliding_window)
            heads = cfg.n_kv_heads // 2 if cfg.n_kv_heads % 2 == 0 else cfg.n_kv_heads
            auto = cfg.n_kv_heads % 2 != 0
            assert got["kv_False"] == [[cfg.n_layers, SERVE_BATCH // 2, C, heads, 16], False]
            assert got["kv_True"] == [[cfg.n_layers, SERVE_BATCH // 2, C // 2, cfg.n_kv_heads, 16],
                                      True]
            assert auto == (tag == "midhead"), tag


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_sharding_variants_match_the_unsharded_jax_step(runs, variant):
    """qwen3 with ``dp_only``, ``zero1`` and both: the pjit step at (2, 2)
    equals the JAX package's unsharded step (loss, grad norm 1e-5; the
    parameters by the rule above)."""
    jax_res, port = runs
    for r in range(WORLD):
        got = port[r][variant]
        np.testing.assert_allclose(got["loss"], jax_res["variants"]["loss"], atol=LOSS_TOL,
                                   rtol=LOSS_TOL)
        np.testing.assert_allclose(got["grad_norm"], jax_res["variants"]["grad_norm"],
                                   atol=LOSS_TOL, rtol=LOSS_TOL)
        _check_params(got["params"], variant)


def test_elastic_restore_and_zero1_dp_step(runs):
    """tinyllama's state after the (2, 2) pjit step, saved, restored at
    (4, 1) (every tensor whole: a ``TrainState``) and at world 1, and
    stepped: each loss against the JAX package's same chain.  The DP step
    on a ZeRO-1 ``ShardedState`` gathers it and equals the JAX package's
    ``dp_shard_map`` step."""
    jax_res, port = runs
    want = jax_res[ELASTIC]
    for r in range(WORLD):
        got = port[r][ELASTIC]
        assert got["elastic_4x1_whole"] and got["zero1_sharded"]
        np.testing.assert_allclose(got["elastic_4x1"], want["elastic_4x1"], atol=LOSS_TOL,
                                   rtol=LOSS_TOL)
        np.testing.assert_allclose(got["dp_loss"], want["dp_loss"], atol=LOSS_TOL, rtol=LOSS_TOL)
        _check_params(got["dp_params"], "dp_shard_map zero1")
    np.testing.assert_allclose(port[0][ELASTIC]["elastic_1"], want["elastic_1"], atol=LOSS_TOL,
                               rtol=LOSS_TOL)


# -------------------------------------------------------------- spec parity
SPEC_ARCHS = ("qwen3_1p7b", "hymba_1p5b", "mixtral_8x7b", "mamba2_1p3b", "seamless_m4t_medium",
              "internvl2_2b", "tinyllama_1p1b")
SPEC_MESHES = [((1, 1), ("data", "model")), ((2, 2), ("data", "model")),
               ((4, 2), ("data", "model")), ((2, 4), ("data", "model")), ((8,), ("data",)),
               ((2, 2, 2), ("pod", "data", "model"))]


def _entries(spec):
    return tuple(spec)


def _jax_cache(tree):
    return None if tree is None else tuple(tuple(s) for s in tree)


@pytest.mark.parametrize("variant", ["tp", "dp_only_zero1"])
@pytest.mark.parametrize("arch", SPEC_ARCHS)
def test_step_and_serving_specs_match_jax(arch, variant):
    """``train_step_shardings``, ``decode_state_specs`` (head- and
    sequence-sharded, auto; batches that do and do not split over DP) and
    ``serve_step_shardings`` equal the JAX package's over ``AbstractMesh``."""
    change = {} if variant == "tp" else VARIANTS[variant]
    cfg = dataclasses.replace(tconfigs.get_config(arch), **change)
    jcfg = dataclasses.replace(jget_config(arch), **change)
    for sizes, names in SPEC_MESHES:
        jmesh = AbstractMesh(sizes, names)
        mesh = dict(zip(names, sizes))
        jt, tt = jspecs.train_step_shardings(jcfg, jmesh), tspecs.train_step_shardings(cfg, mesh)
        assert len(jt["in"]) == len(tt["in"]) and tuple(jt["out"][1].spec) == tuple(tt["out"][1])
        for j, t in zip(jt["in"][1:], tt["in"][1:]):
            assert tuple(j.spec) == tuple(t), (arch, sizes)
        jstate, tstate = jt["in"][0], tt["in"][0]
        for name in tstate.params:
            keys, layer = jax_key(name)
            node = jstate.params
            for k in keys:
                node = node[k]
            got = tstate.params[name].stacked() if layer is not None else tuple(tstate.params[name])
            assert got == tuple(node.spec), (arch, sizes, name)
        for batch in (1, 6, 8):
            for seq in (None, False, True):
                js = jspecs.decode_state_specs(jcfg, jmesh, batch, seq_shard=seq)
                ts = tspecs.decode_state_specs(cfg, mesh, batch, seq_shard=seq)
                for field in ("kv", "ssm"):
                    j, t = getattr(js, field), getattr(ts, field)
                    assert (j is None) == (t is None), (arch, field)
                    if t is not None:
                        fields = ("k", "v") if field == "kv" else ("conv", "state")
                        for f in fields:
                            assert tuple(getattr(j, f)) == _entries(getattr(t, f)), (
                                arch, sizes, batch, seq, field, f)
                assert _jax_cache(js.cross_kv) == _jax_cache(ts.cross_kv), (arch, sizes, batch)
            js, ts = (jspecs.serve_step_shardings(jcfg, jmesh, batch),
                      tspecs.serve_step_shardings(cfg, mesh, batch))
            assert tuple(js["in"][1].spec) == tuple(ts["in"][1]), (arch, sizes, batch)
            assert tuple(js["out"][0].spec) == tuple(ts["out"][0]), (arch, sizes, batch)
            assert tuple(js["out"][1].kv.k.spec if js["out"][1].kv is not None else ()) == (
                tuple(ts["out"][1].kv.k) if ts["out"][1].kv is not None else ())
