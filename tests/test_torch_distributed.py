"""The port's sharded serving on the CPU: gloo, ranks in spawned processes.

The phase functions that the sharded path composes (``core/tree.py``'s
register routes and ``subtree_search``, ``core/plans.py``'s phases) are held
to their JAX counterparts on the same numpy inputs, bit for bit.  Then
``BSTServer(mesh=...)`` runs in 4 spawned ranks over a gloo process group
(started from a ``file://`` store under the test's ``tmp_path``) on the JAX
sharded suite's drive pattern: every column must equal the port's
single-chip server's, on every rank, across compactions, with the same
per-op stats and fetch counts; for hrz and hyb the columns must also equal
the JAX package's sharded server's on a forced 4-device host.  Every spawned
group has its own time limit, so a hung rank fails its test only.
"""

import dataclasses
import gc
import os
import subprocess
import sys
import time
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as torch_mp  # noqa: E402

from repro.core import plans as JP  # noqa: E402
from repro.core import tree as JT  # noqa: E402
from repro.data.keysets import make_tree_data as j_make_tree_data  # noqa: E402
from repro_torch.analysis import gate, invariants, runtime  # noqa: E402
from repro_torch.core import distributed as dist_lib  # noqa: E402
from repro_torch.core import plans as TP  # noqa: E402
from repro_torch.core import tree as TT  # noqa: E402
from repro_torch.core.engine import BSTEngine, EngineConfig  # noqa: E402
from repro_torch.data.keysets import make_tree_data  # noqa: E402
from repro_torch.serving import BSTServer  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT_S = 240
# The JAX sharded suite's drive pattern (tests/test_differential.py).
N_KEYS, KEY_SEED, SPACING = 150, 3, 3
CHUNK, SCAN_K, CAPACITY, HIGH_WATER = 32, 4, 48, 40
ROUNDS, N_WRITES, N_READS = 4, 24, 96
POINT_OPS = ("lookup", "predecessor", "successor")
RANGE_OPS = ("range_count", "range_scan")


# ------------------------------------------------------------ phase functions
def _trees(height: int, seed: int):
    keys, values = j_make_tree_data((1 << (height + 1)) - 1 - seed, seed=seed)
    return JT.build_tree(keys, values), TT.build_tree(keys, values, device="cpu"), keys


def _queries(keys, size: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    pool = np.concatenate([keys, keys + 1, keys - 1, [-(2**31) + 1, 2**31 - 2]])
    return rng.choice(pool, size=size).astype(np.int32)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_fields_equal(got, want, tag=""):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _np(g).dtype == _np(w).dtype, tag
        np.testing.assert_array_equal(_np(g), _np(w), err_msg=tag)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("split", [0, 1, 2, 3])
@pytest.mark.parametrize("height", [3, 6, 9])
def test_register_routes_match_jax(height, split, seed):
    jt, tt, keys = _trees(height, seed)
    q = _queries(keys, 300, seed)
    reg_n = (1 << max(split, 1)) - 1
    jreg = (jt.keys[:reg_n], jt.values[:reg_n])
    treg = (tt.keys[:reg_n], tt.values[:reg_n])
    _assert_fields_equal(
        TP.route_phase(*treg, torch.from_numpy(q), split),
        JP.route_phase(*jreg, jnp.asarray(q), split), "route_phase",
    )
    t_dest, t_res = TP.route_phase_ordered(*treg, torch.from_numpy(q), split, height)
    j_dest, j_res = JP.route_phase_ordered(*jreg, jnp.asarray(q), split, height)
    _assert_fields_equal((t_dest,) + tuple(t_res), (j_dest,) + tuple(j_res), "ordered")


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("height,split", [(3, 1), (6, 2), (9, 3), (9, 0)])
def test_subtree_search_and_gather_indices_match_jax(height, split, seed):
    jt, tt, keys = _trees(height, seed)
    idx = TT.all_subtree_gather_indices(height, split)
    np.testing.assert_array_equal(idx, JT.all_subtree_gather_indices(height, split))
    assert idx.shape == (1 << split, (1 << (height - split + 1)) - 1)
    rng = np.random.default_rng(seed)
    q = _queries(keys, 200, seed)
    active = rng.random(200) > 0.2
    for s in range(1 << split):
        jk, jv = np.asarray(jt.keys)[idx[s]], np.asarray(jt.values)[idx[s]]
        got = TT.subtree_search(
            torch.from_numpy(jk), torch.from_numpy(jv), height - split,
            torch.from_numpy(q), torch.from_numpy(active),
        )
        want = JT.subtree_search(
            jnp.asarray(jk), jnp.asarray(jv), height - split, jnp.asarray(q), jnp.asarray(active)
        )
        _assert_fields_equal(got, want, f"subtree {s}")
        # the descent phase over the same subtree as a forest of one
        got = TP.descend_phase_ordered(
            torch.from_numpy(jk)[None], torch.from_numpy(jv)[None], height - split,
            torch.from_numpy(q)[None], torch.from_numpy(active)[None],
        )
        want = JP.descend_phase_ordered(
            jnp.asarray(jk)[None], jnp.asarray(jv)[None], height - split,
            jnp.asarray(q)[None], jnp.asarray(active)[None],
        )
        _assert_fields_equal(got, want, f"descend_phase_ordered {s}")
        got = TP.descend_phase(
            torch.from_numpy(jk)[None], torch.from_numpy(jv)[None], height - split,
            torch.from_numpy(q)[None], torch.from_numpy(active)[None],
        )
        want = JP.descend_phase(
            jnp.asarray(jk)[None], jnp.asarray(jv)[None], height - split,
            jnp.asarray(q)[None], jnp.asarray(active)[None],
        )
        _assert_fields_equal(got, want, f"descend_phase {s}")


def _random_ordered(rng, shape):
    i32 = lambda lo, hi: rng.integers(lo, hi, shape).astype(np.int32)  # noqa: E731
    return (
        i32(-5, 1000), rng.random(shape) > 0.5, i32(-(2**31), 1000), i32(-1, 1000),
        i32(0, 2**31 - 1), i32(-1, 1000), i32(0, 5000),
    )


def _t_ordered(fields):
    return TT.OrderedResult(*(torch.from_numpy(np.ascontiguousarray(f)) for f in fields))


def _j_ordered(fields):
    return JT.OrderedResult(*(jnp.asarray(f) for f in fields))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n_dest,capacity", [(4, 3), (4, 64), (2, 1), (8, 5)])
def test_dispatch_gather_combine_match_jax(n_dest, capacity, seed):
    rng = np.random.default_rng(seed)
    B = 64
    dest = rng.integers(0, n_dest, B).astype(np.int32)
    active = rng.random(B) > 0.25
    q = rng.integers(0, 10**6, B).astype(np.int32)
    tplan = TP.dispatch_phase("queue", torch.from_numpy(dest), n_dest, capacity,
                              active=torch.from_numpy(active))
    jplan = JP.dispatch_phase("queue", jnp.asarray(dest), n_dest, capacity,
                              active=jnp.asarray(active))
    _assert_fields_equal(tplan, jplan, "dispatch")
    _assert_fields_equal(TP.gather_phase(torch.from_numpy(q), tplan),
                         JP.gather_phase(jnp.asarray(q), jplan), "gather")
    sub = _random_ordered(rng, (n_dest, capacity))
    _assert_fields_equal(
        TP.combine_phase_ordered(_t_ordered(sub), tplan, B),
        JP.combine_phase_ordered(_j_ordered(sub), jplan, B), "combine_ordered",
    )
    reg_v = rng.integers(0, 100, B).astype(np.int32)
    reg_f = rng.random(B) > 0.7
    _assert_fields_equal(
        TP.combine_phase(torch.from_numpy(sub[0]), torch.from_numpy(sub[1]), tplan, B,
                         torch.from_numpy(reg_v), torch.from_numpy(reg_f)),
        JP.combine_phase(jnp.asarray(sub[0]), jnp.asarray(sub[1]), jplan, B,
                         jnp.asarray(reg_v), jnp.asarray(reg_f)),
        "combine",
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_merge_where_match_jax(seed):
    rng = np.random.default_rng(seed)
    a, b = _random_ordered(rng, (50,)), _random_ordered(rng, (50,))
    t_packed = TP.pack_ordered(_t_ordered(a))
    j_packed = JP.pack_ordered(_j_ordered(a))
    assert t_packed.shape == (50, invariants.ORDERED_PACK_WIDTH)
    np.testing.assert_array_equal(t_packed.numpy(), np.asarray(j_packed))
    _assert_fields_equal(TP.unpack_ordered(t_packed), JP.unpack_ordered(j_packed), "unpack")
    _assert_fields_equal(TP.unpack_ordered(t_packed), _t_ordered(a), "round trip")
    _assert_fields_equal(TP.merge_ordered(_t_ordered(a), _t_ordered(b)),
                         JP.merge_ordered(_j_ordered(a), _j_ordered(b)), "merge")
    mask = rng.random(50) > 0.5
    _assert_fields_equal(
        TP.where_ordered(torch.from_numpy(mask), _t_ordered(a), _t_ordered(b)),
        JP.where_ordered(jnp.asarray(mask), _j_ordered(a), _j_ordered(b)), "where",
    )
    assert invariants.ORDERED_FIELDS == TT.OrderedResult._fields


def test_strategy_axes_and_invariants():
    assert TP.SHARDED_STRATEGIES == JP.SHARDED_STRATEGIES
    for s in TP.SHARDED_STRATEGIES:
        assert TP.mesh_axis_for_strategy(s) == JP.mesh_axis_for_strategy(s)
    with pytest.raises(ValueError):
        TP.mesh_axis_for_strategy("Hyb4")
    assert invariants.capacity_for_trace(2048, 4, 2.0) == 1024
    assert invariants.capacity_for_trace(8, 4, 100.0) == 8  # clamped to the batch
    with pytest.raises(ValueError, match="divisible"):
        invariants.check_chunk_divides(30, 4, "model")
    with pytest.raises(RuntimeError, match="process group"):
        dist_lib.make_serving_mesh("hrz", "cpu")  # no group in this process


def test_only_nccl_on_the_card_runs_the_sharded_program_as_graphs():
    assert dist_lib.captures_collectives("cuda", "nccl")
    assert dist_lib.captures_collectives(torch.device("cuda", 1), dist.Backend.NCCL)
    for device, backend in (("cuda", "gloo"), ("cpu", "gloo"), ("cpu", "nccl")):
        assert not dist_lib.captures_collectives(device, backend)


@pytest.mark.parametrize("strategy", ["hrz", "dup", "hyb"])
def test_runner_over_gloo_is_eager_and_reshards_in_place(strategy):
    """In one world-1 gloo group in this process: the runner says it is
    eager and captures nothing; ``run`` equals ``eager=True`` and the
    engine, with and without a buffer; ``reshard`` keeps the shard
    tensors for the same snapshot and cuts new ones for another height."""
    keys, values = make_tree_data(N_KEYS, seed=KEY_SEED, spacing=SPACING)
    cfg = _config(strategy)
    eng = BSTEngine(keys, values, cfg)
    q = torch.from_numpy(_queries(keys, 64, seed=1))
    hi = q + 9
    with gate.world1_group("cpu"):
        mesh = dist_lib.make_serving_mesh(strategy, "cpu")
        run = dist_lib.make_sharded_query(eng.tree, mesh, strategy, plan=eng.plan)
        assert (run.compiled, run.strategy, run.n_shards) == (False, strategy, 1)
        assert tuple(run.static_input("range_scan", 64, slot=1).shape) == (2, 64)
        assert tuple(run.static_input("lookup", 64, slot=1).shape) == (1, 64)
        for op in TP.QUERY_OPS:
            args = (q, hi) if op in RANGE_OPS else (q,)
            for kw in ({}, {"delta": eng.delta, "delta_ops": eng.delta_operands}):
                got = run(op, *args, k=SCAN_K, **kw)
                for want in (run(op, *args, k=SCAN_K, eager=True, **kw),
                             eng.query(op, *args, k=SCAN_K) if kw else
                             TP.ordered_query(eng.plan, op, *args, k=SCAN_K)):
                    _assert_fields_equal(_fields(got), _fields(want), f"{strategy} {op} {kw}")
        assert run.graph_keys() == ()
        ptrs = [t.data_ptr() for pair in run.shards for t in pair]
        assert run.reshard(eng.tree, eng.plan) is True
        assert [t.data_ptr() for pair in run.shards for t in pair] == ptrs
        grown = TT.build_tree(*make_tree_data(2 * N_KEYS, seed=KEY_SEED, spacing=SPACING),
                              device="cpu")
        assert run.reshard(grown, None) is False and run.tree is grown
        new = [t.data_ptr() for pair in run.shards for t in pair]
        assert all(p != n for p, n in zip(ptrs, new))
        _assert_fields_equal(run("lookup", q), TT.search_reference(grown, q), strategy)


def test_sharded_runner_construction_errors():
    keys, values = make_tree_data(N_KEYS, seed=KEY_SEED, spacing=SPACING)
    tree = TT.build_tree(keys, values, device="cpu")
    other = TT.build_tree(keys, values, device="cpu")
    with gate.world1_group("cpu"):
        model = dist_lib.make_serving_mesh("hrz", "cpu")
        with pytest.raises(ValueError, match="shards over mesh axis 'data'"):
            dist_lib.make_sharded_query(tree, model, "dup")
        with pytest.raises(ValueError, match="no 'data' axis"):
            dist_lib.make_dup_query(tree, model)
        with pytest.raises(ValueError, match="another snapshot"):
            dist_lib.make_distributed_query(
                tree, model, plan=TP.make_plan(other, strategy="hrz"))
        run = dist_lib.make_distributed_query(tree, model)
        with pytest.raises(ValueError, match="differ"):
            run("range_count", keys[:8], keys[:7])
        with pytest.raises(ValueError, match="unknown op"):
            run("median", keys[:8])
    assert not dist.is_initialized()


def _fields(res) -> tuple:
    return res if isinstance(res, tuple) else (res,)


# ------------------------------------------------------------ spawned ranks
def _spawn(fn, nprocs: int, store: str, *args) -> None:
    """Run ``fn(rank, nprocs, *args)`` in ``nprocs`` spawned ranks of a gloo
    group started from the ``file://`` store ``store``; fail (and kill the
    rest) if one raises or they outlast ``SPAWN_TIMEOUT_S``."""
    ctx = torch_mp.start_processes(
        _rank_main, args=(nprocs, store, fn) + args, nprocs=nprocs, join=False,
        start_method="spawn",
    )
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise AssertionError(f"ranks still running after {SPAWN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


def _rank_main(rank: int, world: int, store: str, fn, *args) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def _config(strategy: str, **kw) -> EngineConfig:
    return EngineConfig(
        strategy=strategy, n_trees=1 if strategy == "hrz" else 4, device="cpu",
        delta_capacity=CAPACITY, delta_high_water=HIGH_WATER, **kw,
    )


def _submit_round(srv, spec, r: int) -> list:
    """One round of the JAX suite's pattern: writes, deletes, then every
    read op over the same keys (ranges [q, q + span])."""
    q, span = spec[f"q{r}"], spec[f"span{r}"]
    tickets = [srv.submit_write(spec[f"wk{r}"], spec[f"wv{r}"]),
               srv.submit_delete(spec[f"dk{r}"])]
    tickets += [srv.submit(q, op=op) for op in POINT_OPS]
    tickets += [srv.submit_range(q, q + span, op=op) for op in RANGE_OPS]
    return tickets


def _drive_spec(path: str, seed: int = 5) -> None:
    rng = np.random.default_rng(seed)
    spec = {}
    for r in range(ROUNDS):
        spec[f"wk{r}"] = rng.integers(1, 600, N_WRITES).astype(np.int32)
        spec[f"wv{r}"] = rng.integers(0, 10**6, N_WRITES).astype(np.int32)
        spec[f"dk{r}"] = rng.integers(1, 600, N_WRITES // 3).astype(np.int32)
        spec[f"q{r}"] = rng.integers(1, 660, N_READS).astype(np.int32)
        spec[f"span{r}"] = rng.integers(0, 40, N_READS).astype(np.int32)
    np.savez(path, **spec)


def _stats_tuple(st):
    return (st.requests, st.submitted, st.served, st.found, st.chunks, st.lanes,
            st.updates, st.compactions,
            {op: (o.served, o.lanes, o.chunks) for op, o in st.per_op.items()})


def _serve_worker(rank, world, strategy, spec_path, out_dir):
    """Sharded against single-chip on the same submissions; every rank
    checks, and saves its sharded columns for the test to compare."""
    keys, values = make_tree_data(N_KEYS, seed=KEY_SEED, spacing=SPACING)
    cfg = _config(strategy)
    mesh = dist_lib.make_serving_mesh(strategy, "cpu")
    srv = BSTServer(keys, values, cfg, chunk_size=CHUNK, scan_k=SCAN_K, mesh=mesh)
    ref = BSTServer(keys, values, cfg, chunk_size=CHUNK, scan_k=SCAN_K)
    spec = np.load(spec_path)
    out = {}
    if strategy != "dup":
        # this rank's shard is row ``rank`` of the JAX package's gather
        sub_keys, sub_vals, split, sub_h = dist_lib.shard_subtrees(srv.snapshot, mesh, "model")
        out["shard_keys"], out["shard_values"] = sub_keys.numpy(), sub_vals.numpy()
        assert (split, sub_h) == (2, srv.snapshot.height - 2)
    run = srv.sharded_query
    assert run.compiled is False  # gloo: the sharded program runs eagerly
    compacted_before = []
    for r in range(ROUNDS):
        ts, tr = _submit_round(srv, spec, r), _submit_round(ref, spec, r)
        ptrs, height = _shard_ptrs(run), srv.snapshot.height
        f0 = runtime.fetch_count()
        got = srv.drain()
        f1 = runtime.fetch_count()
        # every compaction of the drive keeps the height: the shards are
        # rewritten where they are, so graphs over them would stay valid
        assert srv.snapshot.height == height and _shard_ptrs(run) == ptrs
        want = ref.drain()
        f2 = runtime.fetch_count()
        assert f1 - f0 == f2 - f1, (r, f1 - f0, f2 - f1)
        for i, (a, b) in enumerate(zip(ts, tr)):
            assert len(got[a]) == len(want[b])
            for c, (g, w) in enumerate(zip(got[a], want[b])):
                assert g.dtype == w.dtype and np.array_equal(g, w), (strategy, r, i, c)
                out[f"r{r}_{i}_{c}"] = g
        compacted_before.append(srv.stats.compactions)
    assert _stats_tuple(srv.stats) == _stats_tuple(ref.stats)
    # reads before and after a compaction were both compared
    assert compacted_before[0] < compacted_before[-1], compacted_before
    read_chunks = sum(srv.stats.per_op[op].chunks for op in POINT_OPS + RANGE_OPS)
    assert read_chunks == ROUNDS * (len(POINT_OPS) * 3 + len(RANGE_OPS) * 3)
    nodes = srv.memory_nodes_per_device()
    h = srv.snapshot.height
    want_nodes = (1 << (h + 1)) - 1 if strategy == "dup" else (1 << (h - 1)) - 1 + 3
    assert nodes == want_nodes, (nodes, want_nodes)
    # 100 fresh keys: two compactions that keep the height, then one that
    # grows the tree; only the growth cuts new shards
    seen = []
    compact = srv.engine.compact

    def tracked():
        before = (srv.snapshot.height, _shard_ptrs(run))
        out = compact()
        seen.append((before, (srv.snapshot.height, _shard_ptrs(run))))
        return out

    srv.engine.compact = tracked
    fresh = np.arange(701, 901, 2, dtype=np.int32)
    for server in (srv, ref):
        server.submit_write(fresh, fresh * 5)
    ts = [srv.submit(fresh - 1, op=op) for op in POINT_OPS]
    tr = [ref.submit(fresh - 1, op=op) for op in POINT_OPS]
    got, want = srv.drain(), ref.drain()
    assert [(a[0], b[0]) for a, b in seen] == [(7, 7), (7, 7), (7, 8)], seen
    for (h0, p0), (h1, p1) in seen:
        assert (p1 == p0) if h1 == h0 else all(x != y for x, y in zip(p0, p1))
    for a, b in zip(ts, tr):
        for g, w in zip(got[a], want[b]):
            assert np.array_equal(g, w), strategy
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


def _shard_ptrs(run) -> list:
    return [t.data_ptr() for pair in run.shards for t in pair]


def _run_port(tmp_path, strategy: str, spec_path: str) -> list:
    out_dir = tmp_path / f"port_{strategy}"
    out_dir.mkdir()
    _spawn(_serve_worker, 4, str(tmp_path / f"store_{strategy}"), strategy, spec_path, str(out_dir))
    return [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(4)]


@pytest.mark.parametrize("strategy", ["hrz", "dup", "hyb"])
def test_sharded_server_matches_single_chip_on_four_ranks(tmp_path, strategy):
    spec_path = str(tmp_path / "spec.npz")
    _drive_spec(spec_path)
    ranks = _run_port(tmp_path, strategy, spec_path)
    cols = [k for k in ranks[0] if k.startswith("r")]
    # per round: write 1, delete 1, lookup 2, predecessor 3, successor 3,
    # range_count 1, range_scan 3 columns
    assert len(cols) == ROUNDS * 14
    for other in ranks[1:]:  # every rank returns the whole columns
        for k in cols:
            np.testing.assert_array_equal(other[k], ranks[0][k], err_msg=k)
    if strategy != "dup":
        jt = JT.build_tree(*j_make_tree_data(N_KEYS, seed=KEY_SEED, spacing=SPACING))
        idx = JT.all_subtree_gather_indices(jt.height, 2)
        for r, got in enumerate(ranks):
            np.testing.assert_array_equal(got["shard_keys"][0], np.asarray(jt.keys)[idx[r]])
            np.testing.assert_array_equal(got["shard_values"][0], np.asarray(jt.values)[idx[r]])


_JAX_DRIVE = """
from repro.core import distributed as D
from repro.core.engine import EngineConfig
from repro.data.keysets import make_tree_data
from repro.serving import BSTServer

strategy, spec_path, out_path = {strategy!r}, {spec!r}, {out!r}
keys, values = make_tree_data({n_keys}, seed={key_seed}, spacing={spacing})
cfg = EngineConfig(strategy=strategy, n_trees=1 if strategy == "hrz" else 4,
                   use_kernel=False, delta_capacity={capacity}, delta_high_water={high_water})
srv = BSTServer(keys, values, cfg, chunk_size={chunk}, scan_k={scan_k},
                mesh=D.make_serving_mesh(strategy))
spec = np.load(spec_path)
out = {{}}
for r in range({rounds}):
    q, span = spec[f"q{{r}}"], spec[f"span{{r}}"]
    ts = [srv.submit_write(spec[f"wk{{r}}"], spec[f"wv{{r}}"]), srv.submit_delete(spec[f"dk{{r}}"])]
    ts += [srv.submit(q, op=op) for op in ("lookup", "predecessor", "successor")]
    ts += [srv.submit_range(q, q + span, op=op) for op in ("range_count", "range_scan")]
    got = srv.drain()
    for i, t in enumerate(ts):
        for c, col in enumerate(got[t]):
            out[f"r{{r}}_{{i}}_{{c}}"] = np.asarray(col)
np.savez(out_path, **out)
print("compactions", srv.stats.compactions)
"""


@pytest.mark.parametrize("strategy", ["hrz", "hyb"])
def test_sharded_server_matches_the_jax_sharded_server(tmp_path, multi_device_host, strategy):
    spec_path = str(tmp_path / "spec.npz")
    _drive_spec(spec_path, seed=7)
    jax_out = str(tmp_path / "jax.npz")
    multi_device_host(_JAX_DRIVE.format(
        strategy=strategy, spec=spec_path, out=jax_out, n_keys=N_KEYS, key_seed=KEY_SEED,
        spacing=SPACING, capacity=CAPACITY, high_water=HIGH_WATER, chunk=CHUNK,
        scan_k=SCAN_K, rounds=ROUNDS,
    ), devices=4, timeout=SPAWN_TIMEOUT_S)
    want = dict(np.load(jax_out))
    got = _run_port(tmp_path, strategy, spec_path)[0]
    cols = [k for k in got if k.startswith("r")]
    assert sorted(cols) == sorted(want)
    for k in cols:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _skew_worker(rank, world, strategy, slack, out_dir):
    """Every key of every chunk in subtree 0, and hyb's buffers cut to
    ``slack`` of the fair share: below the local batch K4 overflows, the
    stall round and the drain round carry live keys, and the answers stay
    the single-chip server's."""
    keys, values = make_tree_data(N_KEYS, seed=KEY_SEED, spacing=SPACING)
    cfg = _config(strategy, buffer_slack=slack)
    rounds = []
    real_dispatch = TP.dispatch_phase

    def recording_dispatch(mapping, dest, n_dest, capacity, active=None):
        plan = real_dispatch(mapping, dest, n_dest, capacity, active=active)
        rounds.append((capacity, int(active.sum()), int(plan.overflow.sum())))
        return plan

    srv = BSTServer(keys, values, cfg, chunk_size=CHUNK, scan_k=SCAN_K,
                    mesh=dist_lib.make_serving_mesh(strategy, "cpu"))
    ref = BSTServer(keys, values, cfg, chunk_size=CHUNK, scan_k=SCAN_K)
    rng = np.random.default_rng(11)
    low = keys[: keys.size // 5]  # below every register-layer split key
    q = (rng.choice(low, 4 * CHUNK) + rng.integers(-1, 2, 4 * CHUNK)).astype(np.int32)
    hi = (q + rng.integers(0, 6, q.size)).astype(np.int32)
    TP.dispatch_phase = recording_dispatch
    try:
        ts = [srv.submit(q, op=op) for op in POINT_OPS]
        ts += [srv.submit_range(q, hi, op=op) for op in RANGE_OPS]
        got = srv.drain()
    finally:
        TP.dispatch_phase = real_dispatch
    tr = [ref.submit(q, op=op) for op in POINT_OPS]
    tr += [ref.submit_range(q, hi, op=op) for op in RANGE_OPS]
    want = ref.drain()
    for a, b in zip(ts, tr):
        for g, w in zip(got[a], want[b]):
            assert np.array_equal(g, w)
    np.save(os.path.join(out_dir, f"rank{rank}.npy"), np.asarray(rounds, np.int64))


@pytest.mark.parametrize("strategy", ["hrz", "hyb"])
def test_skewed_chunks_take_the_stall_and_drain_rounds(tmp_path, strategy):
    _spawn(_skew_worker, 4, str(tmp_path / "store"), strategy, 0.25, str(tmp_path))
    chunks = len(POINT_OPS) * 4 + len(RANGE_OPS) * 4
    for r in range(4):
        rounds = np.load(tmp_path / f"rank{r}.npy")
        if strategy == "hrz":  # stall-free: one round at the local batch a chunk
            assert len(rounds) == chunks
            assert (rounds[:, 2] == 0).all()
            continue
        assert len(rounds) == 3 * chunks  # first round, stall round, drain round
        first, stall, drain = rounds[0::3], rounds[1::3], rounds[2::3]
        assert (first[:, 2] > 0).all()  # every chunk overflowed its buffers
        assert (stall[:, 1] == first[:, 2]).all()  # the stall round takes the overflow
        assert (drain[:, 1] == stall[:, 2]).all() and (drain[:, 1] > 0).all()
        assert (drain[:, 2] == 0).all()  # the drain round at the local batch places every key
        assert (drain[:, 0] > first[:, 0]).all()


def test_hyb_at_one_rank_takes_one_round(tmp_path):
    """At one rank hyb's per-batch depth (twice the fair share) is the whole
    local batch: nothing can overflow, so the host runs one stall-free
    round a chunk, with no stall or drain round behind it."""
    _spawn(_skew_worker, 1, str(tmp_path / "store"), "hyb", 2.0, str(tmp_path))
    rounds = np.load(tmp_path / "rank0.npy")
    assert len(rounds) == len(POINT_OPS) * 4 + len(RANGE_OPS) * 4
    assert (rounds[:, 2] == 0).all()
    lanes = [CHUNK] * (len(POINT_OPS) * 4) + [2 * CHUNK] * (len(RANGE_OPS) * 4)
    assert rounds[:, 0].tolist() == lanes  # the depth is the local batch (lo || hi for ranges)


def _bulk_swap_worker(rank, world, strategy):
    """Without a buffer, ``apply_updates`` rebuilds the snapshot; the
    engine's ``on_snapshot`` hook re-shards it before the next read, and the
    shards grow with the tree."""
    keys, values = make_tree_data(N_KEYS, seed=KEY_SEED, spacing=SPACING)
    cfg = dataclasses.replace(_config(strategy), delta_capacity=0, delta_high_water=None)
    srv = BSTServer(keys, values, cfg, chunk_size=CHUNK, scan_k=SCAN_K,
                    mesh=dist_lib.make_serving_mesh(strategy, "cpu"))
    ref = BSTServer(keys, values, cfg, chunk_size=CHUNK, scan_k=SCAN_K)
    rng = np.random.default_rng(13)
    new_keys = (np.arange(N_KEYS, 2 * N_KEYS) * SPACING + 1).astype(np.int32)
    gone = rng.choice(keys, 20, replace=False)
    for server in (srv, ref):
        server.apply_updates(new_keys, new_keys * 7, gone)
    assert srv.stats.snapshot_swaps == ref.stats.snapshot_swaps == 1
    h = srv.snapshot.height
    assert h == 8  # 280 keys: one level more than the 150 it started with
    q = rng.integers(0, 3 * N_KEYS * SPACING, 200).astype(np.int32)
    ts = [srv.submit(q, op=op) for op in POINT_OPS]
    ts += [srv.submit_range(q, q + 30, op=op) for op in RANGE_OPS]
    tr = [ref.submit(q, op=op) for op in POINT_OPS]
    tr += [ref.submit_range(q, q + 30, op=op) for op in RANGE_OPS]
    got, want = srv.drain(), ref.drain()
    for a, b in zip(ts, tr):
        for g, w in zip(got[a], want[b]):
            assert np.array_equal(g, w)
    nodes = srv.memory_nodes_per_device()
    assert nodes == ((1 << (h + 1)) - 1 if strategy == "dup" else (1 << (h - 1)) - 1 + 3)
    # The snapshot hook holds the server weakly: with the collector off, a
    # dropped server and its mesh are freed at once, so the process group
    # dies in destroy_process_group and not at interpreter exit.
    gc.disable()
    try:
        server, mesh = weakref.ref(srv), weakref.ref(srv.mesh)
        del srv
        assert server() is None and mesh() is None
    finally:
        gc.enable()


@pytest.mark.parametrize("strategy", ["hrz", "dup", "hyb"])
def test_bulk_update_without_a_buffer_reshards(tmp_path, strategy):
    _spawn(_bulk_swap_worker, 4, str(tmp_path / "store"), strategy)


def _lookup_shorthands_worker(rank, world):
    """The membership shorthands against the plain descent: a per-(src,
    dst) capacity of 3 (``capacity_frac`` 0.75 of the 16-lane local batch's
    fair share of 4: stall round and drain round), the stall-free default,
    and dup's 2-output fast path."""
    keys, values = make_tree_data(N_KEYS, seed=KEY_SEED, spacing=SPACING)
    tree = TT.build_tree(keys, values, device="cpu")
    q = torch.from_numpy(_queries(keys, 64, seed=0))  # the same on every rank
    want = TT.search_reference(tree, q)
    model = dist_lib.make_serving_mesh("hrz", "cpu")
    for frac in (0.75, None):
        run = dist_lib.make_distributed_lookup(tree, model, capacity_frac=frac)
        assert (run.capacity_frac, run.split_level) == (frac, 2)
        _assert_fields_equal(run(q), want, f"capacity_frac {frac}")
    run = dist_lib.make_dup_lookup(tree, dist_lib.make_serving_mesh("dup", "cpu"))
    _assert_fields_equal(run(q), want, "dup")


def test_lookup_shorthands_on_four_ranks(tmp_path):
    _spawn(_lookup_shorthands_worker, 4, str(tmp_path / "store"))


def _errors_worker(rank, world):
    keys, values = make_tree_data(N_KEYS, seed=KEY_SEED, spacing=SPACING)
    model = dist_lib.make_serving_mesh("hrz", "cpu")
    data = dist_lib.make_serving_mesh("dup", "cpu")
    for strategy, mesh, chunk, match in (
        ("hrz", model, 32, "divisible"),  # 32 lanes over 3 ranks
        ("hyb", model, 30, "power of two"),  # 3 subtrees
        ("hrz", model, 30, "power of two"),
        ("hrz", data, 30, "shards over axis 'model'"),  # strategy and mesh axis
        ("dup", model, 30, "shards over axis 'data'"),
    ):
        try:
            BSTServer(keys, values, _config(strategy), chunk_size=chunk, mesh=mesh)
        except ValueError as e:
            assert match in str(e), (strategy, chunk, str(e))
        else:
            raise AssertionError(f"{strategy} at chunk {chunk} over 3 ranks was accepted")
    # dup needs no power of two: a 3-rank lookup
    srv = BSTServer(keys, values, _config("dup"), chunk_size=30, mesh=data)
    v, f = srv.lookup(keys[:40])
    assert f.all() and np.array_equal(v, values[:40])


def test_sharded_construction_errors_on_three_ranks(tmp_path):
    _spawn(_errors_worker, 3, str(tmp_path / "store"))


@pytest.mark.parametrize("strategy", ["hrz", "dup", "hyb"])
def test_launch_serve_bst_at_world_one(strategy):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--bst", "--device", "cpu",
         "--bst-strategy", strategy, "--requests", "2000", "--chunk", "256"],
        capture_output=True, text=True, timeout=SPAWN_TIMEOUT_S, env=env, cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr
    assert f"sharded {strategy} x 1 gloo ranks on cpu: 2000 lookups" in out.stdout
    assert "2000 found" in out.stdout
    assert "16/16 fresh keys found" in out.stdout
