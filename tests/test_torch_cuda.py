"""The port's CUDA kernels on the card, held against their plain versions.

Every test here needs a CUDA card and skips without one.  The file imports
torch, numpy and the port only (the machine with the card has no JAX), so it
runs there on its own:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses
import functools
import gc
import importlib
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as TC  # noqa: E402
from repro_torch import graphs  # noqa: E402
from repro_torch.analysis import __main__ as analysis_main  # noqa: E402
from repro_torch.analysis import gate, invariants, report, runtime  # noqa: E402
from repro_torch.core import delta as TD  # noqa: E402
from repro_torch.core import tree as TT  # noqa: E402
from repro_torch.core import distributed as TDist  # noqa: E402
from repro_torch.core.engine import (  # noqa: E402
    PAPER_CONFIGS,
    BSTEngine,
    EngineConfig,
    ingest_ladder,
)
from repro_torch.data.keysets import make_tree_data  # noqa: E402
from repro_torch.kernels import bst_search as K  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import queue_dispatch as QD  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.training.train_loop import (  # noqa: E402
    TrainConfig,
    init_train_state,
    make_train_step,
)
from repro_torch.serving import (  # noqa: E402
    BSTServer,
    decode_graph,
    greedy_generate,
    make_prefill_fn,
    make_serve_step,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    return torch.device("cuda")


def _case(n_keys, size, seed):
    keys, values = make_tree_data(n_keys, seed=seed)
    rng = np.random.default_rng(seed)
    q = rng.choice(np.concatenate([keys, keys + 1, keys - 1]), size).astype(np.int32)
    return keys, values, TT.build_tree(keys, values, device="cpu"), torch.from_numpy(q)


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.is_cuda and g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.cpu(), w.cpu())


def test_ops_on_cuda_tensors_launch_the_kernels(cuda_device):
    _, _, tt, q = _case(1023, 2000, seed=7)
    tk, tv, qc = tt.keys.to(cuda_device), tt.values.to(cuda_device), q.to(cuda_device)
    K.reset_launches()
    got = ops.bst_ordered_forest(tk[None], tv[None], qc[None], tt.height)
    assert K.LAUNCHES == {"forest_descend": 1, "hybrid_descend": 0,
                          "forest_descend_delta": 0, "hybrid_descend_delta": 0}
    _same(got, ref.bst_ordered_ref(tt.keys[None], tt.values[None], q[None], tt.height))
    got = ops.bst_search_forest(tk[None], tv[None], qc.reshape(4, -1), tt.height,
                                shared_tree=True)
    assert K.LAUNCHES["forest_descend"] == 2
    _same(got, ref.bst_search_ref(tt.keys[None], tt.values[None], q.reshape(4, -1), tt.height))

    overflow = torch.zeros(2000, dtype=torch.int32, device=cuda_device)
    got = ops.bst_hybrid_forest(tk, tv, qc, tt.height, 3, "queue", 16, overflow_out=overflow)
    assert K.LAUNCHES["hybrid_descend"] == 1
    want_ovf = torch.zeros(2000, dtype=torch.int32)
    want = ref.bst_hybrid_ref(tt.keys, tt.values, q, tt.height, 3, "queue", 16,
                              overflow_out=want_ovf)
    _same(got + (overflow,), want + (want_ovf,))
    assert int(want_ovf.sum()) > 0  # a depth of 16 per subtree overflows


def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    _, _, tt, q = _case(63, 64, seed=1)
    tk, tv, qc = tt.keys.to(cuda_device), tt.values.to(cuda_device), q.to(cuda_device)
    with pytest.raises(ValueError, match="int32"):
        K.bst_ordered_forest_cuda(tk[None], tv[None], qc[None].long(), tt.height)
    with pytest.raises(ValueError, match="contiguous"):
        K.bst_ordered_forest_cuda(tk[None], tv[None], qc.reshape(8, 8).t(), tt.height,
                                  shared_tree=True)
    with pytest.raises(ValueError, match="is on cpu"):
        K.bst_ordered_forest_cuda(tt.keys[None], tt.values[None], qc[None], tt.height)
    with pytest.raises(ValueError, match="overflow_out"):
        K.bst_hybrid_forest_cuda(tk, tv, qc, tt.height, 2, "queue", 4,
                                 overflow_out=torch.zeros_like(qc[:-1]))


@pytest.mark.parametrize("name", list(PAPER_CONFIGS))
def test_engine_on_the_card_matches_the_engine_on_the_cpu(cuda_device, name):
    keys, values, _, q = _case(4095, 3000, seed=3)
    eng = BSTEngine(keys, values, PAPER_CONFIGS[name])
    cpu = BSTEngine(keys, values, dataclasses.replace(PAPER_CONFIGS[name], device="cpu"))
    lo, hi = q[:1000], q[:1000] + 40
    for op, args in (("lookup", (q,)), ("predecessor", (q,)), ("successor", (q,)),
                     ("range_count", (lo, hi)), ("range_scan", (lo, hi))):
        got, want = eng.query(op, *args), cpu.query(op, *args)
        if not isinstance(got, tuple):
            got, want = (got,), (want,)
        _same(got, want)


def _buffer(keys, tree, C, seed, device):
    """A delta buffer of capacity C on ``device``, filled by the port's own
    ingest: upserts of new odd keys, overwrites and tombstones of stored
    keys, tombstones of absent keys."""
    rng = np.random.default_rng(seed)
    m = C
    k = np.concatenate([keys[rng.choice(keys.size, m - m // 2, replace=False)],
                        rng.choice(keys.size, m // 2, replace=False).astype(np.int32) * 2 + 1])
    k = torch.from_numpy(rng.permutation(k).astype(np.int32)).to(device)
    v = torch.from_numpy(rng.integers(0, 2**31 - 1, m, dtype=np.int32)).to(device)
    d = torch.from_numpy(rng.random(m) < 0.3).to(device)
    res = ops.bst_ordered_forest(tree.keys[None], tree.values[None], k[None], tree.height)
    ok = torch.ones(m, dtype=torch.bool, device=device)
    return TD.ingest(TD.empty(C, device), k, v, d, ok, res[1][0], res[6][0])


@pytest.mark.parametrize("C", [1, 64, 4096])
def test_delta_kernels_match_their_plain_versions(cuda_device, C):
    keys, values = make_tree_data(32767, seed=C)
    tree = TT.build_tree(keys, values, device=cuda_device)
    buf = _buffer(keys, tree, C, seed=C, device=cuda_device)
    d_ops = TD.operands(buf)
    rng = np.random.default_rng(1)
    pool = np.concatenate([keys, keys + 1, buf.keys[: int(buf.count)].cpu().numpy()])
    q = torch.from_numpy(rng.choice(pool, 4096).astype(np.int32)).to(cuda_device)
    act = torch.from_numpy(rng.random(4096) > 0.1).to(cuda_device)
    K.reset_launches()
    for ordered in (False, True):
        for T in (1, 4):
            qq, aa = q.reshape(T, -1), act.reshape(T, -1)
            got = K.bst_ordered_forest_cuda(tree.keys[None], tree.values[None], qq, tree.height,
                                            active=aa, shared_tree=T > 1, ordered=ordered,
                                            delta=d_ops)
            want = ref.bst_ordered_ref(tree.keys[None], tree.values[None], qq, tree.height, aa,
                                       ordered=ordered, delta=d_ops)
            _same(got, want)
        for split, mapping in ((2, "queue"), (3, "direct")):
            cap = invariants.buffer_capacity(512, 1 << split, 2.0)
            ko, ro = torch.zeros_like(q), torch.zeros_like(q)
            got = K.bst_hybrid_forest_cuda(tree.keys, tree.values, q, tree.height, split, mapping,
                                           cap, active=act, ordered=ordered, overflow_out=ko,
                                           delta=d_ops)
            want = ref.bst_hybrid_ref(tree.keys, tree.values, q, tree.height, split, mapping, cap,
                                      active=act, ordered=ordered, overflow_out=ro, delta=d_ops)
            _same(got + (ko,), want + (ro,))
    assert K.LAUNCHES["forest_descend_delta"] == 4 and K.LAUNCHES["hybrid_descend_delta"] == 4
    assert K.LAUNCHES["forest_descend"] == K.LAUNCHES["hybrid_descend"] == 0


def test_forest_delta_kernel_takes_large_buffers(cuda_device):
    """K2 forest at C = 20,000 (past the ~14,400 the staged form took) and
    140,000 (sampled lines of 64 slots for membership and 128 ordered):
    equal to its plain version for hrz, dup4 and three unshared rows, both
    configurations; then an hrz and a dup4 engine with a 140,000-slot
    buffer built and read on the card, against a dict oracle."""
    for C in (20000, 140000):
        keys, values = make_tree_data(262143, seed=C)
        tree = TT.build_tree(keys, values, device=cuda_device)
        buf = _buffer(keys, tree, C, seed=C, device=cuda_device)
        d_ops = TD.operands(buf)
        rng = np.random.default_rng(C)
        pool = np.concatenate([keys, keys + 1, buf.keys[: int(buf.count)].cpu().numpy()])
        q = torch.from_numpy(rng.choice(pool, 4 * 4100).astype(np.int32)).to(cuda_device)
        act = torch.from_numpy(rng.random(4 * 4100) > 0.1).to(cuda_device)
        for ordered in (False, True):
            for T, rows in ((1, 1), (4, 1), (3, 3)):
                qq, aa = q[: T * 4100].reshape(T, -1), act[: T * 4100].reshape(T, -1)
                fk = tree.keys[None].repeat(rows, 1)
                fv = (tree.values[None] + torch.arange(rows, device=cuda_device)[:, None]).int()
                got = K.bst_ordered_forest_cuda(fk, fv, qq, tree.height, active=aa,
                                                shared_tree=rows < T, ordered=ordered,
                                                delta=d_ops)
                want = ref.bst_ordered_ref(fk, fv, qq, tree.height, aa, ordered=ordered,
                                           delta=d_ops)
                _same(got, want)
    keys, values = make_tree_data(32767, seed=3)
    rng = np.random.default_rng(3)
    wk = np.unique(rng.integers(1, 2**20, 20000, dtype=np.int32))
    wv = rng.integers(0, 2**31 - 1, wk.size, dtype=np.int32)
    wd = rng.random(wk.size) < 0.25
    want = dict(zip(keys.tolist(), values.tolist()))
    for k, v, d in zip(wk.tolist(), wv.tolist(), wd.tolist()):
        if d:
            want.pop(k, None)
        else:
            want[k] = v
    q = np.concatenate([wk, keys[:5000], wk + 1]).astype(np.int32)
    for name in ("Hrz", "Dup4"):
        eng = BSTEngine(keys, values, dataclasses.replace(PAPER_CONFIGS[name],
                                                          delta_capacity=140_000))
        eng.apply_ops(wk, wv, wd)
        assert eng.pending_writes() == wk.size and eng.compactions == 0
        K.reset_launches()
        val, found = (t.cpu().numpy() for t in eng.lookup(q))
        assert K.LAUNCHES["forest_descend_delta"] > 0
        assert found.tolist() == [k in want for k in q.tolist()]
        assert val[found].tolist() == [want[k] for k in q[found].tolist()]


def _hybrid_same(cuda_device, tree, q, act, split, mapping, cap, ordered, delta=None):
    """The hybrid kernel (K3, or K2 with ``delta``) against ``bst_hybrid_ref``
    on the CPU, overflow mask included; returns the lanes replayed."""
    dev = cuda_device
    ko = torch.full(q.shape, -7, dtype=torch.int32, device=dev)
    ro = torch.full(q.shape, -7, dtype=torch.int32)
    got = K.bst_hybrid_forest_cuda(
        tree.keys.to(dev), tree.values.to(dev), q.to(dev), tree.height, split, mapping, cap,
        active=None if act is None else act.to(dev), ordered=ordered, overflow_out=ko,
        delta=None if delta is None else tuple(t.to(dev) for t in delta),
    )
    want = ref.bst_hybrid_ref(tree.keys, tree.values, q, tree.height, split, mapping, cap,
                              active=act, ordered=ordered, overflow_out=ro, delta=delta)
    _same(got + (ko,), want + (ro,))
    return int(ro.sum())


@pytest.mark.parametrize("mapping", ["queue", "direct"])
@pytest.mark.parametrize("split", [0, 1, 2, 3, 4])
def test_hybrid_kernel_matches_its_plain_version(cuda_device, split, mapping):
    """Every split 0-4 at both mappings, membership and ordered: ragged B
    (1, 511, 513, 8193), a tenth of the lanes inactive, capacity 1 and the
    engine's, random keys and a chunk whose live lanes all share one
    destination."""
    keys, values, tree, pool = _case(32767, 8193, seed=split)
    rng = np.random.default_rng(split)
    for B in (1, 511, 513, 8193):
        act = torch.from_numpy(rng.random(B) > 0.1)
        one_dest = torch.full((B,), int(keys[len(keys) // 3]), dtype=torch.int32)
        for cap in (1, invariants.buffer_capacity(512, 1 << split, 2.0)):
            for ordered in (False, True):
                _hybrid_same(cuda_device, tree, pool[:B].contiguous(), act, split, mapping, cap,
                             ordered)
                replayed = _hybrid_same(cuda_device, tree, one_dest, None, split, mapping, cap,
                                        ordered)
                assert replayed > 0 or cap >= min(B, 512)


def test_hybrid_kernel_with_every_lane_inactive(cuda_device):
    _, _, tree, q = _case(4095, 1500, seed=4)
    for split, mapping in ((0, "queue"), (3, "direct"), (3, "queue")):
        for ordered in (False, True):
            assert _hybrid_same(cuda_device, tree, q, torch.zeros(1500, dtype=torch.bool), split,
                                mapping, 1, ordered) == 0


@pytest.mark.parametrize("C", [1, 4096, 20000, 140000])
def test_hybrid_delta_kernel_matches_its_plain_version(cuda_device, C):
    """K2 hybrid at C = 1, 4096, 20,000 (past the ~14,000 the staged form
    took: the buffer now stays in global memory) and 140,000 (sampled lines
    of 64 slots for membership and 128 ordered, several 32-slot runs
    each)."""
    assert (ref.delta_line(C, False) > 32) == (ref.delta_line(C, True) > 32) == (C > 131072)
    keys, values = make_tree_data(32767 if C < 32767 else 262143, seed=C)
    tree = TT.build_tree(keys, values, device="cpu")
    buf = _buffer(keys, tree, C, seed=C, device="cpu")
    d_ops = TD.operands(buf)
    rng = np.random.default_rng(C)
    pool = np.concatenate([keys, keys + 1, buf.keys[: int(buf.count)].numpy()])
    q = torch.from_numpy(rng.choice(pool, 4099).astype(np.int32))
    act = torch.from_numpy(rng.random(4099) > 0.1)
    for split, mapping in ((2, "queue"), (3, "direct"), (3, "queue"), (0, "queue")):
        cap = invariants.buffer_capacity(512, 1 << split, 2.0)
        for ordered in (False, True):
            _hybrid_same(cuda_device, tree, q, act, split, mapping, cap, ordered, delta=d_ops)


def test_queue_split_past_the_label_table_raises(cuda_device):
    keys, values = make_tree_data(8191, seed=1)  # height 12
    tree = TT.build_tree(keys, values, device=cuda_device)
    limit = K.hybrid_max_queue_split(cuda_device)
    assert limit == 11
    q = torch.from_numpy(keys[:600]).to(cuda_device)
    with pytest.raises(ValueError, match="the limit is split level 11"):
        K.bst_hybrid_forest_cuda(tree.keys, tree.values, q, tree.height, 12, "queue", 4)
    # the direct mapping keeps no table: split 12 runs
    ko = torch.zeros_like(q)
    got = K.bst_hybrid_forest_cuda(tree.keys, tree.values, q, tree.height, 12, "direct", 4,
                                   overflow_out=ko)
    ro = torch.zeros(600, dtype=torch.int32)
    want = ref.bst_hybrid_ref(tree.keys.cpu(), tree.values.cpu(), q.cpu(), tree.height, 12,
                              "direct", 4, overflow_out=ro)
    _same(got + (ko,), want + (ro,))
    got = K.bst_hybrid_forest_cuda(tree.keys, tree.values, q, tree.height, 11, "queue", 4)
    _same(got, ref.bst_hybrid_ref(tree.keys.cpu(), tree.values.cpu(), q.cpu(), tree.height, 11,
                                  "queue", 4))


@pytest.mark.parametrize("name", list(PAPER_CONFIGS))
def test_write_path_server_round_matches_an_oracle(cuda_device, name):
    keys, values = make_tree_data(8191, seed=2)
    cfg = dataclasses.replace(PAPER_CONFIGS[name], delta_capacity=256)
    srv = BSTServer(keys, values, cfg, chunk_size=1024, scan_k=4)
    rng = np.random.default_rng(3)
    wk = np.concatenate([rng.choice(keys, 150, replace=False),
                         rng.choice(keys.size, 150, replace=False).astype(np.int32) * 2 + 1])
    wv = rng.integers(0, 2**31 - 1, wk.size, dtype=np.int32)
    dk = np.concatenate([rng.choice(keys, 90, replace=False), keys[:30] + 1])
    q = rng.choice(np.concatenate([keys, wk, dk, keys + 1]), 3000).astype(np.int32)
    srv.submit_write(wk, wv)
    srv.submit_delete(dk)
    t_look = srv.submit(q)
    t_pred = srv.submit(q, op="predecessor")
    t_succ = srv.submit(q, op="successor")
    t_scan = srv.submit_range(q[:500], q[:500] + 40, op="range_scan")
    # the graphs' captures, the write path's too
    srv.warmup(("lookup", "predecessor", "successor", "range_scan", "write"))
    before = graphs.kernel_runs()
    got = srv.drain()
    runs = {k: n - before[k] for k, n in graphs.kernel_runs().items()}
    assert srv.stats.compactions >= 1

    kv = dict(zip(keys.tolist(), values.tolist()))
    kv.update(zip(wk.tolist(), wv.tolist()))
    for k in dk.tolist():
        kv.pop(k, None)
    sk = np.array(sorted(kv), np.int32)
    sv = np.array([kv[k] for k in sk.tolist()], np.int32)
    i = np.clip(np.searchsorted(sk, q), 0, sk.size - 1)
    found = sk[i] == q
    np.testing.assert_array_equal(got[t_look][1], found)
    np.testing.assert_array_equal(got[t_look][0], np.where(found, sv[i], -1))
    i = np.searchsorted(sk, q, "right") - 1
    np.testing.assert_array_equal(got[t_pred][0], np.where(i >= 0, sk[np.clip(i, 0, None)],
                                                           np.int32(TT.NO_PRED_KEY)))
    i = np.searchsorted(sk, q)
    np.testing.assert_array_equal(got[t_succ][0], np.where(i < sk.size, sk[np.clip(i, 0, sk.size - 1)],
                                                           np.int32(TT.NO_SUCC_KEY)))
    start = np.searchsorted(sk, q[:500])
    counts = np.searchsorted(sk, q[:500] + 40, "right") - start
    np.testing.assert_array_equal(got[t_scan][2], np.minimum(counts, 4))
    np.testing.assert_array_equal(got[t_scan][0][:, 0], np.where(counts > 0, sk[np.clip(start, 0, sk.size - 1)],
                                                                 np.int32(TT.SENTINEL_KEY)))
    kern = "hybrid_descend" if cfg.strategy == "hyb" else "forest_descend"
    read_chunks = sum(srv.stats.per_op[op].chunks for op in
                      ("lookup", "predecessor", "successor", "range_scan"))
    assert read_chunks == 10
    assert runs[kern + "_delta"] == read_chunks  # every read resolves the buffer
    assert runs[kern] == 2  # ingest: 420 writes and deletes in chunks of 256


@pytest.fixture
def nccl_world(cuda_device):
    """A world of one over NCCL in this process, destroyed after the test."""
    import torch.distributed as dist

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("strategy", ["hrz", "dup", "hyb"])
def test_sharded_server_at_world_one_matches_the_single_chip_server(cuda_device, nccl_world,
                                                                     strategy):
    """The sharded path over NCCL (split level 0: trivial routing) against
    the single-chip server and a dict oracle, across a compaction: the same
    columns, one fetch per read chunk and per compaction, K4 and K1 from
    the sharded path, the engine's ingest kernel once an ingest chunk (its
    graph warmed first) and no K2 (the buffer folds in plain torch)."""
    keys, values = make_tree_data(8191, seed=2)
    cfg = EngineConfig(strategy=strategy, n_trees=1 if strategy == "hrz" else 4,
                       delta_capacity=256)
    srv = BSTServer(keys, values, cfg, chunk_size=1024, scan_k=4,
                    mesh=TDist.make_serving_mesh(strategy))
    single = BSTServer(keys, values, cfg, chunk_size=1024, scan_k=4)
    rng = np.random.default_rng(3)
    wk = np.concatenate([rng.choice(keys, 150, replace=False),
                         rng.choice(keys.size, 150, replace=False).astype(np.int32) * 2 + 1])
    wv = rng.integers(0, 2**31 - 1, wk.size, dtype=np.int32)
    dk = np.concatenate([rng.choice(keys, 90, replace=False), keys[:30] + 1])
    q = rng.choice(np.concatenate([keys, wk, dk, keys + 1]), 3000).astype(np.int32)
    ops = ("lookup", "predecessor", "successor", "range_count", "range_scan")

    def submit(server):
        server.submit_write(wk, wv)
        server.submit_delete(dk)
        return [server.submit(q, op=op) if op not in ("range_count", "range_scan")
                else server.submit_range(q[:500], q[:500] + 40, op=op) for op in ops]

    tickets, single_tickets = submit(srv), submit(single)
    # the sharded read graphs of both slots and the engine's ingest and
    # compaction graphs: the drain only replays
    srv.warmup(ops + ("write",))
    runs = graphs.kernel_runs()  # what ran: the ingest runs as graph replays
    fetches = runtime.fetch_count()
    got = srv.drain()
    n_fetch = runtime.fetch_count() - fetches
    launches = {k: n - runs[k] for k, n in graphs.kernel_runs().items()}
    want = single.drain()
    for t, st in zip(tickets, single_tickets):
        for g, w in zip(got[t], want[st]):
            assert g.dtype == w.dtype and np.array_equal(g, w)

    kv = dict(zip(keys.tolist(), values.tolist()))
    kv.update(zip(wk.tolist(), wv.tolist()))
    for k in dk.tolist():
        kv.pop(k, None)
    sk = np.array(sorted(kv), np.int32)
    i = np.clip(np.searchsorted(sk, q), 0, sk.size - 1)
    np.testing.assert_array_equal(got[tickets[0]][1], sk[i] == q)

    st = srv.stats
    assert st.compactions >= 1
    read_chunks = sum(st.per_op[op].chunks for op in ops)
    assert read_chunks == 3 * 3 + 2  # 3000 point keys and 500 ranges in chunks of 1024
    assert n_fetch == read_chunks + st.compactions
    ingest_chunks = st.chunks - read_chunks
    # one round a read chunk: at world 1 hyb's per-batch depth is the whole
    # local batch, so no stall or drain round follows
    assert launches["queue_dispatch"] == (0 if strategy == "dup" else read_chunks)
    ingest_kernel = "hybrid_descend" if strategy == "hyb" else "forest_descend"
    assert launches[ingest_kernel] - (0 if strategy == "hyb" else read_chunks) == ingest_chunks
    if strategy == "hyb":
        assert launches["forest_descend"] == read_chunks
    assert launches["forest_descend_delta"] == launches["hybrid_descend_delta"] == 0
    assert srv.memory_nodes_per_device() == srv.snapshot.n_nodes + (1 if strategy != "dup" else 0)


SHARDED_OPS = ("lookup", "predecessor", "successor", "range_count", "range_scan")


def _sharded_args(op, q):
    return (q, q + 40) if op in ("range_count", "range_scan") else (q,)


@pytest.mark.parametrize("strategy", ["hrz", "dup", "hyb"])
def test_sharded_graphs_equal_the_eager_route(cuda_device, nccl_world, strategy):
    """Over NCCL the sharded runner is compiled: every op through its graph
    equals the eager route and the engine bit for bit, without and with a
    delta buffer; an ingest changes the buffer's content, not its
    addresses, so the next calls replay without a capture."""
    keys, values = make_tree_data(32767, seed=12)
    cfg = EngineConfig(strategy=strategy, n_trees=1 if strategy == "hrz" else 4,
                       delta_capacity=512)
    eng = BSTEngine(keys, values, cfg)
    run = TDist.make_sharded_query(eng.tree, TDist.make_serving_mesh(strategy), strategy,
                                   plan=eng.plan)
    assert run.compiled
    rng = np.random.default_rng(12)
    q = rng.choice(np.concatenate([keys, keys + 1, keys - 1]), 2048).astype(np.int32)

    def agree():
        for op in SHARDED_OPS:
            args = _sharded_args(op, q)
            for kw in ({}, {"delta": eng.delta, "delta_ops": eng.delta_operands}):
                got = _tuple(run(op, *args, k=4, **kw))
                _same(got, _tuple(run(op, *args, k=4, eager=True, **kw)))
                if kw:
                    _same(got, _tuple(eng.query(op, *args, k=4, eager=True)))

    captures = graphs.STATS["captures"]
    agree()
    assert graphs.STATS["captures"] == captures + 2 * len(SHARDED_OPS)
    wk = rng.integers(1, 2 * keys.size, 300).astype(np.int32)
    eng.apply_ops(wk, wk + 7, rng.random(wk.size) < 0.3)  # below the high-water mark
    assert eng.compactions == 0
    captures = graphs.STATS["captures"]
    agree()
    assert graphs.STATS["captures"] == captures


@pytest.mark.parametrize("strategy", ["hrz", "dup", "hyb"])
def test_sharded_server_keeps_its_graphs_until_the_height_changes(cuda_device, nccl_world,
                                                                  strategy):
    """One sharded server over NCCL: ``warmup`` captures one graph per (op,
    slot); a compaction that keeps the height captures nothing and leaves
    the shard tensors where they were; the one that grows the tree cuts
    new shards and captures every held graph again, once; every answer
    equals the single-chip server's (on the CPU)."""
    keys, values = make_tree_data(16383, seed=13)  # height 13, full
    cfg = EngineConfig(strategy=strategy, n_trees=1 if strategy == "hrz" else 4,
                       delta_capacity=1024)
    srv = BSTServer(keys, values, cfg, chunk_size=512, scan_k=4,
                    mesh=TDist.make_serving_mesh(strategy))
    # on the CPU: the single-chip server captures no graph of its own
    single = BSTServer(keys, values, dataclasses.replace(cfg, device="cpu"), chunk_size=512,
                       scan_k=4)
    captures = graphs.STATS["captures"]
    srv.warmup(SHARDED_OPS + ("write",))
    run = srv.sharded_query
    assert len(run.graph_keys()) == 2 * len(SHARDED_OPS)
    assert graphs.STATS["captures"] - captures == 2 * len(SHARDED_OPS) + len(srv.engine.graph_keys())
    rng = np.random.default_rng(13)

    def serve(writes):
        q = rng.choice(np.concatenate([keys, keys + 1]), 1500).astype(np.int32)
        tickets = []
        for server in (srv, single):
            server.submit_write(*writes)
            tickets.append([server.submit(q, op=op) if op not in ("range_count", "range_scan")
                            else server.submit_range(*_sharded_args(op, q), op=op)
                            for op in SHARDED_OPS])
        got, want = srv.drain(), single.drain()
        for a, b in zip(*tickets):
            for g, w in zip(got[a], want[b]):
                assert g.dtype == w.dtype and np.array_equal(g, w)

    ptrs = [t.data_ptr() for pair in run.shards for t in pair]
    captures, height = graphs.STATS["captures"], srv.snapshot.height
    over = rng.choice(keys, 900, replace=False).astype(np.int32)
    serve((over, over + 1))  # crosses the high-water mark (768): the count holds
    assert srv.stats.compactions == 1 and srv.snapshot.height == height
    assert graphs.STATS["captures"] == captures
    assert [t.data_ptr() for pair in run.shards for t in pair] == ptrs
    fresh = (rng.choice(keys.size * 4, 900, replace=False) * 2 + 1).astype(np.int32)
    serve((fresh, fresh + 3))  # grows the tree to height 14
    assert srv.stats.compactions == 2 and srv.snapshot.height == height + 1
    assert srv.sharded_query is run and len(run.graph_keys()) == 2 * len(SHARDED_OPS)
    assert graphs.STATS["captures"] - captures == len(run.graph_keys()) + len(srv.engine.graph_keys())
    assert all(p != n for p, n in zip(ptrs, (t.data_ptr() for pair in run.shards for t in pair)))


def test_sharded_slots_keep_their_outputs(cuda_device, nccl_world):
    """The double buffer's two slots are separate graphs with separate
    static outputs: chunk i's columns are unchanged by chunk i + 1's
    replay in the other slot."""
    keys, values = make_tree_data(32767, seed=14)
    eng = BSTEngine(keys, values, EngineConfig(strategy="hyb", n_trees=4))
    run = TDist.make_sharded_query(eng.tree, TDist.make_serving_mesh("hyb"), "hyb",
                                   plan=eng.plan)
    rng = np.random.default_rng(14)
    a, b = (rng.choice(np.concatenate([keys, keys + 1]), 1024).astype(np.int32) for _ in range(2))
    for op in ("lookup", "successor"):
        first = run.query_static(op, a, slot=0)
        kept = tuple(t.clone() for t in first)
        second = run.query_static(op, b, slot=1)
        assert all(x.data_ptr() != y.data_ptr() for x, y in zip(first, second))
        _same(first, kept)
        _same(kept, _tuple(run(op, a, eager=True)))
        _same(second, _tuple(run(op, b, eager=True)))


# ------------------------------------------------------------ K5: attention
# fp32: the kernel's FMA order and expf against torch's matmul and softmax
# (TF32 off); bf16: the kernel's tensor cores take bf16 q, k, v and P (P
# rounded to bf16 before P V, at most about 2^-9 of sum p|v| / l) and sum in
# fp32, the plain version keeps P in fp32, and both round the output to bf16
# once, so they differ by about one bf16 rounding of the output (the JAX
# sweep's 2e-2).
ATTN_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BH,BHkv,Sq,Skv,d,causal,window", [
    (8, 4, 300, 300, 128, True, None),  # GQA causal, ragged last tiles
    (4, 2, 200, 77, 64, True, None),    # Sq > Skv: rows with no key give 0
    (2, 2, 130, 260, 16, True, 40),     # offset and a sliding window
    (4, 2, 1, 200, 128, True, None),    # one q row of a 128-row q tile
    (4, 2, 127, 127, 128, True, None),  # one row short of the q tile
    (4, 2, 129, 129, 64, True, None),   # one row past it
    (8, 2, 300, 300, 32, True, 100),    # GQA group 4, a window edge inside a kv tile
    (4, 2, 300, 300, 16, False, 70),    # d = 16, a window without the causal mask
    (2, 1, 5, 0, 64, True, None),       # no keys at all: every row gives 0
])
def test_flash_attention_matches_its_plain_version(cuda_device, no_tf32, dtype, BH, BHkv,
                                                   Sq, Skv, d, causal, window):
    gen = torch.Generator(device=cuda_device).manual_seed(BH + Sq)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
               for shape in ((BH, Sq, d), (BHkv, Skv, d), (BHkv, Skv, d)))
    FA.reset_launches()
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert FA.LAUNCHES["flash_attention"] == 1
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == dtype and got.shape == (BH, Sq, d)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    if Sq > Skv:
        assert not got[:, : Sq - Skv].any()


def test_flash_bf16_body_fits_one_cta(cuda_device):
    """The bf16 body's Q tile and two stages of K and V tiles fit the 227 KB
    a CTA can opt in to at every head dim; a head dim without an
    instantiation raises."""
    sizes = [FA.bf16_smem_bytes(d) for d in FA.HEAD_DIMS]
    assert sizes == sorted(sizes) and sizes[-1] <= 232448
    assert sizes[-1] >= 5 * 128 * 128 * 2  # Q and four 128 x 128 bf16 tiles at d = 128
    with pytest.raises(ValueError, match="head dim 48"):
        FA.bf16_smem_bytes(48)


def test_flash_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    def qkv(dtype=torch.bfloat16, d=64, kv_rows=2):
        return (torch.zeros(4, 32, d, dtype=dtype, device=cuda_device),
                torch.zeros(kv_rows, 32, d, dtype=dtype, device=cuda_device),
                torch.zeros(kv_rows, 32, d, dtype=dtype, device=cuda_device))

    FA.reset_launches()
    with pytest.raises(ValueError, match="dtype"):
        FA.flash_attention_cuda(*qkv(torch.float16))
    q, k, v = qkv()
    with pytest.raises(ValueError, match="dtype"):
        FA.flash_attention_cuda(q, k.float(), v)
    with pytest.raises(ValueError, match="contiguous"):
        FA.flash_attention_cuda(q.transpose(0, 1).contiguous().transpose(0, 1), k, v)
    with pytest.raises(ValueError, match="multiple"):
        FA.flash_attention_cuda(*qkv(kv_rows=3))
    with pytest.raises(ValueError, match="head dim 48"):
        FA.flash_attention_cuda(*qkv(d=48))
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_attention_cuda(*(t.cpu() for t in qkv()))
    assert FA.LAUNCHES["flash_attention"] == 0


# K5's backward against its plain version from the same saved tensors:
# fp32, the kernel's FMA order and dQ's kv-tile order against torch's
# matmuls; bf16,
# one rounding of dq, dk and dv against the plain version's fp32 sums,
# and each tensor in norm (BWD_NORM_TOL), where a wrong scale shows.
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
BWD_NORM_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BH,BHkv,Sq,Skv,d,causal,window", [
    (8, 4, 300, 300, 128, True, None),  # GQA causal, ragged last tiles
    (4, 2, 200, 77, 64, True, None),    # Sq > Skv: rows with no key get dq 0
    (2, 2, 130, 260, 16, True, 40),     # offset and a sliding window
    (10, 2, 300, 300, 64, True, 100),   # GQA group 5, a window edge inside a kv tile
    (4, 4, 129, 300, 32, False, None),  # non-causal, Sq != Skv (cross-attention)
    (2, 1, 5, 0, 64, True, None),       # no keys at all: dq 0, dk and dv empty
    # the bf16 body's edges: 128-row kv tiles, 64-row q tiles
    (4, 2, 127, 127, 128, True, None),  # Skv one short of a kv tile
    (4, 2, 128, 128, 64, True, None),   # exactly one kv tile
    (4, 2, 129, 129, 128, True, None),  # one key into a second kv tile
    (4, 2, 257, 257, 32, True, None),   # d = 32 (64-byte swizzle), a third kv tile of one key
    (4, 2, 1, 257, 64, True, None),     # Sq = 1: one q row, at the end of kv
    (4, 2, 256, 256, 128, True, 96),    # a window edge inside a q tile inside a kv tile
    (16, 2, 200, 200, 64, True, None),  # a GQA group of 8
    (8, 8, 300, 300, 16, True, 70),     # d = 16 (32-byte swizzle), group 1, a window
])
def test_flash_attention_backward_matches_its_plain_version(cuda_device, no_tf32, dtype, BH,
                                                            BHkv, Sq, Skv, d, causal, window):
    """``ops.FlashAttention`` on the card: the forward's lse against
    ``flash_attention_lse_ref``'s and the backward kernel's dq, dk, dv
    against ``flash_attention_bwd_ref`` on the same saved tensors; one
    launch of each."""
    gen = torch.Generator(device=cuda_device).manual_seed(BH + Sq + d)
    q, k, v, g = (torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
                  for shape in ((BH, Sq, d), (BHkv, Skv, d), (BHkv, Skv, d), (BH, Sq, d)))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    FA.reset_launches()
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    got = torch.autograd.grad(out, (q, k, v), g)
    assert FA.LAUNCHES == {"flash_attention": 1, "flash_attention_bwd": 1}
    q, k, v = (t.detach() for t in (q, k, v))
    out, lse = FA.flash_attention_cuda(q, k, v, causal=causal, window=window, with_lse=True)
    _, want_lse = ref.flash_attention_lse_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-5)  # -inf where no key: equal
    want = ref.flash_attention_bwd_ref(q, k, v, out, g, lse, causal=causal, window=window)
    tol = BWD_TOL[dtype]
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol)
        # per tensor in norm: the elementwise bf16 limit is near a typical element
        assert float((a.float() - b.float()).norm()) <= BWD_NORM_TOL[dtype] * float(b.float().norm())
    if Sq > Skv:
        assert not got[0][:, : Sq - Skv].any()


def test_flash_backward_fits_one_cta_and_rejects_what_it_does_not_take(cuda_device):
    """Both of the backward's main kernels, the bf16 and the fp32 body, fit
    the 227 KB a CTA can opt in to at every head dim; the wrapper raises on
    a wrong lse, dout or device."""
    for dtype in FA.DTYPES:
        sizes = [FA.bwd_smem_bytes(d, dtype) for d in FA.HEAD_DIMS]
        assert sizes == sorted(sizes) and sizes[-1] <= 232448, dtype
    q = torch.zeros(4, 32, 64, dtype=torch.bfloat16, device=cuda_device)
    k = v = torch.zeros(2, 32, 64, dtype=torch.bfloat16, device=cuda_device)
    out, lse = FA.flash_attention_cuda(q, k, v, with_lse=True)
    assert lse.shape == (4, 32) and lse.dtype == torch.float32
    FA.reset_launches()
    with pytest.raises(ValueError, match="lse"):
        FA.flash_attention_bwd_cuda(q, k, v, out, out, lse[:, :5])
    with pytest.raises(ValueError, match="dout"):
        FA.flash_attention_bwd_cuda(q, k, v, out, out.float(), lse)
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_attention_bwd_cuda(*(t.cpu() for t in (q, k, v, out, out, lse)))
    assert FA.LAUNCHES["flash_attention_bwd"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_stages_alone_redo_the_whole_launch(cuda_device, no_tf32, dtype):
    """``bwd_stage_calls``: the pre-pass, the main kernel and the cast, each
    launched alone and in order, give the whole launch's dq, dk and dv
    again, bit for bit (the main kernel alone zeroes dQ's semaphores
    first), one count each."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    q, g = (torch.randn(8, 200, 64, generator=gen, device=cuda_device).to(dtype)
            for _ in range(2))
    k, v = (torch.randn(2, 200, 64, generator=gen, device=cuda_device).to(dtype)
            for _ in range(2))
    out, lse = FA.flash_attention_cuda(q, k, v, window=90, with_lse=True)
    want = FA.flash_attention_bwd_cuda(q, k, v, out, g, lse, window=90)
    FA.reset_launches()
    grads, calls = FA.bwd_stage_calls(q, k, v, out, g, lse, window=90)
    assert list(calls) == list(FA.BWD_STAGES)
    for grad in grads:
        grad.fill_(float("nan"))
    for name in FA.BWD_STAGES:
        calls[name]()
    torch.cuda.synchronize()
    assert FA.LAUNCHES["flash_attention_bwd"] == 1 + len(FA.BWD_STAGES)
    assert all(torch.equal(a, b) for a, b in zip(grads, want))


# K5's backward called again on the same inputs: (BH, BHkv, Sq, Skv, d,
# causal, window), GQA groups 1, 2 and 4, lengths that are not multiples of
# 64, d 64 and 128, causal with and without a window, and non-causal.
REPEAT_SHAPES = [
    (16, 4, 1000, 1000, 128, True, None),
    (8, 4, 777, 777, 64, True, None),
    (8, 8, 900, 900, 128, True, 200),
    (12, 3, 513, 1030, 64, True, 300),
    (4, 2, 300, 650, 128, False, None),
    (64, 32, 2048, 2048, 128, True, None),  # qwen3-1.7b's training shape
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BH,BHkv,Sq,Skv,d,causal,window", REPEAT_SHAPES)
def test_flash_backward_gives_the_same_bits_every_call(cuda_device, dtype, BH, BHkv, Sq, Skv, d,
                                                       causal, window):
    """Three backward calls on the same inputs give dq, dk and dv equal bit
    for bit: every kv tile adds its dQ into the fp32 rows in the order of
    the kv tiles, whatever order the CTAs run in."""
    gen = torch.Generator(device=cuda_device).manual_seed(BH + Sq + d)
    q, k, v, g = (torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
                  for shape in ((BH, Sq, d), (BHkv, Skv, d), (BHkv, Skv, d), (BH, Sq, d)))
    out, lse = FA.flash_attention_cuda(q, k, v, causal=causal, window=window, with_lse=True)
    first = FA.flash_attention_bwd_cuda(q, k, v, out, g, lse, causal=causal, window=window)
    for _ in range(2):
        again = FA.flash_attention_bwd_cuda(q, k, v, out, g, lse, causal=causal, window=window)
        assert all(torch.equal(a, b) for a, b in zip(again, first))
    assert all(bool(t.any()) for t in first)


# K5 past a launch's 65,535 head rows (``FA.head_row_chunks``): the
# forward's boundary shapes, (BH, BHkv, Sq, Skv, d, causal, window), group 4
# (B 2,049 x 32 heads, 8 kv heads), group 5 with a window (B 2,622 x 25
# heads, 5 kv heads) and qwen3-1.7b's prefill of 4,096 prompts of 16 tokens
# (16 heads, 8 kv heads: 65,534 q rows, then a tail of one kv row); the
# backward's, bf16 past 65,535 q rows and fp32 past 65,535 kv rows (B 8,193
# x 16 heads, 8 kv heads).
ROWS_FWD = [
    (2049 * 32, 2049 * 8, 128, 128, 128, True, None),
    (2622 * 25, 2622 * 5, 192, 192, 64, True, 50),
    (4096 * 16, 4096 * 8, 16, 16, 128, True, None),
]
ROWS_BWD = [
    (torch.bfloat16, (2049 * 32, 2049 * 8, 128, 128, 128, True, None)),
    (torch.float32, (8193 * 16, 8193 * 8, 64, 64, 64, True, None)),
]
ROWS_SLICE = 2048  # kv rows (and their q rows) a slice of the plain version


def _plain_in_slices(fn, q_rows, kv_rows):
    """``fn(*q_slices, *kv_slices)`` over slices of ROWS_SLICE kv rows and
    their GQA groups' q rows, each output concatenated over the slices: the
    plain version at a shape whose whole intermediates the card would not
    hold at once."""
    group = q_rows[0].shape[0] // kv_rows[0].shape[0]
    parts = [fn(*(t[i * group:(i + ROWS_SLICE) * group] for t in q_rows),
                *(t[i:i + ROWS_SLICE] for t in kv_rows))
             for i in range(0, kv_rows[0].shape[0], ROWS_SLICE)]
    return [torch.cat(p) for p in zip(*parts)]


def _assert_within(got, want, tol, norm_tol=None):
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    if norm_tol is not None:
        assert float((got.float() - want.float()).norm()) <= norm_tol * float(want.float().norm())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BH,BHkv,Sq,Skv,d,causal,window", ROWS_FWD)
def test_flash_attention_past_the_head_row_limit_matches_its_plain_version(
        cuda_device, no_tf32, dtype, BH, BHkv, Sq, Skv, d, causal, window):
    """K5 at BH just past 65,535: two launches a call, with and without
    lse, one count a call; the output and lse against the plain version."""
    gen = torch.Generator(device=cuda_device).manual_seed(BH + d)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
               for shape in ((BH, Sq, d), (BHkv, Skv, d), (BHkv, Skv, d)))
    FA.reset_launches()
    out, lse = FA.flash_attention_cuda(q, k, v, causal=causal, window=window, with_lse=True)
    served = FA.flash_attention_cuda(q, k, v, causal=causal, window=window)
    assert FA.LAUNCHES["flash_attention"] == 2 and FA.CHUNKS["flash_attention"] == 4
    want, want_lse = _plain_in_slices(functools.partial(
        ref.flash_attention_lse_ref, causal=causal, window=window), (q,), (k, v))
    for got in (out, served):
        _assert_within(got, want.to(dtype), ATTN_TOL[dtype])
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype,shape", ROWS_BWD, ids=["bf16-q-rows", "fp32-kv-rows"])
def test_flash_backward_past_the_head_row_limit_matches_its_plain_version(cuda_device, no_tf32,
                                                                           dtype, shape):
    """K5's backward past 65,535 q rows (bf16: one launch, its kernels
    bound only by kv rows) and past 65,535 kv rows (fp32: two launches),
    one count a call; dq, dk, dv against the plain version on the same
    saved tensors, elementwise and in norm."""
    BH, BHkv, Sq, Skv, d, causal, window = shape
    gen = torch.Generator(device=cuda_device).manual_seed(BH + d)
    q, k, v, g = (torch.randn(s, generator=gen, device=cuda_device).to(dtype)
                  for s in ((BH, Sq, d), (BHkv, Skv, d), (BHkv, Skv, d), (BH, Sq, d)))
    out, lse = FA.flash_attention_cuda(q, k, v, causal=causal, window=window, with_lse=True)
    FA.reset_launches()
    got = FA.flash_attention_bwd_cuda(q, k, v, out, g, lse, causal=causal, window=window)
    assert FA.LAUNCHES["flash_attention_bwd"] == 1
    assert FA.CHUNKS["flash_attention_bwd"] == -(-BHkv // FA.MAX_HEAD_ROWS)

    def plain(qc, oc, doc, lc, kc, vc):
        return ref.flash_attention_bwd_ref(qc, kc, vc, oc, doc, lc, causal=causal, window=window)

    want = _plain_in_slices(plain, (q, out, g, lse), (k, v))
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        _assert_within(a, b, BWD_TOL[dtype], BWD_NORM_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("limit", [1, 3, 6])
def test_chunked_launches_redo_one_launch(cuda_device, monkeypatch, dtype, limit):
    """With the launch's head rows lowered to ``limit``, the forward (with
    and without lse) and the backward launch in chunks on views at the
    chunks' offsets (the bf16 backward's padded delta and lse term, dq's
    fp32 scratch, dQ's semaphores) and give one launch's results bit for
    bit, dq too; each backward stage alone, over every chunk, redoes the
    backward."""
    gen = torch.Generator(device=cuda_device).manual_seed(limit)
    q, g = (torch.randn(16, 200, 64, generator=gen, device=cuda_device).to(dtype)
            for _ in range(2))
    k, v = (torch.randn(4, 200, 64, generator=gen, device=cuda_device).to(dtype)
            for _ in range(2))
    out, lse = FA.flash_attention_cuda(q, k, v, window=90, with_lse=True)
    want = FA.flash_attention_bwd_cuda(q, k, v, out, g, lse, window=90)
    served = FA.flash_attention_cuda(q, k, v, window=90)
    monkeypatch.setattr(FA, "MAX_HEAD_ROWS", limit)
    FA.reset_launches()
    c_out, c_lse = FA.flash_attention_cuda(q, k, v, window=90, with_lse=True)
    c_served = FA.flash_attention_cuda(q, k, v, window=90)
    c_grads = FA.flash_attention_bwd_cuda(q, k, v, out, g, lse, window=90)
    torch.cuda.synchronize()
    # forward: a group of 4 cut in pieces below 4 rows, else one kv row a
    # chunk; backward: ``limit`` kv rows a chunk
    n_fwd, n_bwd = {1: (16, 4), 3: (8, 2), 6: (4, 1)}[limit]
    assert FA.LAUNCHES == {"flash_attention": 2, "flash_attention_bwd": 1}
    assert FA.CHUNKS == {"flash_attention": 2 * n_fwd, "flash_attention_bwd": n_bwd}
    assert torch.equal(c_out, out) and torch.equal(c_lse, lse) and torch.equal(c_served, served)
    grads, calls = FA.bwd_stage_calls(q, k, v, out, g, lse, window=90)
    for grad in grads:
        grad.fill_(float("nan"))
    for name in FA.BWD_STAGES:
        calls[name]()
    torch.cuda.synchronize()
    for got in (c_grads, grads):
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_bf16_flash_route_gradients_stay_within_the_models_rounding(cuda_device, no_tf32):
    """qwen3's smoke config in bf16 with remat, the same weights three ways:
    over every parameter's gradient, the RMS of (flash route bf16 - naive
    route fp32) is at most 1.25 times that of (naive route bf16 - naive
    route fp32).  The bf16 backward rounds P and dS to bf16; the model's
    gradient may take on that, not more than a quarter more error than
    its own bf16 rounding (chip_smoke's TRAIN_BF16_GRAD_RATIO)."""
    cfg = dataclasses.replace(TC.smoke_config("qwen3-1.7b"), dtype="bfloat16", remat=True)
    naive = dataclasses.replace(cfg, attention_impl="naive")
    naive32 = dataclasses.replace(naive, dtype="float32")
    model = TM.init_params(cfg, seed=3, device=cuda_device, trainable=True)
    model32 = TM.init_params(naive32, seed=3, device=cuda_device, trainable=True)
    with torch.no_grad():
        for p32, p in zip(model32.parameters(), model.parameters()):
            p32.copy_(p)
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 257)))
    toks = toks.to(cuda_device)

    def grads(c, m):
        for p in m.parameters():
            p.grad = None
        loss, _ = TM.forward_train(c, m, toks[:, :-1], toks[:, 1:])
        loss.backward()
        return {n: p.grad.float() for n, p in m.named_parameters()}

    FA.reset_launches()
    flash = grads(cfg, model)
    assert FA.LAUNCHES == {"flash_attention": 2 * cfg.n_layers, "flash_attention_bwd": cfg.n_layers}
    plain = grads(naive, model)
    want = grads(naive32, model32)
    assert FA.LAUNCHES["flash_attention_bwd"] == cfg.n_layers
    d_flash = sum(float((flash[n] - w).pow(2).sum()) for n, w in want.items())
    d_naive = sum(float((plain[n] - w).pow(2).sum()) for n, w in want.items())
    assert all(bool(torch.isfinite(g).all()) for g in flash.values())
    assert d_naive > 0
    assert (d_flash / d_naive) ** 0.5 <= 1.25


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "hymba-1.5b", "seamless-m4t-medium"])
def test_flash_route_gradients_match_the_naive_route(cuda_device, no_tf32, arch):
    """``forward_train`` in fp32 at smoke size with remat: every parameter's
    gradient through K5 and its backward against the naive route's (plain
    attention under autograd) to 1e-4, element by element and of the
    tensor's largest magnitude, and none is missing; K5's forward
    runs twice a layer's attention (remat), its backward once."""
    cfg = dataclasses.replace(TC.smoke_config(arch), remat=True)
    model = TM.init_params(cfg, seed=3, device=cuda_device, trainable=True)
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 41))).to(cuda_device)
    fe = ()
    if cfg.family == "encdec":
        fe = (torch.from_numpy(rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
                               * 0.5).to(cuda_device),)

    def grads(c):
        for p in model.parameters():
            p.grad = None
        loss, _ = TM.forward_train(c, model, toks[:, :-1], toks[:, 1:], *fe)
        loss.backward()
        assert all(p.grad is not None for p in model.parameters())
        return loss.detach(), {n: p.grad for n, p in model.named_parameters()}

    FA.reset_launches()
    loss, flash = grads(cfg)
    attentions = cfg.n_layers + (cfg.encoder_layers + cfg.n_layers if cfg.family == "encdec" else 0)
    assert FA.LAUNCHES == {"flash_attention": 2 * attentions, "flash_attention_bwd": attentions}
    want_loss, naive = grads(dataclasses.replace(cfg, attention_impl="naive"))
    assert FA.LAUNCHES["flash_attention_bwd"] == attentions
    torch.testing.assert_close(loss, want_loss, atol=1e-5, rtol=1e-5)
    for name, g in naive.items():
        torch.testing.assert_close(flash[name], g, atol=1e-4, rtol=1e-4, msg=name)
        # and relative to the tensor's scale, which 1e-4 absolute may exceed
        scale = float(g.abs().max())
        assert scale > 0, name
        assert float((flash[name] - g).abs().max()) <= 1e-4 * scale, name


def test_train_step_on_the_card(cuda_device):
    """Two bf16 steps of ``make_train_step`` on qwen3's smoke config, the
    first the graph's capture (its warm-up is the step), the second a
    replay: every parameter gets a gradient (the step raises otherwise),
    the metrics are finite device tensors, the kernels that ran are K5's
    forward twice a layer and its backward once a layer a step, and the
    fp32 masters move."""
    cfg = dataclasses.replace(TC.smoke_config("qwen3-1.7b"), dtype="bfloat16", remat=True)
    tcfg = TrainConfig(peak_lr=1e-3, warmup_steps=1, total_steps=4)
    state = init_train_state(cfg, tcfg, seed=0, device=cuda_device)
    before = [m.clone() for m in state.opt.master]
    step = make_train_step(cfg, tcfg)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (4, 33)))
    toks = toks.to(cuda_device)
    runs, captures = graphs.kernel_runs(), graphs.STATS["captures"]
    for _ in range(2):
        state, metrics = step(state, toks[:, :-1], toks[:, 1:])
        assert all(v.is_cuda for v in metrics.values())
        assert all(bool(torch.isfinite(v)) for v in metrics.values())
    ran = {k: n - runs[k] for k, n in graphs.kernel_runs().items()}
    assert ran == {**{k: 0 for k in ran}, "flash_attention": 4 * cfg.n_layers,
                   "flash_attention_bwd": 2 * cfg.n_layers}
    assert graphs.STATS["captures"] == captures + 1
    assert int(state.opt.step) == 2
    assert all(p.dtype == torch.bfloat16 and p.grad is None for p in state.params.parameters())
    assert all(bool((m != b).any()) for m, b in zip(state.opt.master, before))


def test_smoke_model_on_the_card_matches_the_cpu(cuda_device, no_tf32):
    """qwen3's smoke config (GQA: 2 kv heads) in fp32, the same weights on
    both devices: prefill logits, caches and decode logits to 1e-4 (kernel
    and plain attention, and the card's and the CPU's matrix products), and
    one K5 launch per layer per prefill."""
    cfg = dataclasses.replace(TC.smoke_config("qwen3-1.7b"), n_kv_heads=2)
    cpu = TM.init_params(cfg, seed=1, device="cpu")
    card = TM.Model(cfg, cuda_device)
    card.load_state_dict(cpu.state_dict())
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, (3, 40)))
    S = 36
    FA.reset_launches()
    got, g_state = TM.prefill(cfg, card, toks[:, :S].to(cuda_device), max_len=40)
    assert FA.LAUNCHES["flash_attention"] == cfg.n_layers
    want, w_state = TM.prefill(cfg, cpu, toks[:, :S], max_len=40)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(g_state.kv.k.cpu(), w_state.kv.k, atol=1e-4, rtol=1e-4)
    for t in range(S, 40):
        got, g_state = TM.decode_step(cfg, card, toks[:, t:t + 1].to(cuda_device), g_state)
        want, w_state = TM.decode_step(cfg, cpu, toks[:, t:t + 1], w_state)
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    assert FA.LAUNCHES["flash_attention"] == cfg.n_layers  # decode runs no K5


# ------------------------------------------------------ K4: queue dispatch
# (G, B, n_dest, capacity): the JAX package's sweep (tests/test_kernels.py)
# and its overflow case, the MoE prefill (4 x 2048 tokens in 32 groups) and
# decode (4 tokens) shapes of mixtral-8x7b, the port's n_dest limit, the
# kernel benchmarks' 4096 x 16 and 8192 x 8 chunks, rows past the largest
# CTA (1025 lanes, past 8192: a second pass of the narrow body), the
# narrow body's 32 destinations and the wide body's 33 and 1024.
K4_SHAPES = [
    (1, 16, 2, 2), (1, 128, 8, 16), (1, 64, 16, 8), (1, 33, 4, 1), (1, 40, 4, 3),
    (32, 512, 8, 80), (1, 8, 8, 1), (3, 700, 1024, 2), (1, 4096, 16, 512), (1, 8192, 8, 1280),
    (2, 1025, 8, 130), (1, 1025, 1024, 3), (1, 9000, 8, 1200), (2, 300, 32, 12),
    (2, 300, 33, 12),
]


def _k4_same(dest, n_dest, capacity):
    QD.reset_launches()
    got = ops.queue_dispatch(dest, n_dest, capacity)
    assert QD.LAUNCHES["queue_dispatch"] == 1
    want = ref.queue_dispatch_ref(dest, n_dest, capacity)
    _same(got, want)


@pytest.mark.parametrize("G,B,n_dest,capacity", K4_SHAPES)
def test_queue_dispatch_kernel_matches_its_plain_version(cuda_device, G, B, n_dest, capacity):
    """Bit for bit on all five outputs of the plan, 1/8 of the lanes
    inactive; then a row whose lanes all go to one destination, one with
    two hot destinations, and an all-inactive row."""
    rng = np.random.default_rng(B + n_dest)
    dest = rng.integers(0, n_dest, (G, B)).astype(np.int32)
    dest[rng.random((G, B)) < 1 / 8] = -1
    _k4_same(torch.from_numpy(dest).to(cuda_device), n_dest, capacity)
    skews = np.stack([np.full(B, n_dest - 1), rng.choice([0, n_dest // 2], B),
                      np.full(B, -1)]).astype(np.int32)
    _k4_same(torch.from_numpy(skews).to(cuda_device), n_dest, capacity)
    _k4_same(torch.from_numpy(dest[0]).to(cuda_device), n_dest, capacity)  # one (B,) row


@pytest.mark.parametrize("G,B,n_dest,capacity", [(32, 512, 8, 80), (1, 8, 8, 1)])
def test_one_queue_dispatch_runs_one_kernel(cuda_device, G, B, n_dest, capacity):
    """The MoE layer's queue dispatch (``core.buffers.dispatch``) at the
    mixtral prefill and decode shapes is one device kernel, K4, as
    torch.profiler counts it over five dispatches (after five more as its
    warm-up): the kernel writes the whole plan."""
    from repro_torch.core import buffers as TB

    rng = np.random.default_rng(B)
    dest = torch.from_numpy(rng.integers(-1, n_dest, (G, B)).astype(np.int32)).to(cuda_device)
    want = TB.DispatchPlan(*ref.queue_dispatch_ref(dest, n_dest, capacity))
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    schedule = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.profiler.profile(activities=activities, schedule=schedule) as prof:
        for _ in range(2):  # a warm-up step (a trace can miss its first kernels), one recorded
            plans = [TB.dispatch("queue", dest, n_dest, capacity) for _ in range(5)]
            torch.cuda.synchronize()
            prof.step()
    names = [ev.name for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA
             and not ev.name.startswith("ProfilerStep")]  # the step's own annotation
    assert len(names) == 5 and all("queue_dispatch" in n for n in names), names
    for plan in plans:
        _same(plan, want)


def test_queue_dispatch_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    limit = QD.max_dest()
    assert limit >= 256
    dest = torch.zeros(64, dtype=torch.int32, device=cuda_device)
    QD.reset_launches()
    with pytest.raises(ValueError, match=f"limit of {limit} destinations"):
        QD.queue_dispatch_cuda(dest, limit + 1, 4)
    with pytest.raises(ValueError, match="int32"):
        QD.queue_dispatch_cuda(dest.long(), 8, 4)
    with pytest.raises(ValueError, match="contiguous"):
        QD.queue_dispatch_cuda(dest.reshape(8, 8).t(), 8, 4)
    with pytest.raises(ValueError, match="CUDA"):
        QD.queue_dispatch_cuda(dest.cpu(), 8, 4)
    assert QD.LAUNCHES["queue_dispatch"] == 0


def test_full_width_moe_model_takes_the_same_plans_through_k4_and_its_plain_version(
        cuda_device, no_tf32, monkeypatch):
    """mixtral-8x7b at full width, 2 layers, bf16: prefill of 2 x 256 and 2
    decode steps through K4 (one launch per layer per step), then the same
    with the plain version of the dispatch swapped in; the plans are equal,
    so the logits are equal."""
    cfg = dataclasses.replace(TC.get_config("mixtral-8x7b"), n_layers=2)
    model = TM.init_params(cfg, seed=0, device=cuda_device)
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 258)))
    toks = toks.to(cuda_device)

    def run():
        logits, state = TM.prefill(cfg, model, toks[:, :256], max_len=258)
        out = [logits]
        for t in (256, 257):
            logits, state = TM.decode_step(cfg, model, toks[:, t:t + 1], state)
            out.append(logits)
        return out

    QD.reset_launches()
    k4 = run()
    assert QD.LAUNCHES["queue_dispatch"] == 3 * cfg.n_layers
    assert all(bool(torch.isfinite(lg).all()) for lg in k4)
    monkeypatch.setattr(ops, "queue_dispatch", ref.queue_dispatch_ref)
    plain = run()
    assert QD.LAUNCHES["queue_dispatch"] == 3 * cfg.n_layers
    for a, b in zip(k4, plain):
        assert torch.equal(a, b)


# ------------------------------------------------- compiled serving steps
def _tuple(res):
    return res if isinstance(res, tuple) else (res,)


QUERY_CASES = (("lookup", 0), ("predecessor", 0), ("successor", 0), ("range_count", 1),
               ("range_scan", 1))


@pytest.mark.parametrize("capacity", [0, 512])
@pytest.mark.parametrize("name", ["Hrz", "Dup4", "Hyb8q"])
def test_graphed_queries_match_the_eager_route(cuda_device, name, capacity):
    """Every op through its graph equals the eager route bit for bit: on a
    read-only engine, and with a delta buffer empty, after an ingest (no
    re-capture: the graphs read the buffer's fixed addresses) and after a
    compaction that grows the tree (the merge's graph captured at its first
    use, then, over the new snapshot set, every graph of the engine, its
    queries', the ingest's and the merge's, captured again, once, inside
    the compaction).  A query's result is unchanged by the
    next query."""
    keys, values = make_tree_data(32767, seed=4)
    eng = BSTEngine(keys, values, dataclasses.replace(PAPER_CONFIGS[name], delta_capacity=capacity))
    rng = np.random.default_rng(4)
    q = rng.choice(np.concatenate([keys, keys + 1, keys - 1]), 3000).astype(np.int32)
    lo = q[:1000]
    hi = (lo + rng.integers(-4, 60, lo.size)).astype(np.int32)

    def agree():
        for op, ranged in QUERY_CASES:
            args = (lo, hi) if ranged else (q,)
            _same(_tuple(eng.query(op, *args)), _tuple(eng.query(op, *args, eager=True)))

    agree()
    first = _tuple(eng.query("lookup", q))
    kept = tuple(t.clone() for t in first)
    eng.query("lookup", q[::-1].copy())
    _same(first, kept)
    if capacity == 0:
        return
    wk = rng.integers(1, 2 * keys.size, 300).astype(np.int32)
    eng.apply_ops(wk, wk + 7, rng.random(wk.size) < 0.3)
    assert eng.compactions == 0
    captures = graphs.STATS["captures"]
    agree()
    assert graphs.STATS["captures"] == captures
    height = eng.tree.height
    eng.compact()
    assert eng.tree.height == height + 1  # 32,767 keys fill height 14
    held = eng.graph_keys()
    assert len(held) == len(QUERY_CASES) + 2  # the queries, the ingest, the merge
    assert graphs.STATS["captures"] == captures + 1 + len(held)
    agree()
    assert graphs.STATS["captures"] == captures + 1 + len(held)


def _write_engine(name, n_keys, capacity, seed):
    """A warmed write-path engine over ``n_keys`` keys (the write path's
    graphs captured before its first write), its keys and a generator."""
    keys, values = make_tree_data(n_keys, seed=seed)
    eng = BSTEngine(keys, values, dataclasses.replace(PAPER_CONFIGS[name], delta_capacity=capacity))
    eng.warmup_writes()
    for op, ranged in QUERY_CASES:
        eng.query(op, keys[:512], keys[:512] + 9) if ranged else eng.query(op, keys[:512])
    assert eng.compactions == 0 and eng.pending_writes() == 0
    return eng, keys, np.random.default_rng(seed)


def _overwrites(keys, rng, m):
    """m ops that keep the key count: overwrites of stored keys."""
    wk = rng.choice(keys, m, replace=False).astype(np.int32)
    return wk, rng.integers(0, 2**31 - 1, m, dtype=np.int32), np.zeros(m, bool)


@pytest.mark.parametrize("name", ["Hrz", "Dup4", "Hyb8q"])
def test_same_height_compaction_captures_no_graph(cuda_device, name):
    """With the write path warmed, ingests and a compaction that keeps the
    height replay their graphs: no capture, no wrapper call, the snapshot
    tensors where they were; the next read is a replay too, and equals the
    eager route."""
    eng, keys, rng = _write_engine(name, 30000, 512, seed=6)
    ptrs = [t.data_ptr() for t in (eng.tree.keys, eng.tree.values, *eng.plan.sorted_view())]
    captures, calls, height = graphs.STATS["captures"], graphs.launch_counts(), eng.tree.height
    eng.apply_ops(*_overwrites(keys, rng, 400))  # crosses the high-water mark (384)
    assert eng.compactions == 1 and eng.tree.height == height
    q = rng.choice(np.concatenate([keys, keys + 1]), 512).astype(np.int32)  # a warmed length
    got = eng.query("predecessor", q)
    assert graphs.STATS["captures"] == captures
    assert graphs.launch_counts() == calls  # every step a replay
    assert [t.data_ptr() for t in (eng.tree.keys, eng.tree.values, *eng.plan.sorted_view())] == ptrs
    _same(got, eng.query("predecessor", q, eager=True))
    # the engine's graphs keep no reference cycle through it: dropped, it
    # and its graphs go at once, not at a collection (one inside a later
    # capture would tear a graph down there)
    gone = weakref.ref(eng)
    collecting = gc.isenabled()
    gc.disable()
    try:
        del eng, got
        assert gone() is None
    finally:
        if collecting:
            gc.enable()


def _clone_delta(delta):
    return TD.DeltaBuffer(*(t.clone() for t in delta))


@pytest.mark.parametrize("name", ["Hrz", "Dup4", "Hyb8q"])
def test_ingest_and_compaction_graphs_equal_the_eager_route(cuda_device, name):
    """The ingest graph against ``_ingest_step`` and the compaction's graphs
    against ``delta.compact``, bit for bit (buffer, kernel operands, BFS
    image, sorted view and device count): a compaction that keeps the
    height, then one that grows it (the merge's graph, then the eager
    layout of the new height)."""
    eng, keys, rng = _write_engine(name, 16000, 4096, seed=7)  # height 13 (16,383 slots)
    fresh = (rng.choice(keys.size * 4, 3000, replace=False) * 2 + 1).astype(np.int32)
    for i, (k, v, d) in enumerate((_overwrites(keys, rng, 3000),
                                   (fresh, fresh + 5, np.zeros(fresh.size, bool)))):
        before, tree = _clone_delta(eng.delta), eng.tree
        tree = TT.TreeData(tree.keys.clone(), tree.values.clone(), tree.height, tree.n_real)
        want = eng._ingest_step(before, *(torch.from_numpy(x).to(cuda_device) for x in (k, v)),
                                torch.from_numpy(d).to(cuda_device),
                                torch.ones(k.size, dtype=torch.bool, device=cuda_device))
        eng.apply_ops(k, v, d)  # below the high-water mark (3072): no compaction
        assert (eng.compactions, eng.pending_writes()) == (i, k.size)
        _same(tuple(eng.delta), tuple(want))
        _same(eng._delta_ops, TD.operands(want))
        want = TD.compact(tree, _clone_delta(eng.delta))
        height = eng.tree.height
        eng.compact()
        _same((eng.tree.keys, eng.tree.values), (want.keys, want.values))
        _same(tuple(eng.plan.sorted_view()), tuple(TT.sorted_view_of(want)))
        assert (eng.tree.height, eng.tree.n_real) == (want.height, want.n_real)
        assert (eng.tree.height == height) == (i == 0)  # 19,000 keys need height 14


def test_write_drain_at_one_height_fetches_once_a_chunk_and_a_compaction(cuda_device):
    """A drain of interleaved writes and reads with several compactions at
    one height: one fetch per read chunk and one per compaction, no
    capture, every K2 run a replay, the answers those of the eager
    engine fed the same stream."""
    keys, values = make_tree_data(30000, seed=8)
    cfg = dataclasses.replace(PAPER_CONFIGS["Hrz"], delta_capacity=256)
    srv = BSTServer(keys, values, cfg, chunk_size=1024, scan_k=4)
    srv.warmup(("lookup", "successor", "write"))
    ref = BSTEngine(keys, values, dataclasses.replace(cfg, device="cpu"))
    rng = np.random.default_rng(8)
    tickets = []
    for _ in range(6):
        k, v, d = _overwrites(keys, rng, 200)
        srv.submit_write(k, v)
        ref.apply_ops(k, v, d)
        q = rng.choice(np.concatenate([keys, keys + 1]), 1500).astype(np.int32)
        tickets.append((srv.submit(q), srv.submit(q, op="successor"),
                        ref.query("lookup", q), ref.query("successor", q)))
    captures, fetches, runs = graphs.STATS["captures"], runtime.fetch_count(), graphs.kernel_runs()
    got = srv.drain()
    st = srv.stats
    read_chunks = st.per_op["lookup"].chunks + st.per_op["successor"].chunks
    assert st.compactions >= 4 and srv.snapshot.height == 14
    assert runtime.fetch_count() - fetches == read_chunks + st.compactions
    assert graphs.STATS["captures"] == captures
    assert graphs.kernel_runs()["forest_descend_delta"] - runs["forest_descend_delta"] == read_chunks
    for t_look, t_succ, look, succ in tickets:
        for g, w in zip(got[t_look] + got[t_succ], look + succ):
            np.testing.assert_array_equal(g, w.numpy())


def test_steady_state_drain_captures_nothing(cuda_device):
    """After ``warmup`` a drain replays its ops' graphs: no capture, no
    wrapper call, one descent kernel run per chunk."""
    keys, values = make_tree_data(65535, seed=5)
    srv = BSTServer(keys, values, PAPER_CONFIGS["Hrz"], chunk_size=1024)
    srv.warmup(("lookup", "predecessor"))
    q = np.random.default_rng(5).choice(keys, 5000).astype(np.int32)
    captures, launches, runs = graphs.STATS["captures"], graphs.launch_counts(), graphs.kernel_runs()
    srv.submit(q)
    srv.submit(q, op="predecessor")
    got = srv.drain()
    assert graphs.STATS["captures"] == captures
    assert graphs.launch_counts() == launches
    assert graphs.kernel_runs()["forest_descend"] - runs["forest_descend"] == srv.stats.chunks == 10
    assert got[0][1].all() and np.array_equal(got[1][0], q)


@pytest.mark.parametrize("name", ["Hrz", "Hyb8q"])
def test_write_spans_of_every_length_replay_the_ingest_ladder(cuda_device, name):
    """After ``warmup_writes`` the engine holds one ingest graph a rung of
    its ladder (256 ... 4,096 lanes).  A drain of write spans of 1 ... 20
    requests of 256 keys (every rung, and spans past the capacity: two
    slices), each span's last request a delete, with reads between the
    spans and compactions at one height, captures no graph, launches no
    wrapper, and answers as the same stream served on the CPU, where every
    step runs eagerly."""
    keys, values = make_tree_data(30000, seed=14)  # height 14 (16,384 ... 32,767 keys)
    cfg = dataclasses.replace(PAPER_CONFIGS[name], delta_capacity=4096)
    srv = BSTServer(keys, values, cfg, chunk_size=4096, scan_k=4)
    srv.warmup(("lookup", "predecessor", "write"))
    assert [k for k in srv.engine.graph_keys() if k[0] == "ingest"] == [
        ("ingest", L) for L in ingest_ladder(4096)]
    cpu = BSTServer(keys, values, dataclasses.replace(cfg, device="cpu"), chunk_size=4096,
                    scan_k=4)
    rng = np.random.default_rng(14)
    tickets = []
    for r in range(1, 21):
        reqs = []
        for i in range(r):
            if i == r - 1 and r > 1:
                reqs.append(("delete", rng.choice(keys, 256).astype(np.int32), None))
                continue
            wk = np.concatenate([rng.choice(keys, 240),  # overwrites, some repeated
                                 rng.integers(0, 2**25, 16) * 2 + 1]).astype(np.int32)
            reqs.append(("write", wk, rng.integers(0, 2**31 - 1, wk.size, dtype=np.int32)))
        q = rng.choice(np.concatenate([keys, keys + 1]), 1000).astype(np.int32)
        pair = []
        for server in (srv, cpu):
            for op, k, v in reqs:
                server.submit_write(k, v) if op == "write" else server.submit_delete(k)
            pair.append((server.submit(q), server.submit(q, op="predecessor")))
        tickets.append(pair)
    height = srv.snapshot.height
    captures, launches = graphs.STATS["captures"], graphs.launch_counts()
    got, want = srv.drain(), cpu.drain()
    assert graphs.STATS["captures"] == captures
    assert graphs.launch_counts() == launches  # every step a replay
    assert srv.stats.compactions >= 5 and srv.snapshot.height == height
    assert (srv.stats.compactions, srv.stats.chunks) == (cpu.stats.compactions, cpu.stats.chunks)
    for (t_look, t_pred), (c_look, c_pred) in tickets:
        for g, w in zip(got[t_look] + got[t_pred], want[c_look] + want[c_pred]):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mixtral-8x7b"])
def test_graphed_decode_matches_the_eager_route(cuda_device, no_tf32, arch, dtype):
    """The smoke configs on the card (mixtral's 16-slot ring wraps in
    decode): the graphed step's logits and tokens equal the eager route's
    bit for bit, the same kernels in the same order; a second request of
    the same shape captures nothing and gives the same tokens; mixtral runs
    one K4 per layer per replayed step, its dropped share the graph's own
    buffer; a state the graph does not own is refused."""
    cfg = dataclasses.replace(TC.smoke_config(arch), dtype=dtype)
    model = TM.init_params(cfg, seed=3, device=cuda_device)
    prompt = torch.from_numpy(np.random.default_rng(8).integers(0, cfg.vocab_size, (3, 12)))
    prompt = prompt.to(cuda_device)
    n_new = 10
    eager = greedy_generate(cfg, model, prompt, n_new, eager=True)

    routes = {}
    for name, eager_route in (("graph", False), ("eager", True)):
        logits, state = make_prefill_fn(cfg, max_len=12 + n_new, eager=eager_route)(model, prompt)
        step = make_serve_step(cfg, eager=eager_route)
        out, tok = [logits.clone()], logits.argmax(dim=-1, keepdim=True)
        runs = graphs.kernel_runs()
        for _ in range(n_new - 1):
            logits, state = step(model, tok, state)
            out.append(logits.clone())
            tok = logits.argmax(dim=-1, keepdim=True)
            assert state.kv.length.dim() == 0 and state.kv.length.is_cuda
        if cfg.family == "moe":
            k4 = graphs.kernel_runs()["queue_dispatch"] - runs["queue_dispatch"]
            assert k4 == cfg.n_layers * (n_new - 1)
        assert int(state.kv.length) == 12 + n_new - 1
        routes[name] = out
    for a, b in zip(routes["graph"], routes["eager"]):
        assert torch.equal(a, b)

    captures = graphs.STATS["captures"]
    for _ in range(2):
        assert torch.equal(greedy_generate(cfg, model, prompt, n_new), eager)
    assert graphs.STATS["captures"] == captures
    _, own = TM.prefill(cfg, model, prompt, max_len=12 + n_new)
    with pytest.raises(ValueError, match="its own graph"):
        make_serve_step(cfg)(model, prompt[:, :1], own)


def _frontend(cfg, batch: int, length: int, device, seed: int = 9):
    """Stub frontend embeddings N(0, 0.02) in the parameter dtype: ``length``
    frames (encdec) or the config's patch budget (vlm); none otherwise."""
    if cfg.frontend is None:
        return ()
    flen = length if cfg.family == "encdec" else cfg.frontend_len
    draw = np.random.default_rng(seed).standard_normal((batch, flen, cfg.d_model)) * 0.02
    return (torch.from_numpy(draw.astype(np.float32)).to(device, cfg.param_dtype),)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "hymba-1.5b", "seamless-m4t-medium",
                                  "internvl2-2b"])
def test_graphed_decode_of_every_family_matches_the_eager_route(cuda_device, no_tf32, arch,
                                                                dtype):
    """The ssm, hybrid, encdec and vlm smoke configs on the card (hymba with
    GQA, its 16-slot ring rolled by the prompt and wrapped by decode;
    seamless with a 15-frame memory): the graphed step's logits and tokens
    equal the eager route's bit for bit, the graph owning the SSM caches
    and the cross memory; one K5 launch per attention per prefill (mamba2
    none), and twice that for the first graphed prefill (its capture's
    warm-up, then its replay); a second request captures nothing."""
    over = {"n_kv_heads": 2} if arch == "hymba-1.5b" else {}
    cfg = dataclasses.replace(TC.smoke_config(arch), dtype=dtype, **over)
    model = TM.init_params(cfg, seed=3, device=cuda_device)
    S, n_new = 20, 10
    prompt = torch.from_numpy(np.random.default_rng(8).integers(0, cfg.vocab_size, (3, S)))
    prompt = prompt.to(cuda_device)
    fe = _frontend(cfg, 3, 15, cuda_device)
    eager = greedy_generate(cfg, model, prompt, n_new, *fe, eager=True)
    attentions = cfg.n_layers * (cfg.family != "ssm") + (
        cfg.encoder_layers + cfg.n_layers if cfg.family == "encdec" else 0)

    routes = {}
    for name, eager_route in (("graph", False), ("eager", True)):
        runs = graphs.kernel_runs()["flash_attention"]
        logits, state = make_prefill_fn(cfg, max_len=S + n_new, eager=eager_route)(
            model, prompt, *fe)
        assert graphs.kernel_runs()["flash_attention"] - runs == attentions * (1 + (not eager_route))
        step = make_serve_step(cfg, eager=eager_route)
        out, tok = [logits.clone()], logits.argmax(dim=-1, keepdim=True)
        for _ in range(n_new - 1):
            logits, state = step(model, tok, state)
            out.append(logits.clone())
            tok = logits.argmax(dim=-1, keepdim=True)
        assert state.position.dim() == 0 and state.position.is_cuda
        assert int(state.position) == S + n_new - 1
        if cfg.family == "encdec":
            assert state.cross_kv[0].shape[2] == 15
        routes[name] = out
    assert graphs.kernel_runs()["flash_attention"] - runs == attentions  # decode runs no K5
    for a, b in zip(routes["graph"], routes["eager"]):
        assert torch.equal(a, b)

    captures = graphs.STATS["captures"]
    assert torch.equal(greedy_generate(cfg, model, prompt, n_new, *fe), eager)
    assert graphs.STATS["captures"] == captures


def test_decode_graph_is_keyed_on_the_memory_length(cuda_device, no_tf32):
    """seamless: a request with another number of frames captures decode and
    prefill graphs of its own (the memory is never padded), both routes
    give the same tokens for each, and a prefill into a graph's state sized
    to another memory length is refused."""
    cfg = TC.smoke_config("seamless-m4t-medium")
    model = TM.init_params(cfg, seed=5, device=cuda_device)
    prompt = torch.from_numpy(np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 12)))
    prompt = prompt.to(cuda_device)
    n_new = 6
    captures = graphs.STATS["captures"]
    for frames in (12, 17, 12):
        fe = _frontend(cfg, 2, frames, cuda_device)
        got = greedy_generate(cfg, model, prompt, n_new, *fe)
        assert torch.equal(got, greedy_generate(cfg, model, prompt, n_new, *fe, eager=True))
    assert graphs.STATS["captures"] - captures == 4  # decode and prefill per memory length
    state = decode_graph(cfg, model, 2, 12 + n_new, 12).state
    assert graphs.STATS["captures"] - captures == 4  # the 12-frame graph, as it was
    with pytest.raises(ValueError, match="out state"):
        TM.prefill(cfg, model, prompt, *_frontend(cfg, 2, 17, cuda_device), max_len=12 + n_new,
                   out=state)


def test_decode_graph_follows_rebound_parameters(cuda_device, no_tf32):
    """A parameter re-bound after the capture: a state prefilled before
    refuses the stale decode graph, and the next request captures new
    decode and prefill graphs over the current weights, equal to the eager
    route bit for bit."""
    cfg = TC.smoke_config("qwen3-1.7b")
    model = TM.init_params(cfg, seed=3, device=cuda_device)
    prompt = torch.from_numpy(np.random.default_rng(8).integers(0, cfg.vocab_size, (3, 12)))
    prompt = prompt.to(cuda_device)
    n_new = 6
    greedy_generate(cfg, model, prompt, n_new)  # captures the decode and prefill graphs
    logits, state = make_prefill_fn(cfg, max_len=12 + n_new)(model, prompt)
    g = torch.Generator(device=cuda_device).manual_seed(4)
    model.final_norm = torch.nn.Parameter(
        torch.randn(model.final_norm.shape, generator=g, device=cuda_device), requires_grad=False)
    with pytest.raises(ValueError, match="no longer holds"):
        make_serve_step(cfg)(model, logits.argmax(dim=-1, keepdim=True), state)
    captures = graphs.STATS["captures"]
    routes = {}
    for name, eager in (("graph", False), ("eager", True)):
        logits, state = make_prefill_fn(cfg, max_len=12 + n_new, eager=eager)(model, prompt)
        logits, state = make_serve_step(cfg, eager=eager)(
            model, logits.argmax(dim=-1, keepdim=True), state)
        routes[name] = logits.clone()
    assert graphs.STATS["captures"] == captures + 2
    assert torch.equal(routes["graph"], routes["eager"])
    assert torch.equal(greedy_generate(cfg, model, prompt, n_new),
                       greedy_generate(cfg, model, prompt, n_new, eager=True))


def _attentions(cfg) -> int:
    """K5's launches in one forward: each self-attention, and for encdec the
    encoder's layers and each decoder layer's cross-attention."""
    return cfg.n_layers * (cfg.family != "ssm") + (
        cfg.encoder_layers + cfg.n_layers if cfg.family == "encdec" else 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mixtral-8x7b", "mamba2-1.3b", "hymba-1.5b",
                                  "seamless-m4t-medium", "internvl2-2b"])
def test_graphed_prefill_equals_the_eager_route(cuda_device, no_tf32, arch, dtype):
    """Every family's smoke config (hymba with GQA and its prompt rolled
    into a 16-slot ring, seamless with a 15-frame memory): the prefill
    graph's logits, every cache and the position equal the eager route's
    bit for bit, K5 (and mixtral's K4) inside the graph; it wrote into its
    decode graph's state; a second request of the shape captures nothing,
    its replay runs K5 once an attention and K4 once a layer; another
    prompt length captures a prefill graph of its own."""
    over = {"n_kv_heads": 2} if arch == "hymba-1.5b" else {}
    cfg = dataclasses.replace(TC.smoke_config(arch), dtype=dtype, **over)
    model = TM.init_params(cfg, seed=3, device=cuda_device)
    S, max_len = 20, 26
    prompt = torch.from_numpy(np.random.default_rng(8).integers(0, cfg.vocab_size, (3, S)))
    prompt = prompt.to(cuda_device)
    fe = _frontend(cfg, 3, 15, cuda_device)
    want, eager_state = make_prefill_fn(cfg, max_len=max_len, eager=True)(model, prompt, *fe)
    got, state = make_prefill_fn(cfg, max_len=max_len)(model, prompt, *fe)
    assert torch.equal(got, want)
    caches, want_caches = TM.state_tensors(state), TM.state_tensors(eager_state)
    assert set(caches) == set(want_caches)
    assert all(torch.equal(caches[k], want_caches[k]) for k in caches)
    assert int(state.position) == int(eager_state.position) == S
    memory_len = 15 if cfg.family == "encdec" else None
    assert state is decode_graph(cfg, model, 3, max_len, memory_len).state

    captures, runs = graphs.STATS["captures"], graphs.kernel_runs()
    again, _ = make_prefill_fn(cfg, max_len=max_len)(model, prompt, *fe)
    assert torch.equal(again, want) and graphs.STATS["captures"] == captures
    ran = {k: n - runs[k] for k, n in graphs.kernel_runs().items()}
    assert ran == {**{k: 0 for k in ran}, "flash_attention": _attentions(cfg),
                   "queue_dispatch": cfg.n_layers if cfg.family == "moe" else 0}
    shorter, _ = make_prefill_fn(cfg, max_len=max_len)(model, prompt[:, :S - 4], *fe)
    assert graphs.STATS["captures"] == captures + 1
    assert torch.equal(shorter, make_prefill_fn(cfg, max_len=max_len, eager=True)(
        model, prompt[:, :S - 4], *fe)[0])


def _train_run(cfg, tcfg, batches, eager: bool) -> tuple:
    """Steps of ``make_train_step`` from the seed-0 state on ``batches``:
    (the state, each step's metrics as floats, the kernels each ran, the
    state's tensors' addresses after each step)."""
    state = init_train_state(cfg, tcfg, seed=0, device="cuda")
    step = make_train_step(cfg, tcfg, eager=eager)
    metrics, kernels, addresses = [], [], []
    for toks in batches:
        runs = graphs.kernel_runs()
        state, m = step(state, toks[:, :-1], toks[:, 1:])
        metrics.append({k: float(v) for k, v in m.items()})
        kernels.append({k: n - runs[k] for k, n in graphs.kernel_runs().items()})
        addresses.append([t.data_ptr() for t in _train_tensors(state)])
    return state, metrics, kernels, addresses


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mixtral-8x7b"])
def test_graphed_train_step_matches_the_eager_route(cuda_device, arch):
    """Three bf16 steps with remat through the graph and twice on the eager
    route from the same init: the two eager runs equal bit for bit in
    every metric and every state tensor (the step is a pure function);
    step 0, the capture's warm-up, gives the eager step's loss bit for bit;
    every graphed step's loss and grad norm equal the eager route's or lie
    within 1e-4 relative; one capture; every step runs K5 twice a layer
    and its backward once (mixtral K4 twice a layer), replays included;
    every state tensor keeps its address."""
    cfg = dataclasses.replace(TC.smoke_config(arch), dtype="bfloat16", remat=True)
    tcfg = TrainConfig(peak_lr=1e-3, warmup_steps=1, total_steps=4)
    rng = np.random.default_rng(6)
    batches = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 33))).to(cuda_device)
               for _ in range(3)]
    captures = graphs.STATS["captures"]
    _, graph, kernels, addresses = _train_run(cfg, tcfg, batches, eager=False)
    assert graphs.STATS["captures"] == captures + 1
    state, eager, _, _ = _train_run(cfg, tcfg, batches, eager=True)
    state_again, again, _, _ = _train_run(cfg, tcfg, batches, eager=True)
    assert again == eager
    assert all(torch.equal(a, b) for a, b in zip(_train_tensors(state_again),
                                                 _train_tensors(state), strict=True))
    assert graph[0]["loss"] == eager[0]["loss"]
    for g, e in zip(graph, eager):
        for k in ("loss", "grad_norm"):
            assert abs(g[k] - e[k]) <= 1e-4 * abs(e[k]), (k, g, e)
    want = {"flash_attention": 2 * cfg.n_layers, "flash_attention_bwd": cfg.n_layers,
            "queue_dispatch": 2 * cfg.n_layers if cfg.family == "moe" else 0}
    assert all(k == {**{n: 0 for n in k}, **want} for k in kernels), kernels
    assert all(a == addresses[0] for a in addresses)


def test_train_graph_capture_releases_the_warm_up(cuda_device):
    """A bf16 step with remat off whose temporaries (hundreds of MB) dwarf
    its inputs: after the first call (the warm-up, then the capture) the
    caching allocator holds the state, the graph's pool and the small
    static inputs and metrics, not the warm-up's temporaries, which were
    freed from the cache before the capture drew its pool; the next step
    replays in that pool."""
    cfg = dataclasses.replace(TC.smoke_config("qwen3-1.7b"), d_model=512, n_heads=8,
                              n_kv_heads=4, head_dim=64, d_ff=2048, vocab_size=8192,
                              logit_chunk=512, dtype="bfloat16", remat=False)
    tcfg = TrainConfig(peak_lr=1e-3, warmup_steps=1, total_steps=4)
    state = init_train_state(cfg, tcfg, seed=0, device=cuda_device)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (8, 513)))
    toks = toks.to(cuda_device)
    step = make_train_step(cfg, tcfg)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base, allocated = torch.cuda.memory_reserved(), torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    pool = graphs.STATS["pool_bytes"]
    state, _ = step(state, toks[:, :-1], toks[:, 1:])
    pool = graphs.STATS["pool_bytes"] - pool
    temporaries = torch.cuda.max_memory_allocated() - allocated
    slack = 16 << 20  # the static inputs' and the metrics' segments
    assert temporaries > 8 * slack and pool > 0
    assert torch.cuda.memory_reserved() - base <= pool + slack
    reserved = torch.cuda.memory_reserved()
    state, metrics = step(state, toks[:, :-1], toks[:, 1:])
    assert torch.cuda.memory_reserved() == reserved
    assert bool(torch.isfinite(metrics["loss"]))


def test_mesh_prefill_and_pjit_step_are_graphs_at_world_one(cuda_device, nccl_world, no_tf32):
    """Mesh (1, 1) over NCCL, qwen3's smoke config: the mesh prefill is a
    graph with its collectives whose logits and caches equal the mesh
    eager route's bit for bit, its greedy tokens the single-card graphs';
    the pjit step is a graph whose first loss (the warm-up) equals the
    eager pjit step's bit for bit, one capture, then a replay within 1e-5
    of the eager route's (fp32)."""
    from repro_torch.checkpoint.elastic import reshard_state
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serving import serve_loop

    cfg = TC.smoke_config("qwen3-1.7b")
    mesh = make_host_mesh(model=1, device_type="cuda")
    model = TM.init_params(cfg, seed=3, device=cuda_device)
    tm = serve_loop.shard_model(cfg, model, mesh)
    prompt = torch.from_numpy(np.random.default_rng(8).integers(0, cfg.vocab_size, (4, 12)))
    prompt = prompt.to(cuda_device)
    captures = graphs.STATS["captures"]
    got, state = serve_loop.make_prefill_fn(cfg, mesh, 4, 18)(tm, prompt)
    assert graphs.STATS["captures"] == captures + 2  # the mesh decode and prefill graphs
    got = got.clone()
    caches = {k: t.clone() for k, t in TM.state_tensors(state).items()}
    want, eager_state = serve_loop.make_prefill_fn(cfg, mesh, 4, 18, eager=True)(tm, prompt)
    assert torch.equal(got, want)
    assert all(torch.equal(t, TM.state_tensors(eager_state)[k]) for k, t in caches.items())
    logits, state = serve_loop.make_prefill_fn(cfg, mesh, 4, 18)(tm, prompt)
    step, tok, tokens = serve_loop.make_serve_step(cfg, mesh, 4), None, []
    for _ in range(5):
        tok = logits.argmax(dim=-1, keepdim=True)
        tokens.append(tok)
        logits, state = step(tm, tok, state)
    assert torch.equal(torch.cat(tokens, dim=1), greedy_generate(cfg, model, prompt, 5))

    tcfg = TrainConfig(peak_lr=1e-3, warmup_steps=1, total_steps=4)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 4, 17)))
    toks = toks.to(cuda_device)
    losses = {}
    for eager in (False, True):
        st = reshard_state(init_train_state(cfg, tcfg, seed=0, device=cuda_device), cfg, mesh)
        step = make_train_step(cfg, tcfg, mesh=mesh, mode="pjit", eager=eager)
        captures = graphs.STATS["captures"]
        losses[eager] = [float(step(st, t[:, :-1], t[:, 1:])[1]["loss"]) for t in toks]
        assert graphs.STATS["captures"] == captures + (not eager)
    assert losses[False][0] == losses[True][0]
    assert abs(losses[False][1] - losses[True][1]) <= 1e-5 * abs(losses[True][1])


def test_graph_counts_the_model_axis_collectives_at_replay(cuda_device):
    """``tp.STATS`` counts the model axis's collectives that ran: a graph's
    capture takes the calls it recorded back out, and every replay adds
    them (as ``graphs.kernel_runs`` counts kernels)."""
    from repro_torch.sharding import tp

    t = torch.zeros(4, device=cuda_device)

    def fn():
        tp._count("all_reduce", t)  # what Axis.all_reduce counts for its call
        return t.add_(1)

    tp.reset_stats()
    g = graphs.Graph(fn)  # its warm-up runs fn once eagerly
    assert tp.STATS["all_reduce"] == {"calls": 1, "bytes": 16}
    for _ in range(3):
        g.replay()
    torch.cuda.synchronize()
    assert tp.STATS["all_reduce"] == {"calls": 4, "bytes": 64}
    assert tp.STATS["all_gather"] == {"calls": 0, "bytes": 0}
    assert float(t[0]) == 4.0


def test_transfer_watch_raises_on_planted_syncs(cuda_device):
    """On the card the watch raises on an implicit pull and a pageable
    copy; the counted spellings and the explicit waits do not."""
    x = torch.arange(64, dtype=torch.int32, device=cuda_device)
    host = torch.arange(64, dtype=torch.int32)
    dst = torch.empty_like(x)
    for planted in (lambda: x.sum().item(), lambda: host.to(cuda_device), lambda: dst.copy_(host)):
        with runtime.transfer_watch():
            with pytest.raises(RuntimeError, match="synchroniz"):
                planted()
    with runtime.transfer_watch() as tw:
        (got,) = runtime.device_fetch((x,))
        runtime.device_put(host, dst)
        runtime.block_until_ready((dst,))
        torch.cuda.synchronize()
    assert (tw.fetches, tw.puts) == (1, 1)
    assert np.array_equal(got, host.numpy()) and torch.equal(dst.cpu(), host)


def test_capture_watch_reports_a_new_batch_length(cuda_device):
    keys, values = make_tree_data(1023, seed=2)
    eng = BSTEngine(keys, values, EngineConfig(device="cuda"))
    eng.query("lookup", np.zeros(64, np.int32))
    with runtime.capture_watch() as cw:
        eng.query("lookup", np.ones(64, np.int32))
        eng.query("lookup", np.ones(32, np.int32))
        eng.query("range_scan", np.ones(32, np.int32), np.ones(32, np.int32), k=4)
    assert cw.keys == [("lookup", None, 32), ("range_scan", 4, 32)]


@pytest.mark.parametrize("sharded", [False, True], ids=["single", "sharded"])
@pytest.mark.parametrize("strategy", ["hrz", "dup", "hyb"])
def test_serve_gate_is_clean_on_the_card(cuda_device, strategy, sharded):
    with gate.world1_group("cuda"):
        errors = gate.serve_gate(strategy, sharded=sharded, device="cuda")
    assert errors == [], report.render_all(errors)


def test_analysis_cli_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: --device cuda is the default")
    assert analysis_main.main(["--repo-root", ".", "--serve-gate"]) == 0


def _train_tensors(state):
    return ([p.detach() for p in state.params.parameters()] + [state.opt.step] + state.opt.master
            + state.opt.mu + state.opt.nu + list(state.error_feedback))


def test_checkpoint_round_trip_on_the_card(cuda_device, tmp_path):
    """A bf16 int8-compression state on the card after one step, saved in
    the background and restored into a fresh state on the card: every
    tensor bit for bit, on the card, in its dtype."""
    from repro_torch.checkpoint import CheckpointManager

    cfg = dataclasses.replace(TC.smoke_config("qwen3-1.7b"), dtype="bfloat16")
    tcfg = TrainConfig(peak_lr=1e-3, warmup_steps=1, total_steps=4, compression="int8")
    state = init_train_state(cfg, tcfg, seed=0, device=cuda_device)
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 17)))
    toks = toks.to(cuda_device)
    state, _ = make_train_step(cfg, tcfg)(state, toks[:, :-1], toks[:, 1:])
    with torch.no_grad():
        for e in state.error_feedback:  # the one-device step leaves it zero
            e.normal_()
    mgr = CheckpointManager(str(tmp_path), save_async=True)
    mgr.save(1, state)
    mgr.wait()
    restored, step, _ = mgr.restore(init_train_state(cfg, tcfg, seed=1, device=cuda_device))
    assert step == 1 and int(restored.opt.step) == 1
    for a, b in zip(_train_tensors(state), _train_tensors(restored), strict=True):
        assert b.is_cuda and a.dtype == b.dtype and torch.equal(a, b)


def test_restored_run_continues_the_run_bit_for_bit(cuda_device, tmp_path):
    """The JAX package's pure-function step on the card (its
    ``tests/test_checkpoint.py``'s elastic restore): qwen3's bf16 smoke
    config with remat, six steps through the step's graph with the state
    saved before step 3; restored into a fresh state, steps 3 to 5 again
    (a new graph); every metric and every state tensor equal to the
    continuous run's, bit for bit."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data.pipeline import TokenPipeline

    cfg = dataclasses.replace(TC.smoke_config("qwen3-1.7b"), dtype="bfloat16", remat=True)
    tcfg = TrainConfig(peak_lr=1e-3, warmup_steps=2, total_steps=20)
    pipe = TokenPipeline(cfg.vocab_size, 16, 4, seed=5)

    def batch(s):
        return tuple(torch.from_numpy(a).to(cuda_device, torch.int64) for a in pipe.batch_at(s))

    mgr = CheckpointManager(str(tmp_path))
    state = init_train_state(cfg, tcfg, seed=0, device=cuda_device)
    step = make_train_step(cfg, tcfg)
    continuous = []
    for s in range(6):
        if s == 3:
            mgr.save(s, state)
        state, m = step(state, *batch(s))
        continuous.append({k: float(v) for k, v in m.items()})
    mgr.wait()
    restored, ck_step, _ = mgr.restore(init_train_state(cfg, tcfg, seed=1, device=cuda_device))
    assert ck_step == 3
    step = make_train_step(cfg, tcfg)
    resumed = []
    for s in range(ck_step, 6):
        restored, m = step(restored, *batch(s))
        resumed.append({k: float(v) for k, v in m.items()})
    assert resumed == continuous[ck_step:]
    assert all(torch.equal(a, b) for a, b in zip(_train_tensors(restored), _train_tensors(state),
                                                 strict=True))


@pytest.mark.parametrize("compression", [None, "bf16", "int8"])
def test_dp_step_at_world_one_over_nccl(cuda_device, nccl_world, compression):
    """``make_train_step(mode="dp_shard_map")`` at world 1 over NCCL on qwen3's
    bf16 smoke config, a CUDA graph with its all-reduces: finite metrics,
    the kernels that ran as the plain step's, the first loss (the capture's
    warm-up) equal to the plain step's from the same state (the forward has
    no atomics), the collectives counted as they ran (2 calls a step, 3
    with int8), one capture and then a replay."""
    from repro_torch.checkpoint.elastic import reshard_state
    from repro_torch.launch.mesh import make_host_mesh

    tl = importlib.import_module("repro_torch.training.train_loop")
    cfg = dataclasses.replace(TC.smoke_config("qwen3-1.7b"), dtype="bfloat16", remat=True)
    tcfg = TrainConfig(peak_lr=1e-3, warmup_steps=1, total_steps=4, compression=compression)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (4, 33)))
    toks = toks.to(cuda_device)
    _, plain = make_train_step(cfg, tcfg)(init_train_state(cfg, tcfg, seed=0, device=cuda_device),
                                          toks[:, :-1], toks[:, 1:])
    mesh = make_host_mesh()
    state = reshard_state(init_train_state(cfg, tcfg, seed=0, device=cuda_device), cfg, mesh)
    step = make_train_step(cfg, tcfg, mesh=mesh, mode="dp_shard_map")
    runs, captures = graphs.kernel_runs(), graphs.STATS["captures"]
    tl.reset_dp_stats()
    for i in range(2):
        state, metrics = step(state, toks[:, :-1], toks[:, 1:])
        assert all(v.is_cuda and bool(torch.isfinite(v)) for v in metrics.values())
        if i == 0:
            assert float(metrics["loss"]) == float(plain["loss"])
    ran = {k: n - runs[k] for k, n in graphs.kernel_runs().items()}
    assert ran == {**{k: 0 for k in ran}, "flash_attention": 4 * cfg.n_layers,
                   "flash_attention_bwd": 2 * cfg.n_layers}
    assert graphs.STATS["captures"] == captures + 1
    assert tl.DP_STATS["calls"] == 2 * (3 if compression == "int8" else 2)
    if compression == "int8":
        assert all(bool(e.any()) for e in state.error_feedback)


TP_CARD_RANKS = 2
TP_CARD_TIMEOUT_S = 300


def _tp_card_worker(rank, world, out):
    """One of two gloo ranks sharing the card, mesh (data 1, model 2): the
    pjit step and the mesh serving steps of qwen3's fp32 smoke config with
    a vocab of 512 (split over the model axis) against the single-card
    steps of the same weights."""
    import json
    import os

    import torch.distributed as dist

    from repro_torch.checkpoint import elastic
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serving import serve_loop

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(out, 'store')}",
                            rank=rank, world_size=world)
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        cfg = dataclasses.replace(TC.smoke_config("qwen3-1.7b"), vocab_size=512, remat=True)
        tcfg = TrainConfig(peak_lr=1e-3, warmup_steps=1, total_steps=4)
        toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (4, 33)))
        toks = toks.cuda()
        mesh = make_host_mesh(model=TP_CARD_RANKS, device_type="cuda")
        plain = init_train_state(cfg, tcfg, seed=0, device="cuda")
        _, m_plain = make_train_step(cfg, tcfg)(plain, toks[:, :-1], toks[:, 1:])
        placed = elastic.reshard_state(init_train_state(cfg, tcfg, seed=0, device="cuda"), cfg,
                                       mesh)
        FA.reset_launches()
        placed, m = make_train_step(cfg, tcfg, mesh=mesh, mode="pjit")(
            placed, toks[:, :-1], toks[:, 1:])
        res = {"loss": [float(m["loss"]), float(m_plain["loss"])],
               "grad_norm": [float(m["grad_norm"]), float(m_plain["grad_norm"])],
               "train_launches": dict(FA.LAUNCHES),
               "sharded": isinstance(placed, elastic.ShardedState)}
        whole = elastic.gather_state(placed, cfg, mesh)
        res["param_err"] = max(float((a.detach() - b.detach()).abs().max()) for a, b in
                               zip(whole.params.parameters(), plain.params.parameters()))
        model = TM.init_params(cfg, seed=0, device="cuda")
        prompt = toks[:, :12]
        want, state = TM.prefill(cfg, model, prompt, max_len=16)
        nxt = want.argmax(dim=-1, keepdim=True)
        want_step, _ = TM.decode_step(cfg, model, nxt, state)
        tm = serve_loop.shard_model(cfg, model, mesh)
        FA.reset_launches()
        got, mstate = serve_loop.make_prefill_fn(cfg, mesh, 4, 16)(tm, prompt)
        res["prefill_launches"] = FA.LAUNCHES["flash_attention"]
        got_step, _ = serve_loop.make_serve_step(cfg, mesh, 4)(tm, nxt, mstate)
        res["logit_err"] = [
            float((serve_loop.gather_logits(cfg, mesh, 4, got) - want).abs().max()),
            float((serve_loop.gather_logits(cfg, mesh, 4, got_step) - want_step).abs().max())]
        res["logits_block"] = list(got.shape)
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def test_tensor_parallel_step_and_serving_on_two_gloo_ranks(cuda_device, tmp_path):
    """Two gloo ranks on the one card (NCCL puts no two ranks on one card),
    mesh (1, 2), qwen3's smoke config in fp32 with a vocab of 512: the
    pjit step's loss and grad norm within 1e-5 of the single-card step's
    and its gathered parameters within 1e-5, K5 launched on each rank's
    heads (forward twice a layer with remat, backward once); the mesh prefill
    and decode step's gathered logits within 1e-4 of the single-card
    steps', each rank's logits its (B, V / 2) vocab block."""
    import json
    import time

    import torch.multiprocessing as torch_mp

    ctx = torch_mp.start_processes(_tp_card_worker, args=(TP_CARD_RANKS, str(tmp_path)),
                                   nprocs=TP_CARD_RANKS, join=False, start_method="spawn")
    deadline = time.monotonic() + TP_CARD_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            assert time.monotonic() < deadline, f"ranks still running after {TP_CARD_TIMEOUT_S} s"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    cfg = TC.smoke_config("qwen3-1.7b")
    for r in range(TP_CARD_RANKS):
        res = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert res["sharded"]
        for key in ("loss", "grad_norm"):
            got, want = res[key]
            assert abs(got - want) <= 1e-5 * max(1.0, abs(want)), (key, got, want)
        assert res["param_err"] <= 1e-5, res["param_err"]
        assert res["train_launches"] == {"flash_attention": 2 * cfg.n_layers,
                                         "flash_attention_bwd": cfg.n_layers}
        assert res["prefill_launches"] == cfg.n_layers
        assert max(res["logit_err"]) <= 1e-4, res["logit_err"]
        assert res["logits_block"] == [4, 256]
