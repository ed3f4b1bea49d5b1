"""The port's CUDA kernels on the card, held against their plain versions.

Every test here needs a CUDA card and skips without one.  The file imports
torch, numpy and the port only (the machine with the card has no JAX), so it
runs there on its own:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses
import gc
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
from repro_torch.core.engine import PAPER_CONFIGS, BSTEngine, EngineConfig  # noqa: E402
from repro_torch.data.keysets import make_tree_data  # noqa: E402
from repro_torch.kernels import bst_search as K  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import queue_dispatch as QD  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving import BSTServer, greedy_generate, make_prefill_fn, make_serve_step  # noqa: E402

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
    srv.warmup(("write",))  # the engine's ingest and compaction graphs
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


def test_decode_graph_follows_rebound_parameters(cuda_device, no_tf32):
    """A parameter re-bound after the capture: a state prefilled before
    refuses the stale graph, and the next request captures a new graph
    over the current weights, equal to the eager route bit for bit."""
    cfg = TC.smoke_config("qwen3-1.7b")
    model = TM.init_params(cfg, seed=3, device=cuda_device)
    prompt = torch.from_numpy(np.random.default_rng(8).integers(0, cfg.vocab_size, (3, 12)))
    prompt = prompt.to(cuda_device)
    n_new = 6
    greedy_generate(cfg, model, prompt, n_new)  # captures the decode graph
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
    assert graphs.STATS["captures"] == captures + 1
    assert torch.equal(routes["graph"], routes["eager"])
    assert torch.equal(greedy_generate(cfg, model, prompt, n_new),
                       greedy_generate(cfg, model, prompt, n_new, eager=True))


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
