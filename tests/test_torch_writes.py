"""The port's write path end to end against the JAX package's and an oracle.

Bulk maintenance (``core.updates``), the engine's delta-buffer stream
(``apply_ops`` / ``apply_updates`` / ``compact``) and the server's
interleaved write/read spans go through ``repro`` (reference path) and
``repro_torch`` (``device="cpu"``) on the same numpy inputs.  Every answer
must agree bit for bit (tolerance 0), and with a dict + sorted oracle of the
store after each batch.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import tree as JT  # noqa: E402
from repro.core import updates as JU  # noqa: E402
from repro.core.engine import PAPER_CONFIGS as J_CONFIGS  # noqa: E402
from repro.core.engine import BSTEngine as JEngine  # noqa: E402
from repro.data.keysets import make_tree_data  # noqa: E402
from repro.serving import BSTServer as JServer  # noqa: E402
from repro_torch import runtime  # noqa: E402
from repro_torch.core import tree as TT  # noqa: E402
from repro_torch.core import updates as TU  # noqa: E402
from repro_torch.core.engine import PAPER_CONFIGS, BSTEngine, EngineConfig  # noqa: E402
from repro_torch.serving import BSTServer  # noqa: E402

OPS = ("lookup", "predecessor", "successor", "range_count", "range_scan")


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _same(got, want, tag=""):
    got, want = _as_tuple(got), _as_tuple(want)
    assert len(got) == len(want), tag
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.dtype == w.dtype, (tag, i, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{tag} output {i}")


def _oracle(kv, op, a, b=None, k=8):
    """Answers from the dict's sorted view (numpy searchsorted)."""
    sk = np.array(sorted(kv), np.int32)
    sv = np.array([kv[x] for x in sk.tolist()], np.int32)
    if op == "lookup":
        i = np.clip(np.searchsorted(sk, a), 0, sk.size - 1)
        found = sk[i] == a
        return np.where(found, sv[i], -1).astype(np.int32), found
    if op == "predecessor":
        i = np.searchsorted(sk, a, "right") - 1
        ok, ii = i >= 0, np.clip(i, 0, None)
        return (np.where(ok, sk[ii], JT.NO_PRED_KEY).astype(np.int32),
                np.where(ok, sv[ii], -1).astype(np.int32), ok)
    if op == "successor":
        i = np.searchsorted(sk, a)
        ok, ii = i < sk.size, np.clip(i, 0, sk.size - 1)
        return (np.where(ok, sk[ii], JT.NO_SUCC_KEY).astype(np.int32),
                np.where(ok, sv[ii], -1).astype(np.int32), ok)
    start = np.searchsorted(sk, a)
    counts = (np.searchsorted(sk, b, "right") - start).clip(0).astype(np.int32)
    if op == "range_count":
        return counts
    take = np.minimum(counts, k).astype(np.int32)
    pos = np.clip(start[:, None] + np.arange(k)[None, :], 0, sk.size - 1)
    valid = np.arange(k)[None, :] < take[:, None]
    return (np.where(valid, sk[pos], JT.SENTINEL_KEY).astype(np.int32),
            np.where(valid, sv[pos], -1).astype(np.int32), take)


def _apply(kv, keys, values, deletes):
    for k, v, d in zip(keys.tolist(), values.tolist(), deletes.tolist()):
        if d:
            kv.pop(k, None)
        else:
            kv[k] = v


# -------------------------------------------------------- bulk maintenance
@pytest.mark.parametrize("case", ["insert", "delete", "insert_then_delete"])
def test_bulk_maintenance_matches_jax(case):
    keys, values = make_tree_data(200, seed=4)
    jt = JT.build_tree(keys, values)
    tt = TT.build_tree(keys, values, device="cpu")
    rng = np.random.default_rng(len(case))
    ik = rng.choice(np.concatenate([keys, keys + 1]), 60).astype(np.int32)  # with repeats
    iv = rng.integers(0, 10**6, ik.size).astype(np.int32)
    dk = rng.choice(np.concatenate([keys, keys + 1]), 50).astype(np.int32)
    if case in ("insert", "insert_then_delete"):
        jt, tt = JU.bulk_insert(jt, ik, iv), TU.bulk_insert(tt, ik, iv)
    if case in ("delete", "insert_then_delete"):
        jt, tt = JU.bulk_delete(jt, dk), TU.bulk_delete(tt, dk)
    assert (tt.height, tt.n_real) == (jt.height, jt.n_real)
    _same((tt.keys, tt.values), (jt.keys, jt.values), case)
    _same(TU.sorted_view(tt), JU.sorted_view(jt), "sorted_view")
    assert TU.bulk_insert(tt, [], []) is tt and TU.bulk_delete(tt, []) is tt
    with pytest.raises(ValueError, match="bulk_delete would empty the tree"):
        TU.bulk_delete(tt, TU.sorted_view(tt)[0])


# ------------------------------------------------------ engine write stream
# One config per strategy is also held to the JAX engine (whose compiles
# take most of this file's time); every config is held to the oracle.
JAX_CHECKED = ("Hrz", "Dup4", "Hyb8q")
# (compactions, pending writes) after each batch of (9, 40, 3) ops with a
# 16-slot buffer and its default high-water mark of 12.
STREAM_COUNTS = [(0, 9), (3, 8), (3, 11)]


@pytest.mark.parametrize("name", list(PAPER_CONFIGS))
def test_engine_write_stream_matches_jax_and_oracle(name):
    """Batches of mixed upserts and tombstones, smaller and larger than the
    capacity, so compactions fire inside the stream; every op is held to
    the oracle (and to the JAX engine, for ``JAX_CHECKED``) with a buffer
    pending before the first compaction and again after several."""
    keys, values = make_tree_data(255, seed=7)
    cfg = dataclasses.replace(PAPER_CONFIGS[name], device="cpu", delta_capacity=16)
    eng = BSTEngine(keys, values, cfg)
    jeng = None
    if name in JAX_CHECKED:
        jeng = JEngine(keys, values, dataclasses.replace(J_CONFIGS[name], delta_capacity=16))
    kv = dict(zip(keys.tolist(), values.tolist()))
    rng = np.random.default_rng(3)
    pool = np.concatenate([keys, keys + 1])
    for step, m in enumerate((9, 40, 3)):
        bk = rng.choice(pool, m).astype(np.int32)
        bv = rng.integers(0, 10**6, m).astype(np.int32)
        bd = rng.random(m) < 0.35
        engines = (eng,) if jeng is None else (eng, jeng)
        if step == 2:  # apply_updates: deletes first, then inserts
            for e in engines:
                e.apply_updates(bk[~bd], bv[~bd], bk[bd])
            _apply(kv, bk[bd], bv[bd], bd[bd])
            _apply(kv, bk[~bd], bv[~bd], bd[~bd])
        else:
            for e in engines:
                e.apply_ops(bk, bv, bd)
            _apply(kv, bk, bv, bd)
        for e in engines:
            assert (e.compactions, e.pending_writes()) == STREAM_COUNTS[step]
        if step == 1:
            continue
        assert eng.pending_writes() > 0
        q = rng.choice(np.concatenate([pool, bk]), 96).astype(np.int32)
        hi = (q + rng.integers(-4, 30, q.size)).astype(np.int32)
        for op in OPS:
            args = (q, hi) if op in ("range_count", "range_scan") else (q,)
            got = eng.query(op, *args, k=4)
            if jeng is not None:
                _same(got, jeng.query(op, *args, k=4), f"{name} step {step} {op}")
            _same(got, _oracle(kv, op, *args, k=4), f"{name} step {step} {op} oracle")
    assert eng.compactions >= 2
    eng.compact()
    assert eng.pending_writes() == 0
    sk = np.array(sorted(kv), np.int32)
    _same(TU.sorted_view(eng.tree), (sk, np.array([kv[x] for x in sk.tolist()], np.int32)))


def test_read_only_engine_rebuilds_on_apply_updates():
    keys, values = make_tree_data(50, seed=3)
    eng = BSTEngine(keys, values, EngineConfig(device="cpu"))
    jeng = JEngine(keys, values)
    with pytest.raises(ValueError, match="write path disabled"):
        eng.apply_ops([1], [1], [False])
    tree = eng.apply_updates(insert_keys=[1, 4], insert_values=[10, 40], delete_keys=[6])
    jtree = jeng.apply_updates(insert_keys=[1, 4], insert_values=[10, 40], delete_keys=[6])
    assert eng.tree is tree and eng.compactions == 0
    _same((tree.keys, tree.values), (jtree.keys, jtree.values), "rebuild")
    v, f = eng.lookup(np.array([1, 4, 6], np.int32))
    assert f.tolist() == [True, True, False] and v[:2].tolist() == [10, 40]


def test_engine_config_validation():
    keys, values = make_tree_data(50, seed=3)
    eng = BSTEngine(keys, values, EngineConfig(delta_capacity=0, device="cpu"))
    with pytest.raises(ValueError, match="delta_capacity == 0"):
        eng.apply_ops([1], [1], [False])
    with pytest.raises(ValueError, match="delta_capacity must be >= 0"):
        EngineConfig(delta_capacity=-4)
    with pytest.raises(ValueError, match="delta_high_water"):
        EngineConfig(delta_capacity=8, delta_high_water=9)
    with pytest.raises(ValueError, match="delta_high_water"):
        EngineConfig(delta_capacity=8, delta_high_water=0)
    eng = BSTEngine(keys, values, EngineConfig(delta_capacity=4, device="cpu"))
    with pytest.raises(ValueError, match="valid mask"):
        eng.apply_ops([1, 2], [1, 2], [False, False], valid=[True])
    with pytest.raises(ValueError, match="equal-length"):
        eng.apply_ops([1, 2], [1], [False, False])
    with pytest.raises(ValueError, match="needs insert_values"):
        eng.apply_updates(insert_keys=[1])
    assert EngineConfig(delta_capacity=8).resolved_high_water() == 6
    assert EngineConfig(delta_capacity=8, delta_high_water=8).resolved_high_water() == 8


# ---------------------------------------------------------------- server
def _submit_stream(srv, keys, seed):
    """Reads, writes and deletes interleaved: each read span must see
    exactly the writes submitted before it."""
    rng = np.random.default_rng(seed)
    pool = np.concatenate([keys, keys + 1])
    subs = []
    for r in range(2):
        wk = rng.choice(pool, 30).astype(np.int32)
        wv = rng.integers(0, 10**6, wk.size).astype(np.int32)
        dk = rng.choice(np.concatenate([pool, wk]), 20).astype(np.int32)
        q = rng.choice(np.concatenate([pool, wk, dk]), 70).astype(np.int32)
        lo = rng.choice(pool, 40).astype(np.int32)
        hi = (lo + rng.integers(-3, 25, lo.size)).astype(np.int32)
        subs += [
            ("lookup", srv.submit(q), q, None),
            ("write", srv.submit_write(wk, wv), wk, wv),
            ("delete", srv.submit_delete(dk), dk, None),
            ("lookup", srv.submit(q), q, None),
            ("predecessor", srv.submit(q, op="predecessor"), q, None),
            ("write", srv.submit_write(wk[:5], wv[:5] + 1), wk[:5], wv[:5] + 1),
            ("successor", srv.submit(q, op="successor"), q, None),
            ("range_count", srv.submit_range(lo, hi, op="range_count"), lo, hi),
            ("range_scan", srv.submit_range(lo, hi, op="range_scan"), lo, hi),
        ]
    return subs


@pytest.mark.parametrize("name", ["Hrz", "Dup4", "Hyb8q"])
def test_server_write_spans_match_jax_and_oracle(name):
    keys, values = make_tree_data(300, seed=5)
    cfg = dataclasses.replace(PAPER_CONFIGS[name], device="cpu", delta_capacity=32)
    srv = BSTServer(keys, values, cfg, chunk_size=64, scan_k=4)
    jsrv = JServer(keys, values, dataclasses.replace(J_CONFIGS[name], delta_capacity=32),
                   chunk_size=64, scan_k=4)
    subs, jsubs = _submit_stream(srv, keys, 1), _submit_stream(jsrv, keys, 1)
    fetches = runtime.fetch_count()
    got, want = srv.drain(), jsrv.drain()

    kv = dict(zip(keys.tolist(), values.tolist()))
    for (op, t, a, b), (_, jt, _, _) in zip(subs, jsubs):
        _same(got[t], want[jt], f"{name} {op} ticket {t}")
        if op == "write":
            _apply(kv, a, b, np.zeros(a.size, bool))
            assert int(got[t][0]) == a.size
        elif op == "delete":
            _apply(kv, a, np.zeros(a.size, np.int32), np.ones(a.size, bool))
        else:
            _same(got[t], _oracle(kv, op, a, b, k=4), f"{name} {op} ticket {t} oracle")
    s, js = srv.stats, jsrv.stats
    assert s.compactions >= 1
    read_chunks = sum(o.chunks for op, o in s.per_op.items() if op in OPS)
    # one fetch per retired read chunk, plus the one sync of each compaction
    assert runtime.fetch_count() - fetches == read_chunks + s.compactions
    assert (s.requests, s.submitted, s.served, s.found, s.chunks, s.lanes, s.updates,
            s.compactions) == (js.requests, js.submitted, js.served, js.found, js.chunks,
                               js.lanes, js.updates, js.compactions)
    for op, o in s.per_op.items():
        assert (o.served, o.lanes, o.chunks) == (js.per_op[op].served, js.per_op[op].lanes,
                                                 js.per_op[op].chunks), op
    assert srv.write(7, 70) == 1 and srv.delete([7, 9]) == 2
    v, f = srv.lookup([7])
    assert not f[0]


def test_server_apply_updates_both_paths():
    keys, values = make_tree_data(100, seed=2)
    live = BSTServer(keys, values, EngineConfig(delta_capacity=8, device="cpu"), chunk_size=32)
    live.apply_updates(insert_keys=[1, 3, 5], insert_values=[10, 30, 50], delete_keys=[2])
    assert (live.stats.updates, live.stats.compactions, live.stats.snapshot_swaps) == (4, 0, 0)
    live.apply_updates(insert_keys=[7, 9], insert_values=[70, 90])
    assert live.stats.compactions == 1 and live.engine.pending_writes() == 0
    bulk = BSTServer(keys, values, EngineConfig(device="cpu"), chunk_size=32)
    bulk.apply_updates(insert_keys=[1, 3, 5, 7, 9], insert_values=[10, 30, 50, 70, 90],
                       delete_keys=[2])
    assert bulk.stats.snapshot_swaps == 1
    for srv in (live, bulk):
        v, f = srv.lookup([1, 2, 9])
        assert f.tolist() == [True, False, True] and v[[0, 2]].tolist() == [10, 90]
    with pytest.raises(ValueError, match="delta_capacity"):
        bulk.submit_write([1], [1])
    with pytest.raises(ValueError, match="delta_capacity"):
        bulk.submit_delete([1])
