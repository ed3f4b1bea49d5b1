"""The write-path engine's snapshot at fixed addresses, against the JAX
package and an oracle.

A write-path ``BSTEngine`` keeps one set of snapshot tensors per tree
height (the BFS image, the sorted view and the key count on the device).  A
compaction that keeps the height writes the new snapshot into them, so the
CUDA graphs that read them stay valid; one that changes the height, up or
down, lays out a new set.  On the CPU the same in-place code runs without
capture.  Here a write stream whose compactions first keep the height, then
grow it, then keep it, then shrink it goes through the engine (hrz, dup,
hyb) and the server; every answer is held against a dict + sorted oracle,
and the engine's, once per strategy, against the JAX engine fed the same
stream (tolerance 0: the write path is int32 and bool only; the JAX engine
compiles its queries again for every snapshot, so it answers once, after
the last compaction).  The delta epilogues, which read the key count from
the device and search the padded view, are held bit for bit to the JAX
package's with the buffer empty, half full and full.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import delta as JD  # noqa: E402
from repro.core import tree as JT  # noqa: E402
from repro.core.engine import PAPER_CONFIGS as J_CONFIGS  # noqa: E402
from repro.core.engine import BSTEngine as JEngine  # noqa: E402
from repro.data.keysets import make_tree_data  # noqa: E402
from repro_torch import runtime  # noqa: E402
from repro_torch.core import delta as TD  # noqa: E402
from repro_torch.core import tree as TT  # noqa: E402
from repro_torch.core.engine import PAPER_CONFIGS, BSTEngine  # noqa: E402
from repro_torch.core.tree import OrderedResult  # noqa: E402
from repro_torch.serving import BSTServer  # noqa: E402

OPS = ("lookup", "predecessor", "successor", "range_count", "range_scan")
N_KEYS = (1 << 12) - 1  # a full tree of height 11
CAPACITY = 256  # high-water mark 192
SCAN_K = 4
# (what the big batch of a step writes, and how many steps): every big batch
# of 200 ops crosses the high-water mark and compacts once
STREAM = (("keep", 1), ("grow", 2), ("shrink", 2))
CONFIGS = {"hrz": "Hrz", "dup": "Dup4", "hyb": "Hyb4q"}


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _same(got, want, tag=""):
    got, want = _tuple(got), _tuple(want)
    assert len(got) == len(want), tag
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.dtype == w.dtype, (tag, i, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{tag} output {i}")


def _oracle(kv, op, a, b=None, k=SCAN_K):
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


def _stream(seed=3):
    """The steps of the write stream, each (kind, big batch, small batch,
    reads), with the oracle's store after each step.  A big batch is 200
    ops (it compacts: the buffer holds the last step's 20 pending ops, and
    220 cross the high-water mark without overflowing the buffer); a small
    batch is 20 mixed ops that stay pending, so the reads resolve a buffer
    over the new snapshot."""
    keys, values = make_tree_data(N_KEYS, seed=seed)
    rng = np.random.default_rng(seed)
    kv = dict(zip(keys.tolist(), values.tolist()))
    steps = []

    def batch(k, d):
        v = rng.integers(0, 2**31 - 1, k.size, dtype=np.int32)
        for key, val, dead in zip(k.tolist(), v.tolist(), d.tolist()):
            if dead:
                kv.pop(key, None)
            else:
                kv[key] = val
        return k.astype(np.int32), v, d

    for kind, n_steps in STREAM:
        for _ in range(n_steps):
            stored = np.array(sorted(kv), np.int32)
            fresh = (rng.integers(0, 2 * N_KEYS, 4000) * 2 + 1).astype(np.int32)
            fresh = np.setdiff1d(fresh, stored)
            if kind == "keep":  # overwrites and deletes of stored keys: net -50
                k = rng.choice(stored, 200, replace=False)
                big = batch(k, np.arange(200) < 50)
            elif kind == "grow":  # new keys: net +200
                big = batch(rng.choice(fresh, 200, replace=False), np.zeros(200, bool))
            else:  # deletes of stored keys: net -200
                big = batch(rng.choice(stored, 200, replace=False), np.ones(200, bool))
            small_k = np.concatenate([rng.choice(stored, 10), rng.choice(fresh, 10)])
            small = batch(small_k, rng.random(20) < 0.5)
            q = rng.choice(np.concatenate([stored, fresh[:500], big[0], small[0]]), 300)
            q = q.astype(np.int32)
            hi = (q + rng.integers(-4, 40, q.size)).astype(np.int32)
            steps.append((kind, big, small, q, hi, dict(kv)))
    return keys, values, steps


def _reads(q, hi):
    return [(op, (q, hi) if op in ("range_count", "range_scan") else (q,)) for op in OPS]


def _snapshot_ptrs(eng):
    view = eng.plan.sorted_view()
    return [t.data_ptr() for t in (eng.tree.keys, eng.tree.values, *view)]


@pytest.mark.parametrize("strategy", list(CONFIGS))
def test_engine_snapshot_stays_in_place_at_one_height(strategy):
    """The stream through the engine: each step's big batch compacts once;
    a compaction that keeps the height keeps the snapshot's keys, values,
    sorted view and device count at their addresses, one that changes it
    (up, then down) does not; every answer equals the oracle, and after the
    last compaction the JAX engine's, fed the same stream; the view past
    the count is padding."""
    keys, values, steps = _stream()
    name = CONFIGS[strategy]
    eng = BSTEngine(keys, values, dataclasses.replace(PAPER_CONFIGS[name], device="cpu",
                                                      delta_capacity=CAPACITY))
    jeng = JEngine(keys, values, dataclasses.replace(J_CONFIGS[name], delta_capacity=CAPACITY))
    heights = []
    for i, (kind, big, small, q, hi, kv) in enumerate(steps):
        h, ptrs, compactions = eng.tree.height, _snapshot_ptrs(eng), eng.compactions
        fetches = runtime.fetch_count()
        for e in (eng, jeng):
            e.apply_ops(*big)
        assert eng.compactions == jeng.compactions == compactions + 1
        assert runtime.fetch_count() - fetches == 1  # the compaction's one fetch
        heights.append((h, eng.tree.height))
        if eng.tree.height == h:
            assert _snapshot_ptrs(eng) == ptrs, f"step {i}: a same-height compaction moved a tensor"
        else:
            moved = [a != b for a, b in zip(_snapshot_ptrs(eng), ptrs)]
            assert all(moved), f"step {i}: a height change kept a tensor {moved}"
        for e in (eng, jeng):
            e.apply_ops(*small)
        assert eng.pending_writes() == 20
        assert (eng.tree.height, eng.tree.n_real) == (jeng.tree.height, jeng.tree.n_real)
        view = eng.plan.sorted_view()
        assert view.count.tolist() == [eng.tree.n_real]
        assert bool((view.keys[eng.tree.n_real:] == int(JT.SENTINEL_KEY)).all())
        for op, args in _reads(q, hi):
            got = eng.query(op, *args, k=SCAN_K)
            if i == len(steps) - 1:
                _same(got, jeng.query(op, *args, k=SCAN_K), f"{name} step {i} {op}")
            _same(got, _oracle(kv, op, *args), f"{name} step {i} {op} oracle")
    # the stream's compactions: kept the height, grew it, kept it, shrank it
    assert heights == [(11, 11), (11, 12), (12, 12), (12, 12), (12, 11)]


@pytest.mark.parametrize("strategy", list(CONFIGS))
def test_server_write_stream_across_heights_matches_the_oracle(strategy):
    """The same stream through ``BSTServer`` in one drain (writes and reads
    in submission order, the write path warmed first): every read equals
    the oracle of the store it must see, and the compactions cross the
    heights as in the engine's run."""
    keys, values, steps = _stream()
    cfg = dataclasses.replace(PAPER_CONFIGS[CONFIGS[strategy]], device="cpu",
                              delta_capacity=CAPACITY)
    srv = BSTServer(keys, values, cfg, chunk_size=256, scan_k=SCAN_K)
    srv.warmup(OPS + ("write",))
    assert (srv.engine.compactions, srv.engine.pending_writes()) == (0, 0)
    heights, tickets = [], []
    compact = srv.engine.compact

    def tracked():
        h = srv.engine.tree.height
        out = compact()
        heights.append((h, srv.engine.tree.height))
        return out

    srv.engine.compact = tracked
    for kind, big, small, q, hi, kv in steps:
        for k, v, d in (big, small):
            srv.submit_write(k[~d], v[~d])
            srv.submit_delete(k[d])
        for op, args in _reads(q, hi):
            ticket = srv.submit(*args, op=op) if len(args) == 1 else srv.submit_range(*args, op=op)
            tickets.append((ticket, op, args, kv))
    fetches = runtime.fetch_count()
    got = srv.drain()
    read_chunks = sum(srv.stats.per_op[op].chunks for op in OPS)
    assert runtime.fetch_count() - fetches == read_chunks + srv.stats.compactions
    for ticket, op, args, kv in tickets:
        _same(got[ticket], _oracle(kv, op, *args), f"{strategy} {op}")
    assert heights == [(11, 11), (11, 12), (12, 12), (12, 12), (12, 11)]


# --------------------------------------------------- the padded view's epilogues
def _buffer(fill, C=64, seed=5):
    """A tree and a buffer of ``C`` slots holding ``fill`` distinct keys
    (upserts of stored and new keys, tombstones of stored and absent ones),
    built by one ingest in both packages."""
    keys, values = make_tree_data(1000, seed=seed)  # a height-9 tree of 1023 slots
    jt, tt = JT.build_tree(keys, values), TT.build_tree(keys, values, device="cpu")
    jd, td = JD.empty(C), TD.empty(C, device="cpu")
    if fill:
        rng = np.random.default_rng(seed)
        pool = np.concatenate([keys, keys + 1])
        k = rng.choice(pool, fill, replace=False).astype(np.int32)
        v = rng.integers(0, 2**31 - 1, fill, dtype=np.int32)
        d = rng.random(fill) < 0.3
        ok = np.ones(fill, bool)
        jres = JT.search_reference_ordered(jt, jnp.asarray(k))
        tres = TT.search_reference_ordered(tt, torch.from_numpy(k))
        jd = JD.ingest(jd, *map(jnp.asarray, (k, v, d, ok)), jres.found, jres.rank)
        td = TD.ingest(td, *map(torch.from_numpy, (k, v, d, ok)), tres.found, tres.rank)
    assert int(td.count) == fill
    return keys, jt, tt, jd, td


@pytest.mark.parametrize("fill", [0, 32, 64], ids=["empty", "half", "full"])
def test_epilogues_over_the_padded_view_and_device_count_match_jax(fill):
    """``select_merged`` and both delta epilogues over the snapshot's whole
    sentinel-padded view with the key count as a (1,) device tensor (what
    the engine's graphs read) equal the JAX package's, which takes the
    count as a static int."""
    keys, jt, tt, jd, td = _buffer(fill)
    view = TT.sorted_view_of(tt)
    assert view.keys.shape[0] == tt.n_nodes > tt.n_real and view.count.tolist() == [tt.n_real]
    sk, sv = view.keys.numpy(), view.values.numpy()
    rng = np.random.default_rng(fill)
    total = tt.n_real + int(JD.net_keys(jd))
    j = rng.integers(-3, total + 5, (40, 6)).astype(np.int32)
    valid = rng.random(j.shape) > 0.1
    want = JD.select_merged(jnp.asarray(sk), jnp.asarray(sv), jt.n_real, jd, jnp.asarray(j),
                            jnp.asarray(valid))
    got = TD.select_merged(view.keys, view.values, view.count, td, torch.from_numpy(j),
                           torch.from_numpy(valid))
    _same(got, want, "select_merged")

    q = rng.choice(np.concatenate([keys, keys + 1, keys - 1]), 200).astype(np.int32)
    hi = (q + rng.integers(-6, 40, q.size)).astype(np.int32)

    def merged(x):
        r = JD.merge_ordered(JT.search_reference_ordered(jt, jnp.asarray(x)),
                             *JD.resolve(jd, jnp.asarray(x)))
        return r, OrderedResult(*(torch.from_numpy(np.array(f)) for f in r))

    j_lo, t_lo = merged(q)
    for op in ("lookup", "predecessor", "successor"):
        want = JD.point_epilogue(op, jnp.asarray(q), j_lo, jnp.asarray(sk), jnp.asarray(sv),
                                 jt.n_real, jd)
        got = TD.point_epilogue(op, torch.from_numpy(q), t_lo, view.keys, view.values,
                                view.count, td)
        _same(got, want, op)
    j_hi, t_hi = merged(hi)
    for op in ("range_count", "range_scan"):
        want = JD.range_epilogue(op, jnp.asarray(sk), jnp.asarray(sv), jt.n_real, jd,
                                 j_lo, j_hi, k=5)
        got = TD.range_epilogue(op, view.keys, view.values, view.count, td, t_lo, t_hi, k=5)
        _same(got, want, op)


@pytest.mark.parametrize("fill", [0, 32, 64], ids=["empty", "half", "full"])
def test_merge_into_fixed_tensors_and_in_place_layout_match_jax(fill):
    """The compaction's two steps as the engine runs them: ``merge_sorted``
    from the view and its device count into caller-owned tensors of
    ``n_nodes + C + 1`` slots, then ``write_sorted_`` into a snapshot set of
    the same height, equal the JAX package's ``compact_sorted`` and
    ``compact`` wherever the height holds."""
    keys, jt, tt, jd, td = _buffer(fill)
    snap = TT.snapshot_of(tt)
    out_size = tt.n_nodes + td.capacity
    out = (torch.empty(out_size + 1, dtype=torch.int32), torch.empty(out_size + 1, dtype=torch.int32))
    sk, sv, count = TD.merge_sorted(snap.view.keys, snap.view.values, snap.view.count, td,
                                    out_size, out=out)
    assert sk.data_ptr() == out[0].data_ptr() and sv.data_ptr() == out[1].data_ptr()
    want = JD.compact_sorted(jt.keys, jt.values, jnp.asarray(JT.rank_to_bfs_indices(jt.height)),
                             jt.n_real, jd, out_size)
    _same((sk, sv, count), want, "merge_sorted")
    j_new = JD.compact(jt, jd)
    assert j_new.height == snap.height  # these fills keep the height
    ptrs = [t.data_ptr() for t in (snap.keys, snap.values, *snap.view)]
    TT.write_sorted_(snap, sk, sv, count)
    assert [t.data_ptr() for t in (snap.keys, snap.values, *snap.view)] == ptrs
    _same((snap.keys, snap.values), (j_new.keys, j_new.values), "write_sorted_")
    assert snap.view.count.tolist() == [j_new.n_real]
    _same(tuple(TT.sorted_view_of(snap.tree(j_new.n_real))), tuple(snap.view), "view")
