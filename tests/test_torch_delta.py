"""The port's delta write buffer against the JAX package's.

The same numpy inputs, made from a seed, go through ``repro.core.delta``
(and ``repro.core.tree``) and ``repro_torch.core.delta`` on the CPU; every
output must be bit-identical (tolerance 0: the write path is int32 and
bool only).  The kernels' delta configuration (K2) is held here through its
plain version, ``kernels.ref.bst_*_ref(..., delta=...)``, against the Pallas
body with ``delta=`` in interpret mode; the CUDA kernels themselves are held
to that plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import delta as JD  # noqa: E402
from repro.core import tree as JT  # noqa: E402
from repro.data.keysets import make_tree_data  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch import invariants, runtime  # noqa: E402
from repro_torch.core import delta as TD  # noqa: E402
from repro_torch.core import tree as TT  # noqa: E402
from repro_torch.core.tree import OrderedResult  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

CAPACITIES = [1, 16, 64]


def _same(got, want, tag=""):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want), tag
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype, (tag, i, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{tag} output {i}")


def _t(x):
    return torch.from_numpy(np.array(x))


def _trees(n_keys=300, seed=0):
    keys, values = make_tree_data(n_keys, seed=seed)  # even keys 2..2n
    return keys, JT.build_tree(keys, values), TT.build_tree(keys, values, device="cpu")


def _write_batch(keys, m, seed):
    """m writes: overwrites of stored keys, new odd keys, tombstones of
    stored and absent keys, some repeated (last wins), some padding."""
    rng = np.random.default_rng(seed)
    pool = np.concatenate([keys, keys + 1, keys[:8] - 1])
    k = rng.choice(pool, m).astype(np.int32)
    v = rng.integers(0, 2**31 - 1, m, dtype=np.int32)
    d = rng.random(m) < 0.3
    valid = rng.random(m) > 0.1
    return k, v, d, valid


def _ingest_both(jt, tt, jd, td, k, v, d, valid):
    """One batch through both ingests, classified by each package's own
    ordered descent (the classifications must agree too)."""
    jres = JT.search_reference_ordered(jt, jnp.asarray(k))
    tres = TT.search_reference_ordered(tt, _t(k))
    _same((tres.found, tres.rank), (jres.found, jres.rank), "classification")
    jd = JD.ingest(jd, jnp.asarray(k), jnp.asarray(v), jnp.asarray(d), jnp.asarray(valid),
                   jres.found, jres.rank)
    td = TD.ingest(td, _t(k), _t(v), _t(d), _t(valid), tres.found, tres.rank)
    return jd, td


def _buffers(C, seed=1, n_keys=300):
    """A buffer filled by two batches (the second overrides the first), in
    both packages, over a tree of ``n_keys`` keys."""
    keys, jt, tt = _trees(n_keys, seed)
    jd, td = JD.empty(C), TD.empty(C, device="cpu")
    for i, m in enumerate((C, max(1, C // 2))):
        jd, td = _ingest_both(jt, tt, jd, td, *_write_batch(keys, m, seed + 10 * i))
    return keys, jt, tt, jd, td


def _same_buffer(td, jd, tag=""):
    _same(tuple(td), tuple(jd), f"{tag} buffer")


# ------------------------------------------------------------------ ingest
@pytest.mark.parametrize("C", CAPACITIES)
def test_ingest_weights_and_operands_match_jax(C):
    keys, jt, tt, jd, td = _buffers(C)
    assert td.capacity == C
    _same_buffer(td, jd)
    assert int(td.count) > 0
    _same(TD.weights(td), JD.weights(jd), "weights")
    _same(TD.net_keys(td), JD.net_keys(jd), "net_keys")
    _same(TD.operands(td), JD.operands(jd), "operands")
    _same_buffer(TD.empty(C, device="cpu"), JD.empty(C), "empty")


def test_ingest_dedups_last_write_wins():
    keys, jt, tt = _trees(100)
    k = np.array([9, 9, 9, 5, 4], np.int32)
    v = np.array([1, 0, 3, 50, 7], np.int32)
    d = np.array([False, True, False, False, True])
    jd, td = _ingest_both(jt, tt, JD.empty(8), TD.empty(8, device="cpu"), k, v, d,
                          np.ones(5, bool))
    _same_buffer(td, jd)
    assert td.keys[:3].tolist() == [4, 5, 9] and td.values[2] == 3
    assert td.tombstone[:3].tolist() == [True, False, False]
    assert TD.weights(td)[:3].tolist() == [-1, 1, 1]  # 4 is stored, 5 and 9 new


# ----------------------------------------------------------------- resolve
@pytest.mark.parametrize("C", CAPACITIES)
def test_resolve_and_merge_match_jax(C):
    keys, jt, tt, jd, td = _buffers(C)
    rng = np.random.default_rng(C)
    q = rng.choice(np.concatenate([keys, keys + 1, np.asarray(jd.keys[:C])]), 400)
    q = np.where(q == JT.SENTINEL_KEY, 3, q).astype(np.int32)  # inside the op contract
    act = rng.random(q.size) > 0.2
    t_res = TD.resolve(td, _t(q), _t(act))
    j_res = JD.resolve(jd, jnp.asarray(q), jnp.asarray(act))
    _same(t_res, j_res, "resolve")
    _same(TD.resolve_operands(TD.operands(td), _t(q)),
          JD.resolve_operands(JD.operands(jd), jnp.asarray(q)), "resolve_operands")
    _same(tops.bst_delta_resolve(*TD.operands(td), _t(q), _t(act)),
          jops.bst_delta_resolve(*JD.operands(jd), jnp.asarray(q), jnp.asarray(act)),
          "ops.bst_delta_resolve")

    j_tree = JT.search_reference_ordered(jt, jnp.asarray(q))
    t_tree = TT.search_reference_ordered(tt, _t(q))
    _same(TD.merge_ordered(t_tree, *t_res), JD.merge_ordered(j_tree, *j_res), "merge_ordered")
    _same(TD.merge_lookup(t_tree.value, t_tree.found, *t_res[:3]),
          JD.merge_lookup(j_tree.value, j_tree.found, *j_res[:3]), "merge_lookup")


# -------------------------------------------------------------- selection
@pytest.mark.parametrize("C", CAPACITIES)
def test_select_merged_matches_jax(C):
    keys, jt, tt, jd, td = _buffers(C)
    rank_to_bfs = JT.rank_to_bfs_indices(jt.height)
    sk = np.asarray(jt.keys)[rank_to_bfs]
    sv = np.asarray(jt.values)[rank_to_bfs]
    n_real = jt.n_real
    total = n_real + int(JD.net_keys(jd))
    rng = np.random.default_rng(C + 1)
    for shape in ((500,), (60, 7)):
        j = rng.integers(-3, total + 4, shape).astype(np.int32)
        valid = rng.random(shape) > 0.15
        want = JD.select_merged(jnp.asarray(sk), jnp.asarray(sv), n_real, jd,
                                jnp.asarray(j), jnp.asarray(valid))
        got = TD.select_merged(_t(sk), _t(sv), n_real, td, _t(j), _t(valid))
        _same(got, want, f"select_merged {shape}")
    # every merged rank is selected, in key order
    j = np.arange(total, dtype=np.int32)
    k, _, ok = TD.select_merged(_t(sk), _t(sv), n_real, td, _t(j), torch.ones(total, dtype=torch.bool))
    assert bool(ok.all()) and bool((k[1:] > k[:-1]).all())


@pytest.mark.parametrize("C", CAPACITIES)
def test_point_and_range_epilogues_match_jax(C):
    keys, jt, tt, jd, td = _buffers(C)
    rank_to_bfs = JT.rank_to_bfs_indices(jt.height)
    sk, sv = np.asarray(jt.keys)[rank_to_bfs], np.asarray(jt.values)[rank_to_bfs]
    rng = np.random.default_rng(C + 2)
    q = rng.choice(np.concatenate([keys, keys + 1, keys - 1]), 300).astype(np.int32)
    hi = (q + rng.integers(-6, 40, q.size)).astype(np.int32)

    def merged(qq):
        j = JD.merge_ordered(JT.search_reference_ordered(jt, jnp.asarray(qq)),
                             *JD.resolve(jd, jnp.asarray(qq)))
        return j, OrderedResult(*(_t(np.asarray(f)) for f in j))

    j_res, t_res = merged(q)
    for op in ("lookup", "predecessor", "successor"):
        want = JD.point_epilogue(op, jnp.asarray(q), j_res, jnp.asarray(sk), jnp.asarray(sv),
                                 jt.n_real, jd)
        got = TD.point_epilogue(op, _t(q), t_res, _t(sk), _t(sv), tt.n_real, td)
        _same(got, want, op)
    j_hi, t_hi = merged(hi)
    for op in ("range_count", "range_scan"):
        want = JD.range_epilogue(op, jnp.asarray(sk), jnp.asarray(sv), jt.n_real, jd,
                                 j_res, j_hi, k=5)
        got = TD.range_epilogue(op, _t(sk), _t(sv), tt.n_real, td, t_res, t_hi, k=5)
        _same(got, want, op)


# -------------------------------------------------------------- compaction
@pytest.mark.parametrize("C", CAPACITIES)
def test_compaction_matches_jax(C):
    keys, jt, tt, jd, td = _buffers(C)
    out_size = jt.n_real + C
    rank_to_bfs = JT.rank_to_bfs_indices(jt.height)
    want = JD.compact_sorted(jt.keys, jt.values, jnp.asarray(rank_to_bfs), jt.n_real, jd, out_size)
    got = TD.compact_sorted(tt.keys, tt.values, _t(rank_to_bfs), tt.n_real, td, out_size)
    _same(got, want, "compact_sorted")

    fetches = runtime.fetch_count()
    t_new = TD.compact(tt, td)
    assert runtime.fetch_count() - fetches == 1  # the one sync: the new key count
    j_new = JD.compact(jt, jd)
    assert (t_new.height, t_new.n_real) == (j_new.height, j_new.n_real)
    _same((t_new.keys, t_new.values), (j_new.keys, j_new.values), "compact")


@pytest.mark.parametrize("n_real,length", [(1, 1), (5, 9), (300, 300), (511, 600)])
def test_layout_from_sorted_device_matches_jax(n_real, length):
    rng = np.random.default_rng(n_real)
    sk = np.full(length, JT.SENTINEL_KEY, np.int32)
    sv = np.full(length, JT.SENTINEL_VALUE, np.int32)
    sk[:n_real] = np.sort(rng.choice(10**6, n_real, replace=False)).astype(np.int32)
    sv[:n_real] = rng.integers(0, 10**6, n_real, dtype=np.int32)
    want = JT.layout_from_sorted_device(jnp.asarray(sk), jnp.asarray(sv), n_real)
    got = TT.layout_from_sorted_device(_t(sk), _t(sv), n_real)
    assert (got.height, got.n_real) == (want.height, want.n_real)
    _same((got.keys, got.values), (want.keys, want.values), "layout")


def test_compaction_refuses_to_empty_the_tree():
    keys, jt, tt = _trees(3)
    res = TT.search_reference_ordered(tt, _t(keys))
    td = TD.ingest(TD.empty(4, device="cpu"), _t(keys), _t(keys), torch.ones(3, dtype=torch.bool),
                   torch.ones(3, dtype=torch.bool), res.found, res.rank)
    with pytest.raises(ValueError, match="empty the tree"):
        TD.compact(tt, td)


# ------------------------------------------- K2: the kernels' delta config
def _delta_case(C, n_keys=1023, seed=4):
    keys, jt, tt, jd, td = _buffers(C, seed=seed, n_keys=n_keys)
    rng = np.random.default_rng(seed)
    pool = np.concatenate([keys, keys + 1, np.asarray(jd.keys)[np.asarray(jd.keys) < JT.SENTINEL_KEY]])
    return keys, jt, tt, jd, td, rng, pool


@pytest.mark.parametrize(
    "C,T,shared,ordered",
    [(16, 1, False, True), (64, 1, False, False), (64, 4, True, True), (1, 8, True, False)],
)
def test_forest_plain_with_delta_matches_pallas(C, T, shared, ordered):
    keys, jt, tt, jd, td, rng, pool = _delta_case(C)
    B = 512 // T
    q = rng.choice(pool, (T, B)).astype(np.int32)
    act = rng.random((T, B)) > 0.1
    jfn = jops.bst_ordered_forest if ordered else jops.bst_search_forest
    want = jfn(jt.keys[None], jt.values[None], jnp.asarray(q), height=jt.height,
               active=jnp.asarray(act), shared_tree=shared, use_ref=False, interpret=True,
               delta=JD.operands(jd))
    tfn = tops.bst_ordered_forest if ordered else tops.bst_search_forest
    got = tfn(tt.keys[None], tt.values[None], _t(q), tt.height, active=_t(act),
              shared_tree=shared, delta=TD.operands(td))
    _same(got, want, f"forest C={C} T={T} ordered={ordered}")


@pytest.mark.parametrize(
    "C,split,mapping,ordered",
    [(64, 2, "queue", True), (16, 3, "direct", False), (1, 3, "queue", True)],
)
def test_hybrid_plain_with_delta_matches_pallas(C, split, mapping, ordered):
    keys, jt, tt, jd, td, rng, pool = _delta_case(C)
    B = 700  # a full chunk and a ragged one
    q = rng.choice(pool, B).astype(np.int32)
    q[: B // 2] = keys[len(keys) // 3]  # one subtree's key: the stall round runs
    act = rng.random(B) > 0.1
    cap = invariants.buffer_capacity(512, 1 << split, 2.0)
    want = jops.bst_hybrid_forest(
        jt.keys, jt.values, jnp.asarray(q), height=jt.height, split_level=split,
        mapping=mapping, capacity=cap, active=jnp.asarray(act), block_q=512,
        ordered=ordered, use_ref=False, interpret=True, delta=JD.operands(jd),
    )
    overflow = torch.zeros(B, dtype=torch.int32)
    got = tops.bst_hybrid_forest(
        tt.keys, tt.values, _t(q), tt.height, split, mapping=mapping, capacity=cap,
        active=_t(act), ordered=ordered, overflow_out=overflow, delta=TD.operands(td),
    )
    _same(got, want, f"hybrid C={C} split={split} {mapping}")
    assert int(overflow.sum()) > 0


def test_empty_buffer_is_the_read_only_answer():
    keys, jt, tt = _trees(500, seed=3)
    q = _t(np.random.default_rng(0).choice(np.concatenate([keys, keys + 1]), 300).astype(np.int32))
    ops = TD.operands(TD.empty(32, device="cpu"))
    for ordered in (False, True):
        fn = tops.bst_ordered_forest if ordered else tops.bst_search_forest
        plain = fn(tt.keys[None], tt.values[None], q[None], tt.height)
        with_delta = fn(tt.keys[None], tt.values[None], q[None], tt.height, delta=ops)
        for a, b in zip(plain, with_delta):
            assert torch.equal(a, b)
