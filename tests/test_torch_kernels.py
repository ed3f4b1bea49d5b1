"""The port's kernel entry points against the JAX package's Pallas kernels.

On the CPU ``repro_torch.kernels.ops`` runs each kernel's plain PyTorch
version; it is held bit for bit (tolerance 0: int32 compare-and-add) against
``repro.kernels.ops`` with ``use_ref=False, interpret=True``, the Pallas
kernel in interpret mode, on the same numpy inputs.  The CUDA kernels
themselves run only on the card: ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold them against these plain versions there.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import plans as jplans  # noqa: E402
from repro.core import tree as JT  # noqa: E402
from repro.core.engine import BSTEngine as JEngine, EngineConfig as JConfig  # noqa: E402
from repro.data.keysets import leaf_keys, make_tree_data  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.bst_search import _dispatch_lanes  # noqa: E402
from repro_torch import invariants  # noqa: E402
from repro_torch.core import plans as tplans  # noqa: E402
from repro_torch.core import tree as TT  # noqa: E402
from repro_torch.core.engine import BSTEngine, EngineConfig  # noqa: E402
from repro_torch.kernels import bst_search as K  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

EDGE_KEYS = np.array([-(2**31) + 1, 2**31 - 2], np.int32)  # extreme real keys


def _trees(n_keys, seed):
    keys, values = make_tree_data(n_keys, seed=seed)
    return keys, JT.build_tree(keys, values), TT.build_tree(keys, values, device="cpu")


def _queries(keys, size, seed):
    rng = np.random.default_rng(seed)
    pool = np.concatenate([keys, keys + 1, keys - 1, EDGE_KEYS])
    return rng.choice(pool, size=size).astype(np.int32)


def _assert_same(got, want, tag=""):
    assert len(got) == len(want), tag
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.numpy()
        w = np.asarray(w)
        assert g.dtype == w.dtype, (tag, i, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{tag} output {i}")


# -------------------------------------------------- K1: the forest descent
@pytest.mark.parametrize(
    "n_keys,T,B,shared,ordered",
    [
        ((1 << 10) - 1, 1, 1024, False, True),  # hrz, H = 9, perfect
        ((1 << 10) - 1, 1, 1000, False, False),  # hrz, ragged last block
        (40, 4, 250, True, True),  # dup4 on one row, sentinel padding
        (200, 8, 128, True, False),  # dup8 on one row
        (25, 2, 300, False, True),  # a forest of two rows
    ],
)
def test_forest_plain_matches_pallas(n_keys, T, B, shared, ordered):
    keys, jt, tt = _trees(n_keys, seed=n_keys)
    rows = 1 if shared else T
    jk = jnp.tile(jt.keys[None], (rows, 1))
    jv = jnp.tile(jt.values[None], (rows, 1))
    if rows > 1:  # distinct rows: the second tree stores every value + 1
        jv = jv.at[1].add(1)
    q = _queries(keys, T * B, seed=B).reshape(T, B)
    act = np.random.default_rng(T).random((T, B)) > 0.15
    jfn = jops.bst_ordered_forest if ordered else jops.bst_search_forest
    want = jfn(jk, jv, jnp.asarray(q), height=jt.height, active=jnp.asarray(act),
               shared_tree=shared, use_ref=False, interpret=True)
    tfn = tops.bst_ordered_forest if ordered else tops.bst_search_forest
    got = tfn(torch.from_numpy(np.array(jk)), torch.from_numpy(np.array(jv)),
              torch.from_numpy(q), tt.height, active=torch.from_numpy(act),
              shared_tree=shared)
    _assert_same(got, want, f"T={T} shared={shared} ordered={ordered}")


def test_forest_inactive_lanes_keep_the_identities():
    keys, _, tt = _trees(511, seed=3)
    q = torch.from_numpy(_queries(keys, 128, seed=4))[None]
    out = tops.bst_ordered_forest(
        tt.keys[None], tt.values[None], q, tt.height,
        active=torch.zeros(q.shape, dtype=torch.bool),
    )
    val, found, pk, pv, sk, sv, rank = (o[0] for o in out)
    assert not found.any()
    assert (pk == int(TT.NO_PRED_KEY)).all() and (sk == int(TT.NO_SUCC_KEY)).all()
    assert (val == -1).all() and (pv == -1).all() and (sv == -1).all()
    assert (rank == 0).all()


def test_forest_rejects_a_row_count_that_is_not_shared():
    keys, _, tt = _trees(31, seed=1)
    q = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        tops.bst_search_forest(tt.keys[None], tt.values[None], q, tt.height)


# ------------------------------------- the forest body's phases, as twins
FOREST_HEIGHT_KEYS = {0: 1, 1: 3, 7: 200, 8: 300, 10: 1500}  # H: keys (sentinel padding)
FOREST_LAYOUTS = {"hrz": (1, False), "dup4": (4, True), "t3": (3, False)}  # T, shared row


def _tree_buffer(keys, C, seed):
    """A delta buffer over a tree's keys, in numpy: sorted unique live keys
    (stored keys, absent neighbours and the int32 extremes) with an
    INT32_MAX tail of empty slots, values, tombstones, signed weights (0 on
    the empty slots)."""
    rng = np.random.default_rng(seed)
    pool = np.concatenate([rng.choice(keys, C), rng.choice(keys, C) + 1,
                           rng.integers(-(2**31) + 1, 2**31 - 2, C // 4 + 1), EDGE_KEYS])
    live = np.unique(pool.astype(np.int32))
    live = np.sort(rng.choice(live, min(live.size, max(1, C - C // 5)), replace=False))
    dk = np.full(C, 2**31 - 1, np.int32)
    dk[: live.size] = live
    dv = rng.integers(0, 2**31 - 1, C, dtype=np.int32)
    dt = (rng.random(C) < 0.3).astype(np.int32)
    dw = rng.integers(-3, 4, C).astype(np.int32)
    dw[live.size:] = 0
    return (dk, dv, dt, dw), live


def _forest_case(H, layout, C, B, seed):
    """Rows, queries and (with C) a buffer for a forest twin test: distinct
    rows store shifted values; the queries mix stored keys, their
    neighbours, buffer keys and the int32 extremes; a seventh of the lanes
    is inactive."""
    keys, jt, tt = _trees(FOREST_HEIGHT_KEYS[H], seed=seed)
    assert jt.height == H
    T, shared = FOREST_LAYOUTS[layout]
    rows = 1 if shared else T
    fk = np.tile(np.asarray(jt.keys)[None], (rows, 1))
    fv = np.tile(np.asarray(jt.values)[None], (rows, 1)) + np.arange(rows, dtype=np.int32)[:, None]
    d_ops, live = (None, np.empty(0, np.int32)) if C is None else _tree_buffer(keys, C, seed)
    q = _queries(np.concatenate([keys, live]).astype(np.int32), T * B, seed).reshape(T, B)
    q = np.minimum(q, 2**31 - 2)  # INT32_MAX is the empty slots' key: outside the contract
    q[:, :2] = EDGE_KEYS
    act = np.random.default_rng(seed + 1).random((T, B)) > 1 / 7
    return fk, fv, q, act, shared, d_ops


@pytest.mark.parametrize(
    "H,layout,ordered,C",
    [(sorted(FOREST_HEIGHT_KEYS)[i % 5], layout, ordered, C)
     for i, (layout, ordered, C) in enumerate(
         (layout, ordered, C) for layout in FOREST_LAYOUTS for ordered in (False, True)
         for C in (None, 1, 64))],
)
def test_forest_phases_match_pallas(H, layout, ordered, C):
    """The forest kernel's phases composed (the top min(8, H + 1) levels
    from shared memory, two levels per round trip below them, the values
    gathered at the end, the delta buffer through its sample) against the
    Pallas forest kernel in interpret mode: hrz, dup4 on one shared row and
    three unshared rows; H 0, 1 and 7 (every level staged), 8 (a last group
    of one), 10 (a full group, then one); inactive lanes and int32-extreme
    keys."""
    fk, fv, q, act, shared, d_ops = _forest_case(H, layout, C, B=300, seed=H + (C or 0))
    jfn = jops.bst_ordered_forest if ordered else jops.bst_search_forest  # jitted Pallas call
    want = jfn(jnp.asarray(fk), jnp.asarray(fv), jnp.asarray(q), height=H,
               active=jnp.asarray(act), shared_tree=shared, use_ref=False, interpret=True,
               delta=None if d_ops is None else tuple(jnp.asarray(x) for x in d_ops))
    got = tref.bst_forest_phases_ref(
        torch.from_numpy(fk), torch.from_numpy(fv), torch.from_numpy(q), H,
        active=torch.from_numpy(act), ordered=ordered,
        delta=None if d_ops is None else tuple(torch.from_numpy(x) for x in d_ops),
    )
    _assert_same(got, want, f"H={H} {layout} ordered={ordered} C={C}")


@pytest.mark.parametrize("C", [20000, 140000])
def test_forest_phases_with_large_buffers_match_jax_ref(C):
    """The composed forest route against JAX's jnp oracle (jitted) with
    buffers whose sampled lines are 32 slots (C = 20,000) and 64
    (membership) or 128 (ordered) slots (C = 140,000): hrz and dup4."""
    assert [tref.delta_line(C, o) for o in (False, True)] == ([32, 32] if C == 20000 else [64, 128])
    for layout in ("hrz", "dup4"):
        fk, fv, q, act, shared, d_ops = _forest_case(10, layout, C, B=256, seed=C % 997)
        for ordered in (False, True):
            jfn = jops.bst_ordered_forest if ordered else jops.bst_search_forest
            want = jfn(jnp.asarray(fk), jnp.asarray(fv), jnp.asarray(q), height=10,
                       active=jnp.asarray(act), shared_tree=shared, use_ref=True,
                       delta=tuple(jnp.asarray(x) for x in d_ops))
            got = tref.bst_forest_phases_ref(
                torch.from_numpy(fk), torch.from_numpy(fv), torch.from_numpy(q), 10,
                active=torch.from_numpy(act), ordered=ordered,
                delta=tuple(torch.from_numpy(x) for x in d_ops),
            )
            _assert_same(got, want, f"C={C} {layout} ordered={ordered}")


# ------------------------------------------------- K3: the hybrid pipeline
def _skewed_batch(keys, jt, B, seed):
    """70% one leaf key (every lane to one subtree: overflows the buffers),
    the rest mixed present and absent keys."""
    rng = np.random.default_rng(seed)
    leaves = leaf_keys(jt)
    q = _queries(keys, B, seed)
    return np.where(rng.random(B) < 0.7, leaves[len(leaves) // 2], q).astype(np.int32)


def _jax_overflow(jt, q, active, split, mapping, capacity):
    """The JAX package's placement of a whole batch: its register route, then
    its kernel's own ``_dispatch_lanes`` (jitted: one compile, not one per
    eager op)."""
    n_sub = 1 << split

    @jax.jit
    def overflow(q, active):
        if split == 0:
            dest = jnp.zeros(q.shape, jnp.int32)
            found = jnp.zeros(q.shape, bool)
        else:
            dest, _, found = JT.register_layer_route(jt, q, split)
        live = active & ~found
        return _dispatch_lanes(jnp.clip(dest, 0, n_sub - 1), live, mapping, n_sub, capacity)[1]

    return np.asarray(overflow(jnp.asarray(q), jnp.asarray(active)))


@pytest.mark.parametrize(
    "split,mapping,ordered",
    [(2, "queue", True), (3, "direct", True), (3, "queue", False), (2, "direct", False)],
)
def test_hybrid_plain_matches_pallas_per_chunk(split, mapping, ordered):
    keys, jt, tt = _trees(1023, seed=5)
    B = 1024  # two dispatch chunks
    q = _skewed_batch(keys, jt, B, seed=split)
    act = np.random.default_rng(1).random(B) > 0.05
    cap = invariants.buffer_capacity(512, 1 << split, 2.0)
    want = jops.bst_hybrid_forest(
        jt.keys, jt.values, jnp.asarray(q), height=jt.height, split_level=split,
        mapping=mapping, capacity=cap, active=jnp.asarray(act), block_q=512,
        ordered=ordered, use_ref=False, interpret=True,
    )
    overflow = torch.zeros(B, dtype=torch.int32)
    got = tops.bst_hybrid_forest(
        tt.keys, tt.values, torch.from_numpy(q), tt.height, split, mapping=mapping,
        capacity=cap, active=torch.from_numpy(act), ordered=ordered, overflow_out=overflow,
    )
    _assert_same(got, want, f"{mapping} split={split}")
    assert int(overflow.sum()) > 0  # the skew reached the stall round
    # chunk by chunk, the placement is the JAX kernel's own dispatch
    for c in range(B // 512):
        sl = slice(512 * c, 512 * (c + 1))
        np.testing.assert_array_equal(
            overflow[sl].numpy().astype(bool),
            _jax_overflow(jt, q[sl], act[sl], split, mapping, cap),
        )


@pytest.mark.parametrize("mapping", ["queue", "direct"])
def test_hybrid_whole_batch_matches_jax_ref(mapping):
    """block_q = B: the port's plain version reduces to JAX's
    ``ref.bst_hybrid_ref``, overflow masks included."""
    keys, jt, tt = _trees(700, seed=6)
    B, split = 900, 2
    q = _skewed_batch(keys, jt, B, seed=9)
    act = np.random.default_rng(2).random(B) > 0.1
    cap = invariants.buffer_capacity(B, 1 << split, 2.0)
    want = jref.bst_hybrid_ref(jt.keys, jt.values, jnp.asarray(q), jt.height, split,
                               mapping, cap, active=jnp.asarray(act))
    overflow = torch.zeros(B, dtype=torch.int32)
    got = tref.bst_hybrid_ref(tt.keys, tt.values, torch.from_numpy(q), tt.height, split,
                              mapping, cap, active=torch.from_numpy(act), block_q=B,
                              overflow_out=overflow)
    _assert_same(got, want, mapping)
    want_ovf = _jax_overflow(jt, q, act, split, mapping, cap)
    assert want_ovf.any()
    np.testing.assert_array_equal(overflow.numpy().astype(bool), want_ovf)


# ------------------------------------- the hybrid body's phases, as twins
def _hyb_batch(keys, jt, B, seed):
    """A skewed batch (it overflows the buffers) with the int32 extremes
    among its keys and a tenth of its lanes inactive."""
    q = _skewed_batch(keys, jt, B, seed)
    q[: min(B, 2)] = EDGE_KEYS[: min(B, 2)]
    act = np.random.default_rng(seed + 1).random(B) > 0.1
    return q, act


def _fifo_labels(dest, live):
    """The serial network's labels: earlier live lanes of the chunk with the
    same destination."""
    out = np.zeros(dest.shape, np.int32)
    for c in range(dest.shape[0]):
        seen = {}
        for i in np.flatnonzero(live[c]):
            out[c, i] = seen.get(dest[c, i], 0)
            seen[dest[c, i]] = out[c, i] + 1
    return out


@pytest.mark.parametrize("batch", ["skewed", "one_dest"])
@pytest.mark.parametrize("split", [0, 1, 2, 3, 4])
def test_warp_labels_match_jax_dispatch_lanes(split, batch):
    """The kernel's warp-aggregated labels (rank in the warp, per-warp count
    table scanned over the warps) are the FIFO labels, and at every
    capacity place exactly the lanes JAX's ``_dispatch_lanes`` places,
    chunk by chunk: on a skewed batch, and on one whose live lanes all
    share one destination."""
    keys, jt, tt = _trees(1023, seed=5)
    B = 1024
    q, act = _hyb_batch(keys, jt, B, seed=split)
    if batch == "one_dest":
        q[:] = leaf_keys(jt)[split]
    n_sub = 1 << split
    qt = torch.from_numpy(q).reshape(-1, 512)
    at = torch.from_numpy(act).reshape(-1, 512)
    state = tref._walk_state(qt.shape, "cpu")
    state = tref.walk_levels_ref(tt.keys, qt, at, state, tt.height, 0, split,
                                 tref.hybrid_staged_levels(split), False)
    live = at & ~state[1]
    dest = torch.clamp(state[0] - (n_sub - 1), 0, n_sub - 1)
    if batch == "one_dest":
        assert bool(live.any()) and int(dest[live].unique().numel()) == 1
    labels = tref.warp_queue_labels(dest, live, n_sub)
    np.testing.assert_array_equal(labels.numpy(), _fifo_labels(dest.numpy(), live.numpy()))
    for cap in (1, 7, invariants.buffer_capacity(512, n_sub, 0.5)):
        for c in range(B // 512):
            sl = slice(512 * c, 512 * (c + 1))
            np.testing.assert_array_equal(
                (live[c] & (labels[c] >= cap)).numpy(),
                _jax_overflow(jt, q[sl], act[sl], split, "queue", cap),
                err_msg=f"capacity {cap} chunk {c}",
            )


@pytest.mark.parametrize("ordered", [False, True])
@pytest.mark.parametrize("mapping", ["queue", "direct"])
@pytest.mark.parametrize("split", [0, 1, 2, 3, 4])
def test_hybrid_phases_match_pallas(split, mapping, ordered):
    """The kernel's phases composed (route, warp labels or direct clash, the
    descent two levels per round trip with the values gathered at the end)
    against the Pallas kernel in interpret mode at B = 513 (a full chunk
    and a ragged one), and against JAX's jnp oracle at B = 1 and 511 (one
    chunk, which it dispatches whole), overflow mask included.  H = 10:
    below the 8 staged levels a full group of two and a last one of one."""
    keys, jt, tt = _trees(2047, seed=5)
    cap = invariants.buffer_capacity(512, 1 << split, 0.5)
    for B in (513, 511, 1):
        q, act = _hyb_batch(keys, jt, B, seed=B + split)
        if B == 513:
            want = jops.bst_hybrid_forest(
                jt.keys, jt.values, jnp.asarray(q), height=jt.height, split_level=split,
                mapping=mapping, capacity=cap, active=jnp.asarray(act), block_q=512,
                ordered=ordered, use_ref=False, interpret=True,
            )
        else:
            want = jax.jit(functools.partial(
                jref.bst_hybrid_ref, height=jt.height, split_level=split, mapping=mapping,
                capacity=cap, ordered=ordered,
            ))(jt.keys, jt.values, jnp.asarray(q), active=jnp.asarray(act))
        want_ovf = np.zeros(B, bool)
        for c in range(0, B, 512):
            sl = slice(c, c + 512)
            want_ovf[sl] = _jax_overflow(jt, q[sl], act[sl], split, mapping, cap)
        if B == 513:
            assert want_ovf.any()  # the skew reached the stall round
        overflow = torch.full((B,), -7, dtype=torch.int32)
        got = tref.bst_hybrid_phases_ref(
            tt.keys, tt.values, torch.from_numpy(q), tt.height, split, mapping, cap,
            active=torch.from_numpy(act), ordered=ordered, overflow_out=overflow,
        )
        tag = f"B={B} split={split} {mapping}"
        _assert_same(got, want, tag)
        np.testing.assert_array_equal(overflow.numpy().astype(bool), want_ovf, err_msg=tag)


def _sorted_buffer(C, seed):
    """A delta buffer's four operands in numpy: sorted unique keys (the
    extremes among them) with an INT32_MAX tail of empty slots, values,
    tombstones, and signed weights (0 on the empty slots)."""
    rng = np.random.default_rng(seed)
    n_live = max(1, C - C // 5)
    live = rng.choice(np.arange(-(2**31) + 1, 2**31 - 1, 5, dtype=np.int64), n_live, replace=False)
    live[: min(2, n_live)] = EDGE_KEYS[: min(2, n_live)]
    dk = np.full(C, 2**31 - 1, np.int32)
    dk[:n_live] = np.sort(live).astype(np.int32)
    dv = rng.integers(0, 2**31 - 1, C, dtype=np.int32)
    dt = (rng.random(C) < 0.3).astype(np.int32)
    dw = rng.integers(-3, 4, C).astype(np.int32)
    dw[n_live:] = 0
    q = np.concatenate([rng.choice(dk[:n_live], 200), dk[:n_live][:64] + 1,
                        rng.integers(-(2**31) + 1, 2**31 - 2, 200), EDGE_KEYS]).astype(np.int32)
    q = np.minimum(q, 2**31 - 2)  # INT32_MAX is the empty slots' key: outside the contract
    return (dk, dv, dt, dw), q, rng.random(q.size) > 0.1


@pytest.mark.parametrize("C", [1, 2, 33, 4096, 20000, 140000])
def test_delta_line_probe_matches_jax_resolution(C):
    """The hybrid kernel's delta resolution (a sample of the sorted keys,
    then one line of keys and weights) against JAX's broadcast oracle, at
    sample lines of 32 slots and, at 140,000 slots, of 64 (membership) and
    128 (ordered)."""
    ops4, q, act = _sorted_buffer(C, seed=C)
    want = jref.bst_delta_resolve_ref(*(jnp.asarray(x) for x in ops4), jnp.asarray(q),
                                      jnp.asarray(act))
    want = (want[0], want[1], jnp.where(want[0], want[2], 0), want[3])
    for ordered in (False, True):
        line = tref.delta_line(C, ordered)
        assert (line == 32) == (C <= 65536 or not ordered and C <= 131072)
        hit, dead, value, wbelow = tref.delta_line_probe_ref(
            *(torch.from_numpy(x) for x in ops4), torch.from_numpy(q), torch.from_numpy(act), line
        )
        _assert_same((hit, dead, torch.where(hit, value, 0), wbelow), want, f"C={C} line={line}")


@pytest.mark.parametrize("C,split,mapping,ordered", [(1, 3, "queue", True), (64, 2, "direct", False),
                                                      (64, 3, "queue", False)])
def test_hybrid_phases_with_delta_match_pallas(C, split, mapping, ordered):
    """The composed phases with the delta buffer (stored and absent keys
    of the tree) against the Pallas kernel in interpret mode."""
    keys, jt, tt = _trees(1023, seed=5)
    (_, dv, dt, dw), _, _ = _sorted_buffer(C, seed=C)
    live = np.unique(np.random.default_rng(C).choice(np.concatenate([keys, keys + 1]), C))
    dk = np.full(C, 2**31 - 1, np.int32)
    dk[: live.size] = live
    dw[live.size:] = 0
    d_ops = (dk, dv, dt, dw)
    B = 700
    q, act = _hyb_batch(keys, jt, B, seed=C)
    q[B // 2:] = np.random.default_rng(1).choice(np.concatenate([keys, live]), B - B // 2)
    cap = invariants.buffer_capacity(512, 1 << split, 2.0)
    want = jops.bst_hybrid_forest(
        jt.keys, jt.values, jnp.asarray(q), height=jt.height, split_level=split,
        mapping=mapping, capacity=cap, active=jnp.asarray(act), block_q=512,
        ordered=ordered, use_ref=False, interpret=True, delta=tuple(jnp.asarray(x) for x in d_ops),
    )
    overflow = torch.zeros(B, dtype=torch.int32)
    got = tref.bst_hybrid_phases_ref(
        tt.keys, tt.values, torch.from_numpy(q), tt.height, split, mapping, cap,
        active=torch.from_numpy(act), ordered=ordered, overflow_out=overflow,
        delta=tuple(torch.from_numpy(x) for x in d_ops),
    )
    _assert_same(got, want, f"C={C} split={split} {mapping}")
    assert int(overflow.sum()) > 0


# ---------------------------------------------------------------- edge cases
def test_height_zero_tree_matches_pallas():
    jt = JT.build_tree(np.array([100], np.int32), np.array([7], np.int32))
    tt = TT.build_tree(np.array([100], np.int32), np.array([7], np.int32), device="cpu")
    q = np.concatenate([np.array([99, 100, 101], np.int32), EDGE_KEYS])
    want = jops.bst_ordered_forest(jt.keys[None], jt.values[None], jnp.asarray(q)[None],
                                   height=0, use_ref=False, interpret=True)
    got = tops.bst_ordered_forest(tt.keys[None], tt.values[None],
                                  torch.from_numpy(q)[None], 0)
    _assert_same(got, want, "H=0")
    for mapping in ("queue", "direct"):  # split 0: one subtree, the whole tree
        want = jops.bst_hybrid_forest(jt.keys, jt.values, jnp.asarray(q), height=0,
                                      split_level=0, mapping=mapping, capacity=2,
                                      use_ref=True)
        got = tops.bst_hybrid_forest(tt.keys, tt.values, torch.from_numpy(q), 0, 0,
                                     mapping=mapping, capacity=2)
        _assert_same(got, want, f"H=0 {mapping}")


@pytest.mark.parametrize("split", [0, 1, 2])
def test_minimal_hyb_tree_every_split_matches_jax(split):
    """The 7-key tree Hyb4 just fits (height 2), B < 512, extreme keys:
    against the Pallas kernel at Hyb4's split, its jnp twin elsewhere (the
    JAX suite holds the two bit-identical)."""
    keys = np.arange(2, 16, 2, dtype=np.int32)
    jt, tt = JT.build_tree(keys, keys * 3), TT.build_tree(keys, keys * 3, device="cpu")
    q = np.concatenate([np.arange(0, 18, dtype=np.int32), EDGE_KEYS])
    for mapping in ("queue", "direct"):
        want = jops.bst_hybrid_forest(jt.keys, jt.values, jnp.asarray(q), height=2,
                                      split_level=split, mapping=mapping, capacity=3,
                                      use_ref=split != 2, interpret=True)
        got = tops.bst_hybrid_forest(tt.keys, tt.values, torch.from_numpy(q), 2, split,
                                     mapping=mapping, capacity=3)
        _assert_same(got, want, f"split={split} {mapping}")


@pytest.mark.parametrize("B", [1, 37, 511])
def test_dup_batch_not_a_multiple_of_n_trees_matches_jax(B):
    keys, _, _ = _trees(300, seed=B)
    q = _queries(keys, B, seed=B)
    want = JEngine(keys, keys, JConfig(strategy="dup", n_trees=8)).plan
    got = BSTEngine(keys, keys, EngineConfig(strategy="dup", n_trees=8, device="cpu")).plan
    w = jplans.execute_plan_ordered(want, jnp.asarray(q))
    g = tplans.execute_plan_ordered(got, torch.from_numpy(q))
    _assert_same(g, w, f"dup8 B={B}")
    w = jplans.execute_plan(want, jnp.asarray(q))
    g = tplans.execute_plan(got, torch.from_numpy(q))
    _assert_same(g, w, f"dup8 membership B={B}")


# -------------------------------------------------------------- no fallback
def test_cuda_wrappers_refuse_cpu_tensors():
    """A kernel wrapper never runs the plain version: CPU tensors raise."""
    keys, _, tt = _trees(31, seed=2)
    q = torch.from_numpy(_queries(keys, 16, seed=1))
    before = dict(K.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        K.bst_ordered_forest_cuda(tt.keys[None], tt.values[None], q[None], tt.height)
    with pytest.raises(ValueError, match="CUDA"):
        K.bst_hybrid_forest_cuda(tt.keys, tt.values, q, tt.height, 2, "queue", 4)
    assert K.LAUNCHES == before
