"""The port's kernel entry points against the JAX package's Pallas kernels.

On the CPU ``repro_torch.kernels.ops`` runs each kernel's plain PyTorch
version; it is held bit for bit (tolerance 0: int32 compare-and-add) against
``repro.kernels.ops`` with ``use_ref=False, interpret=True``, the Pallas
kernel in interpret mode, on the same numpy inputs.  The CUDA kernels
themselves run only on the card: ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold them against these plain versions there.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

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
    its kernel's own ``_dispatch_lanes``."""
    n_sub = 1 << split
    if split == 0:
        dest = np.zeros(q.shape, np.int32)
        found = np.zeros(q.shape, bool)
    else:
        dest, _, found = JT.register_layer_route(jt, jnp.asarray(q), split)
    live = jnp.asarray(active) & ~jnp.asarray(found)
    dest = jnp.clip(jnp.asarray(dest), 0, n_sub - 1)
    _, overflow = _dispatch_lanes(dest, live, mapping, n_sub, capacity)
    return np.asarray(overflow)


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
