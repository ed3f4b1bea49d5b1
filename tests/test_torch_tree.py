"""The port's tree layout against the JAX package's, and the port's isolation.

Inputs are made with numpy from a fixed seed and go through both
``repro.core.tree`` and ``repro_torch.core.tree``; every result must be
bit-identical (tolerance 0: the layout and the descent are int32 only).
"""

import ast
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import tree as JT  # noqa: E402
from repro.data import keysets as jkeysets  # noqa: E402
from repro_torch.core import tree as TT  # noqa: E402
from repro_torch.data import keysets as tkeysets  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _keys_for_height(height: int, seed: int):
    """Unsorted unique keys whose perfect tree has ``height`` and, above
    height 0, some sentinel padding."""
    n_keys = max(1, (1 << (height + 1)) - 1 - height)
    rng = np.random.default_rng(seed)
    keys = rng.permutation(np.arange(1, n_keys + 1, dtype=np.int32) * 3)
    values = rng.integers(-(2**31), 2**31 - 1, n_keys, dtype=np.int32)
    return keys, values


def _queries(keys, size, seed):
    rng = np.random.default_rng(seed)
    pool = np.concatenate([keys, keys + 1, keys - 1, [-(2**31) + 1, 2**31 - 2]])
    return rng.choice(pool, size=size).astype(np.int32)


@pytest.mark.parametrize("height", [0, 1, 5, 10])
def test_tree_layout_and_descents_match_jax(height):
    keys, values = _keys_for_height(height, seed=height)
    jt = JT.build_tree(keys, values)
    tt = TT.build_tree(keys, values, device="cpu")
    assert tt.height == jt.height == height
    assert tt.n_real == jt.n_real
    assert tt.keys.dtype == tt.values.dtype == torch.int32
    np.testing.assert_array_equal(tt.keys.numpy(), np.asarray(jt.keys))
    np.testing.assert_array_equal(tt.values.numpy(), np.asarray(jt.values))
    np.testing.assert_array_equal(
        TT.rank_to_bfs_indices(height), JT.rank_to_bfs_indices(height)
    )
    np.testing.assert_array_equal(
        TT.bfs_inorder_ranks(height), JT.bfs_inorder_ranks(height)
    )
    np.testing.assert_array_equal(
        TT.left_subtree_sizes(height), JT.left_subtree_sizes(height)
    )
    for l in range(height + 1):
        assert (TT.level_offset(l), TT.level_size(l)) == (JT.level_offset(l), JT.level_size(l))
    assert TT.height_for(tt.n_real) == JT.height_for(jt.n_real) == height

    q = _queries(keys, 300, seed=height + 1)
    got_v, got_f = TT.search_reference(tt, torch.from_numpy(q))
    want_v, want_f = JT.search_reference(jt, jnp.asarray(q))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))

    active = np.random.default_rng(height).random(q.size) > 0.2
    got = TT.search_reference_ordered(tt, torch.from_numpy(q), torch.from_numpy(active))
    want = JT.search_reference_ordered(jt, jnp.asarray(q), jnp.asarray(active))
    for name, g, w in zip(want._fields, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)

    if height >= 2:
        for s in (0, 3):
            got_sub, want_sub = tt.subtree(2, s), jt.subtree(2, s)
            np.testing.assert_array_equal(got_sub.keys.numpy(), np.asarray(want_sub.keys))
            assert got_sub.n_real == want_sub.n_real
            assert got_sub.height == want_sub.height


def test_tree_from_numpy_round_trips_a_jax_snapshot():
    keys, values = _keys_for_height(7, seed=3)
    jt = JT.build_tree(keys, values)
    tt = TT.tree_from_numpy(
        np.asarray(jt.keys), np.asarray(jt.values), jt.height, jt.n_real, device="cpu"
    )
    assert (tt.height, tt.n_real, tt.n_nodes) == (jt.height, jt.n_real, jt.n_nodes)
    np.testing.assert_array_equal(tt.keys.numpy(), np.asarray(jt.keys))
    np.testing.assert_array_equal(tt.values.numpy(), np.asarray(jt.values))
    with pytest.raises(ValueError):
        TT.tree_from_numpy(np.asarray(jt.keys)[:-1], np.asarray(jt.values)[:-1], 7, 1)


def test_key_sets_match_jax():
    keys, values = jkeysets.make_tree_data(4095, seed=4)
    tkeys, tvalues = tkeysets.make_tree_data(4095, seed=4)
    np.testing.assert_array_equal(keys, tkeys)
    np.testing.assert_array_equal(values, tvalues)
    want = jkeysets.make_key_sets(JT.build_tree(keys, values), 1000)
    got = tkeysets.make_key_sets(TT.build_tree(keys, values, device="cpu"), 1000)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


# ----------------------------------------------------------------- isolation
def _port_sources():
    base = os.path.join(ROOT, "src", "repro_torch")
    for dirpath, _, files in os.walk(base):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_port_sources_import_no_jax_and_nothing_of_repro():
    sources = list(_port_sources())
    assert len(sources) > 10
    for path in sources:
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad = [n for n in names if _forbidden(n)]
            assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax_and_nothing_of_repro():
    code = (
        "import pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    __import__(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=300
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 12  # every module of the port was imported
