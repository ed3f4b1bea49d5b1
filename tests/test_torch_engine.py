"""The port's BSTEngine against the JAX package's, for every paper config.

The same numpy keys and queries go through ``repro.core.BSTEngine`` and
``repro_torch.core.BSTEngine(device="cpu")``; all five query ops must agree
bit for bit (tolerance 0).  The JAX side runs its reference path, which the
JAX suite holds bit-identical to its Pallas kernel; one case per strategy
runs the Pallas kernel itself in interpret mode.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.engine import PAPER_CONFIGS as J_CONFIGS  # noqa: E402
from repro.core.engine import BSTEngine as JEngine  # noqa: E402
from repro.core.engine import EngineConfig as JConfig  # noqa: E402
from repro.data.keysets import make_tree_data  # noqa: E402
from repro_torch.core import tree as TT  # noqa: E402
from repro_torch.core.engine import PAPER_CONFIGS, BSTEngine, EngineConfig  # noqa: E402

POINT = ("lookup", "predecessor", "successor")


def _cpu(cfg: EngineConfig) -> EngineConfig:
    return dataclasses.replace(cfg, device="cpu")


def _assert_op(eng, jeng, op, a, b=None, k=8, tag=""):
    if b is None:
        got, want = eng.query(op, a), jeng.query(op, a)
    else:
        got, want = eng.query(op, a, b, k=k), jeng.query(op, a, b, k=k)
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype, (tag, op, i)
        np.testing.assert_array_equal(g, w, err_msg=f"{tag} {op} output {i}")
    return got


def _streams(keys, rng, size):
    q = rng.choice(np.concatenate([keys, keys + 1, keys - 1]), size).astype(np.int32)
    lo = rng.choice(np.concatenate([keys, keys + 1]), size).astype(np.int32)
    hi = (lo + rng.integers(-8, 300, size)).astype(np.int32)
    return q, lo, hi


def test_paper_configs_match_the_jax_presets():
    assert list(PAPER_CONFIGS) == list(J_CONFIGS)
    for name, cfg in PAPER_CONFIGS.items():
        j = J_CONFIGS[name]
        assert cfg.device == "cuda"  # the port runs on the card unless asked
        assert (cfg.strategy, cfg.n_trees, cfg.mapping, cfg.register_levels,
                cfg.buffer_slack, cfg.name) == (
            j.strategy, j.n_trees, j.mapping, j.register_levels, j.buffer_slack, j.name)


@pytest.mark.parametrize("name", list(PAPER_CONFIGS))
def test_all_ops_match_the_jax_engine(name):
    keys, values = make_tree_data(1023, seed=11)
    eng = BSTEngine(keys, values, _cpu(PAPER_CONFIGS[name]))
    jeng = JEngine(keys, values, J_CONFIGS[name])
    assert eng.memory_nodes() == jeng.memory_nodes()
    q, lo, hi = _streams(keys, np.random.default_rng(5), 700)
    for op in POINT:
        _assert_op(eng, jeng, op, q, tag=name)
    for op in ("range_count", "range_scan"):
        _assert_op(eng, jeng, op, lo, hi, k=5, tag=name)


@pytest.mark.parametrize("name", list(PAPER_CONFIGS))
def test_boundary_and_range_edges_match_the_jax_engine(name):
    """Below-min / above-max keys, empty / gap / whole-tree ranges."""
    keys, values = make_tree_data(500, seed=2)  # even keys 2..1000
    eng = BSTEngine(keys, values, _cpu(PAPER_CONFIGS[name]))
    jeng = JEngine(keys, values, J_CONFIGS[name])
    kmin, kmax = int(keys[0]), int(keys[-1])
    q = np.array([kmin - 10, kmin - 1, kmax + 1, kmax + 10], np.int32)
    pk, _, pok = _assert_op(eng, jeng, "predecessor", q, tag=name)
    assert not pok[0] and not pok[1] and int(pk[0]) == int(TT.NO_PRED_KEY)
    assert pok[2] and int(pk[2]) == kmax
    sk, _, sok = _assert_op(eng, jeng, "successor", q, tag=name)
    assert sok[0] and int(sk[0]) == kmin
    assert not sok[3] and int(sk[3]) == int(TT.NO_SUCC_KEY)

    lo = np.array([50, 51, kmin, kmax + 1, kmin - 5], np.int32)
    hi = np.array([40, 51, kmax, kmax + 9, kmax + 5], np.int32)
    (counts,) = _assert_op(eng, jeng, "range_count", lo, hi, tag=name)
    assert counts.tolist() == [0, 0, keys.size, 0, keys.size]
    _assert_op(eng, jeng, "range_scan", lo, hi, k=7, tag=name)


@pytest.mark.parametrize(
    "strategy,n_trees,mapping,ops",
    [
        ("hrz", 1, "queue", ("lookup", "range_scan")),
        ("dup", 4, "queue", ("predecessor", "range_count")),
        ("hyb", 8, "direct", ("successor", "range_scan")),
    ],
)
def test_ops_match_the_jax_pallas_kernel_path(strategy, n_trees, mapping, ops):
    keys, values = make_tree_data(1023, seed=3)
    cfg = EngineConfig(strategy=strategy, n_trees=n_trees, mapping=mapping, device="cpu")
    jcfg = JConfig(strategy=strategy, n_trees=n_trees, mapping=mapping,
                   use_kernel=True, interpret=True)
    eng, jeng = BSTEngine(keys, values, cfg), JEngine(keys, values, jcfg)
    q, lo, hi = _streams(keys, np.random.default_rng(8), 512)
    for op in ops:
        if op in POINT:
            _assert_op(eng, jeng, op, q, tag=strategy)
        else:  # the lo || hi descent: a batch of 512 lanes
            _assert_op(eng, jeng, op, lo[:256], hi[:256], k=6, tag=strategy)


@pytest.mark.parametrize("strategy,n_trees", [("hrz", 1), ("dup", 4)])
def test_single_node_tree(strategy, n_trees):
    keys, values = np.array([100], np.int32), np.array([7], np.int32)
    eng = BSTEngine(keys, values, EngineConfig(strategy=strategy, n_trees=n_trees, device="cpu"))
    jeng = JEngine(keys, values, JConfig(strategy=strategy, n_trees=n_trees))
    q = np.array([99, 100, 101], np.int32)
    for op in POINT:
        _assert_op(eng, jeng, op, q, tag=strategy)
    (counts,) = _assert_op(eng, jeng, "range_count", q, q[::-1].copy(), tag=strategy)
    assert counts.tolist() == [1, 1, 0]


def test_engine_inputs_and_errors():
    keys, values = make_tree_data(63, seed=1)
    eng = BSTEngine(keys, values, EngineConfig(strategy="hyb", n_trees=4, device="cpu"))
    v, f = eng.lookup(torch.tensor(keys[:5]))
    assert v.dtype == torch.int32 and f.dtype == torch.bool and bool(f.all())
    with pytest.raises(ValueError):
        eng.query("range_count", keys)  # range ops take (lo, hi)
    with pytest.raises(ValueError):
        eng.query("median", keys)
    with pytest.raises(ValueError):  # a Hyb8 split needs height >= 3
        BSTEngine(keys[:3], values[:3], EngineConfig(strategy="hyb", n_trees=8, device="cpu"))
    tree = TT.build_tree(keys, values, device="cpu")
    same = BSTEngine.from_tree(tree, EngineConfig(device="cpu"))
    np.testing.assert_array_equal(same.lookup(keys)[0].numpy(), values)
