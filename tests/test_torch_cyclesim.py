"""The port's cycle model of the paper's FPGA pipeline against the JAX
package's.

``repro_torch.core.cyclesim`` is a copy of ``repro.core.cyclesim`` (numpy),
whose register-layer route runs in torch on the tree's device (the CPU
here).  The paper's whole evaluation grid (Fig. 7: seven implementations x
three key sets) must give the same ``SimResult`` field for field, on the
same tree and key sets, and keep the JAX package's pins of the paper's
claims: the Fig. 7 relative ordering and Dup8's ~16 keys/cycle
(``tests/test_cyclesim.py``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import tree as JT  # noqa: E402
from repro.core.cyclesim import run_paper_matrix as j_run_paper_matrix  # noqa: E402
from repro.core.cyclesim import simulate as j_simulate  # noqa: E402
from repro.core.engine import PAPER_CONFIGS as J_CONFIGS  # noqa: E402
from repro.data.keysets import make_key_sets, make_tree_data  # noqa: E402
from repro_torch.core import SimResult, run_paper_matrix, simulate  # noqa: E402
from repro_torch.core import tree as TT  # noqa: E402
from repro_torch.core.engine import PAPER_CONFIGS, EngineConfig  # noqa: E402


@pytest.fixture(scope="module")
def matrices():
    keys, values = make_tree_data((1 << 14) - 1, seed=0)
    jtree = JT.build_tree(keys, values)
    sets = make_key_sets(jtree, 16384)
    ttree = TT.build_tree(keys, values, device="cpu")
    return run_paper_matrix(ttree, sets), j_run_paper_matrix(jtree, sets)


def test_paper_matrix_matches_jax_field_for_field(matrices):
    got, want = matrices
    assert list(got) == list(want) == ["equal", "random", "split"]
    for set_name, row in want.items():
        assert list(got[set_name]) == list(row) == list(PAPER_CONFIGS)
        for impl, w in row.items():
            g = got[set_name][impl]
            assert isinstance(g, SimResult)
            assert dataclasses.asdict(g) == dataclasses.asdict(w), (set_name, impl)


def test_fig7_relative_ordering_golden(matrices):
    """The JAX package's pin of the paper's Fig. 7 ordering on the random
    set, against the port: Hrz < Hyb4 < Dup4 < Hyb8q <= Dup8, and each
    queue mapping between its direct twin and the replica ceiling."""
    row = matrices[0]["random"]
    sp = {impl: row["Hrz"].cycles / r.cycles for impl, r in row.items()}
    assert sp["Hrz"] == pytest.approx(1.0)
    assert sp["Hrz"] < sp["Hyb4"] < sp["Dup4"] < sp["Hyb8q"] <= sp["Dup8"], sp
    assert sp["Hyb4"] < sp["Hyb4q"] < sp["Dup4"], sp
    assert sp["Hyb8"] < sp["Hyb8q"] <= sp["Dup8"], sp


def test_dup8_reaches_16_keys_per_cycle(matrices):
    for row in matrices[0].values():
        assert row["Dup8"].keys_per_cycle > 15.5
        assert abs(row["Hrz"].keys_per_cycle - 2.0) < 0.05  # dual-port


def test_stall_accounting_matches_jax_on_one_subtree():
    """16 keys that all route to subtree 0 (the JAX package's pinned trace:
    Hyb4q stalls 2 cycles), for every paper config."""
    keys, values = make_tree_data((1 << 10) - 1, seed=0)
    jtree, ttree = JT.build_tree(keys, values), TT.build_tree(keys, values, device="cpu")
    q = np.zeros(16, np.int32)
    for name, cfg in PAPER_CONFIGS.items():
        got = simulate(cfg, ttree, q)
        assert dataclasses.asdict(got) == dataclasses.asdict(j_simulate(J_CONFIGS[name], jtree, q))
    assert simulate(PAPER_CONFIGS["Hyb4q"], ttree, q).stall_cycles == 2


@pytest.mark.parametrize("name", list(PAPER_CONFIGS))
def test_resolved_register_levels_matches_jax(name):
    assert PAPER_CONFIGS[name].resolved_register_levels() == J_CONFIGS[name].resolved_register_levels()
    for levels in (None, 1, 4):
        t = dataclasses.replace(PAPER_CONFIGS[name], register_levels=levels)
        j = dataclasses.replace(J_CONFIGS[name], register_levels=levels)
        assert t.resolved_register_levels() == j.resolved_register_levels()
    assert EngineConfig(strategy="hyb", n_trees=16).resolved_register_levels() == 4
