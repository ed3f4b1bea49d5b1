"""The port's CUDA kernels on the card, held against their plain versions.

Every test here needs a CUDA card and skips without one.  The file imports
torch, numpy and the port only (the machine with the card has no JAX), so it
runs there on its own:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import tree as TT  # noqa: E402
from repro_torch.core.engine import PAPER_CONFIGS, BSTEngine  # noqa: E402
from repro_torch.data.keysets import make_tree_data  # noqa: E402
from repro_torch.kernels import bst_search as K  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

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
    return keys, values, TT.build_tree(keys, values), torch.from_numpy(q)


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.is_cuda and g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.cpu(), w)


def test_ops_on_cuda_tensors_launch_the_kernels(cuda_device):
    _, _, tt, q = _case(1023, 2000, seed=7)
    tk, tv, qc = tt.keys.to(cuda_device), tt.values.to(cuda_device), q.to(cuda_device)
    K.reset_launches()
    got = ops.bst_ordered_forest(tk[None], tv[None], qc[None], tt.height)
    assert K.LAUNCHES == {"forest_descend": 1, "hybrid_descend": 0}
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
