"""The port's BSTServer against the JAX package's, for every paper config.

The same submissions go to ``repro.serving.BSTServer`` (reference path) and
``repro_torch.serving.BSTServer(device="cpu")``: every answer must agree bit
for bit, and the per-op accounting (served, lanes, chunks) and the found
count must agree exactly.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.engine import PAPER_CONFIGS as J_CONFIGS  # noqa: E402
from repro.data.keysets import make_tree_data  # noqa: E402
from repro.serving import BSTServer as JServer  # noqa: E402
from repro_torch import runtime  # noqa: E402
from repro_torch.core.engine import PAPER_CONFIGS, EngineConfig  # noqa: E402
from repro_torch.serving import BSTServer  # noqa: E402

CHUNK = 256


def _submit_mix(srv, keys, seed):
    rng = np.random.default_rng(seed)
    pool = np.concatenate([keys, keys + 1])
    q = rng.choice(pool, 517).astype(np.int32)
    lo = rng.choice(keys, 300).astype(np.int32)
    hi = (lo + rng.integers(-5, 50, 300)).astype(np.int32)
    return [
        srv.submit(q),
        srv.submit(q[:100], op="predecessor"),
        srv.submit_range(lo, hi, op="range_count"),
        srv.submit_range(lo[:90], hi[:90], op="range_scan"),
        srv.submit(np.array([1], np.int32), op="successor"),
        srv.submit(q[100:400], op="predecessor"),
        srv.submit(np.empty(0, np.int32), op="successor"),  # zero keys
        srv.submit(q[::-1].copy(), op="successor"),
    ]


@pytest.mark.parametrize("name", list(PAPER_CONFIGS))
def test_server_matches_the_jax_server(name):
    keys, values = make_tree_data(1000, seed=7)
    srv = BSTServer(keys, values, dataclasses.replace(PAPER_CONFIGS[name], device="cpu"),
                    chunk_size=CHUNK, scan_k=4)
    jsrv = JServer(keys, values, J_CONFIGS[name], chunk_size=CHUNK, scan_k=4)
    tickets = _submit_mix(srv, keys, seed=1)
    jtickets = _submit_mix(jsrv, keys, seed=1)
    assert srv.pending() == jsrv.pending()
    fetches = runtime.fetch_count()
    got, want = srv.drain(), jsrv.drain()
    assert srv.pending() == 0
    for t, jt in zip(tickets, jtickets):
        assert len(got[t]) == len(want[jt])
        for g, w in zip(got[t], want[jt]):
            assert isinstance(g, np.ndarray) and g.dtype == np.asarray(w).dtype
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=f"{name} ticket {t}")

    s, js = srv.stats, jsrv.stats
    assert runtime.fetch_count() - fetches == s.chunks  # one fetch per chunk
    assert (s.requests, s.submitted, s.served, s.found, s.chunks, s.lanes) == (
        js.requests, js.submitted, js.served, js.found, js.chunks, js.lanes)
    assert set(s.per_op) == set(js.per_op)
    for op, o in s.per_op.items():
        j = js.per_op[op]
        assert (o.served, o.lanes, o.chunks) == (j.served, j.lanes, j.chunks), op
        assert o.busy_s > 0 and o.lanes_per_sec > 0
    assert s.per_op["range_scan"].lanes == 2 * 90  # lo and hi both descend


def test_server_convenience_calls_and_warmup():
    keys, values = make_tree_data(300, seed=9)
    srv = BSTServer(keys, values, EngineConfig(device="cpu"), chunk_size=64)
    srv.warmup(("lookup", "range_scan"))
    assert srv.stats.chunks == 0  # warming serves nothing
    v, f = srv.lookup(keys[:10])
    np.testing.assert_array_equal(v, values[:10])
    assert f.all()
    pk, pv, ok = srv.predecessor(np.array([int(keys[0]) - 1, int(keys[3]) + 1], np.int32))
    assert not ok[0] and ok[1] and int(pk[1]) == int(keys[3]) and int(pv[1]) == int(values[3])
    sk, _, sok = srv.successor(int(keys[-1]) + 1)
    assert not sok[0]
    assert int(srv.range_count(keys[0], keys[-1])[0]) == keys.size
    K, V, taken = srv.range_scan(keys[0], keys[-1])
    assert int(taken[0]) == srv.scan_k
    np.testing.assert_array_equal(K[0], keys[: srv.scan_k])
    np.testing.assert_array_equal(V[0], values[: srv.scan_k])
    assert srv.memory_nodes() == srv.snapshot.n_nodes
    srv.reset_stats()
    assert srv.stats.served == 0


def test_server_rejects_what_this_slice_does_not_serve():
    keys, values = make_tree_data(100, seed=1)
    # a mesh it cannot shard over: the strategy's axis missing, or a chunk
    # that does not split over the axis (checked before any collective)
    with pytest.raises(ValueError, match="shards over axis 'model'"):
        BSTServer(keys, values, EngineConfig(device="cpu"),
                  mesh=types.SimpleNamespace(mesh_dim_names=("data",), shape=(4,)))
    with pytest.raises(ValueError, match="divisible"):
        BSTServer(keys, values, EngineConfig(device="cpu"),
                  mesh=types.SimpleNamespace(mesh_dim_names=("model",), shape=(3,)))
    srv = BSTServer(keys, values, EngineConfig(device="cpu"))
    with pytest.raises(ValueError):
        srv.submit(keys, op="range_count")
    with pytest.raises(ValueError):
        srv.submit_range(keys, keys, op="lookup")
    with pytest.raises(ValueError):
        srv.submit_range(keys, keys[:-1])
    with pytest.raises(ValueError):
        BSTServer(keys, values, EngineConfig(device="cpu"), chunk_size=0)
    with pytest.raises(ValueError, match="delta_capacity"):  # a read-only engine
        srv.submit_write(keys[:1], keys[:1])
