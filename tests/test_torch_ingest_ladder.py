"""The ingest ladder of the port's write path, on the CPU.

Each write slice runs at the smallest rung of ``engine.ingest_ladder`` that
holds it, not padded to the buffer's capacity.  Spans of every length up to
one past the capacity, with repeated keys, deletes and compactions between
and after slices, leave the same buffer, snapshot and answers as the
full-capacity route (every slice padded to the capacity) and as the JAX
package's server; an empty span launches nothing; ``lanes_launched`` counts
what was launched, padding included.
"""

import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.engine import PAPER_CONFIGS as J_CONFIGS  # noqa: E402
from repro.data.keysets import make_tree_data  # noqa: E402
from repro.serving import BSTServer as JServer  # noqa: E402
from repro_torch.analysis import gate  # noqa: E402
from repro_torch.core import distributed as TDist  # noqa: E402
from repro_torch.core.engine import (  # noqa: E402
    PAPER_CONFIGS,
    BSTEngine,
    EngineConfig,
    ingest_ladder,
)
from repro_torch.serving import BSTServer  # noqa: E402

CAPACITY = 64  # ladder 4, 8, 16, 32, 64


@pytest.mark.parametrize("capacity,ladder", [
    (65536, (4096, 8192, 16384, 32768, 65536)),
    (64, (4, 8, 16, 32, 64)),
    (100, (8, 16, 32, 64, 100)),
    (96, (8, 16, 32, 64, 96)),
    (16, (1, 2, 4, 8, 16)),
    (4, (1, 2, 4)),
    (1, (1,)),
])
def test_ladder_is_the_powers_of_two_from_a_sixteenth_capped_by_the_capacity(capacity, ladder):
    assert ingest_ladder(capacity) == ladder


def _log_steps(eng):
    """Log ``eng``'s steps as (graph key, static input shape)."""
    steps = []
    run = eng._run

    def logged(key, step, *args):
        steps.append((key, tuple(args[0].shape) if args else None))
        return run(key, step, *args)

    eng._run = logged
    return steps


def _recording_engine(capacity=CAPACITY, name="Hrz"):
    """A write-path engine on the CPU whose steps are logged."""
    keys, values = make_tree_data(300, seed=9)
    eng = BSTEngine(keys, values, dataclasses.replace(PAPER_CONFIGS[name], device="cpu",
                                                      delta_capacity=capacity))
    return eng, keys, _log_steps(eng)


def test_each_slice_runs_at_the_smallest_rung_that_holds_it():
    eng, keys, steps = _recording_engine()
    assert [eng.ingest_length(m) for m in (0, 1, 4, 5, 8, 9, 16, 17, 32, 33, 63, 64)] == [
        4, 4, 4, 8, 8, 16, 16, 32, 32, 64, 64, 64]
    for m in range(1, CAPACITY + 1):
        del steps[:]
        k = keys[:m]
        eng.apply_ops(k, k + 1, np.zeros(m, bool))
        ingests = [s for s in steps if s[0][0] == "ingest"]
        L = eng.ingest_length(m)
        assert ingests == [(("ingest", L), (4, L))], m
        assert L >= m and (L == ingest_ladder(CAPACITY)[0] or L // 2 < m)
    # a batch past the capacity: capacity-sized slices, the last at its own rung
    del steps[:]
    eng.apply_ops(keys[:CAPACITY + 5], keys[:CAPACITY + 5], np.zeros(CAPACITY + 5, bool))
    assert [s for s in steps if s[0][0] == "ingest"] == [
        (("ingest", 64), (4, 64)), (("ingest", 8), (4, 8))]


def test_warmup_writes_runs_every_rung_and_changes_nothing():
    eng, keys, steps = _recording_engine()
    eng.warmup_writes()
    assert [s[0] for s in steps] == [("ingest", L) for L in ingest_ladder(CAPACITY)] + [
        ("merge",), ("layout",)]
    assert eng.pending_writes() == 0 and eng.compactions == 0
    assert int(eng.delta.count) == 0
    with pytest.raises(ValueError, match="write path disabled"):
        BSTEngine(keys, keys, EngineConfig(device="cpu")).ingest_length(1)


def _full_capacity(srv):
    """``srv`` with every write slice padded to the buffer's capacity: the
    route before the ladder, one ingest length."""
    srv.engine._ladder = (srv.engine.config.delta_capacity,)
    return srv


def _events(srv, log):
    """Log the engine's ingests ("i") and compactions ("c"), and the end of
    each write span ("|")."""
    eng = srv.engine
    ingest, compact, serve = eng._ingest, eng.compact, srv._serve_write_span

    def logged_ingest(*args):
        log.append("i")
        return ingest(*args)

    def logged_compact():
        log.append("c")
        return compact()

    def logged_span(*args):
        serve(*args)
        log.append("|")

    eng._ingest, eng.compact, srv._serve_write_span = logged_ingest, logged_compact, logged_span


def _stream(srv, keys, seed):
    """Write spans of 1 ... capacity + 1 lanes, each a write then a delete
    request (keys repeat within a span and across its slices and spans),
    with reads of every kind between them."""
    rng = np.random.default_rng(seed)
    pool = np.concatenate([keys[:40], keys[:40] + 1])  # few keys: many repeats
    subs = []
    for n in range(1, CAPACITY + 2):
        nd = n // 3
        wk = rng.choice(pool, n - nd).astype(np.int32)
        subs.append(("write", srv.submit_write(wk, (wk * 7 + n).astype(np.int32))))
        if nd:
            subs.append(("delete", srv.submit_delete(rng.choice(pool, nd).astype(np.int32))))
        q = rng.choice(np.concatenate([pool, keys]), 20).astype(np.int32)
        subs.append(("lookup", srv.submit(q)))
        if n % 8 == 0:
            subs.append(("predecessor", srv.submit(q, op="predecessor")))
            subs.append(("range_scan", srv.submit_range(q, q + 30, op="range_scan")))
    return subs


def _host(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


# The JAX server compacts slowly on the CPU (~0.7 s each, 40-odd here): it
# checks one config per descent kernel; every config is held to the
# full-capacity route.
JAX_CHECKED = ("Hrz", "Hyb8q")


@pytest.mark.parametrize("name", ["Hrz", "Dup4", "Hyb8q"])
def test_ladder_drain_equals_the_full_capacity_route_and_the_jax_server(name):
    keys, values = make_tree_data(300, seed=11)
    cfg = dataclasses.replace(PAPER_CONFIGS[name], device="cpu", delta_capacity=CAPACITY)
    srv = BSTServer(keys, values, cfg, chunk_size=CAPACITY, scan_k=4)
    servers = [srv, _full_capacity(BSTServer(keys, values, cfg, chunk_size=CAPACITY, scan_k=4))]
    if name in JAX_CHECKED:
        servers.append(JServer(keys, values,
                               dataclasses.replace(J_CONFIGS[name], delta_capacity=CAPACITY),
                               chunk_size=CAPACITY, scan_k=4))
    log = []
    _events(srv, log)
    subs = [_stream(s, keys, seed=4) for s in servers]
    outs = [s.drain() for s in servers]

    for route, (ref, ref_subs) in zip(("full route", "JAX"), zip(outs[1:], subs[1:])):
        for (op, t), (_, tr) in zip(subs[0], ref_subs):
            assert len(outs[0][t]) == len(ref[tr]), (route, op)
            for g, w in zip(outs[0][t], ref[tr]):
                np.testing.assert_array_equal(g, _host(w),
                                              err_msg=f"{name} {op} ticket {t}: {route}")
    spans = "".join(log).split("|")[:-1]
    assert len(spans) == CAPACITY + 1
    assert any("ici" in s for s in spans)  # a compaction between two slices of a span
    assert any(s.endswith("c") for s in spans)  # and one after a span's last slice
    assert srv.stats.compactions >= 20
    for other in servers[1:]:
        assert (other.stats.compactions, other.stats.chunks) == (srv.stats.compactions,
                                                                 srv.stats.chunks)
        # the buffer (every column and the count) and the snapshot, pending writes included
        eng, ref = srv.engine, other.engine
        assert eng.pending_writes() == ref.pending_writes() > 0
        for g, w in zip(eng.delta, ref.delta):
            np.testing.assert_array_equal(_host(g), _host(w))
        assert (eng.tree.height, eng.tree.n_real) == (ref.tree.height, ref.tree.n_real)
        np.testing.assert_array_equal(_host(eng.tree.keys), _host(ref.tree.keys))
        np.testing.assert_array_equal(_host(eng.tree.values), _host(ref.tree.values))


def test_an_empty_write_span_launches_nothing():
    keys, values = make_tree_data(300, seed=9)
    srv = BSTServer(keys, values, EngineConfig(device="cpu", delta_capacity=CAPACITY),
                    chunk_size=CAPACITY)
    steps = _log_steps(srv.engine)
    t = srv.submit_write(np.empty(0, np.int32), np.empty(0, np.int32))
    d = srv.submit_delete(np.empty(0, np.int32))
    out = srv.drain()
    assert steps == []
    assert int(out[t][0]) == 0 and int(out[d][0]) == 0
    st = srv.stats
    assert (st.chunks, st.lanes, st.lanes_launched, st.updates) == (0, 0, 0, 0)
    assert st.per_op["write"].lanes_launched == st.per_op["delete"].lanes_launched == 0


def _counted_drain(srv, keys):
    """A drain whose launched lanes are counted by hand (capacity and read
    chunk 64, ladder 4 ... 64); returns the expected lanes launched per op
    and the padding lanes."""
    srv.submit(keys[:100])  # 2 read chunks: 128 lanes, 28 padding
    srv.submit_range(keys[:10], keys[:10] + 9, op="range_count")  # 1 chunk, 2 x 64 lanes, 20 used
    srv.submit_write(keys[:5], keys[:5])  # a span of 5 + 3 lanes: rung 8, no padding
    srv.submit_delete(keys[5:8])
    srv.submit(keys[:3], op="successor")  # 1 chunk: 64 lanes, 61 padding
    srv.submit_write(keys[:70], keys[:70])  # slices of 64 (rung 64) and 6 (rung 8): 2 padding
    srv.submit(keys[:1])  # 1 more lookup chunk: 64 lanes, 63 padding
    srv.submit_write(keys[:3], keys[:3])  # 3 + 2 lanes: rung 8, 3 padding, after the delete
    srv.submit_delete(keys[3:5])
    srv.drain()
    launched = {"lookup": 3 * 64, "range_count": 2 * 64, "successor": 64,
                "write": 5 + 70 + 3 + 2, "delete": 3 + 2 + 3}
    padding = 28 + 108 + 61 + 2 + 63 + 3
    return launched, padding


@pytest.mark.parametrize("sharded", [False, True], ids=["single", "sharded"])
def test_lanes_launched_counts_chunk_lengths_and_rungs(sharded):
    keys, values = make_tree_data(300, seed=12)
    cfg = EngineConfig(strategy="hrz", device="cpu", delta_capacity=CAPACITY)
    with gate.world1_group("cpu") if sharded else contextlib.nullcontext():
        mesh = TDist.make_serving_mesh("hrz", device_type="cpu") if sharded else None
        srv = BSTServer(keys, values, cfg, chunk_size=CAPACITY, mesh=mesh)
        launched, padding = _counted_drain(srv, keys)
        st = srv.stats
        del srv, mesh
    assert {op: o.lanes_launched for op, o in st.per_op.items()} == launched
    assert st.lanes_launched == sum(launched.values())
    assert st.lanes_launched - st.lanes == padding
    assert st.chunks == 3 + 1 + 1 + 4  # read chunks, then 1 + 2 + 1 write slices
