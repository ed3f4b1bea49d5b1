"""The port's spans (``repro_torch.tracing``) on the CPU.

A tiny write-path ``BSTServer`` serves one mixed drain (reads of three
kinds around writes and a delete, enough writes for a compaction): with no
profiler, ``span`` never enters ``record_function``; under
``torch.profiler`` the trace holds the three program spans and no other
name; with the engine's ``query_static``, ``apply_ops`` and ``compact``
wrapped in probe spans as the benchmark wraps them, no program span
encloses a probe; and every drain gives the same answers.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import tracing  # noqa: E402
from repro_torch.core.engine import EngineConfig  # noqa: E402
from repro_torch.serving import BSTServer  # noqa: E402

PROGRAM_SPANS = {"bst.server.pack", "bst.engine.stage", "bst.server.retire"}
# the names the benchmark's own spans take (``bstbench/kvloop.py``, ``bstbench/drivers/``)
BENCHMARK_SPANS = {"client.submit", "server.drain", "bstbench.traced_window"}
PROBED = ("query_static", "apply_ops", "compact")
KEYS = np.arange(2, 2 * 1023 + 1, 2, dtype=np.int32)  # 1,023 records, even keys


def _server():
    cfg = EngineConfig(strategy="hrz", device="cpu", delta_capacity=64)
    return BSTServer(KEYS, KEYS * 3, cfg, chunk_size=64)


def _drain(srv):
    """One drain of a mixed queue: reads, writes past the buffer's high
    water (a compaction), a delete, and reads that must see them."""
    rng = np.random.default_rng(5)
    srv.submit(rng.choice(KEYS, 100))
    srv.submit_range(KEYS[:20], KEYS[:20] + 40, op="range_count")
    srv.submit(KEYS[:30] + 1, op="predecessor")
    srv.submit_write(KEYS[:90], np.arange(90, dtype=np.int32))
    srv.submit_write(np.array([5, 7], np.int32), np.array([50, 70], np.int32))
    srv.submit_delete(KEYS[10:15])
    srv.submit(np.concatenate([KEYS[:100], [5, 7, 9]]).astype(np.int32))
    srv.submit_range(np.array([0], np.int32), np.array([40], np.int32), op="range_scan")
    return srv.drain()


def _probe(srv):
    """Wrap the engine's three calls on the instance in spans of their own,
    as the benchmark does in a traced segment."""
    eng = srv.engine
    for name in PROBED:
        method = getattr(eng, name)

        def probed(*args, _method=method, _name=name, **kw):
            with torch.profiler.record_function(f"engine.{_name}"):
                return _method(*args, **kw)

        setattr(eng, name, probed)


def _traced(tmp_path, probe: bool):
    srv = _server()
    if probe:
        _probe(srv)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        out = _drain(srv)
    path = tmp_path / f"trace_{probe}.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    return out, spans


@pytest.fixture(scope="module")
def untraced():
    return _drain(_server())


def _same_answers(got, want):
    assert got.keys() == want.keys()
    for t in want:
        assert len(got[t]) == len(want[t])
        for g, w in zip(got[t], want[t]):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=f"ticket {t}")


def test_span_enters_no_record_function_without_a_profiler(monkeypatch, untraced):
    entered = []
    real = torch.profiler.record_function

    def counted(name, *args):
        entered.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    assert tracing.span("bst.server.pack") is tracing.span("bst.engine.stage")  # one shared no-op
    _same_answers(_drain(_server()), untraced)
    assert entered == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _drain(_server())
    assert set(entered) == PROGRAM_SPANS  # the same patch sees every span of a traced drain


def test_a_traced_drain_names_the_three_phases_and_no_other(tmp_path, untraced):
    out, spans = _traced(tmp_path, probe=False)
    names = {e["name"] for e in spans}
    assert names == PROGRAM_SPANS
    assert not any(n in BENCHMARK_SPANS or n.startswith("engine.") for n in names)
    _same_answers(out, untraced)


def test_no_program_span_encloses_a_call_into_the_engine(tmp_path, untraced):
    out, spans = _traced(tmp_path, probe=True)
    probes = [e for e in spans if e["name"] in {f"engine.{n}" for n in PROBED}]
    program = [e for e in spans if e["name"] in PROGRAM_SPANS]
    assert {e["name"] for e in probes} == {f"engine.{n}" for n in PROBED}  # a compaction ran
    assert {e["name"] for e in program} == PROGRAM_SPANS
    for p in probes:
        p0, p1 = float(p["ts"]), float(p["ts"]) + float(p["dur"])
        for s in program:
            s0, s1 = float(s["ts"]), float(s["ts"]) + float(s["dur"])
            assert not (s0 <= p0 and p1 <= s1), (s["name"], p["name"])
    _same_answers(out, untraced)
