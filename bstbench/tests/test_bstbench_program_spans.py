"""The program's own spans in a traced segment: the summary names each
idle gap by the innermost of them (or by the CUDA call in flight), keeps
one kernel entry per read chunk for the roofline, and each reader of a
program span's idle time gives ms per traced round (nothing for a trace
without the program's spans), on a trace made up for the test."""

import pytest

from bstbench import spec, trace

READERS = {
    "server.pack_idle_ms": "bst.server.pack",
    "server.retire_idle_ms": "bst.server.retire",
    "engine.stage_idle_ms": "bst.engine.stage",
}


def _ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": args}


def _user(name, ts, dur):
    return _ev("user_annotation", name, ts, dur)


# One drain of two read chunks (µs): the program's spans sit inside the
# benchmark's ``server.drain`` and ``engine.query_static``.
EVENTS = [
    _user(trace.WINDOW, 0, 1000),
    _user("server.drain", 0, 1000),
    _user("bst.server.pack", 0, 200),
    _ev("gpu_memset", "Memset (Device)", 200, 10, tid=7),
    _user("engine.query_static", 210, 290),
    _user("bst.engine.stage", 210, 190),
    _ev("gpu_memset", "Memset (Device)", 250, 10, tid=7),
    _ev("cuda_runtime", "cudaMemcpyAsync", 300, 100, correlation=1),
    _ev("gpu_memcpy", "Memcpy HtoD", 390, 10, tid=7, correlation=1),
    _ev("cuda_runtime", "cudaGraphLaunch", 410, 10, correlation=2),
    _ev("kernel", "forest_descend_kernel<false, true>", 420, 60, tid=7, correlation=2),
    _user("bst.server.retire", 500, 200),
    _ev("cuda_runtime", "cudaMemcpyAsync", 690, 10, correlation=3),
    _ev("gpu_memcpy", "Memcpy DtoH", 700, 10, tid=7, correlation=3),
    _user("engine.query_static", 720, 80),
    _user("bst.engine.stage", 720, 15),
    _ev("cuda_runtime", "cudaGraphLaunch", 730, 10, correlation=4),
    _ev("kernel", "forest_descend_kernel<false, true>", 740, 20, tid=7, correlation=4),
]


def test_summarize_names_each_gap_by_the_innermost_program_span():
    s = trace.summarize(EVENTS, ("engine.query_static",), ("forest_descend",))
    assert s["busy_s"] == pytest.approx(120e-6)
    assert dict(s["idle_gaps"]) == pytest.approx({
        "bst.server.pack": 200e-6,  # [0, 200], inside the drain
        "bst.engine.stage": 70e-6,  # [210, 250] and [710, 740], inside query_static
        "cudaMemcpyAsync": 130e-6,  # [260, 390]: the copy call inside the stage span
        "cudaGraphLaunch": 20e-6,  # [400, 420]
        "bst.server.retire": 220e-6,  # [480, 700]
        "server.drain": 240e-6,  # [760, 1000]: the drain's own
    })
    # the read roofline's join: one entry a chunk, the stage span's copy no kernel
    assert s["span_kernel_s"]["engine.query_static"] == pytest.approx([60e-6, 20e-6])
    assert s["orphans"] == 0 and s["marked_kernels"] == 2


def _ctx(summary):
    return {"rounds": 100, "mix": {"trace_rounds": 4}, "trace": summary}


@pytest.mark.parametrize("name", READERS)
def test_reader_gives_the_span_idle_ms_per_traced_round(name):
    s = trace.summarize(EVENTS, ("engine.query_static",), ("forest_descend",))
    s["complete"] = True
    want = dict(s["idle_gaps"])[READERS[name]] / 4 * 1e3
    assert spec.metric_reader(name).read(_ctx(s)) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("case", ["no trace", "lost events", "a program without spans"])
def test_reader_gives_nothing_without_the_program_spans(name, case):
    s = trace.summarize(EVENTS, ("engine.query_static",), ("forest_descend",))
    s["complete"] = case != "lost events"
    if case == "a program without spans":
        s["idle_gaps"] = [g for g in s["idle_gaps"] if not g[0].startswith("bst.")]
    assert spec.metric_reader(name).read(_ctx(None if case == "no trace" else s)) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_gives_zero_for_its_span_below_the_listed_names(name):
    """The program's other spans are listed, this one is not: it held less
    idle time than the last name listed (here: none)."""
    s = trace.summarize(EVENTS, ("engine.query_static",), ("forest_descend",))
    s["complete"] = True
    s["idle_gaps"] = [g for g in s["idle_gaps"] if g[0] != READERS[name]]
    assert spec.metric_reader(name).read(_ctx(s)) == 0.0
