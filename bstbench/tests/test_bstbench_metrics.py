"""Each per-layer metric's arithmetic, and the trace summary it reads, on
numbers made up for the test."""

import pytest

from bstbench import peaks, spec, trace

COUNTERS = {
    "busy_s": 0.6, "lanes": 300_000, "read_busy_s": 0.4, "read_chunks": 5,
    "read_lanes_launched": 5 * 65536, "write_busy_s": 0.2, "write_chunks": 3,
    "write_lanes_launched": 3 * 65536, "writes": 12_288, "compactions": 1, "captures": 0,
    "kernel_runs": 8,
}


def _ctx(trace_summary=None):
    return {"rounds": 4, "drain_s": 1.0, "counters": dict(COUNTERS), "trace": trace_summary}


def _read(name, ctx):
    return spec.metric_reader(name).read(ctx)


def test_counter_metrics():
    ctx = _ctx()
    assert _read("server.host_ms_per_drain", ctx) == pytest.approx((1.0 - 0.6) / 4 * 1e3)
    assert _read("server.padding_pct", ctx) == pytest.approx(100 * (1 - 300_000 / (8 * 65536)))
    assert _read("engine.read_chunk_ms", ctx) == pytest.approx(0.4 / 5 * 1e3)
    assert _read("engine.write_ms_per_kop", ctx) == pytest.approx(0.2e3 / 12.288)
    assert _read("graphs.captures", ctx) == 0


def test_counter_metrics_with_nothing_to_read_give_nothing():
    ctx = _ctx()
    ctx["rounds"] = 0
    ctx["counters"].update(read_chunks=0, writes=0, read_lanes_launched=0, write_lanes_launched=0)
    for name in ("server.host_ms_per_drain", "server.padding_pct", "engine.read_chunk_ms",
                 "engine.write_ms_per_kop"):
        assert _read(name, ctx) is None


def _summary(**kw):
    s = {"complete": True, "window_s": 2.0, "busy_s": 0.5,
         "span_kernel_s": {"engine.query_static": [1e-4, 3e-4]}, "chunk_bytes": [2e6, 4e6]}
    s.update(kw)
    return s


def test_trace_metrics():
    ctx = _ctx(_summary())
    assert _read("device.idle_pct", ctx) == pytest.approx(75.0)
    want = 100 * 6e6 / peaks.HBM_BYTES_PER_S / 4e-4
    assert _read("kernels.read_roofline_pct", ctx) == pytest.approx(want)


@pytest.mark.parametrize("summary", [None, _summary(complete=False),
                                     _summary(chunk_bytes=[2e6]),
                                     _summary(span_kernel_s={"engine.query_static": []},
                                              chunk_bytes=[])])
def test_trace_metrics_from_a_lost_or_empty_trace_give_nothing(summary):
    ctx = _ctx(summary)
    assert _read("kernels.read_roofline_pct", ctx) is None
    if summary is None or not summary["complete"]:
        assert _read("device.idle_pct", ctx) is None


def _ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": args}


def test_summarize_joins_kernels_to_spans_by_correlation():
    events = [
        _ev("user_annotation", trace.WINDOW, 0, 1000),
        _ev("user_annotation", "server.drain", 10, 900),
        _ev("user_annotation", "engine.query_static", 100, 100),
        _ev("cuda_runtime", "cudaGraphLaunch", 120, 10, correlation=7),
        _ev("kernel", "forest_descend_kernel<false, true>", 150, 40, tid=7, correlation=7),
        _ev("kernel", "other_kernel", 190, 20, tid=7, correlation=7),
        _ev("cuda_runtime", "cudaMemcpyAsync", 300, 200, correlation=8),
        _ev("gpu_memcpy", "Memcpy DtoH", 450, 50, tid=7, correlation=8),
        _ev("user_annotation", "engine.query_static", 700, 100),
        _ev("cuda_runtime", "cudaGraphLaunch", 710, 10, correlation=9),  # its kernel was lost
        _ev("gpu_user_annotation", "engine.query_static", 700, 100, tid=7),  # not device work
    ]
    s = trace.summarize(events, ("engine.query_static",), ("forest_descend",))
    assert s["window_s"] == pytest.approx(1e-3)
    assert s["busy_s"] == pytest.approx(110e-6)  # [150, 210] and [450, 500]
    assert s["span_kernel_s"]["engine.query_static"] == pytest.approx([60e-6, 0.0])
    assert s["orphans"] == 1 and s["marked_kernels"] == 1 and s["device_events"] == 3
    # a gap is named by what the host did at its middle
    assert dict(s["idle_gaps"]) == pytest.approx({
        "cudaMemcpyAsync": 240e-6,  # [210, 450]: the copy call
        "server.drain": 150e-6,  # [0, 150]
        "engine.query_static": 500e-6,  # [500, 1000], whose middle is in the span
    })
    assert dict(s["device_ops"])["Memcpy DtoH"] == pytest.approx(50e-6)


def test_summarize_without_a_window_gives_nothing():
    assert trace.summarize([_ev("kernel", "k", 0, 1)]) is None

