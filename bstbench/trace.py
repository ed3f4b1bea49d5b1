"""Reading a torch.profiler trace of a traced segment.

The segment runs inside one ``record_function`` span (``WINDOW``), and the
benchmark's own spans mark what the host was doing: ``client.submit``,
``server.drain`` and, around the calls into the engine, ``engine.*``.  From
the trace's Chrome JSON this module takes:

* ``busy_s``: the union of the device's kernels, copies and memsets inside
  the window, and ``window_s``, the window's length;
* the device time of each operation by name, and the idle gaps, each named
  by the host activity in flight at its middle: the CUDA runtime call under
  way, else the innermost benchmark span, else ``host``;
* for each span of a given name, the device time of the kernels that the
  runtime calls made inside it launched, joined by the trace's correlation
  ids (a graph replay's kernels carry its launch's id), so no kernel is
  picked by its name;
* ``orphans``: launches and copies in the window whose device events the
  trace lost.

The profiler loses device events now and then, more often while CUDA
graphs are alive; the caller compares the kernels it saw with the
program's own count and takes the segment again when they differ.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

WINDOW = "bstbench.traced_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CALL_CATS = ("cuda_runtime", "cuda_driver")
# host calls that put work on the device, each with device events of its own
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")
TOP = 10  # entries of each breakdown list
NAME_CHARS = 160  # a device operation's name as listed (kernels' template arguments run long)


def export_events(prof) -> List[dict]:
    """The profiler's events as Chrome trace dicts (written to a temporary
    file under ``TMPDIR`` and removed)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _x(events: Sequence[dict], cats: Sequence[str]) -> List[dict]:
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in cats]


def summarize(events: Sequence[dict], span_names: Sequence[str] = (),
              kernel_markers: Sequence[str] = ()) -> Optional[dict]:
    """The summary of a traced segment (see the module's docstring), or
    None where the trace holds no window span.  ``span_names``: spans whose
    kernels' device seconds are listed one by one under ``span_kernel_s``.
    ``kernel_markers``: substrings of the program's own kernels' names, whose
    events are counted under ``marked_kernels``."""
    wins = [e for e in _x(events, ("user_annotation",)) if e["name"] == WINDOW]
    if not wins:
        return None
    win = wins[-1]
    w0, w1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    tid = win.get("tid")
    dev = [e for e in _x(events, DEVICE_CATS)
           if float(e["ts"]) < w1 and float(e["ts"]) + float(e["dur"]) > w0]
    busy = _merge([(max(w0, float(e["ts"])), min(w1, float(e["ts"]) + float(e["dur"])))
                   for e in dev])
    busy_us = sum(b - a for a, b in busy)

    by_name: Dict[str, float] = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"])
    by_corr: Dict[int, List[dict]] = {}
    for e in dev:
        c = e.get("args", {}).get("correlation")
        if c is not None:
            by_corr.setdefault(c, []).append(e)

    calls = sorted((e for e in _x(events, HOST_CALL_CATS)
                    if e.get("tid") == tid and w0 <= float(e["ts"]) < w1),
                   key=lambda e: float(e["ts"]))
    orphans = sum(1 for e in calls if e["name"] in LAUNCH_CALLS
                  and not by_corr.get(e.get("args", {}).get("correlation")))
    call_ts = [float(e["ts"]) for e in calls]

    spans = sorted((e for e in _x(events, ("user_annotation",))
                    if e.get("tid") == tid and e["name"] != WINDOW
                    and w0 <= float(e["ts"]) < w1), key=lambda e: float(e["ts"]))
    span_ts = [float(e["ts"]) for e in spans]

    span_kernel_s: Dict[str, List[float]] = {name: [] for name in span_names}
    for s in spans:
        if s["name"] not in span_kernel_s:
            continue
        a, b = float(s["ts"]), float(s["ts"]) + float(s["dur"])
        us = 0.0
        for c in calls[bisect.bisect_left(call_ts, a):bisect.bisect_left(call_ts, b)]:
            for k in by_corr.get(c.get("args", {}).get("correlation"), ()):
                if k.get("cat") == "kernel":
                    us += float(k["dur"])
        span_kernel_s[s["name"]].append(us / 1e6)

    def host_at(t: float) -> str:
        i = bisect.bisect_right(call_ts, t) - 1
        if i >= 0 and float(calls[i]["ts"]) + float(calls[i]["dur"]) > t:
            return calls[i]["name"]
        for j in range(bisect.bisect_right(span_ts, t) - 1, -1, -1):
            if float(spans[j]["ts"]) + float(spans[j]["dur"]) > t:
                return spans[j]["name"]  # the latest-starting span that covers t: the innermost
        return "host"

    gaps: Dict[str, float] = {}
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            name = host_at((a + b) / 2)
            gaps[name] = gaps.get(name, 0.0) + (b - a)

    marked = sum(1 for e in dev if e.get("cat") == "kernel"
                 and any(m in e["name"] for m in kernel_markers))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": busy_us / 1e6,
        "device_ops": [[name[:NAME_CHARS], us / 1e6] for name, us in top],
        "idle_gaps": [[name, us / 1e6] for name, us in top_gaps],
        "span_kernel_s": span_kernel_s,
        "orphans": orphans,
        "marked_kernels": marked,
        "device_events": len(dev),
    }
