"""One run of a key-value cell: set-up, the measured window, the traced
segment, and the comparison with the reference.

A driver (``drivers/<kind>.py``) adapts the system under test to the
interface below; this loop knows nothing else of it.

* ``submit_read(keys) -> ticket``, ``submit_write(keys, values) -> ticket``
  and ``drain() -> {ticket: answers}``: a read answers ``(values, found)``,
  a write ``(applied_count,)``;
* ``warmup()``: first-use costs (builds, captures) before any round;
* ``counters()``: the program's cumulative counters, by name;
* ``read_back(keys) -> (values, found)``, or None where it went unanswered:
  every record, once the window has closed;
* ``settle()``: bring a write buffer to a known state (empty) before a
  traced segment; ``instrument(log)``: while ``log`` is a list, put the
  benchmark's spans around the calls into the engine and append each read
  chunk's queries (the lanes that carry a request, not the padding) and
  the buffered keys it met (``None`` removes them);
* ``kernel_markers()``: substrings of the names of the program's own
  kernels, whose runs ``counters()["kernel_runs"]`` counts;
* ``close()``: free the program's state.

The loop is closed (``traffic/ycsb.py``): each round every client submits
one request, and one ``drain()`` answers them all.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import os
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from bstbench import trace as trace_lib
from bstbench import work
from bstbench.reference.sorted_index import SortedIndex
from bstbench.traffic.ycsb import Mix, RequestPool

TRACE_ATTEMPTS = 5  # traced segments taken before the trace is given up
READ_CHUNK_SPAN = "engine.query_static"


def make_records(config: dict, seed: int):
    """The records' sorted keys (``key_spacing`` apart, from
    ``key_spacing``) and their values, drawn from the seed."""
    n, step = int(config["records"]), int(config["key_spacing"])
    keys = (np.arange(1, n + 1, dtype=np.int64) * step).astype(np.int32)
    values = np.random.default_rng([seed, 0x7A1]).integers(0, 2**31 - 1, n, dtype=np.int32)
    return keys, values


@dataclasses.dataclass
class Ledger:
    """What the comparison needs of every submission: how many there were,
    the sampled reads' answers, the writes' acknowledgements, and the
    requests that came back without an answer."""

    submitted: int = 0
    sampled: Dict[int, tuple] = dataclasses.field(default_factory=dict)
    acks: Dict[int, int] = dataclasses.field(default_factory=dict)
    missing: List[int] = dataclasses.field(default_factory=list)


class Loop:
    def __init__(self, adapter, pool: RequestPool):
        self.adapter = adapter
        self.pool = pool
        self.ledger = Ledger()

    def round(self, spans: bool = False):
        """One closed-loop round: ``(latencies of its requests in s, the
        drain's seconds)``."""
        a, pool, led = self.adapter, self.pool, self.ledger
        n = pool.mix.clients
        seq0 = led.submitted
        tickets = [0] * n
        t_sub = np.empty(n)
        with _span(spans, "client.submit"):
            for j in range(n):
                is_write, keys, values = pool.request(seq0 + j)
                t_sub[j] = time.perf_counter()
                tickets[j] = a.submit_write(keys, values) if is_write else a.submit_read(keys)
        t0 = time.perf_counter()
        with _span(spans, "server.drain"):
            out = a.drain()
        t1 = time.perf_counter()
        led.submitted += n
        for j, ticket in enumerate(tickets):
            seq = seq0 + j
            ans = out.get(ticket)
            if ans is None:
                led.missing.append(seq)
            elif pool.is_write(seq):
                led.acks[seq] = int(np.asarray(ans[0]))
            elif pool.is_sampled(seq):
                led.sampled[seq] = (np.array(ans[0]), np.array(ans[1]))
        return t1 - t_sub, t1 - t0


def _span(on: bool, name: str):
    """The benchmark's span ``name`` in a traced segment, else nothing."""
    if not on:
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function(name)


def traced_segment(loop: Loop, rounds: int, sync: Callable[[], None]) -> Optional[dict]:
    """``rounds`` rounds under torch.profiler, taken again (up to
    TRACE_ATTEMPTS) while the trace lost device events: fewer of the
    program's kernels than ``counters()["kernel_runs"]`` says ran, or a
    launch without its device events.  Returns the last trace's summary
    (``complete`` says whether it lost nothing) with the logged read
    chunks and the segment's rounds a second, or None where no trace held
    the window.

    The profiler slows the host (its tracing of the CUDA runtime's calls
    and the device's work, which the join of kernels to spans needs), so
    the segment runs fewer rounds a second than the window, and its idle
    share is that of the traced segment."""
    import torch

    a = loop.adapter
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    a.settle()
    summary = None
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        log: list = []
        k0 = a.counters()["kernel_runs"]
        a.instrument(log)
        try:
            with torch.profiler.profile(activities=acts) as prof:
                sync()
                with torch.profiler.record_function(trace_lib.WINDOW):
                    for _ in range(rounds):
                        loop.round(spans=True)
                    sync()
        finally:
            a.instrument(None)
        ran = a.counters()["kernel_runs"] - k0
        summary = trace_lib.summarize(trace_lib.export_events(prof), (READ_CHUNK_SPAN,),
                                      a.kernel_markers())
        if summary is None:
            continue
        summary.update(attempts=attempt, kernel_runs=ran, chunks=log,
                       rounds_per_s=rounds / summary["window_s"],
                       complete=summary["orphans"] == 0 and summary["marked_kernels"] == ran)
        if summary["complete"]:
            break
    return summary


def chunk_bytes(ref: SortedIndex, chunks: list) -> List[int]:
    """``work.lookup_bytes`` of each logged read chunk."""
    out = []
    for queries, buffered in chunks:
        idx = ref.index_of(queries)
        present = idx >= 0
        ranks = idx.astype(np.int64)
        if not present.all():
            u, inv = np.unique(queries[~present], return_inverse=True)
            ranks[~present] = ref.rank(u)[inv]
        out.append(work.lookup_bytes(queries, ranks, present, ref.keys.size, buffered))
    return out


def compare(ref: SortedIndex, pool: RequestPool, ledger: Ledger, final: Optional[tuple]):
    """Replay every submission on the reference in order, and hold to it
    each sampled read's answers as they came and, at the end, every
    record's value as read back (``final``, None where the read-back went
    unanswered).  Returns the numbers compared with their
    limits (both comparisons are exact), the read lanes compared and the
    requests that failed.

    ``lanes_wrong``: the lanes of sampled reads whose value or found flag
    differs from the reference's, and every lane of a request left without
    an answer, answered with another length, or acknowledged for another
    number of keys than it carried.  ``final_values_wrong``: the records
    whose value read back after the window differs, or that were not
    found."""
    lanes_wrong = read_lanes = 0
    failed = set(ledger.missing)
    lanes_wrong += sum(pool.keys(seq).size for seq in ledger.missing)
    for seq in range(ledger.submitted):
        is_write, keys, values = pool.request(seq)
        if is_write:
            ref.put(keys, values)
            if seq in ledger.acks and ledger.acks[seq] != keys.size:
                lanes_wrong += keys.size
                failed.add(seq)
        elif seq in ledger.sampled:
            got_v, got_f = ledger.sampled[seq]
            want_v, want_f = ref.get(keys)
            read_lanes += keys.size
            if got_v.shape != want_v.shape or got_f.shape != want_f.shape:
                bad = keys.size
            else:
                bad = int(np.count_nonzero((got_v != want_v) | (got_f != want_f)))
            lanes_wrong += bad
            if bad:
                failed.add(seq)
    got_v, got_f = final if final is not None else (None, None)
    if final is None or got_v.shape != ref.values.shape or got_f.shape != ref.values.shape:
        final_bad = ref.values.size
    else:
        final_bad = int(np.count_nonzero((got_v != ref.values) | ~np.asarray(got_f, bool)))
    checks = {
        "lanes_wrong": {"value": lanes_wrong, "limit": 0},
        "final_values_wrong": {"value": final_bad, "limit": 0},
    }
    return checks, read_lanes, len(failed)


class _Phases:
    """Seconds of each named phase, for the run's log on standard error."""

    def __init__(self):
        self._t = time.perf_counter()
        self.seconds: Dict[str, float] = {}

    def mark(self, name: str) -> None:
        t = time.perf_counter()
        self.seconds[name] = t - self._t
        self._t = t

    def __str__(self) -> str:
        return ", ".join(f"{k} {v:.3f} s" for k, v in self.seconds.items())

    @staticmethod
    def log(line: str) -> None:
        print(line, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Outcome:
    """A run's numbers: the end-to-end metrics, the context the per-layer
    readers take theirs from, the device, and the comparison."""

    end_to_end: Dict[str, float]
    context: dict
    device: dict
    checks: Dict[str, dict]
    attempted: int
    failed: int

    @property
    def correct(self) -> bool:
        return all(c["value"] <= c["limit"] for c in self.checks.values())


def run(make_adapter: Callable, config: dict, traffic: dict, seed: int, seconds: float,
        trace: bool, device: str, t_start: float, device_info: Callable[[], dict],
        sync: Callable[[], None], max_rounds: Optional[int] = None) -> Outcome:
    """One run (see the module's docstring).  ``t_start``: the process's
    start on ``time.perf_counter``; ``device_info()`` is read once the
    window has closed, before the program's state is freed; ``max_rounds``
    caps the window (the CPU tests)."""
    mix = Mix.from_traffic(traffic)
    phases = _Phases()
    keys, values = make_records(config, seed)
    phases.mark("records")
    pool = RequestPool(mix, keys, seed, device)
    phases.mark("request pool")
    adapter = make_adapter(config, keys, values, device)
    phases.mark("system")
    adapter.warmup()
    phases.mark("warm-up")
    loop = Loop(adapter, pool)
    for _ in range(mix.warmup_rounds):
        loop.round()
    phases.mark("warm-up rounds")

    # set-up's objects go where the collector no longer walks them
    gc.collect()
    gc.freeze()
    before = adapter.counters()
    cpu0 = os.times()  # the process's CPU seconds: a host-paced window keeps them near its own
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    lat: List[np.ndarray] = []
    drain_s = 0.0
    rounds = 0
    first_seq = loop.ledger.submitted
    while time.perf_counter() - t0 < seconds and (max_rounds is None or rounds < max_rounds):
        l, d = loop.round()
        lat.append(l)
        drain_s += d
        rounds += 1
    window_s = time.perf_counter() - t0
    cpu_s = sum(os.times()[:2]) - sum(cpu0[:2])
    after = adapter.counters()
    counters = {k: after[k] - before[k] for k in after}
    requests = loop.ledger.submitted - first_seq

    phases.log(f"set-up {setup_s!r} s ({phases}); window {window_s!r} s, {rounds} rounds, "
               f"counters {counters}; process CPU {cpu_s!r} s")
    phases = _Phases()
    summary = traced_segment(loop, mix.trace_rounds, sync) if trace else None
    phases.mark("traced segment")
    final = adapter.read_back(keys)
    phases.mark("read-back")
    info = device_info()
    adapter.close()
    del adapter
    gc.collect()

    ref = SortedIndex(keys, values)
    checks, read_lanes, failed = compare(ref, pool, loop.ledger, final)
    phases.mark("comparison")
    if summary is not None:
        summary["chunk_bytes"] = chunk_bytes(ref, summary.pop("chunks"))
        phases.mark("work")
    phases.log(f"after the window: {phases}")
    latencies = np.concatenate(lat) if lat else np.zeros(0)
    end_to_end = {
        "ops_per_s": requests * mix.request_keys / window_s,
        "req_p95_ms": float(np.percentile(latencies, 95)) * 1e3 if latencies.size else None,
        "peak_bytes_per_record": info["memory_peak_bytes"] / keys.size,
        "setup_s": setup_s,
    }
    context = {
        "config": config, "mix": dataclasses.asdict(mix), "rounds": rounds,
        "rounds_per_s": rounds / window_s,
        "requests": requests, "window_s": window_s, "drain_s": drain_s,
        "counters": counters, "trace": summary,
        "read_lanes_compared": read_lanes,
    }
    return Outcome(end_to_end, context, info, checks, attempted=loop.ledger.submitted,
                   failed=failed)
