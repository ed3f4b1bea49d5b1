"""BSTServer: streaming request scheduler over immutable tree snapshots.

The paper's deployment story: search streams are served at full throughput
from an immutable tree while inserts and deletes accumulate.  This module is
that loop:

  * **typed request kinds** -- ``lookup`` / ``predecessor`` / ``successor``
    via ``submit``, ``range_count`` / ``range_scan`` via ``submit_range``.
    The drain packs each kind into its own stream of fixed ``chunk_size``
    engine calls, padding only the final partial chunk per op; per-request
    results are sliced back out, so padded lanes never leak into answers or
    accounting;
  * **live write path** -- with ``EngineConfig(delta_capacity > 0)`` the
    server also takes ``write`` / ``delete`` requests (``submit_write`` /
    ``submit_delete``).  The drain keeps SUBMISSION ORDER across reads and
    writes: the queue splits into maximal read spans (packed per op as
    above) separated by write spans, each write span lands in the engine's
    delta buffer as fixed-size padded chunks, and the engine compacts
    between chunks at the high-water mark;
  * **snapshot swap** -- ``apply_updates`` on a write-path engine goes
    through the delta buffer; otherwise it rebuilds the snapshot through
    ``core.updates`` and installs a new engine;
  * **one fetch per chunk** -- a read chunk's results cross device->host
    once, through the counted ``runtime.device_fetch`` in
    ``_fill_columns``; a compaction adds one more (its new key count);
  * **lanes/sec accounting** -- per-chunk engine time (synchronised on the
    device), found counts per chunk, and busy seconds attributed per op by
    the engine lanes each request occupied (one per point, write or delete
    key, two per range request: the lo||hi concatenated descent).

The JAX server re-warms its reads after every snapshot swap to refill jit's
compile cache; eager torch has no such cache, so nothing is re-warmed here.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch import runtime
from repro_torch.core import plans as plans_lib
from repro_torch.core.engine import BSTEngine, EngineConfig
from repro_torch.core.tree import TreeData

RANGE_OPS = plans_lib.RANGE_OPS
POINT_OPS = tuple(op for op in plans_lib.QUERY_OPS if op not in RANGE_OPS)
# Mutating request kinds; they are order barriers in the drain.
WRITE_OPS = ("write", "delete")


@dataclasses.dataclass
class OpStats:
    """Per-op serving counters (one entry per request kind actually seen)."""

    served: int = 0  # keys (point ops) / ranges (range ops) answered
    chunks: int = 0  # engine invocations
    busy_s: float = 0.0  # time inside the engine (incl. padding lanes)
    # Engine lanes the op's requests occupied (padding excluded): one per
    # key for point ops, TWO per range request (lo and hi both descend).
    lanes: int = 0

    @property
    def keys_per_sec(self) -> float:
        return self.served / self.busy_s if self.busy_s > 0 else 0.0

    @property
    def lanes_per_sec(self) -> float:
        return self.lanes / self.busy_s if self.busy_s > 0 else 0.0


@dataclasses.dataclass
class ServerStats:
    """Cumulative serving counters (reset with ``BSTServer.reset_stats``)."""

    requests: int = 0  # submit() calls
    submitted: int = 0  # keys/ranges accepted
    served: int = 0  # keys/ranges/write ops answered
    found: int = 0  # lookup hits, accumulated per chunk
    chunks: int = 0  # engine invocations
    busy_s: float = 0.0  # time inside the engine (incl. padding lanes)
    lanes: int = 0  # engine lanes occupied (see OpStats.lanes)
    snapshot_swaps: int = 0  # full-rebuild swaps (the path without a buffer)
    updates: int = 0  # write/delete ops absorbed by the delta buffer
    compactions: int = 0  # delta-buffer merges into fresh snapshots
    per_op: Dict[str, OpStats] = dataclasses.field(default_factory=dict)

    @property
    def keys_per_sec(self) -> float:
        return self.served / self.busy_s if self.busy_s > 0 else 0.0

    @property
    def lanes_per_sec(self) -> float:
        return self.lanes / self.busy_s if self.busy_s > 0 else 0.0

    def op(self, name: str) -> OpStats:
        return self.per_op.setdefault(name, OpStats())


@dataclasses.dataclass
class _Request:
    ticket: int
    op: str
    a: np.ndarray  # keys (point / write / delete ops) / range lows
    b: Optional[np.ndarray]  # range highs (range ops) / write values


class BSTServer:
    """Accumulate typed query requests, serve them in fixed-shape chunks.

    Single-threaded by design: the FPGA frontend is one stream of key
    chunks.  ``scan_k`` fixes range_scan's bounded fan-out.  Sharded serving
    (``mesh``) is not part of this package yet.
    """

    def __init__(
        self,
        keys,
        values,
        config: EngineConfig = EngineConfig(),
        chunk_size: int = 8192,
        scan_k: int = 8,
        mesh=None,
    ):
        if mesh is not None:
            raise NotImplementedError("sharded serving (mesh=...) is not ported yet")
        if chunk_size < 1:
            raise ValueError("chunk_size must be positive")
        if scan_k < 1:
            raise ValueError("scan_k must be positive")
        self.config = config
        self.chunk_size = chunk_size
        self.scan_k = scan_k
        self.stats = ServerStats()
        self._pending: List[_Request] = []
        self._pending_keys = 0
        self._next_ticket = 0
        # Write chunks are at most the buffer's capacity, so each is one
        # ingest step of the engine.
        self._write_chunk = (
            min(chunk_size, config.delta_capacity) if config.delta_capacity > 0 else chunk_size
        )
        self._engine = BSTEngine(keys, values, config)

    @property
    def snapshot(self) -> TreeData:
        """The current immutable tree snapshot (pending delta-buffer writes,
        if any, overlay it until the next compaction)."""
        return self._engine.tree

    @property
    def engine(self) -> BSTEngine:
        return self._engine

    def warmup(self, ops=("lookup",)) -> None:
        """Run one chunk of each op, so timed chunks exclude first-use costs
        (the kernels' build and load, the allocator's first blocks)."""
        dummy = np.zeros(self.chunk_size, np.int32)
        for op in ops:
            runtime.block_until_ready(self._query_chunk(op, dummy, dummy))

    def _query_chunk(self, op: str, a, b) -> tuple:
        if op in RANGE_OPS:
            res = self._engine.query(op, a, b, k=self.scan_k)
        else:
            res = self._engine.query(op, a)
        return res if isinstance(res, tuple) else (res,)

    def apply_updates(self, insert_keys=None, insert_values=None, delete_keys=None) -> TreeData:
        """Bulk-maintain the store (deletes before inserts, so an upsert of
        a just-deleted key lands).  Returns the current snapshot.  Pending
        (undrained) requests will be served from the new state.

        With the write path enabled the batch is absorbed by the engine's
        delta buffer (compaction at the high-water mark); otherwise the
        engine rebuilds its snapshot (``BSTEngine.apply_updates``).
        """
        before = self._engine.compactions
        tree = self._engine.apply_updates(insert_keys, insert_values, delete_keys)
        if self._engine.delta is None:
            self.stats.snapshot_swaps += 1
            return tree
        self.stats.updates += sum(
            len(np.atleast_1d(x)) for x in (insert_keys, delete_keys) if x is not None
        )
        self.stats.compactions += self._engine.compactions - before
        return tree

    # --------------------------------------------------------------- requests
    def submit(self, request_keys, op: str = "lookup") -> int:
        """Queue a point-query request; returns a ticket for drain().

        ``op`` is one of ``lookup`` (values, found), ``predecessor`` /
        ``successor`` (keys, values, ok).
        """
        if op not in POINT_OPS:
            raise ValueError(f"submit() op must be one of {POINT_OPS}, got {op!r}")
        req = np.atleast_1d(np.asarray(request_keys, np.int32))
        if req.ndim != 1:
            raise ValueError("request_keys must be scalar or 1-D")
        return self._enqueue(_Request(0, op, req, None), req.size)

    def submit_range(self, lo, hi, op: str = "range_count") -> int:
        """Queue a range request over [lo, hi] (inclusive); returns a ticket.

        ``op`` is ``range_count`` (counts) or ``range_scan`` (keys (B,
        scan_k), values, counts).  lo/hi must be equal-length (or scalar).
        """
        if op not in RANGE_OPS:
            raise ValueError(f"submit_range() op must be one of {RANGE_OPS}, got {op!r}")
        lo = np.atleast_1d(np.asarray(lo, np.int32))
        hi = np.atleast_1d(np.asarray(hi, np.int32))
        if lo.shape != hi.shape or lo.ndim != 1:
            raise ValueError("lo/hi must be equal-length scalars or 1-D arrays")
        return self._enqueue(_Request(0, op, lo, hi), lo.size)

    def submit_write(self, request_keys, request_values) -> int:
        """Queue an upsert request; returns a ticket.

        Requires a write-path engine (``delta_capacity > 0``).  The drain
        applies writes in SUBMISSION ORDER relative to every other request
        (reads before the write see the old state, reads after see it); the
        ticket resolves to ``(applied_count,)``.
        """
        self._require_write_path()
        k = np.atleast_1d(np.asarray(request_keys, np.int32))
        v = np.atleast_1d(np.asarray(request_values, np.int32))
        if k.shape != v.shape or k.ndim != 1:
            raise ValueError("keys/values must be equal-length scalars or 1-D")
        return self._enqueue(_Request(0, "write", k, v), k.size)

    def submit_delete(self, request_keys) -> int:
        """Queue a delete (tombstone) request; returns a ticket.  Same
        ordering contract as ``submit_write``; deleting an absent key is a
        no-op that still counts as applied."""
        self._require_write_path()
        k = np.atleast_1d(np.asarray(request_keys, np.int32))
        if k.ndim != 1:
            raise ValueError("request_keys must be scalar or 1-D")
        return self._enqueue(_Request(0, "delete", k, None), k.size)

    def _require_write_path(self) -> None:
        if self._engine.delta is None:
            raise ValueError(
                "write/delete request kinds need EngineConfig(delta_capacity"
                " > 0); use apply_updates() for bulk snapshot swaps"
            )

    def _enqueue(self, req: _Request, size: int) -> int:
        req.ticket = self._next_ticket
        self._next_ticket += 1
        self._pending.append(req)
        self._pending_keys += size
        self.stats.requests += 1
        self.stats.submitted += size
        return req.ticket

    def pending(self) -> int:
        """Keys/ranges queued but not yet served."""
        return self._pending_keys

    # ------------------------------------------------------------------ drain
    def drain(self) -> Dict[int, tuple]:
        """Serve every queued request; returns {ticket: op results}.

        Result shapes per op: ``lookup`` -> (values, found);
        ``predecessor``/``successor`` -> (keys, values, ok);
        ``range_count`` -> (counts,); ``range_scan`` -> (keys, values,
        counts); ``write``/``delete`` -> (applied_count,).

        Writes are ORDER BARRIERS: the queue splits into maximal read spans
        separated by write spans, served in submission order, so a read
        sees exactly the writes submitted before it.  Reads commute within
        a span, so each op's stream is packed into its own ``chunk_size``
        engine calls; a write span lands in the delta buffer as padded
        chunks, with compaction between chunks at the high-water mark.
        """
        if not self._pending:
            return {}
        batch = self._pending
        self._pending = []
        self._pending_keys = 0
        out: Dict[int, tuple] = {}
        span: List[_Request] = []
        for req in batch:
            if span and (req.op in WRITE_OPS) != (span[-1].op in WRITE_OPS):
                self._serve_span(span, out)
                span = []
            span.append(req)
        self._serve_span(span, out)
        return out

    def _serve_span(self, reqs: List[_Request], out: Dict[int, tuple]) -> None:
        if reqs[-1].op in WRITE_OPS:
            self._serve_write_span(reqs, out)
        else:
            self._serve_read_span(reqs, out)

    def _serve_read_span(self, reqs: List[_Request], out: Dict[int, tuple]):
        """One span of reads: requests commute, so pack per op kind."""
        by_op: Dict[str, List[_Request]] = {}
        for req in reqs:
            by_op.setdefault(req.op, []).append(req)
        for op, group in by_op.items():
            a = np.concatenate([r.a for r in group])
            b = np.concatenate([r.b for r in group]) if op in RANGE_OPS else None
            columns = self._serve_stream(op, a, b)
            lo = 0
            for r in group:
                hi = lo + r.a.size
                out[r.ticket] = tuple(col[lo:hi] for col in columns)
                lo = hi

    def _serve_write_span(self, reqs: List[_Request], out: Dict[int, tuple]):
        """One run of consecutive write/delete requests -> delta ingest.

        The requests merge into one submission-ordered batch (the buffer's
        last-wins dedup keeps exactly that order), cut into ``_write_chunk``
        slices, the last padded with invalid lanes.  The engine may compact
        between slices.
        """
        keys = np.concatenate([r.a for r in reqs])
        values = np.concatenate(
            [r.b if r.op == "write" else np.zeros(r.a.size, np.int32) for r in reqs]
        )
        deletes = np.concatenate([np.full(r.a.size, r.op == "delete") for r in reqs])
        n = keys.size
        pad = (-n) % self._write_chunk
        valid = np.arange(n + pad) < n
        if pad:
            keys = np.pad(keys, (0, pad))
            values = np.pad(values, (0, pad))
            deletes = np.pad(deletes, (0, pad))
        before = self._engine.compactions
        t0 = time.perf_counter()
        n_calls = 0
        for lo in range(0, keys.size, self._write_chunk):
            sl = slice(lo, lo + self._write_chunk)
            self._engine.apply_ops(keys[sl], values[sl], deletes[sl], valid[sl])
            n_calls += 1
        # the device work is asynchronous: wait for the buffer, so busy_s
        # holds the ingest as _serve_stream's does the reads
        runtime.block_until_ready(self._engine.delta)
        dt = time.perf_counter() - t0
        self.stats.busy_s += dt
        self.stats.updates += n
        self.stats.served += n
        self.stats.chunks += n_calls
        self.stats.compactions += self._engine.compactions - before
        self.stats.lanes += n
        for r in reqs:
            op_stats = self.stats.op(r.op)
            op_stats.served += r.a.size
            # busy time shared by the lanes each request occupied
            op_stats.busy_s += dt * (r.a.size / max(n, 1))
            op_stats.lanes += r.a.size
            out[r.ticket] = (np.asarray(r.a.size, np.int32),)
        for kind in {r.op for r in reqs}:
            # each kind records every engine call of the span it rode in
            self.stats.op(kind).chunks += n_calls

    def _empty_columns(self, op: str):
        """Result columns for a zero-key stream (no engine call needed)."""
        if op == "lookup":
            return [np.empty(0, np.int32), np.empty(0, bool)]
        if op in ("predecessor", "successor"):
            return [np.empty(0, np.int32), np.empty(0, np.int32), np.empty(0, bool)]
        if op == "range_count":
            return [np.empty(0, np.int32)]
        k = self.scan_k
        return [
            np.empty((0, k), np.int32),
            np.empty((0, k), np.int32),
            np.empty(0, np.int32),
        ]

    def _serve_stream(self, op: str, a: np.ndarray, b: Optional[np.ndarray]):
        """Run one op's packed stream through fixed-shape engine chunks."""
        B = a.size
        if B == 0:
            return self._empty_columns(op)
        pad = (-B) % self.chunk_size
        if pad:
            a = np.pad(a, (0, pad))
            if b is not None:
                b = np.pad(b, (0, pad))
        columns = None
        for lo in range(0, a.size, self.chunk_size):
            sl = slice(lo, lo + self.chunk_size)
            t0 = time.perf_counter()
            res = self._query_chunk(op, a[sl], None if b is None else b[sl])
            runtime.block_until_ready(res)
            dt = time.perf_counter() - t0
            real = min(self.chunk_size, B - lo)  # non-padded lanes this chunk
            # range requests occupy TWO engine lanes each (lo||hi descent)
            lanes = real * (2 if op in RANGE_OPS else 1)
            self.stats.busy_s += dt
            self.stats.chunks += 1
            self.stats.lanes += lanes
            ops = self.stats.op(op)
            ops.busy_s += dt
            ops.chunks += 1
            ops.lanes += lanes
            columns = self._fill_columns(columns, a.size, sl, res)
            if op == "lookup":
                # hits counted from the host columns the retire already paid for
                self.stats.found += int(columns[1][lo : lo + real].sum())
        self.stats.served += B
        self.stats.op(op).served += B
        return [col[:B] for col in columns]

    def _fill_columns(self, columns, total: int, sl: slice, res: tuple):
        """Copy one chunk's result tuple into the stream-sized host columns.

        The ONLY place read results cross device->host: one counted
        ``device_fetch`` per chunk.
        """
        host = runtime.device_fetch(res)
        if columns is None:
            columns = [np.empty((total,) + c.shape[1:], c.dtype) for c in host]
        for col, c in zip(columns, host):
            col[sl] = c
        return columns

    # ------------------------------------------------------------ convenience
    def lookup(self, request_keys):
        """Synchronous convenience: submit one request and drain the queue."""
        ticket = self.submit(request_keys)
        return self.drain()[ticket]

    def predecessor(self, request_keys):
        ticket = self.submit(request_keys, op="predecessor")
        return self.drain()[ticket]

    def successor(self, request_keys):
        ticket = self.submit(request_keys, op="successor")
        return self.drain()[ticket]

    def range_count(self, lo, hi) -> np.ndarray:
        ticket = self.submit_range(lo, hi, op="range_count")
        return self.drain()[ticket][0]

    def range_scan(self, lo, hi):
        ticket = self.submit_range(lo, hi, op="range_scan")
        return self.drain()[ticket]

    def write(self, request_keys, request_values) -> int:
        """Synchronous upsert: submit one write request and drain."""
        ticket = self.submit_write(request_keys, request_values)
        return int(self.drain()[ticket][0])

    def delete(self, request_keys) -> int:
        """Synchronous delete: submit one tombstone request and drain."""
        ticket = self.submit_delete(request_keys)
        return int(self.drain()[ticket][0])

    # ------------------------------------------------------------- accounting
    def reset_stats(self) -> None:
        self.stats = ServerStats()

    def memory_nodes(self) -> int:
        return self._engine.memory_nodes()
