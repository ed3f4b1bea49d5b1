"""BSTServer: streaming read-request scheduler over an immutable snapshot.

The paper's deployment story: search streams are served at full throughput
from an immutable tree.  This module is that loop for the read path:

  * **typed request kinds** -- ``lookup`` / ``predecessor`` / ``successor``
    via ``submit``, ``range_count`` / ``range_scan`` via ``submit_range``.
    The drain packs each kind into its own stream of fixed ``chunk_size``
    engine calls, padding only the final partial chunk per op; per-request
    results are sliced back out, so padded lanes never leak into answers or
    accounting;
  * **one fetch per chunk** -- a chunk's results cross device->host once,
    through the counted ``runtime.device_fetch`` in ``_fill_columns``;
  * **lanes/sec accounting** -- per-chunk engine time (synchronised on the
    device), found counts per chunk, and busy seconds attributed per op by
    the engine lanes each request occupied (one per point key, two per
    range request: the lo||hi concatenated descent).
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
    served: int = 0  # keys/ranges answered
    found: int = 0  # lookup hits, accumulated per chunk
    chunks: int = 0  # engine invocations
    busy_s: float = 0.0  # time inside the engine (incl. padding lanes)
    lanes: int = 0  # engine lanes occupied (see OpStats.lanes)
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
    a: np.ndarray  # keys (point ops) / range lows
    b: Optional[np.ndarray]  # range highs (range ops)


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
        self._engine = BSTEngine(keys, values, config)

    @property
    def snapshot(self) -> TreeData:
        """The current immutable tree snapshot."""
        return self._engine.tree

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
        counts).  Reads commute, so each op's stream is packed into its own
        ``chunk_size`` engine calls.
        """
        if not self._pending:
            return {}
        batch = self._pending
        self._pending = []
        self._pending_keys = 0
        out: Dict[int, tuple] = {}
        self._serve_read_span(batch, out)
        return out

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

    # ------------------------------------------------------------- accounting
    def reset_stats(self) -> None:
        self.stats = ServerStats()

    def memory_nodes(self) -> int:
        return self._engine.memory_nodes()
