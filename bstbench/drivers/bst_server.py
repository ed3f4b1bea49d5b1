"""The system under test for a ``"kind": "bst_server"`` configuration:
``repro_torch.serving.BSTServer`` over a ``repro_torch.core.EngineConfig``,
adapted to the loop's interface (``kvloop.py``).

What the benchmark takes from the program: the server and its engine, the
server's counters (``ServerStats``), ``graphs.STATS`` and
``graphs.kernel_runs()``, and the names of its descent kernels (from
``kernels.bst_search.LAUNCHES``).  In a traced segment it wraps the
engine's ``query_static``, ``apply_ops`` and ``compact`` on the instance,
to put its own spans around them and to log each read chunk's queries and
the keys buffered when it ran, and the server's ``_serve_stream``, to
learn how many of a chunk's lanes carry a request (the server pads a read
stream's last chunk with key 0); the program is not changed.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from bstbench import kvloop
from repro_torch import graphs
from repro_torch.core.engine import EngineConfig
from repro_torch.kernels import bst_search
from repro_torch.serving.bst_server import WRITE_OPS, BSTServer

_WRAPPED = ("query_static", "apply_ops", "compact")


class Adapter:
    def __init__(self, config: dict, keys: np.ndarray, values: np.ndarray, device: str):
        e = config["engine"]
        cfg = EngineConfig(
            strategy=e["strategy"],
            n_trees=int(e.get("n_trees", 1)),
            mapping=e.get("mapping", "queue"),
            buffer_slack=float(e.get("buffer_slack", 2.0)),
            delta_capacity=int(e["delta_capacity"]),
            delta_high_water=e.get("delta_high_water"),
            device=device,
        )
        s = config["server"]
        self.chunk = int(s["chunk_size"])
        self.write_chunk = min(self.chunk, cfg.delta_capacity)  # the server's ingest slice
        self.server = BSTServer(keys, values, cfg, chunk_size=self.chunk)
        self._buffered = np.empty(0, np.int32)
        self._stream_left = 0  # lanes of the read stream in flight not yet in a chunk

    def warmup(self) -> None:
        self.server.warmup(("lookup", "write"))

    def submit_read(self, keys) -> int:
        return self.server.submit(keys)

    def submit_write(self, keys, values) -> int:
        return self.server.submit_write(keys, values)

    def drain(self) -> Dict[int, tuple]:
        return self.server.drain()

    def counters(self) -> Dict[str, float]:
        st = self.server.stats
        reads = [o for name, o in st.per_op.items() if name not in WRITE_OPS]
        writes = [o for name, o in st.per_op.items() if name in WRITE_OPS]
        return {
            "busy_s": st.busy_s,
            "lanes": st.lanes,
            "read_busy_s": sum(o.busy_s for o in reads),
            "read_chunks": sum(o.chunks for o in reads),
            "read_lanes_launched": sum(o.chunks for o in reads) * self.chunk,
            "write_busy_s": sum(o.busy_s for o in writes),
            "write_chunks": st.chunks - sum(o.chunks for o in reads),
            "write_lanes_launched": (st.chunks - sum(o.chunks for o in reads)) * self.write_chunk,
            "writes": st.updates,
            "compactions": st.compactions,
            "captures": graphs.STATS["captures"],
            "kernel_runs": sum(graphs.kernel_runs().values()),
        }

    def read_back(self, keys: np.ndarray):
        ticket = self.server.submit(keys)
        return self.server.drain().get(ticket)

    def settle(self) -> None:
        self.server.engine.compact()
        self._buffered = np.empty(0, np.int32)

    def kernel_markers(self) -> tuple:
        return tuple(sorted({name.replace("_delta", "") for name in bst_search.LAUNCHES}))

    def instrument(self, log: Optional[list]) -> None:
        eng, srv = self.server.engine, self.server
        for name in _WRAPPED:
            eng.__dict__.pop(name, None)  # the class's methods again
        srv.__dict__.pop("_serve_stream", None)
        if log is None:
            return
        query_static, apply_ops, compact = (getattr(eng, n) for n in _WRAPPED)
        serve_stream = srv._serve_stream

        def traced_serve_stream(op, a, b):
            self._stream_left = np.size(a)  # the stream before its padding
            try:
                return serve_stream(op, a, b)
            finally:
                self._stream_left = 0

        def traced_query_static(op, queries, *args, **kw):
            real = min(len(queries), self._stream_left)  # the rest is padding
            self._stream_left -= real
            log.append((np.array(queries[:real], np.int32), self._buffered))
            with torch.profiler.record_function("engine.query_static"):
                return query_static(op, queries, *args, **kw)

        def traced_apply_ops(keys, values, deletes, valid=None):
            before = eng.compactions
            with torch.profiler.record_function("engine.apply_ops"):
                apply_ops(keys, values, deletes, valid)
            keys = np.asarray(keys, np.int32)
            if valid is not None:
                keys = keys[np.asarray(valid, bool)]
            if eng.compactions == before:
                self._buffered = np.union1d(self._buffered, keys)
            elif eng.pending_writes() > 0:  # compacted before this slice went in
                self._buffered = np.unique(keys)
            else:  # compacted after it
                self._buffered = np.empty(0, np.int32)

        def traced_compact():
            with torch.profiler.record_function("engine.compact"):
                return compact()

        eng.query_static = traced_query_static
        eng.apply_ops = traced_apply_ops
        eng.compact = traced_compact
        srv._serve_stream = traced_serve_stream

    def close(self) -> None:
        self.instrument(None)
        self.server = None
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            torch.cuda.empty_cache()


def make(config: dict, keys: np.ndarray, values: np.ndarray, device: str) -> Adapter:
    return Adapter(config, keys, values, device)


def run(cell, *, seed: int, seconds: float, trace: bool, device: str, t_start: float,
        device_info, sync, max_rounds=None, make_adapter=make):
    """One run of ``cell`` through the closed loop of ``kvloop.py``."""
    return kvloop.run(make_adapter, cell.config, cell.traffic, seed % (1 << 63), seconds, trace,
                      device, t_start, device_info, sync, max_rounds)
