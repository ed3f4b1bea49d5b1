"""BSTEngine: the query engine with the paper's three strategies.

Strategies (paper §II):
  * ``hrz`` -- horizontal partitioning: one tree in level-major layout, the
    whole query chunk descends one level per step.
  * ``dup`` -- duplicated horizontal partitioning: ``n_trees`` replicas of
    one shared tree row, each taking a slice of the chunk.
  * ``hyb`` -- hybrid horizontal-vertical partitioning: the top levels are a
    register layer, survivors are routed to ``n_trees`` vertical subtrees
    through direct- or queue-mapped buffers and descend there.

All strategies return bit-identical results; they differ in layout and
dispatch.  The tree is built with numpy on the host and moved to
``EngineConfig.device`` once; the device then decides whether each descent
launches a Hopper kernel (CUDA) or runs the plain version (CPU).  On the
card each bound (op, k) query runs as one CUDA graph per batch length and
snapshot (``repro_torch.graphs``), the counterpart of the JAX package's jit
cache: captured at first use, replayed after, with the delta buffer in
static buffers that every write refreshes in place, so writes do not
re-capture; a compaction's new snapshot does.

The live write path (``EngineConfig(delta_capacity > 0)``): writes land in a
sorted delta buffer on the device (``core.delta``), classified by the
engine's own ordered descent; every read resolves the buffer inside its
descent; at the high-water mark a compaction merges the buffer into a fresh
perfect snapshot.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import graphs, invariants
from repro_torch.core import delta as delta_lib
from repro_torch.core import plans as plans_lib
from repro_torch.core import tree as tree_lib
from repro_torch.core import updates as updates_lib
from repro_torch.core.tree import TreeData
from repro_torch.kernels import bst_search as bst_kernels


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Reconfigurable parameters (paper: "fully reconfigurable")."""

    strategy: str = "hrz"  # hrz | dup | hyb
    n_trees: int = 1  # replicas (dup) or vertical subtrees (hyb)
    mapping: str = "queue"  # direct | queue   (hyb only)
    register_levels: Optional[int] = None  # default: log2(n_trees) for hyb
    # Buffer capacity per subtree as a multiple of the fair share B/n_trees.
    buffer_slack: float = 2.0
    device: str = "cuda"  # where the tree lives and the descent runs
    # Live write path: > 0 attaches a delta buffer of that many slots to
    # every query, enabling apply_ops/apply_updates with compaction at the
    # high-water mark.  0 keeps the engine read-only (updates then rebuild
    # the snapshot through core.updates).
    delta_capacity: int = 0
    delta_high_water: Optional[int] = None  # default: 3/4 of the capacity

    def __post_init__(self) -> None:
        invariants.check_delta_config(self.delta_capacity, self.delta_high_water)

    def resolved_high_water(self) -> int:
        return invariants.resolved_high_water(self.delta_capacity, self.delta_high_water)

    @property
    def name(self) -> str:
        if self.strategy == "hrz":
            return "Hrz"
        if self.strategy == "dup":
            return f"Dup{self.n_trees}"
        suffix = "q" if self.mapping == "queue" else ""
        return f"Hyb{self.n_trees}{suffix}"


# Preset configurations matching the paper's evaluated implementations.
PAPER_CONFIGS = {
    "Hrz": EngineConfig(strategy="hrz"),
    "Dup4": EngineConfig(strategy="dup", n_trees=4),
    "Dup8": EngineConfig(strategy="dup", n_trees=8),
    "Hyb4": EngineConfig(strategy="hyb", n_trees=4, mapping="direct"),
    "Hyb4q": EngineConfig(strategy="hyb", n_trees=4, mapping="queue"),
    "Hyb8": EngineConfig(strategy="hyb", n_trees=8, mapping="direct"),
    "Hyb8q": EngineConfig(strategy="hyb", n_trees=8, mapping="queue"),
}


class _QueryGraph(NamedTuple):
    """One bound query as a CUDA graph and the static inputs it reads."""

    queries: torch.Tensor
    queries_hi: Optional[torch.Tensor]
    graph: graphs.Graph


class BSTEngine:
    """Build once, query batches of keys many times."""

    def __init__(self, keys, values, config: EngineConfig = EngineConfig()):
        _check_kernel_limits(config)
        tree = tree_lib.build_tree(np.asarray(keys), np.asarray(values), device=config.device)
        self._start(tree, config)

    @classmethod
    def from_tree(cls, tree: TreeData, config: EngineConfig = EngineConfig()):
        """Wrap an existing immutable snapshot (moved to the config's device)."""
        _check_kernel_limits(config)
        self = cls.__new__(cls)
        self._start(
            dataclasses.replace(
                tree, keys=tree.keys.to(config.device), values=tree.values.to(config.device)
            ),
            config,
        )
        return self

    def _start(self, tree: TreeData, config: EngineConfig) -> None:
        self.config = config
        self.tree = tree
        self.compactions = 0
        self.delta = None
        # Snapshot-swap hook: called with the fresh TreeData after every
        # swap (a compaction, or an ``apply_updates`` rebuild without a
        # buffer), which can happen deep inside ``apply_ops``' chunk loop;
        # whatever holds state made from the old snapshot (the sharded
        # server's shards) rebuilds before the next read.  None by default.
        self.on_snapshot = None
        # the query graphs' keys already warmed up once: a re-capture on a
        # new snapshot runs ops this process has run, so it skips the warm-up
        self._warmed = set()
        self._finalize()

    def _finalize(self) -> None:
        cfg = self.config
        self.device = self.tree.device
        self.plan = plans_lib.make_plan(
            self.tree,
            strategy=cfg.strategy,
            n_trees=cfg.n_trees,
            mapping=cfg.mapping,
            register_levels=cfg.register_levels,
            buffer_slack=cfg.buffer_slack,
        )
        # On the card, one graph per (op, k, batch length) of this snapshot
        # and plan, all in one memory pool: the snapshot's jit cache.
        self._graphs: Dict[Tuple[str, Optional[int], int], _QueryGraph] = {}
        self._pool = torch.cuda.graph_pool_handle() if self.device.type == "cuda" else None
        # The live write path: a fresh empty buffer per snapshot.
        self._set_delta(
            delta_lib.empty(cfg.delta_capacity, self.device)
            if cfg.delta_capacity > 0
            else None
        )
        # Host-side upper bound on the buffer's occupancy (the sum of the
        # batch sizes since the last compaction): the trigger never reads
        # the device count, at the cost of compacting a little early.
        self._pending_writes = 0

    def query(self, op: str, queries, queries_hi=None, *, k: int = 8, eager: bool = False):
        """Run one query op over a 1-D int32 batch.

        * ``query("lookup", q)``            -> (values, found)
        * ``query("predecessor", q)``       -> (keys, values, ok): floor(q)
        * ``query("successor", q)``         -> (keys, values, ok): ceiling(q)
        * ``query("range_count", lo, hi)``  -> counts of keys in [lo, hi]
        * ``query("range_scan", lo, hi, k=8)`` -> (keys (B, k), values,
          counts): the first ``k`` in-order pairs per range.

        Inputs may be numpy arrays or tensors; they are moved to the
        engine's device, and results stay there.  On the card the op runs
        as its graph (``eager=True`` runs its ops one by one instead, to
        hold the graph against them), and the results are copies of the
        graph's outputs, which later queries leave alone.
        """
        res = self.query_static(op, queries, queries_hi, k=k, eager=eager)
        if eager or self.device.type != "cuda":
            return res
        return tuple(t.clone() for t in res) if isinstance(res, tuple) else res.clone()

    def query_static(self, op: str, queries, queries_hi=None, *, k: int = 8, eager: bool = False):
        """``query``, except that on the card the results are the graph's
        static outputs, valid until this engine's next query: for a caller
        that fetches them at once (``BSTServer``)."""
        plans_lib.validate_op(op, queries_hi is not None)
        if eager or self.device.type != "cuda":
            hi = None if queries_hi is None else self._to_device(queries_hi)
            return plans_lib.ordered_query(
                self.plan, op, self._to_device(queries), hi, k=k,
                delta=self.delta, delta_ops=self._delta_ops,
            )
        q = _batch(queries)
        hi = None if queries_hi is None else _batch(queries_hi)
        if hi is not None and hi.shape != q.shape:
            raise ValueError(f"queries {tuple(q.shape)} and queries_hi {tuple(hi.shape)} differ")
        if q.shape[0] == 0:  # no lanes, no kernel: nothing to capture
            return self.query_static(op, q, hi, k=k, eager=True)
        g = self._graph(op, k, q.shape[0], hi is not None)
        g.queries.copy_(q)  # the H2D copy of a host batch, outside the graph
        if hi is not None:
            g.queries_hi.copy_(hi)
        return g.graph.replay()

    def _graph(self, op: str, k: int, B: int, ranged: bool) -> _QueryGraph:
        """The graph of (op, k) over B lanes for this snapshot, captured at
        its first use."""
        key = (op, k if op == "range_scan" else None, B)  # k shapes only range_scan
        g = self._graphs.get(key)
        if g is not None:
            return g
        if self.delta is not None:
            self.plan.sorted_view()  # made once per snapshot, outside every graph
        q = torch.zeros(B, dtype=torch.int32, device=self.device)
        hi = torch.zeros_like(q) if ranged else None
        fn = functools.partial(
            plans_lib.ordered_query, self.plan, op, q, hi, k=k,
            delta=self.delta, delta_ops=self._delta_ops,
        )
        with torch.cuda.device(self.device):
            graph = graphs.Graph(fn, warmup=key not in self._warmed, pool=self._pool)
        self._warmed.add(key)
        g = self._graphs[key] = _QueryGraph(q, hi, graph)
        return g

    def _set_delta(self, delta: Optional[delta_lib.DeltaBuffer]) -> None:
        """Install a buffer with its kernel operands, computed here rather
        than on every read chunk: the buffer changes only at ingest and
        compaction.  The engine keeps one buffer at fixed addresses and
        copies each new one into it, so that the query graphs read the
        current buffer, as the JAX package's jitted queries take it as an
        argument."""
        if delta is None or self.delta is None:
            self.delta = delta
            self._delta_ops = None if delta is None else delta_lib.operands(delta)
            return
        for dst, src in zip(self.delta, delta):
            dst.copy_(src)
        for dst, src in zip(self._delta_ops[2:], delta_lib.operands(self.delta)[2:]):
            dst.copy_(src)  # keys and values are the buffer's own tensors

    def _to_device(self, x) -> torch.Tensor:
        return _batch(x).to(device=self.device).contiguous()

    def lookup(self, queries) -> Tuple[torch.Tensor, torch.Tensor]:
        """(values, found) for a 1-D int32 query batch."""
        return self.query("lookup", queries)

    # ------------------------------------------------------------------ write
    def _ingest_step(self, delta, keys, values, deletes, valid):
        """One write-batch ingest: the batch descends the engine's OWN
        datapath (the same plan and kernel as its reads, without the
        buffer) to classify each key against the snapshot, then merges into
        the sorted buffer, all on the device."""
        res = plans_lib.execute_plan_ordered(self.plan, keys)
        return delta_lib.ingest(delta, keys, values, deletes, valid, res.found, res.rank)

    def apply_ops(self, keys, values, deletes, valid=None) -> None:
        """Apply a mixed batch of upserts/tombstones in submission order.

        ``keys``/``values`` are int32 arrays, ``deletes`` a bool mask (True
        = tombstone; its value is ignored), ``valid`` an optional bool mask
        of padding lanes.  Requires ``delta_capacity > 0``.  The buffer
        absorbs the batch on the device; a batch larger than the capacity
        goes through in capacity-sized slices with a compaction before any
        slice that would overflow the buffer.  The high-water mark compacts
        after the batch, never inside a slice, so readers always see a
        consistent snapshot + buffer pair.
        """
        if self.delta is None:
            raise ValueError(
                "write path disabled (delta_capacity == 0): construct the "
                "engine with EngineConfig(delta_capacity > 0), or use "
                "core.updates bulk maintenance + snapshot swap"
            )
        keys = np.atleast_1d(np.asarray(keys, np.int32))
        values = np.atleast_1d(np.asarray(values, np.int32))
        deletes = np.atleast_1d(np.asarray(deletes, bool))
        if not (keys.shape == values.shape == deletes.shape) or keys.ndim != 1:
            raise ValueError("keys/values/deletes must be equal-length 1-D")
        valid = (
            np.ones(keys.shape, bool) if valid is None else np.atleast_1d(np.asarray(valid, bool))
        )
        if valid.shape != keys.shape:
            raise ValueError("valid mask must match the batch shape")
        cap = self.config.delta_capacity
        for lo in range(0, keys.size, cap):
            sl = slice(lo, lo + cap)
            m = int(valid[sl].sum())  # <= cap: the slice is cap lanes long
            if m == 0:
                continue
            if self._pending_writes + m > cap:
                self.compact()
            # one host -> device copy per slice: keys, values, deletes, valid
            packed = np.stack([keys[sl], values[sl], deletes[sl], valid[sl]]).astype(np.int32)
            k, v, d, ok = torch.from_numpy(packed).to(self.device)
            self._set_delta(self._ingest_step(self.delta, k, v, d != 0, ok != 0))
            # an upper bound on the occupancy (ingest dedups, so the true
            # count can only be lower); it stays <= cap at every step
            self._pending_writes += m
        if self._pending_writes >= self.config.resolved_high_water():
            self.compact()

    def apply_updates(self, insert_keys=None, insert_values=None, delete_keys=None) -> TreeData:
        """Insert/delete over ``apply_ops`` (deletes first, so an upsert of
        a just-deleted key lands).

        With the write path enabled the batch lands in the delta buffer and
        the snapshot changes only at compaction; without it, the snapshot is
        rebuilt through ``core.updates``.  Returns the current snapshot.
        """
        dk = _as_keys(delete_keys)
        ik = _as_keys(insert_keys)
        if ik.size and insert_values is None:
            raise ValueError("insert_keys needs insert_values")
        iv = np.atleast_1d(np.asarray(insert_values, np.int32)) if ik.size else ik
        if self.delta is None:
            tree = self.tree
            if dk.size:
                tree = updates_lib.bulk_delete(tree, dk)
            if ik.size:
                tree = updates_lib.bulk_insert(tree, ik, iv)
            self._swap(tree)
            return tree
        keys = np.concatenate([dk, ik])
        values = np.concatenate([np.zeros(dk.size, np.int32), iv])
        deletes = np.concatenate([np.ones(dk.size, bool), np.zeros(ik.size, bool)])
        if keys.size:
            self.apply_ops(keys, values, deletes)
        return self.tree

    def compact(self) -> TreeData:
        """Absorb the delta buffer into a fresh perfect snapshot (one
        counted device fetch, the new key count); the plan rebuilds against
        it and the buffer comes back empty.  No-op while nothing is
        buffered."""
        if self.delta is None or self._pending_writes == 0:
            return self.tree
        tree = delta_lib.compact(self.tree, self.delta)
        self.compactions += 1
        self._swap(tree)
        return tree

    def _swap(self, tree: TreeData) -> None:
        self.tree = tree
        self._finalize()
        if self.on_snapshot is not None:
            self.on_snapshot(self.tree)

    def pending_writes(self) -> int:
        """Upper bound on buffered entries (0 right after a compaction)."""
        return self._pending_writes

    # ------------------------------------------------------------- accounting
    def memory_nodes(self) -> int:
        """Stored nodes (the paper's Fig. 8 memory metric)."""
        return self.plan.memory_nodes()


def _check_kernel_limits(config: EngineConfig) -> None:
    """On a CUDA device, the limits of the kernels the configuration will
    launch, before anything is allocated: the hybrid kernel's queue label
    table (hyb with the queue mapping), with the wrapper's message.  The
    forest kernel (hrz, dup), the direct mapping and both kernels' delta
    buffers have none: any capacity runs.  A kernel would otherwise refuse
    the engine's configuration at its first read."""
    device = torch.device(config.device)
    if device.type == "cuda" and config.strategy == "hyb" and config.mapping == "queue":
        bst_kernels.check_queue_split(invariants.split_level_for(config.n_trees), device)


def _batch(x) -> torch.Tensor:
    """A query batch as an int32 tensor, where it lies (numpy on the
    host)."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32))
    return x.to(dtype=torch.int32)


def _as_keys(keys) -> np.ndarray:
    """An optional key batch as a 1-D int32 array (empty for None)."""
    if keys is None:
        return np.empty(0, np.int32)
    return np.atleast_1d(np.asarray(keys, np.int32))
