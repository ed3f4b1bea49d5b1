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
launches a Hopper kernel (CUDA) or runs the plain version (CPU).

The live write path (``EngineConfig(delta_capacity > 0)``): writes land in a
sorted delta buffer on the device (``core.delta``), classified by the
engine's own ordered descent; every read resolves the buffer inside its
descent; at the high-water mark a compaction merges the buffer into a fresh
perfect snapshot.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import invariants
from repro_torch.core import delta as delta_lib
from repro_torch.core import plans as plans_lib
from repro_torch.core import tree as tree_lib
from repro_torch.core import updates as updates_lib
from repro_torch.core.tree import TreeData


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


class BSTEngine:
    """Build once, query batches of keys many times."""

    def __init__(self, keys, values, config: EngineConfig = EngineConfig()):
        tree = tree_lib.build_tree(np.asarray(keys), np.asarray(values), device=config.device)
        self._start(tree, config)

    @classmethod
    def from_tree(cls, tree: TreeData, config: EngineConfig = EngineConfig()):
        """Wrap an existing immutable snapshot (moved to the config's device)."""
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
        # One bound callable per (op, k): the eager counterpart of a jit cache.
        self._query_cache: Dict[Tuple[str, Optional[int]], Callable] = {}
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

    def query(self, op: str, queries, queries_hi=None, *, k: int = 8):
        """Run one query op over a 1-D int32 batch.

        * ``query("lookup", q)``            -> (values, found)
        * ``query("predecessor", q)``       -> (keys, values, ok): floor(q)
        * ``query("successor", q)``         -> (keys, values, ok): ceiling(q)
        * ``query("range_count", lo, hi)``  -> counts of keys in [lo, hi]
        * ``query("range_scan", lo, hi, k=8)`` -> (keys (B, k), values,
          counts): the first ``k`` in-order pairs per range.

        Inputs may be numpy arrays or tensors; they are moved to the
        engine's device, and results stay there.
        """
        plans_lib.validate_op(op, queries_hi is not None)
        # k shapes only range_scan's epilogue; other ops share one slot.
        key = (op, k) if op == "range_scan" else (op, None)
        fn = self._query_cache.get(key)
        if fn is None:
            fn = functools.partial(plans_lib.ordered_query, self.plan, op, k=k)
            self._query_cache[key] = fn
        queries = self._to_device(queries)
        # The buffer is an argument, not part of the bound callable: it
        # changes with every write batch.
        d = {"delta": self.delta, "delta_ops": self._delta_ops}
        if op in plans_lib.RANGE_OPS:
            return fn(queries, self._to_device(queries_hi), **d)
        return fn(queries, **d)

    def _set_delta(self, delta: Optional[delta_lib.DeltaBuffer]) -> None:
        """Install a buffer with its kernel operands, computed once here
        rather than on every read chunk: the buffer changes only at ingest
        and compaction."""
        self.delta = delta
        self._delta_ops = None if delta is None else delta_lib.operands(delta)

    def _to_device(self, x) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32))
        return x.to(device=self.device, dtype=torch.int32).contiguous()

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

    def pending_writes(self) -> int:
        """Upper bound on buffered entries (0 right after a compaction)."""
        return self._pending_writes

    # ------------------------------------------------------------- accounting
    def memory_nodes(self) -> int:
        """Stored nodes (the paper's Fig. 8 memory metric)."""
        return self.plan.memory_nodes()


def _as_keys(keys) -> np.ndarray:
    """An optional key batch as a 1-D int32 array (empty for None)."""
    if keys is None:
        return np.empty(0, np.int32)
    return np.atleast_1d(np.asarray(keys, np.int32))
