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
card each step of the engine runs as one CUDA graph (``repro_torch.graphs``),
the counterpart of the JAX package's jit cache: each bound (op, k) query per
batch length, the ingest of a write slice, and the compaction's merge and
layout.  A graph is captured at its first use and replayed after; it reads
static buffers that the engine rewrites in place (the delta buffer at
every write, the snapshot at a compaction that keeps the tree's height),
so only a compaction that changes the height captures again.

The live write path (``EngineConfig(delta_capacity > 0)``): writes land in a
sorted delta buffer on the device (``core.delta``), classified by the
engine's own ordered descent; every read resolves the buffer inside its
descent; at the high-water mark a compaction merges the buffer into a fresh
perfect snapshot.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import graphs
from repro_torch.analysis import invariants, runtime
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

    def resolved_register_levels(self) -> int:
        return plans_lib.resolved_register_levels(self.n_trees, self.register_levels)

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


# The engine's CUDA graphs besides its queries (keyed (op, k, batch length)):
# the ingest step and the compaction's two steps.
_INGEST = ("ingest",)
_MERGE = ("merge",)
_LAYOUT = ("layout",)

StepKey = Tuple


class _Staging(NamedTuple):
    """The compaction's merge output, at fixed addresses for a height: the
    merged sorted view (``n_nodes + capacity`` slots and a sink slot) and
    its key count (() int32), which the one counted fetch reads."""

    keys: torch.Tensor
    values: torch.Tensor
    count: torch.Tensor


class BSTEngine:
    """Build once, query batches of keys many times."""

    def __init__(self, keys, values, config: EngineConfig = EngineConfig()):
        _check_kernel_limits(config)
        tree = tree_lib.build_tree(np.asarray(keys), np.asarray(values), device=config.device)
        self._start(tree, config)

    @classmethod
    def from_tree(cls, tree: TreeData, config: EngineConfig = EngineConfig()):
        """Wrap an existing snapshot (moved to the config's device; a
        write-path engine keeps a copy of its own, which compactions
        rewrite)."""
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
        self.device = tree.device
        self.compactions = 0
        # Snapshot-swap hook: called with the fresh TreeData after every
        # swap (a compaction, or an ``apply_updates`` rebuild without a
        # buffer), which can happen deep inside ``apply_ops``' chunk loop;
        # whatever holds state made from the old snapshot (the sharded
        # server's shards) rebuilds before the next read.  None by default.
        self.on_snapshot = None
        # On the card, one graph per step of the engine (each bound query,
        # the ingest, the compaction's merge and layout), all in one memory
        # pool: the counterpart of the JAX package's jit cache.  ``_steps``
        # keeps each graph's step and arguments, to capture it again over a
        # new snapshot's tensors; ``_inputs`` the static inputs the graphs
        # read.
        self._graphs: Dict[StepKey, graphs.Graph] = {}
        self._steps: Dict[StepKey, Tuple[Callable, tuple]] = {}
        self._inputs: Dict[StepKey, Tuple[torch.Tensor, ...]] = {}
        self._pool = None
        # The live write path: one buffer, one snapshot set and one merge
        # staging at fixed addresses, written in place (see ``compact``).
        self.delta = None
        self._delta_ops = None
        self._snap: Optional[tree_lib.Snapshot] = None
        self._staging: Optional[_Staging] = None
        if config.delta_capacity > 0:
            self._snap = tree_lib.snapshot_of(tree)
            tree = self._snap.tree(tree.n_real)
            self.delta = delta_lib.empty(config.delta_capacity, self.device)
            self._delta_ops = delta_lib.operands(self.delta)
        # Host-side upper bound on the buffer's occupancy (the sum of the
        # batch sizes since the last compaction): the trigger never reads
        # the device count, at the cost of compacting a little early.
        self._pending_writes = 0
        self._swap(tree)

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
            return self._query_step(op, k, self._to_device(queries), hi)
        q = _batch(queries)
        hi = None if queries_hi is None else _batch(queries_hi)
        if hi is not None and hi.shape != q.shape:
            raise ValueError(f"queries {tuple(q.shape)} and queries_hi {tuple(hi.shape)} differ")
        if q.shape[0] == 0:  # no lanes, no kernel: nothing to capture
            return self.query_static(op, q, hi, k=k, eager=True)
        key = (op, k if op == "range_scan" else None, q.shape[0])  # k shapes only range_scan
        if key not in self._inputs:
            q_s = torch.zeros(q.shape[0], dtype=torch.int32, device=self.device)
            self._inputs[key] = (q_s, None if hi is None else torch.zeros_like(q_s))
        q_s, hi_s = self._inputs[key]
        _stage(q, q_s)  # a host batch's copy to the device, outside the graph
        if hi is not None:
            _stage(hi, hi_s)
        return self._run(key, BSTEngine._query_step, op, k, q_s, hi_s)

    def _query_step(self, op: str, k: int, queries, queries_hi):
        return plans_lib.ordered_query(
            self.plan, op, queries, queries_hi, k=k,
            delta=self.delta, delta_ops=self._delta_ops,
        )

    def _run(self, key: StepKey, step: Callable, *args):
        """``step(self, *args)``: on the card as its graph, captured (after
        one warm-up run) at its first use and replayed after; on the CPU as
        it is.  A step reads and writes only tensors at fixed addresses: its
        static inputs, the snapshot set, the buffer and the staging, so a
        graph stays valid until the snapshot's tensors are replaced.  Its
        first use on the card runs it twice (the warm-up, then the
        replay), which every step of the engine allows: the queries and the
        merge write nothing the step reads, an ingest of a batch the buffer
        already holds changes nothing, and the layout writes what it wrote
        again.  ``step`` is a function of the engine, kept unbound in
        ``_steps`` (a bound one would tie the engine into a reference
        cycle, which only the collector frees)."""
        if self.device.type != "cuda":
            return step(self, *args)
        g = self._graphs.get(key)
        if g is None:
            self._steps[key] = (step, args)
            g = self._capture(key, warmup=True)
        return g.replay()

    def _capture(self, key: StepKey, *, warmup: bool) -> graphs.Graph:
        step, args = self._steps[key]
        with torch.cuda.device(self.device):
            g = self._graphs[key] = graphs.Graph(
                functools.partial(step, self, *args), warmup=warmup, pool=self._pool, label=key
            )
        return g

    def graph_keys(self) -> Tuple[StepKey, ...]:
        """The steps this engine holds as CUDA graphs, in capture order:
        ``(op, k or None, batch length)`` per bound query, and
        ``("ingest",)``, ``("merge",)``, ``("layout",)``."""
        return tuple(self._graphs)

    def _to_device(self, x) -> torch.Tensor:
        """A batch on the engine's device: a host batch through the counted
        ``runtime.device_put`` (on the CPU a host copy, counted alike, so
        that a drain counts the same puts on either device)."""
        x = _batch(x)
        if x.is_cpu:
            return runtime.device_put(x, torch.empty(x.shape, dtype=torch.int32, device=self.device))
        return x.to(device=self.device).contiguous()

    def lookup(self, queries) -> Tuple[torch.Tensor, torch.Tensor]:
        """(values, found) for a 1-D int32 query batch."""
        return self.query("lookup", queries)

    # ------------------------------------------------------------------ write
    def _ingest_step(self, delta, keys, values, deletes, valid):
        """One write-batch ingest: the batch descends the engine's OWN
        datapath (the same plan and kernel as its reads, without the
        buffer) to classify each key against the snapshot, then merges into
        the sorted buffer, all on the device.  Returns the new buffer (the
        eager route; ``_ingest_into`` writes it into the engine's)."""
        res = plans_lib.execute_plan_ordered(self.plan, keys)
        return delta_lib.ingest(delta, keys, values, deletes, valid, res.found, res.rank)

    def _ingest_into(self, batch: torch.Tensor) -> None:
        """The ingest step over the packed (4, C) batch (keys, values,
        deletes, valid), written into the engine's buffer and its kernel
        operands."""
        k, v, d, ok = batch
        new = self._ingest_step(self.delta, k, v, d != 0, ok != 0)
        for dst, src in zip(self.delta, new):
            dst.copy_(src)
        for dst, src in zip(self._delta_ops[2:], delta_lib.operands(new)[2:]):
            dst.copy_(src)  # keys and values are the buffer's own tensors

    def _ingest(self, keys, values, deletes, valid) -> None:
        """One slice of at most ``delta_capacity`` ops into the buffer: the
        slice padded with invalid lanes to the capacity (one ingest graph
        per engine), one host -> device copy of the packed batch into the
        step's static input, then the step."""
        cap = self.config.delta_capacity
        packed = np.zeros((4, cap), np.int32)  # padding lanes: valid = 0
        for row, x in enumerate((keys, values, deletes, valid)):
            packed[row, : x.size] = x
        if _INGEST not in self._inputs:
            self._inputs[_INGEST] = (torch.zeros((4, cap), dtype=torch.int32, device=self.device),)
        (batch,) = self._inputs[_INGEST]
        runtime.device_put(torch.from_numpy(packed), batch)
        self._run(_INGEST, BSTEngine._ingest_into, batch)

    def warmup_writes(self) -> None:
        """Capture the write path's graphs on the card before the first
        write, as a read's first use captures its own: the ingest step over
        a batch of padding lanes (it writes nothing), and, while the buffer
        is empty, the compaction's two steps (they write the snapshot into
        itself).  Counts no write and no compaction, and makes no fetch.
        On the CPU the same steps run once."""
        self._require_write_path()
        self._ingest(*(np.zeros(0, np.int32),) * 4)
        if self._pending_writes == 0:
            self._run(_MERGE, BSTEngine._merge_step)
            self._run(_LAYOUT, BSTEngine._layout_step)

    def _require_write_path(self) -> None:
        if self.delta is None:
            raise ValueError(
                "write path disabled (delta_capacity == 0): construct the "
                "engine with EngineConfig(delta_capacity > 0), or use "
                "core.updates bulk maintenance + snapshot swap"
            )

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
        self._require_write_path()
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
            self._ingest(keys[sl], values[sl], deletes[sl], valid[sl])
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
        """Absorb the delta buffer into the snapshot; the buffer comes back
        empty.  No-op while nothing is buffered.

        The merge runs into the staging (a graph on the card), and its key
        count comes back in the one counted device fetch of a compaction.
        Where the count keeps the snapshot's height, a second step (a graph
        too) lays the merged view into the snapshot's own tensors and
        empties the buffer: every graph of the engine stays valid, and a
        TreeData that the engine returned before now reads the new keys.
        Where the height changes, up or down, a new set of tensors is laid
        out eagerly, the old set and every graph are dropped, and each
        graph is captured again over the new set."""
        if self.delta is None or self._pending_writes == 0:
            return self.tree
        self._run(_MERGE, BSTEngine._merge_step)
        (n_real,) = runtime.device_fetch((self._staging.count,))
        n_real = int(n_real)
        if n_real == 0:
            raise ValueError("compaction would empty the tree")
        self.compactions += 1
        self._pending_writes = 0
        if tree_lib.height_for(n_real) == self._snap.height:
            self._run(_LAYOUT, BSTEngine._layout_step)
            self._swap(self._snap.tree(n_real), kept=True)
            return self.tree
        st = self._staging
        self._snap = tree_lib.snapshot_from_sorted(st.keys[:-1], st.values[:-1], st.count, n_real)
        del st
        self._staging = None  # one set at a time: the old height's goes
        self._clear_delta()
        self._swap(self._snap.tree(n_real))
        return self.tree

    def _merge_step(self) -> None:
        """The compaction's merge: snapshot view + buffer into the staging."""
        snap, st = self._snap, self._staging
        _, _, count = delta_lib.merge_sorted(
            snap.view.keys, snap.view.values, snap.view.count, self.delta,
            int(st.keys.shape[0]) - 1, out=(st.keys, st.values),
        )
        st.count.copy_(count)

    def _layout_step(self) -> None:
        """The compaction's layout at the same height: the staging into the
        snapshot's view, BFS image and count, after the merge has read them;
        then the buffer empties."""
        st = self._staging
        tree_lib.write_sorted_(self._snap, st.keys, st.values, st.count)
        self._clear_delta()

    def _clear_delta(self) -> None:
        """Empty the buffer in place (``delta.empty``'s contents)."""
        d = self.delta
        d.keys.fill_(int(tree_lib.SENTINEL_KEY))
        d.values.fill_(int(tree_lib.SENTINEL_VALUE))
        for t in (d.tombstone, d.in_tree, d.tree_rank, d.count, *self._delta_ops[2:]):
            t.zero_()

    def _swap(self, tree: TreeData, *, kept: bool = False) -> None:
        """Install ``tree``.  ``kept``: its tensors are the ones every graph
        reads already (a compaction that kept the height), and only the
        plan's host copy of the key count is new.  Otherwise the graphs go
        with the old tensors (their pool too), and each is captured again
        over the new ones, in its first capture's order and without a
        warm-up: its ops have run."""
        stale = () if kept else tuple(self._graphs)
        if not kept:
            self._graphs = {}
            self._pool = None
        self.tree = tree
        cfg = self.config
        self.plan = plans_lib.make_plan(
            tree,
            strategy=cfg.strategy,
            n_trees=cfg.n_trees,
            mapping=cfg.mapping,
            register_levels=cfg.register_levels,
            buffer_slack=cfg.buffer_slack,
            view=None if self._snap is None else self._snap.view,
        )
        if not kept:
            if self._snap is not None and self._staging is None:
                size = self._snap.n_nodes + cfg.delta_capacity + 1
                self._staging = _Staging(
                    torch.empty(size, dtype=torch.int32, device=self.device),
                    torch.empty(size, dtype=torch.int32, device=self.device),
                    torch.zeros((), dtype=torch.int32, device=self.device),
                )
            if self.device.type == "cuda":
                self._pool = torch.cuda.graph_pool_handle()
            for key in stale:
                self._capture(key, warmup=False)
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


def _stage(x: torch.Tensor, static: torch.Tensor) -> None:
    """Copy a query batch into a graph's static input: a host batch through
    the counted ``runtime.device_put``, a device batch in place."""
    if x.is_cpu:
        runtime.device_put(x, static)
    else:
        static.copy_(x)


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
