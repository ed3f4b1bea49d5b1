"""SearchPlan: one strategy abstraction behind the single-chip search path.

A ``SearchPlan`` captures a strategy's static layout -- the flat forest
operands, hyb's split level and dispatch mapping -- and every query op lowers
through one descent: hrz and dup through the forest kernel (dup as one shared
tree row), hyb through the hybrid kernel whose route, dispatch, subtree
descent and stall-round replay run inside one launch.  Range ops descend the
concatenated ``lo || hi`` batch and finish with rank arithmetic over the
sorted view.  With ``delta`` (the live write path) the pending write buffer
rides the same descent (the kernels' delta configuration) and the epilogues
switch to their delta-aware twins in ``core.delta``.  The tensors' device
decides kernel or plain version (``kernels.ops``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import torch

from repro_torch import invariants
from repro_torch.core import delta as delta_lib
from repro_torch.core import tree as tree_lib
from repro_torch.core.tree import OrderedResult, TreeData
from repro_torch.kernels import bst_search as kernels
from repro_torch.kernels import ops as kops

# The per-op query contract.  Every op lowers through one ordered forest
# descent; they differ only in operand count and epilogue.
QUERY_OPS = ("lookup", "predecessor", "successor", "range_count", "range_scan")
RANGE_OPS = ("range_count", "range_scan")

# The hybrid kernel dispatches each 512-lane chunk on its own (the FPGA
# streams chunks), and so does its plain version, on either device.
KERNEL_BLOCK_Q = kernels.HYBRID_BLOCK_Q


def validate_op(op: str, has_hi: bool) -> None:
    """The op-name / operand-arity contract, shared by every entry point."""
    if op not in QUERY_OPS:
        raise ValueError(f"unknown op {op!r} (want one of {QUERY_OPS})")
    if has_hi != (op in RANGE_OPS):
        raise ValueError(f"op {op!r}: range ops take (lo, hi), others one batch")


@dataclasses.dataclass(frozen=True)
class SearchPlan:
    """Static per-engine search configuration (built once, looked up often).

    forest_keys/forest_values: (1, n) flat level-major tree -- one row for
    every single-chip strategy; dup shares it across ``n_trees`` replicas
    (``shared_tree``), and for hyb levels ``[0, split_level)`` double as the
    register layer.  ``full_tree`` backs the range ops' sorted-view gathers;
    ``rank_to_bfs`` maps in-order rank -> BFS index on the tree's device.
    The delta epilogues' sorted view is gathered on first use and kept
    (``sorted_view``), so a read-only plan never materialises it.
    """

    strategy: str  # hrz | dup | hyb
    forest_keys: torch.Tensor
    forest_values: torch.Tensor
    forest_height: int
    n_trees: int
    shared_tree: bool
    full_tree: TreeData
    rank_to_bfs: torch.Tensor
    split_level: int = 0
    mapping: str = "queue"  # direct | queue (hyb only)
    buffer_slack: float = 2.0

    def sorted_view(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The snapshot's sorted key/value view: one gather through
        ``rank_to_bfs``, made once per plan (the snapshot is immutable)."""
        return self._sorted_view

    @functools.cached_property
    def _sorted_view(self) -> Tuple[torch.Tensor, torch.Tensor]:
        idx = self.rank_to_bfs.long()
        return self.full_tree.keys[idx], self.full_tree.values[idx]

    def memory_nodes(self) -> int:
        """Stored nodes (the paper's Fig. 8 memory metric)."""
        rows, m = self.forest_keys.shape
        if self.strategy == "dup":
            return int(m) * self.n_trees
        return rows * int(m)


def resolved_register_levels(n_trees: int, register_levels: Optional[int]) -> int:
    if register_levels is not None:
        return register_levels
    return max(1, int(math.log2(max(n_trees, 2))))


def make_plan(
    tree: TreeData,
    *,
    strategy: str,
    n_trees: int = 1,
    mapping: str = "queue",
    register_levels: Optional[int] = None,
    buffer_slack: float = 2.0,
) -> SearchPlan:
    """Build the strategy's SearchPlan from one immutable tree snapshot."""
    common = dict(
        forest_keys=tree.keys[None, :],
        forest_values=tree.values[None, :],
        forest_height=tree.height,
        full_tree=tree,
        rank_to_bfs=tree_lib.rank_to_bfs_on(tree.height, tree.device),
    )
    if strategy == "hrz":
        return SearchPlan(strategy="hrz", n_trees=1, shared_tree=False, **common)
    if strategy == "dup":
        if n_trees < 1:
            raise ValueError("dup needs n_trees >= 1")
        return SearchPlan(strategy="dup", n_trees=n_trees, shared_tree=True, **common)
    if strategy != "hyb":
        raise ValueError(f"unknown strategy {strategy!r}")

    r = resolved_register_levels(n_trees, register_levels)
    if (1 << r) < n_trees:
        raise ValueError(
            f"register_levels={r} exposes {1 << r} subtrees < n_trees={n_trees}"
        )
    if r > tree.height:
        raise ValueError("register layer deeper than the tree")
    return SearchPlan(
        strategy="hyb",
        n_trees=n_trees,
        shared_tree=False,
        split_level=invariants.split_level_for(n_trees),
        mapping=mapping,
        buffer_slack=buffer_slack,
        **common,
    )


def hyb_capacity(plan: SearchPlan, chunk: int) -> int:
    """Per-subtree dispatch-buffer depth for a ``chunk``-lane frontend:
    the fair share ``chunk / n_trees`` scaled by the plan's slack."""
    return invariants.buffer_capacity(chunk, plan.n_trees, plan.buffer_slack)


DeltaOps = Optional[Tuple[torch.Tensor, ...]]


def _hybrid_descend(
    plan: SearchPlan, queries: torch.Tensor, *, ordered: bool, delta: DeltaOps
) -> Tuple[torch.Tensor, ...]:
    """Single-chip hyb: the whole pipeline, delta merge included, in one
    call."""
    return kops.bst_hybrid_forest(
        plan.full_tree.keys,
        plan.full_tree.values,
        queries,
        height=plan.full_tree.height,
        split_level=plan.split_level,
        mapping=plan.mapping,
        capacity=hyb_capacity(plan, KERNEL_BLOCK_Q),
        ordered=ordered,
        delta=delta,
    )


def _dup_rows(queries: torch.Tensor, n: int) -> torch.Tensor:
    """dup: n replicas each take a contiguous slice of the chunk (zero
    padded to a multiple of n; the padding lanes are sliced off after)."""
    pad = (-queries.shape[0]) % n
    if pad:
        queries = torch.cat([queries, queries.new_zeros(pad)])
    return queries.reshape(n, -1)


def _forest_descend(
    plan: SearchPlan, queries: torch.Tensor, *, ordered: bool, delta: DeltaOps
):
    """hrz and dup through the forest kernel; (B,) outputs."""
    B = queries.shape[0]
    fn = kops.bst_ordered_forest if ordered else kops.bst_search_forest
    if plan.strategy == "hrz":
        out = fn(
            plan.forest_keys, plan.forest_values, queries[None, :], plan.forest_height,
            delta=delta,
        )
        return tuple(f[0] for f in out)
    out = fn(
        plan.forest_keys,
        plan.forest_values,
        _dup_rows(queries, plan.n_trees),
        plan.forest_height,
        shared_tree=True,
        delta=delta,
    )
    return tuple(f.reshape(-1)[:B] for f in out)


def _operands(delta: Optional[delta_lib.DeltaBuffer], delta_ops: DeltaOps) -> DeltaOps:
    if delta is None or delta_ops is not None:
        return delta_ops
    return delta_lib.operands(delta)


def execute_plan_ordered(
    plan: SearchPlan,
    queries: torch.Tensor,
    *,
    delta: Optional[delta_lib.DeltaBuffer] = None,
    delta_ops: DeltaOps = None,
) -> OrderedResult:
    """The single-chip path: one ordered pass -> the per-query
    ``OrderedResult`` every op's epilogue reads.  With ``delta`` value,
    found and rank come back merged with the pending writes, resolved
    inside the descent itself.  ``delta_ops`` are ``delta``'s kernel
    operands (``core.delta.operands``) when the caller already holds them;
    otherwise they are computed here."""
    d_ops = _operands(delta, delta_ops)
    if plan.strategy == "hyb":
        return OrderedResult(*_hybrid_descend(plan, queries, ordered=True, delta=d_ops))
    return OrderedResult(*_forest_descend(plan, queries, ordered=True, delta=d_ops))


def execute_plan(
    plan: SearchPlan,
    queries: torch.Tensor,
    *,
    delta: Optional[delta_lib.DeltaBuffer] = None,
    delta_ops: DeltaOps = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Membership lookup through the kernels' 2-output configuration: the
    hot lookup path pays nothing for the ordered tracking.  ``delta`` (and
    ``delta_ops``) ride the descent as in ``execute_plan_ordered``."""
    d_ops = _operands(delta, delta_ops)
    if plan.strategy == "hyb":
        return _hybrid_descend(plan, queries, ordered=False, delta=d_ops)
    return _forest_descend(plan, queries, ordered=False, delta=d_ops)


def ordered_query(
    plan: SearchPlan,
    op: str,
    queries: torch.Tensor,
    queries_hi: Optional[torch.Tensor] = None,
    *,
    k: int = 8,
    delta: Optional[delta_lib.DeltaBuffer] = None,
    delta_ops: DeltaOps = None,
):
    """The per-op query contract -- one descent, one epilogue.

    * ``lookup(q)``           -> (values, found)
    * ``predecessor(q)``      -> (keys, values, ok): largest stored key <= q
    * ``successor(q)``        -> (keys, values, ok): smallest stored key >= q
    * ``range_count(lo, hi)`` -> counts of stored keys in [lo, hi]
    * ``range_scan(lo, hi)``  -> (keys (B, k), values (B, k), counts): the
      first ``k`` in-order pairs of [lo, hi], sentinel-padded past the end;
      ``counts`` is clipped to ``k``.

    Keys and bounds must be strictly inside (NO_PRED_KEY, SENTINEL_KEY).

    With ``delta`` (the live write path) the same descent resolves the
    pending upserts and tombstones, and every epilogue switches to its
    delta-aware twin in ``core.delta``: rank selection over the merged key
    set instead of the static rank -> BFS map.  An empty buffer gives the
    read-only answers bit for bit.  ``delta_ops`` as in
    ``execute_plan_ordered``.
    """
    validate_op(op, queries_hi is not None)
    if op == "lookup":
        return execute_plan(plan, queries, delta=delta, delta_ops=delta_ops)
    n_real = plan.full_tree.n_real
    if op in RANGE_OPS:
        B = queries.shape[0]
        res = execute_plan_ordered(
            plan, torch.cat([queries, queries_hi]), delta=delta, delta_ops=delta_ops
        )
        r_lo = OrderedResult(*(f[:B] for f in res))
        r_hi = OrderedResult(*(f[B:] for f in res))
        if delta is not None:
            sk, sv = plan.sorted_view()
            return delta_lib.range_epilogue(op, sk, sv, n_real, delta, r_lo, r_hi, k=k)
        return range_epilogue(op, plan.full_tree, plan.rank_to_bfs, r_lo, r_hi, k=k)
    res = execute_plan_ordered(plan, queries, delta=delta, delta_ops=delta_ops)
    if delta is not None:
        sk, sv = plan.sorted_view()
        return delta_lib.point_epilogue(op, queries, res, sk, sv, n_real, delta)
    return point_epilogue(op, queries, res)


def point_epilogue(op: str, queries: torch.Tensor, res: OrderedResult):
    """Per-lane epilogue of the single-batch ops."""
    if op == "lookup":
        return res.value, res.found
    if op == "predecessor":
        # floor(q): q itself on an exact hit, else the strict predecessor.
        keys = torch.where(res.found, queries, res.pred_key)
        values = torch.where(res.found, res.value, res.pred_value)
        return keys, values, res.found | (res.pred_key != int(tree_lib.NO_PRED_KEY))
    # successor: ceiling(q).
    keys = torch.where(res.found, queries, res.succ_key)
    values = torch.where(res.found, res.value, res.succ_value)
    return keys, values, res.found | (res.succ_key != int(tree_lib.NO_SUCC_KEY))


def range_epilogue(
    op: str,
    full_tree: TreeData,
    rank_to_bfs: torch.Tensor,
    r_lo: OrderedResult,
    r_hi: OrderedResult,
    *,
    k: int = 8,
):
    """Rank arithmetic over the sorted view.

    |[lo, hi]| = rank_le(hi) - rank_lt(lo); empty ranges (lo > hi) clamp to
    0.  range_scan gathers the first ``k`` ranks through the rank -> BFS
    map, so the sorted view is read straight out of the flat layout.
    """
    counts = torch.clamp(r_hi.rank + r_hi.found.to(torch.int32) - r_lo.rank, min=0)
    if op == "range_count":
        return counts
    take = torch.clamp(counts, max=k)
    steps = torch.arange(k, dtype=torch.int32, device=counts.device)[None, :]
    ranks = torch.clamp(r_lo.rank[:, None] + steps, 0, full_tree.n_nodes - 1)
    valid = steps < take[:, None]
    bfs = rank_to_bfs[ranks.long()].long()
    keys = torch.where(valid, full_tree.keys[bfs], int(tree_lib.SENTINEL_KEY))
    values = torch.where(valid, full_tree.values[bfs], int(tree_lib.SENTINEL_VALUE))
    return keys, values, take
