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

The pipeline phases

    route_phase    -- register-layer descent, survivors get a subtree id
    dispatch_phase -- direct-/queue-mapped buffer placement (paper §II.C.3)
    descend_phase  -- forest-batched subtree descent (kernel K1 on the card)
    combine_phase  -- scatter buffered results back into chunk order

are plain functions, each with an ``_ordered`` variant carrying the 7-field
``OrderedResult``.  The single-chip path does not compose them (the hybrid
kernel runs the whole pipeline in one launch); the sharded path in
``core/distributed.py`` does, because there dispatch is a pair of
``all_to_all`` collectives between placement and descent.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import torch

from repro_torch.analysis import invariants
from repro_torch.core import buffers as buf
from repro_torch.core import delta as delta_lib
from repro_torch.core import tree as tree_lib
from repro_torch.core.tree import OrderedResult, TreeData
from repro_torch.kernels import bst_search as kernels
from repro_torch.kernels import ops as kops

# The per-op query contract.  Every op lowers through one ordered forest
# descent; they differ only in operand count and epilogue.
QUERY_OPS = ("lookup", "predecessor", "successor", "range_count", "range_scan")
RANGE_OPS = ("range_count", "range_scan")

# How each engine strategy lays out over a serving mesh:
#   hrz -- the one tree vertically partitioned into per-device subtrees;
#          request chunks route through the stall-free all_to_all network;
#   dup -- the tree replicated on every device, the chunk split over the
#          axis (data parallelism, no routing traffic at all);
#   hyb -- subtree-sharded forest + replicated register layer, with the
#          paper's queue-capped dispatch buffers as the collective-bytes
#          lever (finite capacity + stall rounds).
# ``mesh_axis_for_strategy`` is the one place that mapping lives.
SHARDED_STRATEGIES = ("hrz", "dup", "hyb")


def mesh_axis_for_strategy(strategy: str) -> str:
    """The mesh axis a sharded plan uses: dup shards the *batch* over the
    data axis; hrz/hyb shard the *tree* over the model axis."""
    if strategy not in SHARDED_STRATEGIES:
        raise ValueError(
            f"unknown sharded strategy {strategy!r} (want {SHARDED_STRATEGIES})"
        )
    return "data" if strategy == "dup" else "model"


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
    ``view`` is the delta epilogues' sorted view with the key count on the
    device: a write-path engine passes its snapshot's, which a compaction
    that keeps the height rewrites in place; without one it is gathered on
    first use and kept (``sorted_view``), so a read-only plan never
    materialises it.
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
    view: Optional[tree_lib.SortedView] = None

    def sorted_view(self) -> tree_lib.SortedView:
        """The snapshot's sorted key/value view and its device key count."""
        return self.view if self.view is not None else self._gathered_view

    @functools.cached_property
    def _gathered_view(self) -> tree_lib.SortedView:
        return tree_lib.sorted_view_of(self.full_tree)

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
    view: Optional[tree_lib.SortedView] = None,
) -> SearchPlan:
    """Build the strategy's SearchPlan from one tree snapshot (``view`` as
    in ``SearchPlan``).  It makes no tensor but views of the snapshot's
    and the memoised rank map of its height, so a plan of a snapshot
    rewritten in place reads the same addresses as the one before."""
    common = dict(
        forest_keys=tree.keys[None, :],
        forest_values=tree.values[None, :],
        forest_height=tree.height,
        full_tree=tree,
        rank_to_bfs=tree_lib.rank_to_bfs_on(tree.height, tree.device),
        view=view,
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
    return query_through(
        plan, op, queries, queries_hi, k=k, delta=delta,
        descend=lambda q: execute_plan_ordered(plan, q, delta=delta, delta_ops=delta_ops),
        lookup=lambda q: execute_plan(plan, q, delta=delta, delta_ops=delta_ops),
    )


def query_through(
    plan: SearchPlan,
    op: str,
    queries: torch.Tensor,
    queries_hi: Optional[torch.Tensor],
    *,
    k: int,
    delta: Optional[delta_lib.DeltaBuffer],
    descend,
    lookup=None,
):
    """``ordered_query``'s op dispatch over a given descent: ``descend(q)``
    returns the ``OrderedResult`` of a batch with ``delta`` already folded
    in, and ``lookup(q)``, when given, the membership columns.  The
    epilogues read ``plan``'s rank -> BFS map and sorted view, so the
    sharded runners (``core/distributed.py``) share the engine's.  No host
    value of the snapshot's key count reaches them: the delta epilogues
    read the view's device count."""
    validate_op(op, queries_hi is not None)
    if op == "lookup" and lookup is not None:
        return lookup(queries)
    if op in RANGE_OPS:
        B = queries.shape[0]
        res = descend(torch.cat([queries, queries_hi]))
        r_lo = OrderedResult(*(f[:B] for f in res))
        r_hi = OrderedResult(*(f[B:] for f in res))
        if delta is not None:
            view = plan.sorted_view()
            return delta_lib.range_epilogue(
                op, view.keys, view.values, view.count, delta, r_lo, r_hi, k=k
            )
        return range_epilogue(op, plan.full_tree, plan.rank_to_bfs, r_lo, r_hi, k=k)
    res = descend(queries)
    if delta is not None:
        view = plan.sorted_view()
        return delta_lib.point_epilogue(op, queries, res, view.keys, view.values, view.count, delta)
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


# --------------------------------------------------------------------- phases
def _register_tree(reg_keys: torch.Tensor, reg_values: torch.Tensor, split_level: int) -> TreeData:
    return TreeData(reg_keys, reg_values, max(split_level - 1, 0), int(reg_keys.shape[0]))


def route_phase(
    reg_keys: torch.Tensor,
    reg_values: torch.Tensor,
    queries: torch.Tensor,
    split_level: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Register-layer descent -> (dest, value, found).

    ``split_level == 0`` means no routing network: everything goes to
    subtree 0 unresolved (the single-partition degenerate case).
    """
    B = queries.shape[0]
    if split_level == 0:
        return (
            torch.zeros((B,), dtype=torch.int32, device=queries.device),
            torch.full((B,), int(tree_lib.SENTINEL_VALUE), dtype=torch.int32, device=queries.device),
            torch.zeros((B,), dtype=torch.bool, device=queries.device),
        )
    reg_tree = _register_tree(reg_keys, reg_values, split_level)
    return tree_lib.register_layer_route(reg_tree, queries, split_level)


def route_phase_ordered(
    reg_keys: torch.Tensor,
    reg_values: torch.Tensor,
    queries: torch.Tensor,
    split_level: int,
    full_height: int,
) -> Tuple[torch.Tensor, OrderedResult]:
    """Ordered register-layer descent -> (dest, partial OrderedResult).

    The partial result carries the register layer's predecessor/successor
    candidates and its rank contribution (left-subtree sizes of the FULL
    tree); the subtree descent below the split completes all three
    (``merge_ordered``).
    """
    B = queries.shape[0]
    if split_level == 0:
        return (
            torch.zeros((B,), dtype=torch.int32, device=queries.device),
            tree_lib.init_ordered(B, queries.device),
        )
    reg_tree = _register_tree(reg_keys, reg_values, split_level)
    return tree_lib.register_layer_route_ordered(reg_tree, queries, split_level, full_height)


def dispatch_phase(
    mapping: str,
    dest: torch.Tensor,
    n_dest: int,
    capacity: int,
    active: Optional[torch.Tensor] = None,
) -> buf.DispatchPlan:
    """Buffer placement: the paper's direct/queue mapping networks (the
    queue mapping is kernel K4 on the card)."""
    return buf.dispatch(mapping, dest, n_dest, capacity, active=active)


def gather_phase(
    items: torch.Tensor, dplan: buf.DispatchPlan, fill_value=0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Materialise the buffered items: (B,) -> ((n_dest, cap), live mask)."""
    per_dest = buf.gather_from_buffers(items, dplan.buffers, fill_value=fill_value)
    return per_dest, dplan.buffers >= 0


def descend_phase(
    forest_keys: torch.Tensor,
    forest_values: torch.Tensor,
    height: int,
    queries: torch.Tensor,
    active: Optional[torch.Tensor] = None,
    *,
    shared_tree: bool = False,
    delta: DeltaOps = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forest-batched compare-descend: (n_trees, B) queries in one launch
    of kernel K1 on the card (its plain version on the CPU) -> ``(values,
    found)``.  ``delta`` rides the descent as in ``kernels.ops``."""
    return kops.bst_search_forest(
        forest_keys, forest_values, queries, height, active=active,
        shared_tree=shared_tree, delta=delta,
    )


def descend_phase_ordered(
    forest_keys: torch.Tensor,
    forest_values: torch.Tensor,
    height: int,
    queries: torch.Tensor,
    active: Optional[torch.Tensor] = None,
    *,
    shared_tree: bool = False,
    delta: DeltaOps = None,
) -> OrderedResult:
    """Ordered forest-batched compare-descend, the same single launch as
    ``descend_phase``; fields are (n_trees, B)."""
    return OrderedResult(*kops.bst_ordered_forest(
        forest_keys, forest_values, queries, height, active=active,
        shared_tree=shared_tree, delta=delta,
    ))


def combine_phase(
    sub_values: torch.Tensor,
    sub_found: torch.Tensor,
    dplan: buf.DispatchPlan,
    chunk_size: int,
    reg_values: Optional[torch.Tensor] = None,
    reg_found: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter per-buffer results back to chunk order; merge register hits."""
    got_v = buf.combine_to_chunk(
        sub_values, dplan.buffers, chunk_size, fill_value=int(tree_lib.SENTINEL_VALUE)
    )
    got_f = buf.combine_to_chunk(sub_found, dplan.buffers, chunk_size, fill_value=False)
    if reg_found is None:
        return got_v, got_f
    return torch.where(reg_found, reg_values, got_v), reg_found | got_f


# Each ordered field's identity: no hit, no predecessor, no successor, rank 0.
_ORDERED_FILLS = (
    int(tree_lib.SENTINEL_VALUE),
    False,
    int(tree_lib.NO_PRED_KEY),
    int(tree_lib.SENTINEL_VALUE),
    int(tree_lib.NO_SUCC_KEY),
    int(tree_lib.SENTINEL_VALUE),
    0,
)


def combine_phase_ordered(
    sub: OrderedResult, dplan: buf.DispatchPlan, chunk_size: int
) -> OrderedResult:
    """Scatter per-buffer ordered results back to chunk order.  Unplaced
    lanes get each field's identity, so a later ``merge_ordered`` or
    stall-round override composes cleanly."""
    return OrderedResult(*(
        buf.combine_to_chunk(field, dplan.buffers, chunk_size, fill_value=fill)
        for field, fill in zip(sub, _ORDERED_FILLS)
    ))


def pack_ordered(res: OrderedResult) -> torch.Tensor:
    """Stack the 7 ordered fields into one ``(..., F)`` int32 image, so the
    whole ordered payload rides a collective (or a device transfer) as one
    tensor.  The width is pinned to ``invariants.ORDERED_PACK_WIDTH``."""
    if len(res) != invariants.ORDERED_PACK_WIDTH:
        raise ValueError(f"an ordered result has {invariants.ORDERED_PACK_WIDTH} fields")
    return torch.stack([f.to(torch.int32) for f in res], dim=-1)


def unpack_ordered(packed: torch.Tensor) -> OrderedResult:
    """Inverse of ``pack_ordered`` (the NamedTuple's order on both sides).
    One transposing copy makes every field contiguous again."""
    if packed.shape[-1] != invariants.ORDERED_PACK_WIDTH:
        raise ValueError(
            f"packed image {tuple(packed.shape)} is not "
            f"{invariants.ORDERED_PACK_WIDTH} lanes wide"
        )
    res = OrderedResult(*packed.movedim(-1, 0).contiguous().unbind(0))
    return res._replace(found=res.found != 0)


def merge_ordered(reg: OrderedResult, sub: OrderedResult) -> OrderedResult:
    """Merge the register layer's partial result with the subtree descent.

    The two are disjoint halves of one root-to-leaf path: exact hits are
    exclusive; the predecessor is the larger of the two right-turn
    candidates and the successor the smaller left-turn candidate (absent
    candidates sit at the tracking identities, so plain max/min is exact);
    ranks add (register turns count FULL-tree left subtrees, subtree turns
    local ones -- together the global rank).
    """
    take_sub_pred = sub.pred_key > reg.pred_key
    take_sub_succ = sub.succ_key < reg.succ_key
    return OrderedResult(
        value=torch.where(reg.found, reg.value, sub.value),
        found=reg.found | sub.found,
        pred_key=torch.maximum(reg.pred_key, sub.pred_key),
        pred_value=torch.where(take_sub_pred, sub.pred_value, reg.pred_value),
        succ_key=torch.minimum(reg.succ_key, sub.succ_key),
        succ_value=torch.where(take_sub_succ, sub.succ_value, reg.succ_value),
        rank=reg.rank + sub.rank,
    )


def where_ordered(mask: torch.Tensor, a: OrderedResult, b: OrderedResult) -> OrderedResult:
    """Per-lane select between two ordered results (stall-round override)."""
    return OrderedResult(*(torch.where(mask, x, y) for x, y in zip(a, b)))
