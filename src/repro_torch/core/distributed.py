"""Sharded serving over ``torch.distributed``: the paper's key router as a
collective.

On the FPGA, vertical partitioning splits the tree into subtrees that live in
disjoint BRAM groups, and a routing network moves keys from the register
layer to the right subtree.  Across devices the disjoint memories are the
ranks' devices:

  * the register layer (top ``log2(M)`` levels, a few bytes) is REPLICATED on
    every rank -- the port-less register file;
  * subtree ``s`` lives on rank ``s`` (sharded over the ``model`` axis);
  * the routing network is an ``all_to_all``: after the local register-layer
    descent, each rank posts (dest -> key) buffers built by the paper's
    queue mapping (kernel K4 on the card), and the collective delivers each
    subtree its keys; each rank descends its subtree (kernel K1) and the
    results ride the inverse ``all_to_all`` back.

Tree *duplication* (dup) is data parallelism over the ``data`` axis: every
rank holds the whole tree and serves its slice of the chunk.

The JAX package drives a mesh from one process; here every rank runs the
same program on the same chunk (SPMD).  Rank ``r`` of ``M`` serves lanes
``[r B/M, (r+1) B/M)`` of a B-lane chunk, and one ``all_gather_into_tensor``
of the packed result hands every rank the whole columns, as the JAX
package's fetch of a sharded result does.  Buffer capacity is the
collective-bytes lever: capacity == local batch is stall-free but sends
B x M keys; smaller capacities send less and re-dispatch overflowed keys in
a stall round, then one final stall-free drain round, so every answer is
exact.  The JAX package runs that drain round only when some rank still has
a pending key (``lax.cond`` on a mesh-wide ``pmax``); eager PyTorch has no
device-side branch, and reading the flag on the host would add a fetch per
chunk, so here the drain round always runs behind a capped round, with
``active = pending``: the answers are the same, and each such chunk pays
one full ``all_to_all`` of M x B keys more.  Where the per-batch depth is
the local batch anyway (one rank), nothing can overflow, and the host runs
the one stall-free round alone.

The delta buffer (the live write path) is replicated: every rank's engine
ingests the same writes, and each rank folds the buffer into its local
slice after the register merge, with the plain ``delta.resolve_operands``
(the JAX package folds it with jnp, not with a kernel).  The process group
must exist before a mesh is made (``make_serving_mesh`` never starts one):
NCCL on the card, gloo on the CPU.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.analysis import invariants, runtime
from repro_torch.core import delta as delta_lib
from repro_torch.core import plans as plans_lib
from repro_torch.core import tree as tree_lib
from repro_torch.core.plans import SearchPlan
from repro_torch.core.tree import OrderedResult, TreeData

# Rounds that re-dispatch a capped round's overflowed keys before the
# stall-free drain round.
STALL_ROUNDS = 1


def stored_nodes_per_device(tensors: Sequence[torch.Tensor], group) -> int:
    """MEASURED stored key slots on the fullest rank: each rank counts the
    elements of the tensors it really holds, and an ``all_reduce(MAX)``
    over ``group`` takes the largest.  A sharding fault that replicated a
    partitioned operand shows as an M-fold jump.  A collective: every rank
    of ``group`` must call it; the result comes back in one counted fetch,
    never inside a drain."""
    local = sum(int(t.numel()) for t in tensors)
    count = torch.full((1,), local, dtype=torch.int64, device=tensors[0].device)
    dist.all_reduce(count, op=dist.ReduceOp.MAX, group=group)
    (most,) = runtime.device_fetch((count,))
    return int(most[0])


def _axis_of(mesh: DeviceMesh, axis: str) -> Tuple[int, int, object]:
    """(size, this rank's index, process group) of ``mesh``'s ``axis``."""
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"mesh axes {names} have no {axis!r} axis")
    dim = names.index(axis)
    return mesh.shape[dim], mesh.get_local_rank(dim), mesh.get_group(dim)


def _check_device(tree: TreeData, mesh: DeviceMesh) -> None:
    if tree.device.type != mesh.device_type:
        raise ValueError(
            f"the tree is on {tree.device}, the mesh on {mesh.device_type!r} devices"
        )


def _subtree_index(height: int, split_level: int, index: int, device) -> torch.Tensor:
    """Global BFS indices of subtree ``index`` rooted at ``split_level``
    (row ``index`` of ``tree.all_subtree_gather_indices``), made on
    ``device``."""
    parts = [
        tree_lib.level_offset(split_level + l) + (index << l)
        + torch.arange(1 << l, dtype=torch.int64, device=device)
        for l in range(height - split_level + 1)
    ]
    return torch.cat(parts)


def shard_subtrees(
    tree: TreeData, mesh: DeviceMesh, axis: str
) -> Tuple[torch.Tensor, torch.Tensor, int, int]:
    """Vertical-partition the tree across ``axis``: this rank keeps row
    ``rank`` of the (M, sub_n) gather, as (1, sub_n) keys and values.
    Returns (sub_keys, sub_values, split_level, sub_height)."""
    M, rank, _ = _axis_of(mesh, axis)
    split_level = invariants.check_power_of_two(M, f"mesh axis {axis} size")
    if split_level > tree.height:
        raise ValueError("tree shallower than the mesh axis")
    idx = _subtree_index(tree.height, split_level, rank, tree.device)
    sub_keys = tree.keys[idx][None, :].contiguous()
    sub_vals = tree.values[idx][None, :].contiguous()
    return sub_keys, sub_vals, split_level, tree.height - split_level


def _batch(x, device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x)
    return x.to(device=device, dtype=torch.int32).contiguous()


def _local(x: torch.Tensor, M: int, rank: int) -> torch.Tensor:
    """This rank's contiguous slice of a chunk (the chunk must divide)."""
    B = x.shape[0]
    if B % M:
        raise ValueError(f"a batch of {B} lanes does not split over {M} ranks")
    n = B // M
    return x[rank * n:(rank + 1) * n]


def _gather(local: torch.Tensor, M: int, group) -> torch.Tensor:
    """Every rank's (n, ...) slice, concatenated in rank order on every rank."""
    local = local.contiguous()
    out = local.new_empty((M * local.shape[0],) + tuple(local.shape[1:]))
    dist.all_gather_into_tensor(out, local, group=group)
    return out


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """(M, ...) -> (M, ...): row d goes to rank d; received row s came from
    rank s (equal splits)."""
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


def _plan_of(tree: TreeData, plan: Optional[SearchPlan]) -> SearchPlan:
    """The plan whose rank -> BFS map and sorted view the epilogues read:
    the engine's own for the same snapshot (a server passes it), else one
    made here."""
    if plan is None:
        return plans_lib.make_plan(tree, strategy="hrz")
    if plan.full_tree is not tree:
        raise ValueError("the plan was made from another snapshot than the tree")
    return plan


def _make_query_runner(descend, plan: SearchPlan, lookup=None):
    """Wrap a sharded ordered descent into the ``run(op, ...)`` contract.

    The op dispatch and epilogues are ``plans.query_through``'s, shared with
    ``BSTEngine.query``, so the contract cannot drift between the sharded
    and single-chip paths.  ``descend(both, d_ops)`` returns the whole
    chunk's ``OrderedResult`` on every rank, the replicated buffer's
    operands folded in; the epilogues then run on every rank over the whole
    columns.  ``lookup`` is an optional membership fast path
    ``(queries, d_ops) -> (values, found)``.
    """
    device = plan.full_tree.device

    def run(op: str, queries, queries_hi=None, *, k: int = 8, delta=None):
        d_ops = None if delta is None else delta_lib.operands(delta)
        q = _batch(queries, device)
        hi = None
        if queries_hi is not None:
            hi = _batch(queries_hi, device)
            if hi.shape != q.shape:
                raise ValueError(f"lo {tuple(q.shape)} and hi {tuple(hi.shape)} differ")
        return plans_lib.query_through(
            plan, op, q, hi, k=k, delta=delta,
            descend=lambda x: descend(x, d_ops),
            lookup=None if lookup is None else (lambda x: lookup(x, d_ops)),
        )

    return run


def make_distributed_query(
    tree: TreeData,
    mesh: DeviceMesh,
    axis: str = "model",
    capacity_frac: Optional[float] = None,
    *,
    plan: Optional[SearchPlan] = None,
):
    """The sharded ``query(op, ...)`` over ``axis``: subtrees sharded, the
    register layer replicated, keys routed by ``all_to_all``.

    Returns ``run(op, queries, queries_hi=None, *, k=8, delta=None)`` with
    the same per-op contract as ``BSTEngine.query``.  Every rank calls it
    with the same whole chunk (B lanes, B divisible by the axis size) and
    gets the whole answer back.  ``plan`` is the engine's plan of ``tree``,
    whose rank -> BFS map and sorted view the epilogues share.

    Without ``capacity_frac`` the per-(src, dst) buffer depth is the local
    batch: one stall-free round.  ``capacity_frac`` sizes the depth per
    batch as the local batch's fair share scaled by the fraction
    (``invariants.capacity_for_trace``), so the ``lo || hi`` range batches
    (twice the lanes) keep the same slack.  Where that depth is below the
    local batch, STALL_ROUNDS extra rounds re-dispatch overflowed keys and
    one final stall-free drain round follows, so every result is exact.
    Per round: K4 places the keys (``dispatch_phase``), ``gather_phase``
    forms the (M, C) buffers, two ``all_to_all_single`` move the keys and
    the live mask, K1 descends the local subtree as a forest of one with
    the live mask as ``active``, and the packed 7-field result rides one
    ``all_to_all_single`` back to ``combine_phase_ordered``.
    """
    _check_device(tree, mesh)
    plan = _plan_of(tree, plan)
    M, rank, group = _axis_of(mesh, axis)
    sub_keys, sub_vals, split_level, sub_height = shard_subtrees(tree, mesh, axis)
    reg_n = (1 << max(split_level, 1)) - 1
    reg_keys = tree.keys[:reg_n].clone()
    reg_vals = tree.values[:reg_n].clone()

    def _one_round(queries, dest, active, cap):
        """dispatch -> all_to_all -> local ordered descent -> all_to_all back."""
        dplan = plans_lib.dispatch_phase("queue", dest, M, cap, active=active)
        send_q, send_live = plans_lib.gather_phase(queries, dplan)
        recv_q = _all_to_all(send_q, group)
        recv_live = _all_to_all(send_live.to(torch.int32), group)  # bools ride as int32
        sub = plans_lib.descend_phase_ordered(
            sub_keys, sub_vals, sub_height, recv_q.reshape(1, -1),
            recv_live.reshape(1, -1) != 0,
        )
        packed = plans_lib.pack_ordered(OrderedResult(*(f[0].reshape(M, cap) for f in sub)))
        back = _all_to_all(packed, group)
        got = plans_lib.combine_phase_ordered(
            plans_lib.unpack_ordered(back), dplan, queries.shape[0]
        )
        return got, dplan.overflow

    def _query_local(queries, d_ops) -> OrderedResult:
        B = queries.shape[0]
        cap = B if capacity_frac is None else invariants.capacity_for_trace(B, M, capacity_frac)
        # a depth of the local batch cannot overflow: the host knows that no
        # key is left for the stall and drain rounds without asking
        capped = cap < B
        dest, reg = plans_lib.route_phase_ordered(
            reg_keys, reg_vals, queries, split_level, tree.height
        )
        acc = tree_lib.init_ordered(B, queries.device)
        pending = ~reg.found
        # stall rounds: overflowed keys re-enter, the buffers empty again
        for _ in range(1 + (STALL_ROUNDS if capped else 0)):
            got, overflow = _one_round(queries, dest, pending, cap)
            acc = plans_lib.where_ordered(pending & ~overflow, got, acc)
            pending = overflow
        if capped:
            # the drain round at capacity == local batch, where the queue
            # mapping cannot overflow: no lane keeps a partial result.  It
            # always runs (see the module docstring).
            got, _ = _one_round(queries, dest, pending, B)
            acc = plans_lib.where_ordered(pending, got, acc)
        res = plans_lib.merge_ordered(reg, acc)
        if d_ops is not None:
            # after the register merge, so register hits see overrides too
            res = delta_lib.merge_ordered(res, *delta_lib.resolve_operands(d_ops, queries))
        return res

    def _descend(queries, d_ops=None) -> OrderedResult:
        res = _query_local(_local(queries, M, rank), d_ops)
        return plans_lib.unpack_ordered(_gather(plans_lib.pack_ordered(res), M, group))

    run = _make_query_runner(_descend, plan)
    run.mesh = mesh
    run.capacity_frac = capacity_frac
    run.split_level = split_level
    run.device_nodes = functools.partial(stored_nodes_per_device, (sub_keys, reg_keys), group)
    return run


def make_distributed_lookup(
    tree: TreeData,
    mesh: DeviceMesh,
    axis: str = "model",
    capacity_frac: Optional[float] = None,
):
    """Membership shorthand over ``make_distributed_query``."""
    query = make_distributed_query(tree, mesh, axis=axis, capacity_frac=capacity_frac)

    def run(queries):
        return query("lookup", queries)

    run.mesh = query.mesh
    run.capacity_frac = query.capacity_frac
    run.split_level = query.split_level
    run.query = query
    return run


def make_dup_query(
    tree: TreeData, mesh: DeviceMesh, axis: str = "data", *, plan: Optional[SearchPlan] = None
):
    """dup as data parallelism: the tree replicated, the chunk split.

    Returns the same ``run(op, ...)`` contract as ``make_distributed_query``:
    each rank runs the whole ordered descent (K1) on its slice.  Lookups
    take a membership fast path (K1's 2-output configuration), so the hot
    path pays nothing for the ordered tracking or return lanes.
    """
    _check_device(tree, mesh)
    plan = _plan_of(tree, plan)
    M, rank, group = _axis_of(mesh, axis)
    keys = tree.keys[None, :]
    vals = tree.values[None, :]

    def _descend(queries, d_ops=None) -> OrderedResult:
        q = _local(queries, M, rank)
        res = plans_lib.descend_phase_ordered(keys, vals, tree.height, q[None, :])
        res = OrderedResult(*(f[0] for f in res))
        if d_ops is not None:
            res = delta_lib.merge_ordered(res, *delta_lib.resolve_operands(d_ops, q))
        return plans_lib.unpack_ordered(_gather(plans_lib.pack_ordered(res), M, group))

    def _lookup(queries, d_ops=None):
        q = _local(queries, M, rank)
        val, found = plans_lib.descend_phase(keys, vals, tree.height, q[None, :])
        val, found = val[0], found[0]
        if d_ops is not None:
            hit, dead, d_val, _ = delta_lib.resolve_operands(d_ops, q)
            val, found = delta_lib.merge_lookup(val, found, hit, dead, d_val)
        both = _gather(torch.stack([val, found.to(torch.int32)], dim=-1), M, group)
        values, hits = both.t().contiguous()
        return values, hits != 0

    run = _make_query_runner(_descend, plan, lookup=_lookup)
    run.mesh = mesh
    run.device_nodes = functools.partial(stored_nodes_per_device, (tree.keys,), group)
    return run


def make_dup_lookup(tree: TreeData, mesh: DeviceMesh, axis: str = "data"):
    """Membership shorthand over ``make_dup_query``."""
    query = make_dup_query(tree, mesh, axis=axis)

    def run(queries):
        return query("lookup", queries)

    run.mesh = query.mesh
    run.query = query
    return run


# ------------------------------------------------------------ sharded serving
def make_serving_mesh(strategy: str, device_type: str = "cuda") -> DeviceMesh:
    """A 1-D mesh over every rank of the default process group, named for
    the strategy's shard axis (``plans.mesh_axis_for_strategy``), so a mesh
    built here always satisfies ``make_sharded_query``.  Its collectives run
    on ``mesh.get_group()``.  The process group must already exist (NCCL on
    the card, gloo on the CPU); this function never starts one."""
    axis = plans_lib.mesh_axis_for_strategy(strategy)
    if not dist.is_initialized():
        raise RuntimeError(
            "make_serving_mesh needs a process group: call "
            "torch.distributed.init_process_group first"
        )
    return init_device_mesh(device_type, (dist.get_world_size(),), mesh_dim_names=(axis,))


def make_sharded_query(
    tree: TreeData,
    mesh: DeviceMesh,
    strategy: str,
    *,
    buffer_slack: float = 2.0,
    plan: Optional[SearchPlan] = None,
):
    """The serving-facing sharded factory: one strategy name -- the hrz /
    dup / hyb vocabulary of ``EngineConfig`` -- picks the mesh layout:

      * ``hrz``: per-rank subtrees, chunks routed by the STALL-FREE
        all_to_all (capacity == local batch: one round, most bytes);
      * ``dup``: the tree replicated, the chunk split over the axis;
      * ``hyb``: per-rank subtrees behind the replicated register layer,
        with the paper's queue-capped buffers: per-(src, dst) capacity
        sized per batch as the fair share scaled by ``buffer_slack``, plus
        the stall round and the drain round where that depth is below the
        local batch.

    Returns the ``run(op, queries, queries_hi=None, *, k=8, delta=None)``
    contract of ``make_distributed_query``.  Chunks must divide over the
    axis (``BSTServer`` pads them and checks at construction).  ``plan`` is
    the engine's plan of ``tree`` (see ``make_distributed_query``).
    """
    axis = plans_lib.mesh_axis_for_strategy(strategy)
    if axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(
            f"strategy {strategy!r} shards over mesh axis {axis!r}, but the "
            f"mesh has {mesh.mesh_dim_names} -- build one with make_serving_mesh"
        )
    if strategy == "dup":
        run = make_dup_query(tree, mesh, axis=axis, plan=plan)
        run.capacity_frac = None
    else:
        frac = buffer_slack if strategy == "hyb" else None
        run = make_distributed_query(tree, mesh, axis=axis, capacity_frac=frac, plan=plan)
    run.strategy = strategy
    run.axis = axis
    run.n_shards = _axis_of(mesh, axis)[0]
    return run
