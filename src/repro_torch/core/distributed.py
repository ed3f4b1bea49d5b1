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
a pending key (``lax.cond`` on a mesh-wide ``pmax``); a CUDA graph holds no
device-side branch, and reading the flag on the host would add a fetch per
chunk, so here the drain round always runs behind a capped round, with
``active = pending``: the answers are the same, and each such chunk pays
one full ``all_to_all`` of M x B keys more.  Where the per-batch depth is
the local batch anyway (one rank), nothing can overflow, and the host runs
the one stall-free round alone.

The JAX package compiles each runner into one ``jax.jit(shard_map(...))``
program.  Here, on the card over NCCL, each call shape of a runner is one
CUDA graph that holds the whole call, collectives included
(``ShardedQuery``); over gloo, whose collectives run on the host, the same
ops run eagerly.  A compaction that keeps the tree's height rewrites the
snapshot in place, and ``ShardedQuery.reshard`` copies this rank's rows
into its shard tensors, so the graphs stay; a height change cuts new
shards and captures every graph again.

The delta buffer (the live write path) is replicated: every rank's engine
ingests the same writes, and each rank folds the buffer into its local
slice after the register merge, with the plain ``delta.resolve_operands``
(the JAX package folds it with jnp, not with a kernel).  The process group
must exist before a mesh is made (``make_serving_mesh`` never starts one):
NCCL on the card, gloo on the CPU.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch import graphs
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


def _write_subtree(
    tree: TreeData, split_level: int, index: int, keys: torch.Tensor, values: torch.Tensor
) -> None:
    """Copy subtree ``index`` rooted at ``split_level`` (row ``index`` of
    ``tree.all_subtree_gather_indices``) into the flat ``keys`` and
    ``values``: one slice copy a level (level ``l`` of the subtree is
    contiguous in both layouts), on the current stream, with no index
    tensor."""
    for l in range(tree.height - split_level + 1):
        src = tree_lib.level_offset(split_level + l) + (index << l)
        dst = (1 << l) - 1
        keys[dst:dst + (1 << l)].copy_(tree.keys[src:src + (1 << l)])
        values[dst:dst + (1 << l)].copy_(tree.values[src:src + (1 << l)])


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
    sub_n = (1 << (tree.height - split_level + 1)) - 1
    sub_keys = torch.empty((1, sub_n), dtype=tree.keys.dtype, device=tree.device)
    sub_vals = torch.empty((1, sub_n), dtype=tree.values.dtype, device=tree.device)
    _write_subtree(tree, split_level, rank, sub_keys[0], sub_vals[0])
    return sub_keys, sub_vals, split_level, tree.height - split_level


def captures_collectives(device, backend: str) -> bool:
    """Whether a sharded runner on ``device`` over a process group of
    ``backend`` runs as CUDA graphs: on the card over NCCL, whose
    collectives are kernels a graph can hold.  gloo's run on the host and
    cannot be captured, so a runner over gloo (the CPU, or ranks that share
    one card) runs its ops eagerly."""
    return torch.device(device).type == "cuda" and backend == dist.Backend.NCCL


def _batch(x, device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x)
    return x.to(device=device, dtype=torch.int32).contiguous()


def _stage(x, static: torch.Tensor) -> None:
    """Copy a batch into a graph's static input row: a host batch through
    the counted ``runtime.device_put``, a device batch in place, and
    nothing where it is the row itself (the server's put landed there)."""
    if isinstance(x, torch.Tensor) and not x.is_cpu:
        if x.data_ptr() != static.data_ptr():
            static.copy_(x)
        return
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32))
    runtime.device_put(x, static)


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


def _delta_key(delta, delta_ops) -> Optional[Tuple[int, ...]]:
    """The addresses a graph reads the buffer at (its step holds the
    tensors, so no other buffer can take them while the graph lives)."""
    if delta is None:
        return None
    return tuple(t.data_ptr() for t in (*delta, *(delta_ops or ())))


class ShardedQuery:
    """A sharded ``query(op, ...)`` over one mesh axis: the part that the
    subtree runner (hrz, hyb) and the replica runner (dup) share.

    ``run(op, queries, queries_hi=None, *, k=8, delta=None, delta_ops=None,
    eager=False)`` has the per-op contract of ``BSTEngine.query``.  Every
    rank calls it with the same whole chunk (B lanes, B divisible by the
    axis size) and gets the whole answer back.  The op dispatch and
    epilogues are ``plans.query_through``'s, shared with the engine, over
    the engine's plan of the snapshot.  ``delta`` is the replicated write
    buffer, ``delta_ops`` its kernel operands where the caller keeps them
    (the engine does, in place); each rank folds it into its slice.

    ``compiled`` (``captures_collectives``, decided once from the group's
    backend): on the card over NCCL each ``(op, k for range_scan, batch
    length, slot)`` of a call is one CUDA graph, the counterpart of the
    JAX package's jitted ``shard_map`` program.  It holds the whole call:
    the route, every round's K4, the buffers' gather, the
    ``all_to_all_single``s, K1, the combine, the register merge, the delta
    fold, the ``all_gather_into_tensor`` and the epilogue.  A graph reads
    only tensors at fixed addresses: its slot's static input
    (``static_input``), the shard tensors, the plan's tensors and the
    buffer, so it stays valid until ``reshard`` replaces the shard
    tensors.  It is captured at its first use, after one eager run of its
    ops (which also starts the NCCL communicator), and replayed after; a
    failed capture raises.  Every rank makes the same calls, so every rank
    captures the same graphs in the same order.  ``eager=True`` runs the
    same ops one by one, to hold the graphs against them; over gloo every
    call does.  Each slot's graphs share a memory pool, and the two slots
    never share one: the server's double buffer replays slot i + 1's graph
    before it reads slot i's outputs.
    """

    capacity_frac: Optional[float] = None

    def __init__(self, tree: TreeData, mesh: DeviceMesh, axis: str, plan: Optional[SearchPlan]):
        _check_device(tree, mesh)
        self.mesh = mesh
        self.axis = axis
        self.n_shards, self.rank, self.group = _axis_of(mesh, axis)
        self.device = tree.device
        self.compiled = captures_collectives(self.device, dist.get_backend(self.group))
        self._graphs: Dict[tuple, graphs.Graph] = {}
        self._steps: Dict[tuple, tuple] = {}
        self._inputs: Dict[Tuple[int, int, int], torch.Tensor] = {}
        self._pools: Dict[int, object] = {}
        self._install(tree, _plan_of(tree, plan))

    # A subclass cuts this rank's shard of a snapshot (``_cut``), rewrites it
    # in place from a snapshot rewritten in place (``_recut``), names its
    # (keys, values) pairs (``shards``) and descends a chunk
    # (``_descend(queries, d_ops)``), and may add a membership fast path.
    _lookup = None  # (queries, d_ops) -> (values, found)

    def device_nodes(self) -> int:
        """``stored_nodes_per_device`` over the keys of this rank's shards
        (a collective: every rank calls it)."""
        return stored_nodes_per_device(tuple(keys for keys, _ in self.shards), self.group)

    def _install(self, tree: TreeData, plan: SearchPlan) -> None:
        self.tree = tree
        self.plan = plan
        self._cut(tree)

    # ------------------------------------------------------------------ calls
    def __call__(self, op: str, queries, queries_hi=None, *, k: int = 8, delta=None,
                 delta_ops=None, eager: bool = False):
        """Run one op; on the graph route the results are copies of the
        graph's outputs, which later calls leave alone."""
        res = self.query_static(
            op, queries, queries_hi, k=k, delta=delta, delta_ops=delta_ops, eager=eager
        )
        if eager or not self.compiled:
            return res
        return tuple(t.clone() for t in res) if isinstance(res, tuple) else res.clone()

    def query_static(self, op: str, queries, queries_hi=None, *, k: int = 8, delta=None,
                     delta_ops=None, slot: int = 0, eager: bool = False):
        """``run``, except that on the graph route the results are the
        static outputs of ``slot``'s graph, valid until that graph's next
        replay: for a caller that fetches them first (``BSTServer``)."""
        plans_lib.validate_op(op, queries_hi is not None)
        B = queries.shape[0] if hasattr(queries, "shape") else len(queries)
        if queries_hi is not None:
            B_hi = queries_hi.shape[0] if hasattr(queries_hi, "shape") else len(queries_hi)
            if B_hi != B:
                raise ValueError(f"lo ({B},) and hi ({B_hi},) differ")
        if eager or not self.compiled or B == 0:
            q = _batch(queries, self.device)
            hi = None if queries_hi is None else _batch(queries_hi, self.device)
            return self._step(op, k, q, hi, delta, delta_ops)
        rows = self.static_input(op, B, slot=slot)
        _stage(queries, rows[0])
        if queries_hi is not None:
            _stage(queries_hi, rows[1])
        key = (op, k if op == "range_scan" else None, B, slot, _delta_key(delta, delta_ops))
        g = self._graphs.get(key)
        if g is None:
            hi = None if queries_hi is None else rows[1]
            self._steps[key] = (op, k, rows[0], hi, delta, delta_ops)
            g = self._capture(key, warmup=True)
        return g.replay()

    def static_input(self, op: str, B: int, *, slot: int = 0) -> torch.Tensor:
        """``slot``'s static input for a B-lane chunk of ``op``: (1, B) int32
        on the runner's device, (2, B) for the range ops (lows, highs).  A
        caller may put a chunk straight into it; the graph route stages
        other batches there."""
        key = (2 if op in plans_lib.RANGE_OPS else 1, B, slot)
        if key not in self._inputs:
            self._inputs[key] = torch.zeros(key[:2], dtype=torch.int32, device=self.device)
        return self._inputs[key]

    def _step(self, op: str, k: int, queries, queries_hi, delta, delta_ops):
        """The whole call over fixed tensors: what a graph holds."""
        d_ops = None
        if delta is not None:
            d_ops = delta_ops if delta_ops is not None else delta_lib.operands(delta)
        lookup = self._lookup
        return plans_lib.query_through(
            self.plan, op, queries, queries_hi, k=k, delta=delta,
            descend=lambda x: self._descend(x, d_ops),
            lookup=None if lookup is None else (lambda x: lookup(x, d_ops)),
        )

    def _capture(self, key: tuple, *, warmup: bool) -> graphs.Graph:
        slot = key[3]
        if slot not in self._pools:
            self._pools[slot] = torch.cuda.graph_pool_handle()
        with torch.cuda.device(self.device):
            g = self._graphs[key] = graphs.Graph(
                functools.partial(self._step, *self._steps[key]), warmup=warmup,
                pool=self._pools[slot], label=key[:4], collectives=True,
            )
        return g

    def graph_keys(self) -> Tuple[tuple, ...]:
        """The calls held as CUDA graphs, in capture order: ``(op, k or
        None, batch length, slot, buffer addresses or None)``."""
        return tuple(self._graphs)

    def reshard(self, tree: TreeData, plan: Optional[SearchPlan] = None) -> bool:
        """Install the engine's new snapshot; returns whether the graphs
        were kept.  Where ``tree`` is the snapshot the shards were cut from
        (a compaction that kept the height rewrote its tensors in place),
        this rank's rows are copied into the shard tensors, on the current
        stream, and every graph stays; the plan stays too, since the
        graphs read its tensors and the new plan's are the same.  Otherwise
        new shard tensors are cut and every graph is captured again over
        them, in its first capture's order and without a warm-up (its ops
        have run): every rank reshards at the same call."""
        if tree.keys is self.tree.keys and tree.values is self.tree.values \
                and tree.height == self.tree.height:
            self._recut(tree)
            self.tree = tree
            return True
        stale = tuple(self._graphs)
        self._graphs, self._pools = {}, {}
        self._install(tree, _plan_of(tree, plan))
        for key in stale:
            self._capture(key, warmup=False)
        return False


class _SubtreeQuery(ShardedQuery):
    """hrz and hyb: subtrees sharded, the register layer replicated, keys
    routed by ``all_to_all`` (see ``make_distributed_query``)."""

    def __init__(self, tree, mesh, axis, capacity_frac, plan):
        self.capacity_frac = capacity_frac
        super().__init__(tree, mesh, axis, plan)

    def _cut(self, tree: TreeData) -> None:
        self._sub_keys, self._sub_vals, self.split_level, self._sub_height = shard_subtrees(
            tree, self.mesh, self.axis
        )
        reg_n = (1 << max(self.split_level, 1)) - 1
        self._reg_keys = tree.keys[:reg_n].clone()
        self._reg_vals = tree.values[:reg_n].clone()

    def _recut(self, tree: TreeData) -> None:
        _write_subtree(tree, self.split_level, self.rank, self._sub_keys[0], self._sub_vals[0])
        reg_n = self._reg_keys.shape[0]
        self._reg_keys.copy_(tree.keys[:reg_n])
        self._reg_vals.copy_(tree.values[:reg_n])

    @property
    def shards(self) -> Tuple[Tuple[torch.Tensor, torch.Tensor], ...]:
        """The subtree's and the register layer's (keys, values)."""
        return ((self._sub_keys, self._sub_vals), (self._reg_keys, self._reg_vals))

    def _one_round(self, queries, dest, active, cap: int):
        """dispatch -> all_to_all -> local ordered descent -> all_to_all back."""
        M, group = self.n_shards, self.group
        dplan = plans_lib.dispatch_phase("queue", dest, M, cap, active=active)
        send_q, send_live = plans_lib.gather_phase(queries, dplan)
        recv_q = _all_to_all(send_q, group)
        recv_live = _all_to_all(send_live.to(torch.int32), group)  # bools ride as int32
        sub = plans_lib.descend_phase_ordered(
            self._sub_keys, self._sub_vals, self._sub_height, recv_q.reshape(1, -1),
            recv_live.reshape(1, -1) != 0,
        )
        packed = plans_lib.pack_ordered(OrderedResult(*(f[0].reshape(M, cap) for f in sub)))
        back = _all_to_all(packed, group)
        got = plans_lib.combine_phase_ordered(
            plans_lib.unpack_ordered(back), dplan, queries.shape[0]
        )
        return got, dplan.overflow

    def _query_local(self, queries, d_ops) -> OrderedResult:
        B, M = queries.shape[0], self.n_shards
        frac = self.capacity_frac
        cap = B if frac is None else invariants.capacity_for_trace(B, M, frac)
        # a depth of the local batch cannot overflow: the host knows that no
        # key is left for the stall and drain rounds without asking
        capped = cap < B
        dest, reg = plans_lib.route_phase_ordered(
            self._reg_keys, self._reg_vals, queries, self.split_level, self.tree.height
        )
        acc = tree_lib.init_ordered(B, queries.device)
        pending = ~reg.found
        # stall rounds: overflowed keys re-enter, the buffers empty again
        for _ in range(1 + (STALL_ROUNDS if capped else 0)):
            got, overflow = self._one_round(queries, dest, pending, cap)
            acc = plans_lib.where_ordered(pending & ~overflow, got, acc)
            pending = overflow
        if capped:
            # the drain round at capacity == local batch, where the queue
            # mapping cannot overflow: no lane keeps a partial result.  It
            # always runs (see the module docstring).
            got, _ = self._one_round(queries, dest, pending, B)
            acc = plans_lib.where_ordered(pending, got, acc)
        res = plans_lib.merge_ordered(reg, acc)
        if d_ops is not None:
            # after the register merge, so register hits see overrides too
            res = delta_lib.merge_ordered(res, *delta_lib.resolve_operands(d_ops, queries))
        return res

    def _descend(self, queries, d_ops) -> OrderedResult:
        M = self.n_shards
        res = self._query_local(_local(queries, M, self.rank), d_ops)
        return plans_lib.unpack_ordered(_gather(plans_lib.pack_ordered(res), M, self.group))


class _DupQuery(ShardedQuery):
    """dup: the tree replicated, the chunk split (see ``make_dup_query``).
    The shards are views of the snapshot's own tensors."""

    def _cut(self, tree: TreeData) -> None:
        self._keys = tree.keys[None, :]
        self._vals = tree.values[None, :]

    def _recut(self, tree: TreeData) -> None:
        """Nothing to copy: the views read the tensors the compaction
        rewrote."""

    @property
    def shards(self) -> Tuple[Tuple[torch.Tensor, torch.Tensor], ...]:
        """The whole tree's (keys, values), as (1, n) views."""
        return ((self._keys, self._vals),)

    def _descend(self, queries, d_ops) -> OrderedResult:
        q = _local(queries, self.n_shards, self.rank)
        res = plans_lib.descend_phase_ordered(self._keys, self._vals, self.tree.height, q[None, :])
        res = OrderedResult(*(f[0] for f in res))
        if d_ops is not None:
            res = delta_lib.merge_ordered(res, *delta_lib.resolve_operands(d_ops, q))
        return plans_lib.unpack_ordered(_gather(plans_lib.pack_ordered(res), self.n_shards, self.group))

    def _lookup(self, queries, d_ops):
        q = _local(queries, self.n_shards, self.rank)
        val, found = plans_lib.descend_phase(self._keys, self._vals, self.tree.height, q[None, :])
        val, found = val[0], found[0]
        if d_ops is not None:
            hit, dead, d_val, _ = delta_lib.resolve_operands(d_ops, q)
            val, found = delta_lib.merge_lookup(val, found, hit, dead, d_val)
        both = _gather(torch.stack([val, found.to(torch.int32)], dim=-1), self.n_shards, self.group)
        values, hits = both.t().contiguous()
        return values, hits != 0


def make_distributed_query(
    tree: TreeData,
    mesh: DeviceMesh,
    axis: str = "model",
    capacity_frac: Optional[float] = None,
    *,
    plan: Optional[SearchPlan] = None,
) -> ShardedQuery:
    """The sharded ``query(op, ...)`` over ``axis``: subtrees sharded, the
    register layer replicated, keys routed by ``all_to_all``.

    Returns a ``ShardedQuery``: ``run(op, queries, queries_hi=None, *, k=8,
    delta=None)`` with the same per-op contract as ``BSTEngine.query``.
    ``plan`` is the engine's plan of ``tree``, whose rank -> BFS map and
    sorted view the epilogues share.

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
    return _SubtreeQuery(tree, mesh, axis, capacity_frac, plan)


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
) -> ShardedQuery:
    """dup as data parallelism: the tree replicated, the chunk split.

    Returns a ``ShardedQuery`` with the contract of
    ``make_distributed_query``: each rank runs the whole ordered descent
    (K1) on its slice.  Lookups take a membership fast path (K1's
    2-output configuration), so the hot path pays nothing for the ordered
    tracking or return lanes.
    """
    return _DupQuery(tree, mesh, axis, plan)


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

    Returns a ``ShardedQuery`` (the contract of
    ``make_distributed_query``).  Chunks must divide over the
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
    else:
        frac = buffer_slack if strategy == "hyb" else None
        run = make_distributed_query(tree, mesh, axis=axis, capacity_frac=frac, plan=plan)
    run.strategy = strategy
    return run
