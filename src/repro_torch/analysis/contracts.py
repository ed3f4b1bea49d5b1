"""Contract checker: the shapes, dtypes and layouts the port's layers
exchange (the JAX package's ``repro.analysis.contracts``).

Declares the per-op query outputs (``OP_CONTRACTS``), the ordered-result
packing, the ``SearchPlan`` operand layout, the delta buffer's four
operands and the sharded builders' mesh and replication rules, and checks
them on representative sizes (31 keys, a batch of 8, k = 4), with the
cross-module bounds delegated to ``analysis.invariants`` so that the
checker and the run-time checks cannot disagree.

Torch has no ``eval_shape``.  A check whose function is shape-only runs on
``device="meta"`` tensors: ``check_ordered_packing``, ``check_plan_layout``
and the delta operands in ``check_query_contracts``.  A check that needs
values runs on tiny tensors of the given device: the queries of
``check_query_contracts`` (the plain route branches on its stall flags on
the CPU; on the card the kernels need real memory) and
``check_sharded_builders`` (collectives over the process group that
exists, a world-1 one made for the check where there is none);
``check_invariant_bounds`` and ``check_engine_delegation`` run Python
only.

The JAX table ``DELTA_IN_SPECS`` (``PartitionSpec``s of the delta
operands) is not ported: the port runs one process per rank and has no
sharding annotations to read.  ``check_sharded_builders`` checks the
nearest property it can observe instead: every rank's query takes the
engine's whole four-tensor buffer (each operand (C,) int32), not a shard
of it.

To declare a contract on a new op, add its output row to ``OP_CONTRACTS``:
the checker fails on any drift between the row and what the code returns.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.analysis import invariants
from repro_torch.analysis.report import Violation

# The per-op output contract for a B-lane batch with scan fan-out k:
# op -> tuple of (shape-lambda, dtype).  The engine, the sharded runners
# and the server all honour these rows.
OP_CONTRACTS = {
    "lookup": (
        (lambda B, k: (B,), torch.int32),
        (lambda B, k: (B,), torch.bool),
    ),
    "predecessor": (
        (lambda B, k: (B,), torch.int32),
        (lambda B, k: (B,), torch.int32),
        (lambda B, k: (B,), torch.bool),
    ),
    "successor": (
        (lambda B, k: (B,), torch.int32),
        (lambda B, k: (B,), torch.int32),
        (lambda B, k: (B,), torch.bool),
    ),
    "range_count": ((lambda B, k: (B,), torch.int32),),
    "range_scan": (
        (lambda B, k: (B, k), torch.int32),
        (lambda B, k: (B, k), torch.int32),
        (lambda B, k: (B,), torch.int32),
    ),
}

# Representative sizes: tiny, but non-degenerate (multi-level tree, batch
# > n_trees, k smaller than the key count).
_N_KEYS = 31  # height-4 perfect tree
_BATCH = 8
_K = 4
_DELTA_CAP = 8


def _violation(check: str, msg: str) -> Violation:
    return Violation("CON001", f"contracts:{check}", 0, msg)


def _check_outputs(check: str, op: str, out, B: int, k: int, errors: List[Violation]) -> None:
    rows = OP_CONTRACTS[op]
    out = out if isinstance(out, tuple) else (out,)
    if len(out) != len(rows):
        errors.append(_violation(check, f"{op}: {len(out)} outputs, contract declares {len(rows)}"))
        return
    for i, (o, (shape_fn, dtype)) in enumerate(zip(out, rows)):
        want = tuple(shape_fn(B, k))
        if tuple(o.shape) != want or o.dtype != dtype:
            errors.append(
                _violation(
                    check,
                    f"{op} output[{i}]: {o.dtype}{tuple(o.shape)} != declared {dtype}{want}",
                )
            )


def _tiny_tree(device):
    from repro_torch.core import tree as tree_lib

    keys = np.arange(1, _N_KEYS + 1, dtype=np.int32) * 3
    return tree_lib.build_tree(keys, keys * 7, device=device)


def _queries(device) -> torch.Tensor:
    return torch.arange(_BATCH, dtype=torch.int32, device=device) * 3 + 1


# ----------------------------------------------------------------- the checks
def check_ordered_packing(device: str = "cpu") -> List[Violation]:
    """OrderedResult field order == the packed-collective lane layout
    (meta tensors)."""
    from repro_torch.core import plans as plans_lib
    from repro_torch.core import tree as tree_lib

    errors: List[Violation] = []
    if tree_lib.OrderedResult._fields != invariants.ORDERED_FIELDS:
        errors.append(
            _violation(
                "packing",
                f"OrderedResult fields {tree_lib.OrderedResult._fields} != "
                f"invariants.ORDERED_FIELDS {invariants.ORDERED_FIELDS}",
            )
        )
        return errors
    res = tree_lib.OrderedResult(*(
        torch.empty(_BATCH, dtype=torch.bool if f == "found" else torch.int32, device="meta")
        for f in invariants.ORDERED_FIELDS
    ))
    packed = plans_lib.pack_ordered(res)
    want = (_BATCH, invariants.ORDERED_PACK_WIDTH)
    if tuple(packed.shape) != want or packed.dtype != torch.int32:
        errors.append(
            _violation(
                "packing",
                f"pack_ordered: {packed.dtype}{tuple(packed.shape)} != int32{want} -- "
                "the packed collective image drifted",
            )
        )
    else:
        unpacked = plans_lib.unpack_ordered(packed)
        if unpacked.found.dtype != torch.bool or any(tuple(f.shape) != (_BATCH,) for f in unpacked):
            errors.append(_violation("packing", "unpack_ordered round-trip drifted"))
    return errors


def check_plan_layout(device: str = "cpu") -> List[Violation]:
    """SearchPlan operand layout per strategy (meta tensors): one flat
    level-major row of 2^(h+1)-1 int32 nodes; hyb's split level ==
    log2(n_trees)."""
    from repro_torch.core import plans as plans_lib

    errors: List[Violation] = []
    tree = _tiny_tree("meta")
    for strategy, n_trees in (("hrz", 1), ("dup", 4), ("hyb", 4)):
        plan = plans_lib.make_plan(tree, strategy=strategy, n_trees=n_trees)
        rows, n = plan.forest_keys.shape
        try:
            invariants.check_forest_nodes(n, plan.forest_height)
        except ValueError as e:
            errors.append(_violation("plan", f"{strategy}: {e}"))
        if plan.forest_values.shape != plan.forest_keys.shape:
            errors.append(_violation("plan", f"{strategy}: keys/values shape mismatch"))
        if plan.forest_keys.dtype != torch.int32:
            errors.append(_violation("plan", f"{strategy}: operands {plan.forest_keys.dtype}"))
        if rows != 1:
            errors.append(
                _violation(
                    "plan",
                    f"{strategy}: {rows} operand rows -- the single-chip strategies "
                    "carry ONE flat tree row",
                )
            )
        if plan.rank_to_bfs.shape[0] != tree.n_nodes:
            errors.append(_violation("plan", f"{strategy}: rank_to_bfs size drifted"))
        if strategy == "hyb":
            want_split = invariants.split_level_for(n_trees)
            if plan.split_level != want_split:
                errors.append(
                    _violation(
                        "plan",
                        f"hyb split_level {plan.split_level} != log2(n_trees) {want_split}",
                    )
                )
    return errors


def check_query_contracts(device: str = "cpu") -> List[Violation]:
    """Every (strategy, op, with/without delta) query on ``device`` (the
    plain route on the CPU, the kernels on the card) returns the declared
    rows; the delta buffer's four operands are (C,) int32 (meta)."""
    from repro_torch.core import delta as delta_lib
    from repro_torch.core import plans as plans_lib

    errors: List[Violation] = []
    tree = _tiny_tree(device)
    q = _queries(device)
    delta = delta_lib.empty(_DELTA_CAP, device)
    for strategy, n_trees in (("hrz", 1), ("dup", 2), ("hyb", 4)):
        plan = plans_lib.make_plan(tree, strategy=strategy, n_trees=n_trees)
        for with_delta in (False, True):
            tag = f"{strategy}/{torch.device(device).type}/{'delta' if with_delta else 'plain'}"
            for op in plans_lib.QUERY_OPS:
                args = (q, q + 5) if op in plans_lib.RANGE_OPS else (q,)
                try:
                    out = plans_lib.ordered_query(
                        plan, op, *args, k=_K, delta=delta if with_delta else None
                    )
                except (RuntimeError, ValueError) as e:  # contract: must run
                    errors.append(_violation("query", f"{tag} {op}: failed: {e}"))
                    continue
                _check_outputs(f"query[{tag}]", op, out, _BATCH, _K, errors)
    ops = delta_lib.operands(delta_lib.empty(_DELTA_CAP, "meta"))
    if len(ops) != invariants.DELTA_OPERANDS or any(
        tuple(o.shape) != (_DELTA_CAP,) or o.dtype != torch.int32 for o in ops
    ):
        errors.append(
            _violation(
                "delta",
                f"delta.operands: {[(str(o.dtype), tuple(o.shape)) for o in ops]} "
                f"!= {invariants.DELTA_OPERANDS} x int32(C,)",
            )
        )
    return errors


def check_invariant_bounds(device: str = "cpu") -> List[Violation]:
    """The shared bounds themselves: good values pass, bad values raise.
    Guards against someone weakening ``invariants`` (both the checker and
    the run-time checks would rot together otherwise)."""
    errors: List[Violation] = []
    cases: Tuple[Tuple[str, Callable[[], object], bool], ...] = (
        ("chunk divides axis", lambda: invariants.check_chunk_divides(8192, 8, "model"), True),
        ("chunk !divides axis", lambda: invariants.check_chunk_divides(100, 8, "model"), False),
        ("delta config ok", lambda: invariants.check_delta_config(64, 48), True),
        ("delta negative cap", lambda: invariants.check_delta_config(-1, None), False),
        ("high water > cap", lambda: invariants.check_delta_config(64, 65), False),
        ("high water zero", lambda: invariants.check_delta_config(64, 0), False),
        ("pow2 ok", lambda: invariants.check_power_of_two(8, "n"), True),
        ("pow2 bad", lambda: invariants.check_power_of_two(6, "n"), False),
        ("capacity_frac bad", lambda: invariants.capacity_for_trace(512, 8, 0.0), False),
        ("forest nodes ok", lambda: invariants.check_forest_nodes(31, 4), True),
        ("forest nodes bad", lambda: invariants.check_forest_nodes(30, 4), False),
    )
    for name, fn, should_pass in cases:
        try:
            fn()
            ok = True
        except ValueError:
            ok = False
        if ok != should_pass:
            errors.append(
                _violation(
                    "bounds",
                    f"invariants self-check {name!r}: {'passed' if ok else 'raised'}, "
                    f"expected {'pass' if should_pass else 'raise'}",
                )
            )
    # capacity bounds over a representative grid: 1 <= cap <= B
    for B in (8, 512, 8192):
        for M in (1, 2, 8):
            for frac in (0.25, 1.0, 2.0):
                cap = invariants.capacity_for_trace(B, M, frac)
                if not 1 <= cap <= B:
                    errors.append(
                        _violation(
                            "bounds", f"capacity_for_trace({B}, {M}, {frac}) = {cap} outside [1, {B}]"
                        )
                    )
    # high-water default stays inside (0, capacity]
    for cap in (1, 4, 64, 8192):
        hw = invariants.resolved_high_water(cap, None)
        if not 1 <= hw <= cap:
            errors.append(_violation("bounds", f"resolved_high_water({cap}) = {hw} outside [1, {cap}]"))
    return errors


def check_engine_delegation(device: str = "cpu") -> List[Violation]:
    """EngineConfig must enforce the shared bounds: constructing with values
    the invariants reject must raise ValueError."""
    from repro_torch.core.engine import EngineConfig

    errors: List[Violation] = []
    for kwargs in ({"delta_capacity": -1}, {"delta_capacity": 8, "delta_high_water": 9}):
        try:
            EngineConfig(**kwargs)
            errors.append(_violation("delegation", f"EngineConfig({kwargs}) did not raise"))
        except ValueError:
            pass
    return errors


def check_sharded_builders(device: str = "cpu") -> List[Violation]:
    """The sharded builders over the process group that exists (a world-1
    one made here where there is none): mesh axis naming per strategy,
    every rank's query taking the whole four-operand delta buffer, the
    stored nodes per device, and ``run(op, ...)``'s outputs against the
    rows -- on a tiny tree on ``device``."""
    if not dist.is_initialized():
        from repro_torch.analysis import gate

        with gate.world1_group(device):
            return check_sharded_builders(device)
    from repro_torch.core import delta as delta_lib
    from repro_torch.core import distributed as dist_lib
    from repro_torch.core import plans as plans_lib

    errors: List[Violation] = []
    tree = _tiny_tree(device)
    q = _queries(device)
    delta = delta_lib.empty(_DELTA_CAP, device)
    seen: List[Tuple[torch.Tensor, ...]] = []
    resolve = delta_lib.resolve_operands

    def recording(d_ops, queries):
        seen.append(tuple(d_ops))
        return resolve(d_ops, queries)

    for strategy in plans_lib.SHARDED_STRATEGIES:
        axis = plans_lib.mesh_axis_for_strategy(strategy)
        want = "data" if strategy == "dup" else "model"
        if axis != want:
            errors.append(_violation("sharded", f"{strategy} shards over {axis!r}, want {want!r}"))
        mesh = dist_lib.make_serving_mesh(strategy, torch.device(device).type)
        if tuple(mesh.mesh_dim_names or ()) != (axis,):
            errors.append(
                _violation("sharded", f"make_serving_mesh({strategy!r}) axes {mesh.mesh_dim_names}")
            )
        run = dist_lib.make_sharded_query(tree, mesh, strategy)
        # per-device stored nodes: the subtree shard plus the replicated
        # register layer (< axis size nodes); an M-fold replication of a
        # partitioned operand blows through this bound
        bound = tree.n_nodes + run.n_shards
        nodes = run.device_nodes()
        if nodes > bound:
            errors.append(
                _violation(
                    "sharded",
                    f"{strategy}: {nodes} stored nodes/device > single-chip bound {bound}",
                )
            )
        for op in plans_lib.QUERY_OPS:
            args = (q, q + 5) if op in plans_lib.RANGE_OPS else (q,)
            for kw in ({}, {"delta": delta}):
                seen.clear()
                delta_lib.resolve_operands = recording
                try:
                    out = run(op, *args, k=_K, **kw)
                finally:
                    delta_lib.resolve_operands = resolve
                tag = f"sharded[{strategy}/{'delta' if kw else 'plain'}]"
                _check_outputs(tag, op, out, _BATCH, _K, errors)
                if kw and (
                    not seen
                    or any(
                        len(ops) != invariants.DELTA_OPERANDS
                        or any(tuple(o.shape) != (_DELTA_CAP,) or o.dtype != torch.int32 for o in ops)
                        for ops in seen
                    )
                ):
                    errors.append(
                        _violation(
                            "sharded",
                            f"{tag} {op}: the rank resolved "
                            f"{[[tuple(o.shape) for o in ops] for ops in seen]}, not the "
                            f"whole {invariants.DELTA_OPERANDS} x int32({_DELTA_CAP},) buffer "
                            "-- the delta buffer must be whole on every rank",
                        )
                    )
    return errors


ALL_CHECKS = (
    check_ordered_packing,
    check_plan_layout,
    check_query_contracts,
    check_invariant_bounds,
    check_engine_delegation,
    check_sharded_builders,
)


def run_contracts(device: str = "cpu") -> List[Violation]:
    errors: List[Violation] = []
    for check in ALL_CHECKS:
        errors.extend(check(device))
    return errors
