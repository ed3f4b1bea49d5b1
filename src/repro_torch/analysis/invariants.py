"""Shared invariants of the read and write paths: one definition, two
consumers.

Each check is imported both by the code that must fail loudly at run time
(``EngineConfig.__post_init__``, ``BSTServer`` construction, the sharded
builders, the kernel wrappers) and by ``analysis.contracts``, which holds
the same bounds on representative sizes.  The port stands alone: it
imports nothing of the JAX package, so this is its own copy of
``repro.analysis.invariants``, function for function.  Keep this file
stdlib only, so every subpackage can depend on it without cycles.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

# The ordered-query payload: the field order of ``tree.OrderedResult`` and
# the lane width of ``plans.pack_ordered``'s packed collective image are one
# contract seen from two sides.
ORDERED_FIELDS: Tuple[str, ...] = (
    "value",
    "found",
    "pred_key",
    "pred_value",
    "succ_key",
    "succ_value",
    "rank",
)
ORDERED_PACK_WIDTH: int = len(ORDERED_FIELDS)

# The delta buffer rides every query as this many flat (C,) int32 operands
# -- sorted keys, values, tombstone flags, signed rank weights -- replicated
# on every rank in sharded mode.
DELTA_OPERANDS: int = 4


def check_power_of_two(n: int, what: str) -> int:
    """Validate ``n`` is a positive power of two; returns ``log2(n)``."""
    if n < 1 or (n & (n - 1)):
        raise ValueError(f"{what} must be a positive power of two (got {n})")
    return n.bit_length() - 1


def split_level_for(n_trees: int) -> int:
    """The hybrid split level: ``log2(n_trees)`` vertical subtrees hang off
    the register layer, so the subtree count must be a power of two."""
    return check_power_of_two(n_trees, "n_trees")


def check_forest_nodes(n_nodes: int, height: int) -> None:
    """A flat level-major operand stores the FULL perfect tree."""
    if n_nodes != (1 << (height + 1)) - 1:
        raise ValueError(
            f"flat operand has {n_nodes} nodes, want 2^{height + 1}-1"
        )


def check_chunk_divides(chunk_size: int, n_shards: int, axis: str) -> None:
    """Sharded programs are fixed-shape SPMD: a chunk whose lanes do not
    split evenly over the mesh axis has no legal placement, so the server
    refuses it at construction."""
    if chunk_size % n_shards:
        raise ValueError(
            f"chunk_size={chunk_size} must be divisible by the mesh "
            f"axis {axis!r} size {n_shards} -- sharded chunks split "
            "evenly across devices"
        )


def capacity_for_trace(batch: int, n_shards: int, capacity_frac: float) -> int:
    """Per-(src, dst) dispatch-buffer depth sized per batch: the local
    batch's fair share ``batch / n_shards`` scaled by the fraction, clamped
    to ``[1, batch]`` (a depth above the batch is stall-free anyway, and a
    zero depth could never place a key).  The concatenated ``lo || hi``
    range batches see twice the lanes and get twice the depth, so the slack
    is one constant across ops."""
    if capacity_frac <= 0:
        raise ValueError(f"capacity_frac must be > 0 (got {capacity_frac})")
    return max(1, min(batch, int(math.ceil(batch / n_shards * capacity_frac))))


def buffer_capacity(chunk: int, n_trees: int, buffer_slack: float) -> int:
    """Per-subtree dispatch depth for a ``chunk``-lane frontend: the fair
    share ``chunk / n_trees`` scaled by the slack (``plans.hyb_capacity``)."""
    if buffer_slack <= 0:
        raise ValueError(f"buffer_slack must be > 0 (got {buffer_slack})")
    return max(1, int(math.ceil(chunk / n_trees * buffer_slack)))


def check_delta_config(delta_capacity: int, delta_high_water: Optional[int]) -> None:
    """The write path's capacity bounds (``EngineConfig.__post_init__``)."""
    if delta_capacity < 0:
        raise ValueError(
            f"delta_capacity must be >= 0 (got {delta_capacity}); "
            "0 disables the write path"
        )
    if (
        delta_capacity > 0
        and delta_high_water is not None
        and not 1 <= delta_high_water <= delta_capacity
    ):
        raise ValueError(
            f"delta_high_water={delta_high_water} must lie in "
            f"[1, delta_capacity={delta_capacity}] -- a mark above "
            "the capacity could never trigger compaction and the buffer "
            "would overflow"
        )


def resolved_high_water(delta_capacity: int, delta_high_water: Optional[int]) -> int:
    """The compaction trigger: explicit mark, else 3/4 of the capacity."""
    if delta_high_water is not None:
        return delta_high_water
    return max(1, (3 * delta_capacity) // 4)
