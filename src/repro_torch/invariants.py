"""Shared invariants of the read and write paths, kept inside the port.

The port stands alone: it imports nothing of the JAX package, so it keeps
its own copy of the few pure-stdlib bounds its engine, plans and kernel
wrappers enforce.  Keep this file stdlib only, so every subpackage can
depend on it without cycles.
"""

from __future__ import annotations

import math
from typing import Optional


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
