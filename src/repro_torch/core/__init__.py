"""Core library of the port: tree layout, search plans, the read-only engine."""

from repro_torch.core.engine import PAPER_CONFIGS, BSTEngine, EngineConfig
from repro_torch.core.plans import (
    QUERY_OPS,
    RANGE_OPS,
    SearchPlan,
    execute_plan,
    execute_plan_ordered,
    make_plan,
    ordered_query,
)
from repro_torch.core.tree import (
    NO_PRED_KEY,
    NO_SUCC_KEY,
    SENTINEL_KEY,
    SENTINEL_VALUE,
    OrderedResult,
    TreeData,
    build_tree,
    search_reference,
    search_reference_ordered,
    tree_from_numpy,
)

__all__ = [
    "BSTEngine",
    "EngineConfig",
    "NO_PRED_KEY",
    "NO_SUCC_KEY",
    "OrderedResult",
    "PAPER_CONFIGS",
    "QUERY_OPS",
    "RANGE_OPS",
    "SENTINEL_KEY",
    "SENTINEL_VALUE",
    "SearchPlan",
    "TreeData",
    "build_tree",
    "execute_plan",
    "execute_plan_ordered",
    "make_plan",
    "ordered_query",
    "search_reference",
    "search_reference_ordered",
    "tree_from_numpy",
]
