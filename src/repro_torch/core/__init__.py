"""Core library of the port: tree layout, search plans, the engine, the
delta write buffer and bulk maintenance."""

from repro_torch.core import delta
from repro_torch.core.delta import DeltaBuffer
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
    layout_from_sorted_device,
    search_reference,
    search_reference_ordered,
    tree_from_numpy,
)
from repro_torch.core.updates import bulk_delete, bulk_insert, sorted_view

__all__ = [
    "BSTEngine",
    "DeltaBuffer",
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
    "bulk_delete",
    "bulk_insert",
    "delta",
    "execute_plan",
    "execute_plan_ordered",
    "layout_from_sorted_device",
    "make_plan",
    "ordered_query",
    "search_reference",
    "search_reference_ordered",
    "sorted_view",
    "tree_from_numpy",
]
