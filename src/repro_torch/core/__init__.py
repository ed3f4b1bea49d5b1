"""Core library of the port: tree layout, search plans, the engine, the
delta write buffer, bulk maintenance, the dispatch buffers, sharded
serving over ``torch.distributed``, and the cycle model of the paper's
FPGA pipeline (``cyclesim``)."""

from repro_torch.core import buffers, delta
from repro_torch.core.buffers import (
    DispatchPlan,
    combine_to_chunk,
    direct_dispatch,
    dispatch,
    gather_from_buffers,
    queue_dispatch,
)
from repro_torch.core.cyclesim import SimResult, run_paper_matrix, simulate
from repro_torch.core.delta import DeltaBuffer
from repro_torch.core.distributed import (
    make_distributed_lookup,
    make_distributed_query,
    make_dup_lookup,
    make_dup_query,
)
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
    "DispatchPlan",
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
    "SimResult",
    "TreeData",
    "buffers",
    "build_tree",
    "bulk_delete",
    "bulk_insert",
    "combine_to_chunk",
    "delta",
    "direct_dispatch",
    "dispatch",
    "execute_plan",
    "execute_plan_ordered",
    "gather_from_buffers",
    "layout_from_sorted_device",
    "make_distributed_lookup",
    "make_distributed_query",
    "make_dup_lookup",
    "make_dup_query",
    "make_plan",
    "ordered_query",
    "queue_dispatch",
    "run_paper_matrix",
    "search_reference",
    "search_reference_ordered",
    "simulate",
    "sorted_view",
    "tree_from_numpy",
]
