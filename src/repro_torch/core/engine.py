"""BSTEngine: the read-only query engine with the paper's three strategies.

Strategies (paper §II):
  * ``hrz`` -- horizontal partitioning: one tree in level-major layout, the
    whole query chunk descends one level per step.
  * ``dup`` -- duplicated horizontal partitioning: ``n_trees`` replicas of
    one shared tree row, each taking a slice of the chunk.
  * ``hyb`` -- hybrid horizontal-vertical partitioning: the top levels are a
    register layer, survivors are routed to ``n_trees`` vertical subtrees
    through direct- or queue-mapped buffers and descend there.

All strategies return bit-identical results; they differ in layout and
dispatch.  The tree is built with numpy on the host and moved to
``EngineConfig.device`` once; the device then decides whether each descent
launches a Hopper kernel (CUDA) or runs the plain version (CPU).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import plans as plans_lib
from repro_torch.core import tree as tree_lib
from repro_torch.core.tree import TreeData


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Reconfigurable parameters (paper: "fully reconfigurable")."""

    strategy: str = "hrz"  # hrz | dup | hyb
    n_trees: int = 1  # replicas (dup) or vertical subtrees (hyb)
    mapping: str = "queue"  # direct | queue   (hyb only)
    register_levels: Optional[int] = None  # default: log2(n_trees) for hyb
    # Buffer capacity per subtree as a multiple of the fair share B/n_trees.
    buffer_slack: float = 2.0
    device: str = "cuda"  # where the tree lives and the descent runs

    @property
    def name(self) -> str:
        if self.strategy == "hrz":
            return "Hrz"
        if self.strategy == "dup":
            return f"Dup{self.n_trees}"
        suffix = "q" if self.mapping == "queue" else ""
        return f"Hyb{self.n_trees}{suffix}"


# Preset configurations matching the paper's evaluated implementations.
PAPER_CONFIGS = {
    "Hrz": EngineConfig(strategy="hrz"),
    "Dup4": EngineConfig(strategy="dup", n_trees=4),
    "Dup8": EngineConfig(strategy="dup", n_trees=8),
    "Hyb4": EngineConfig(strategy="hyb", n_trees=4, mapping="direct"),
    "Hyb4q": EngineConfig(strategy="hyb", n_trees=4, mapping="queue"),
    "Hyb8": EngineConfig(strategy="hyb", n_trees=8, mapping="direct"),
    "Hyb8q": EngineConfig(strategy="hyb", n_trees=8, mapping="queue"),
}


class BSTEngine:
    """Build once, query batches of keys many times."""

    def __init__(self, keys, values, config: EngineConfig = EngineConfig()):
        self.config = config
        self.tree = tree_lib.build_tree(
            np.asarray(keys), np.asarray(values), device=config.device
        )
        self._finalize()

    @classmethod
    def from_tree(cls, tree: TreeData, config: EngineConfig = EngineConfig()):
        """Wrap an existing immutable snapshot (moved to the config's device)."""
        self = cls.__new__(cls)
        self.config = config
        self.tree = dataclasses.replace(
            tree,
            keys=tree.keys.to(config.device),
            values=tree.values.to(config.device),
        )
        self._finalize()
        return self

    def _finalize(self) -> None:
        cfg = self.config
        self.device = self.tree.device
        self.plan = plans_lib.make_plan(
            self.tree,
            strategy=cfg.strategy,
            n_trees=cfg.n_trees,
            mapping=cfg.mapping,
            register_levels=cfg.register_levels,
            buffer_slack=cfg.buffer_slack,
        )
        # One bound callable per (op, k): the eager counterpart of a jit cache.
        self._query_cache: Dict[Tuple[str, Optional[int]], Callable] = {}

    def query(self, op: str, queries, queries_hi=None, *, k: int = 8):
        """Run one query op over a 1-D int32 batch.

        * ``query("lookup", q)``            -> (values, found)
        * ``query("predecessor", q)``       -> (keys, values, ok): floor(q)
        * ``query("successor", q)``         -> (keys, values, ok): ceiling(q)
        * ``query("range_count", lo, hi)``  -> counts of keys in [lo, hi]
        * ``query("range_scan", lo, hi, k=8)`` -> (keys (B, k), values,
          counts): the first ``k`` in-order pairs per range.

        Inputs may be numpy arrays or tensors; they are moved to the
        engine's device, and results stay there.
        """
        plans_lib.validate_op(op, queries_hi is not None)
        # k shapes only range_scan's epilogue; other ops share one slot.
        key = (op, k) if op == "range_scan" else (op, None)
        fn = self._query_cache.get(key)
        if fn is None:
            fn = functools.partial(plans_lib.ordered_query, self.plan, op, k=k)
            self._query_cache[key] = fn
        queries = self._to_device(queries)
        if op in plans_lib.RANGE_OPS:
            return fn(queries, self._to_device(queries_hi))
        return fn(queries)

    def _to_device(self, x) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32))
        return x.to(device=self.device, dtype=torch.int32).contiguous()

    def lookup(self, queries) -> Tuple[torch.Tensor, torch.Tensor]:
        """(values, found) for a 1-D int32 query batch."""
        return self.query("lookup", queries)

    def memory_nodes(self) -> int:
        """Stored nodes (the paper's Fig. 8 memory metric)."""
        return self.plan.memory_nodes()
