"""Wrappers of the Hopper kernels in ``csrc/forest_search.cu``.

Each wrapper checks its operands (device, dtype, shape, contiguity), allocates
the outputs with ``torch.empty``, launches its kernel on the current stream,
raises if the launch was refused, and adds one to its kernel's entry in
``LAUNCHES``.  They take CUDA tensors only; ``kernels.ops`` sends CPU tensors
to the plain versions in ``kernels.ref`` instead.  Lanes past the end of the
batch are the kernels' own padding, so no query is copied to pad it.

``delta=``, the write buffer's four (C,) int32 operands, selects a kernel's
delta configuration (K2: ``forest_descend_delta``, ``hybrid_descend_delta``).
Both kernels read the buffer in global memory through a sample of it in
shared memory, so any capacity runs.  The hybrid kernel's queue mapping
keeps a label table of 16 x 2^split ints in shared memory, so a split above
``hybrid_max_queue_split`` raises (``check_queue_split``, which the engine
also applies to its configuration before it is built).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.analysis import invariants
from repro_torch.kernels import _build
from repro_torch.kernels.ref import MAPPINGS

# Launches per kernel since the last ``reset_launches()``.
LAUNCHES: Dict[str, int] = {
    "forest_descend": 0,
    "hybrid_descend": 0,
    "forest_descend_delta": 0,
    "hybrid_descend_delta": 0,
}

HYBRID_BLOCK_Q = 512  # lanes per dispatch chunk: one CTA of hybrid_descend
_INT32_MAX = 2**31 - 1


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check_int32(name: str, t: torch.Tensor, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, want {device}")
    if t.dtype != torch.int32:
        raise ValueError(f"{name} must be int32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_active(active: Optional[torch.Tensor], shape, device) -> Optional[torch.Tensor]:
    if active is None:
        return None
    if active.device != device or active.dtype != torch.bool:
        raise ValueError(f"active must be a bool tensor on {device}")
    if tuple(active.shape) != tuple(shape):
        raise ValueError(f"active has shape {tuple(active.shape)}, want {tuple(shape)}")
    return active.contiguous()


def check_forest_operands(
    forest_keys: torch.Tensor,
    forest_values: torch.Tensor,
    queries: torch.Tensor,
    height: int,
    shared_tree: bool,
) -> None:
    """The forest contract: (R, n) flat trees with ``n = 2^{H+1} - 1``,
    (T, B) queries, and R == T unless every query row shares row 0."""
    if forest_keys.ndim != 2 or queries.ndim != 2:
        raise ValueError("forest operands and queries must be 2-D")
    if forest_values.shape != forest_keys.shape:
        raise ValueError("forest keys and values must have one shape")
    invariants.check_forest_nodes(forest_keys.shape[1], height)
    if not shared_tree and forest_keys.shape[0] != queries.shape[0]:
        raise ValueError("need one tree row per query row (or shared_tree=True)")


def check_hybrid_operands(
    tree_keys: torch.Tensor,
    tree_values: torch.Tensor,
    queries: torch.Tensor,
    height: int,
    split_level: int,
    mapping: str,
    capacity: int,
) -> None:
    if tree_keys.ndim != 1 or queries.ndim != 1:
        raise ValueError("hybrid operands are single-tree: 1-D tensors")
    if tree_values.shape != tree_keys.shape:
        raise ValueError("tree keys and values must have one shape")
    invariants.check_forest_nodes(tree_keys.shape[0], height)
    if not 0 <= split_level <= height:
        raise ValueError("hybrid split level must lie in [0, height]")
    if mapping not in MAPPINGS:
        raise ValueError(f"unknown mapping {mapping!r} (want one of {MAPPINGS})")
    if capacity < 1:
        raise ValueError(f"capacity must be >= 1 (got {capacity})")


@functools.lru_cache(maxsize=None)
def hybrid_max_queue_split(device: torch.device) -> int:
    """The largest split level the hybrid kernel's queue mapping takes on
    ``device``: its label table, 16 warps x 2^split ints, must fit one
    CTA's shared memory beside the delta buffer's sample."""
    with torch.cuda.device(device):
        rc = _build.library().lib.hybrid_max_queue_split()
    if rc < 0:
        _build.check_launch(-rc, "hybrid_max_queue_split")
    return rc


def check_queue_split(split_level: int, device) -> None:
    """Raise if the hybrid kernel's queue label table at ``split_level``
    does not fit one CTA on ``device``."""
    limit = hybrid_max_queue_split(device)
    if split_level > limit:
        raise ValueError(
            f"queue mapping at split level {split_level} needs a label table of "
            f"{16 << split_level} ints in the shared memory of one hybrid_descend "
            f"CTA on this card: the limit is split level {limit}"
        )


def _check_delta(delta: Sequence[torch.Tensor], device) -> int:
    """The buffer's four operands: (C,) int32, contiguous, on ``device``,
    one length C >= 1.  Returns C."""
    if len(delta) != invariants.DELTA_OPERANDS:
        raise ValueError("delta must be (keys, values, tombstone, weight)")
    C = int(delta[0].shape[0]) if delta[0].ndim == 1 else -1
    for name, t in zip(("keys", "values", "tombstone", "weight"), delta):
        _check_int32(f"delta {name}", t, device)
        if t.ndim != 1 or int(t.shape[0]) != C:
            raise ValueError("delta operands must be 1-D (C,) tensors of one length")
    if C < 1:
        raise ValueError("delta capacity must be >= 1")
    if C > _INT32_MAX:
        raise ValueError(f"delta capacity {C} exceeds int32")
    return C


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _outputs(shape, device, ordered: bool):
    val = torch.empty(shape, dtype=torch.int32, device=device)
    found = torch.empty(shape, dtype=torch.bool, device=device)
    if not ordered:
        return (val, found)
    rest = tuple(torch.empty(shape, dtype=torch.int32, device=device) for _ in range(5))
    return (val, found) + rest


def bst_ordered_forest_cuda(
    forest_keys: torch.Tensor,
    forest_values: torch.Tensor,
    queries: torch.Tensor,
    height: int,
    active: Optional[torch.Tensor] = None,
    shared_tree: bool = False,
    ordered: bool = True,
    delta: Optional[Sequence[torch.Tensor]] = None,
) -> Tuple[torch.Tensor, ...]:
    """Kernel K1 (``forest_descend``) over (R, n) flat trees for (T, B)
    queries: ``(values, found, pred_keys, pred_values, succ_keys,
    succ_values, rank)``, each (T, B), or ``(values, found)`` with
    ``ordered=False``.  Each CTA stages the top ``min(8, height + 1)``
    levels of its row's keys in shared memory (the kernel's
    ``forest_staged_levels``); deeper levels go two per global round trip,
    and the values are gathered at the end.  With ``delta`` it is K2
    (``forest_descend_delta``): value/found/rank come back merged with the
    write buffer, read through its sample, at any capacity."""
    device = queries.device
    if device.type != "cuda":
        raise ValueError(f"bst_ordered_forest_cuda takes CUDA tensors, got {device}")
    check_forest_operands(forest_keys, forest_values, queries, height, shared_tree)
    for name, t in (("forest_keys", forest_keys), ("forest_values", forest_values),
                    ("queries", queries)):
        _check_int32(name, t, device)
    active = _check_active(active, queries.shape, device)
    C = None if delta is None else _check_delta(delta, device)
    T, B = queries.shape
    if T > 65535 or B > _INT32_MAX or forest_keys.shape[1] > _INT32_MAX:
        raise ValueError(f"forest shape out of the kernel's range: T={T}, B={B}")
    outs = _outputs((T, B), device, ordered)
    if B == 0 or T == 0:
        return outs
    built = _build.library()
    ord_ptrs = [_ptr(o) for o in outs[2:]] if ordered else [None] * 5
    tree_args = (
        forest_keys.data_ptr(), forest_values.data_ptr(), forest_keys.shape[1],
        height, int(shared_tree), queries.data_ptr(), _ptr(active), T, B,
        int(ordered),
    )
    out_ptrs = (outs[0].data_ptr(), outs[1].data_ptr(), *ord_ptrs)
    name = "forest_descend" if delta is None else "forest_descend_delta"
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        LAUNCHES[name] += 1
        if delta is None:
            rc = built.lib.forest_descend(*tree_args, *out_ptrs, stream)
        else:
            rc = built.lib.forest_descend_delta(
                *tree_args, *(t.data_ptr() for t in delta), C, *out_ptrs, stream
            )
    _build.check_launch(rc, name)
    return outs


def bst_search_forest_cuda(
    forest_keys: torch.Tensor,
    forest_values: torch.Tensor,
    queries: torch.Tensor,
    height: int,
    active: Optional[torch.Tensor] = None,
    shared_tree: bool = False,
    delta: Optional[Sequence[torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Membership search: K1 (K2 with ``delta``) in its 2-output
    configuration."""
    return bst_ordered_forest_cuda(
        forest_keys, forest_values, queries, height, active=active,
        shared_tree=shared_tree, ordered=False, delta=delta,
    )


def bst_search_cuda(
    tree_keys: torch.Tensor,
    tree_values: torch.Tensor,
    queries: torch.Tensor,
    height: int,
    active: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-tree membership search: a forest of one."""
    val, found = bst_search_forest_cuda(
        tree_keys[None, :], tree_values[None, :], queries[None, :], height,
        active=None if active is None else active[None, :],
    )
    return val[0], found[0]


def bst_hybrid_forest_cuda(
    tree_keys: torch.Tensor,
    tree_values: torch.Tensor,
    queries: torch.Tensor,
    height: int,
    split_level: int,
    mapping: str = "queue",
    capacity: int = 1,
    active: Optional[torch.Tensor] = None,
    ordered: bool = True,
    overflow_out: Optional[torch.Tensor] = None,
    delta: Optional[Sequence[torch.Tensor]] = None,
) -> Tuple[torch.Tensor, ...]:
    """Kernel K3 (``hybrid_descend``): the whole hybrid pipeline over the
    (n,) flat FULL tree, one 512-lane CTA per dispatch chunk.  Returns (B,)
    tensors in the ordered contract (``(values, found)`` with
    ``ordered=False``).  ``overflow_out``, an int32 (B,) CUDA tensor, if
    given receives which lanes took the stall round.  With ``delta`` it is
    K2 (``hybrid_descend_delta``), resolving the buffer after the stall
    round."""
    device = queries.device
    if device.type != "cuda":
        raise ValueError(f"bst_hybrid_forest_cuda takes CUDA tensors, got {device}")
    check_hybrid_operands(
        tree_keys, tree_values, queries, height, split_level, mapping, capacity
    )
    for name, t in (("tree_keys", tree_keys), ("tree_values", tree_values),
                    ("queries", queries)):
        _check_int32(name, t, device)
    active = _check_active(active, queries.shape, device)
    if overflow_out is not None:
        _check_int32("overflow_out", overflow_out, device)
        if tuple(overflow_out.shape) != tuple(queries.shape):
            raise ValueError("overflow_out must have the queries' shape")
    C = None if delta is None else _check_delta(delta, device)
    if mapping == "queue":
        check_queue_split(split_level, device)
    B = queries.shape[0]
    if B > _INT32_MAX or tree_keys.shape[0] > _INT32_MAX:
        raise ValueError(f"hybrid shape out of the kernel's range: B={B}")
    outs = _outputs((B,), device, ordered)
    if B == 0:
        return outs
    built = _build.library()
    if built.lib.hybrid_block_q() != HYBRID_BLOCK_Q:
        raise RuntimeError("kernel and wrapper disagree on the dispatch chunk")
    ord_ptrs = [_ptr(o) for o in outs[2:]] if ordered else [None] * 5
    tree_args = (
        tree_keys.data_ptr(), tree_values.data_ptr(), tree_keys.shape[0], height,
        split_level, MAPPINGS.index(mapping), min(capacity, _INT32_MAX),
        queries.data_ptr(), _ptr(active), B, int(ordered),
    )
    out_ptrs = (outs[0].data_ptr(), outs[1].data_ptr(), *ord_ptrs, _ptr(overflow_out))
    name = "hybrid_descend" if delta is None else "hybrid_descend_delta"
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        LAUNCHES[name] += 1
        if delta is None:
            rc = built.lib.hybrid_descend(*tree_args, *out_ptrs, stream)
        else:
            rc = built.lib.hybrid_descend_delta(
                *tree_args, *(t.data_ptr() for t in delta), C, *out_ptrs, stream
            )
    _build.check_launch(rc, name)
    return outs
