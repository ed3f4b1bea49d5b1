"""Public entry points of the kernels: the BST searches and flash attention.

The tensors' device decides: CUDA tensors launch the Hopper kernel (or the
call raises), CPU tensors take the plain version in ``kernels.ref``.  There
is no fallback from one to the other.  ``delta=``, the write buffer's four
(C,) int32 operands (``core.delta.operands``), rides any descent: value,
found and (ordered) rank come back merged with the pending writes.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels import bst_search as K
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ref


def _on_card(queries: torch.Tensor) -> bool:
    return queries.device.type == "cuda"


def bst_search_forest(
    forest_keys: torch.Tensor,
    forest_values: torch.Tensor,
    queries: torch.Tensor,
    height: int,
    active: Optional[torch.Tensor] = None,
    shared_tree: bool = False,
    delta: Optional[Sequence[torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forest-batched membership search: (T, B) queries over (R, n) flat
    trees -> ``(values, found)``, each (T, B).  hrz is a forest of one, dup
    shares one row across the query rows (``shared_tree``)."""
    if _on_card(queries):
        return K.bst_search_forest_cuda(
            forest_keys, forest_values, queries, height, active=active,
            shared_tree=shared_tree, delta=delta,
        )
    K.check_forest_operands(forest_keys, forest_values, queries, height, shared_tree)
    return ref.bst_search_ref(forest_keys, forest_values, queries, height, active, delta)


def bst_ordered_forest(
    forest_keys: torch.Tensor,
    forest_values: torch.Tensor,
    queries: torch.Tensor,
    height: int,
    active: Optional[torch.Tensor] = None,
    shared_tree: bool = False,
    delta: Optional[Sequence[torch.Tensor]] = None,
) -> Tuple[torch.Tensor, ...]:
    """Forest-batched ORDERED search: one pass per query yields ``(values,
    found, pred_keys, pred_values, succ_keys, succ_values, rank)``, each
    (T, B) -- the descent behind predecessor, successor and the range ops.
    With ``delta`` pred/succ stay tree-local (``core.delta`` selects the
    merged floor and ceiling by rank)."""
    if _on_card(queries):
        return K.bst_ordered_forest_cuda(
            forest_keys, forest_values, queries, height, active=active,
            shared_tree=shared_tree, delta=delta,
        )
    K.check_forest_operands(forest_keys, forest_values, queries, height, shared_tree)
    return ref.bst_ordered_ref(
        forest_keys, forest_values, queries, height, active, delta=delta
    )


def bst_hybrid_forest(
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
    """The hybrid strategy's single entry point: register route,
    queue/direct dispatch per 512-lane chunk, vertical-subtree descent,
    stall-round replay and the delta merge in one call.  Operands are the
    (n,) flat FULL tree and a (B,) batch; outputs are (B,) in the ordered
    contract (``(values, found)`` with ``ordered=False``).  ``overflow_out``
    (int32 (B,)) optionally receives which lanes overflowed."""
    if _on_card(queries):
        return K.bst_hybrid_forest_cuda(
            tree_keys, tree_values, queries, height, split_level, mapping=mapping,
            capacity=capacity, active=active, ordered=ordered, overflow_out=overflow_out,
            delta=delta,
        )
    K.check_hybrid_operands(
        tree_keys, tree_values, queries, height, split_level, mapping, capacity
    )
    return ref.bst_hybrid_ref(
        tree_keys, tree_values, queries, height, split_level, mapping, capacity,
        active=active, ordered=ordered, block_q=K.HYBRID_BLOCK_Q, overflow_out=overflow_out,
        delta=delta,
    )


def bst_search(
    tree_keys: torch.Tensor,
    tree_values: torch.Tensor,
    queries: torch.Tensor,
    height: int,
    active: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-tree membership search: ``(values, found)``, each (B,)."""
    if _on_card(queries):
        return K.bst_search_cuda(tree_keys, tree_values, queries, height, active=active)
    val, found = bst_search_forest(
        tree_keys[None, :], tree_values[None, :], queries[None, :], height,
        active=None if active is None else active[None, :],
    )
    return val[0], found[0]


def bst_delta_resolve(
    delta_keys: torch.Tensor,
    delta_values: torch.Tensor,
    delta_tombstone: torch.Tensor,
    delta_weight: torch.Tensor,
    queries: torch.Tensor,
    active: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The delta buffer's resolution on its own: per query ``(hit, dead,
    value, weight_below)`` against the four flat operands, with inactive
    lanes' hit dropped and rank correction zeroed.  Plain torch on either
    device (the JAX twin is jnp, not a Pallas kernel); the descent kernels
    resolve the buffer themselves, so the serving path never calls this."""
    return ref.bst_delta_resolve_ref(
        delta_keys, delta_values, delta_tombstone, delta_weight, queries, active
    )


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Batched-heads attention: q (BH, Sq, d) against k/v (BHkv, Skv, d),
    GQA by reading kv row ``b // (BH // BHkv)`` for q row b; causal and
    window masks align q at the end of kv; rows that see no key give 0.
    Kernel K5 on the card, ``ref.flash_attention_ref`` on the CPU."""
    if _on_card(q):
        return FA.flash_attention_cuda(q, k, v, causal=causal, window=window, scale=scale)
    FA.check_operands(q, k, v, window)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window, scale=scale)
