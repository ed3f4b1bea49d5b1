"""Public entry points of the kernels: the BST searches, queue dispatch and
flash attention.

The tensors' device decides: CUDA tensors launch the Hopper kernel (or the
call raises), CPU tensors take the plain version in ``kernels.ref``.  There
is no fallback from one to the other.  ``delta=``, the write buffer's four
(C,) int32 operands (``core.delta.operands``), rides any descent: value,
found and (ordered) rank come back merged with the pending writes.

Tensors without data -- ``FakeTensor``s under ``FakeTensorMode``, or
``meta`` tensors -- take a third, shapes-only route, which the dry runs
(``launch/dryrun.py``, ``launch/dryrun_bst.py``) trace the port through:
each entry point checks the operands as the plain version does, returns
outputs of its kernel's shapes and dtypes without computing anything (the
plain versions would allocate what the kernels never do: the (S, S)
scores of a 32k prefill), and adds the kernel's work (its wrapper's
``*_work`` function: operations and bytes from the shapes) to
``SHAPE_WORK``.  It launches nothing and counts no launch.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.kernels import bst_search as K
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import queue_dispatch as QD
from repro_torch.kernels import ref


def _shapes_only(t: torch.Tensor) -> bool:
    """Whether ``t`` holds no data: a ``FakeTensor`` or a ``meta`` tensor."""
    return isinstance(t, FakeTensor) or t.is_meta


def _on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` is a CUDA tensor with data (a fake one takes the
    shapes-only route)."""
    return t.device.type == "cuda" and not _shapes_only(t)


# The kernels' work that shapes-only calls stood for since the last
# ``reset_shape_work()``: kernel -> {"calls", "flop", "bytes"}, kernels named
# as in the wrappers' ``LAUNCHES``.
SHAPE_WORK: Dict[str, Dict[str, float]] = {}


def reset_shape_work() -> None:
    SHAPE_WORK.clear()


def _record(kernel: str, work: Tuple[float, int]) -> None:
    row = SHAPE_WORK.setdefault(kernel, {"calls": 0, "flop": 0, "bytes": 0})
    row["calls"] += 1
    row["flop"] += work[0]
    row["bytes"] += work[1]


def _descent_shapes(kernel: str, shape, device, height: int, ordered: bool,
                    delta: Optional[Sequence[torch.Tensor]]) -> Tuple[torch.Tensor, ...]:
    lanes = 1
    for n in shape:
        lanes *= n
    capacity = None if delta is None else delta[0].shape[0]
    _record(kernel if delta is None else kernel + "_delta",
            K.descent_work(lanes, height, ordered, capacity))
    return K.outputs(tuple(shape), device, ordered)


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
    if _shapes_only(queries):
        return _descent_shapes("forest_descend", queries.shape, queries.device, height, False,
                               delta)
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
    if _shapes_only(queries):
        return _descent_shapes("forest_descend", queries.shape, queries.device, height, True,
                               delta)
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
    if _shapes_only(queries):
        return _descent_shapes("hybrid_descend", queries.shape, queries.device, height, ordered,
                               delta)
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


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with a gradient: the forward is K5 with its
    ``lse`` output on the card (``ref.flash_attention_lse_ref`` on the CPU),
    and it saves q, k, v, the output and lse; the backward is K5's backward
    kernel on the card (``ref.flash_attention_bwd_ref`` on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int], scale: float):
        if _on_card(q):
            out, lse = FA.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                               scale=scale, with_lse=True)
        elif _shapes_only(q):
            out, lse = _flash_shapes(q, k, v, causal, window, with_lse=True)
        else:
            FA.check_operands(q, k, v, window)
            out, lse = ref.flash_attention_lse_ref(q, k, v, causal=causal, window=window,
                                                   scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.masks = (causal, window, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, scale = ctx.masks
        if _shapes_only(q):
            BH, Sq, d, BHkv, Skv = FA.check_operands(q, k, v, window)
            _record("flash_attention_bwd",
                    FA.backward_work(BH, BHkv, Sq, Skv, d, causal, window, q.element_size()))
            dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
            FA.bwd_scratch(q, dq)  # allocated and freed as the card's call does
            return dq, dk, dv, None, None, None
        bwd = FA.flash_attention_bwd_cuda if _on_card(q) else ref.flash_attention_bwd_ref
        dq, dk, dv = bwd(q, k, v, out, dout.contiguous(), lse, causal=causal, window=window,
                         scale=scale)
        return dq, dk, dv, None, None, None


def _flash_shapes(q, k, v, causal: bool, window: Optional[int], with_lse: bool):
    """K5's outputs without computing them: (BH, Sq, d) in q's dtype and,
    with ``with_lse``, the (BH, Sq) fp32 lse."""
    BH, Sq, d, BHkv, Skv = FA.check_operands(q, k, v, window)
    _record("flash_attention",
            FA.forward_work(BH, BHkv, Sq, Skv, d, causal, window, q.element_size(), with_lse))
    out = torch.empty_like(q)
    if not with_lse:
        return out
    return out, torch.empty((BH, Sq), dtype=torch.float32, device=q.device)


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
    Kernel K5 on the card, ``ref.flash_attention_ref`` on the CPU.  Where an
    operand requires a gradient (under ``torch.no_grad`` only a leaf can)
    the call goes through ``FlashAttention``, whose backward is K5's
    backward kernel; the serving route stores no lse."""
    if q.requires_grad or k.requires_grad or v.requires_grad:
        return FlashAttention.apply(q, k, v, causal, window,
                                    scale if scale is not None else q.shape[-1] ** -0.5)
    if _on_card(q):
        return FA.flash_attention_cuda(q, k, v, causal=causal, window=window, scale=scale)
    if _shapes_only(q):
        return _flash_shapes(q, k, v, causal, window, with_lse=False)
    FA.check_operands(q, k, v, window)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window, scale=scale)


def queue_dispatch(
    dest: torch.Tensor, n_dest: int, capacity: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Queue-mapped buffer placement (the paper's labeling network) of one
    row of lanes (B,) or of G rows at once (G, B): the dispatch plan
    ``(slot (…, B) int32: the FIFO label of a kept lane, else -1; kept (…,
    B) bool; buffers (…, n_dest, capacity) of source lane indices, -1 when
    empty; counts (…, n_dest) = min(lanes per destination, capacity);
    overflow (…, B) bool)``.  A negative dest marks an inactive lane.
    Kernel K4 on the card (one launch for all five), ``ref.queue_dispatch_ref``
    on the CPU."""
    if _on_card(dest):
        return QD.queue_dispatch_cuda(dest, n_dest, capacity)
    G, B = QD.check_operands(dest, n_dest, capacity)
    if _shapes_only(dest):
        _record("queue_dispatch", QD.work(G, B, n_dest, capacity))
        return QD.outputs(dest, n_dest, capacity)
    return ref.queue_dispatch_ref(dest, n_dest, capacity)
