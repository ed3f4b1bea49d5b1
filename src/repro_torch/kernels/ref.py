"""Plain PyTorch versions of the Hopper kernels in ``csrc/``.

Each BST function repeats its kernel's arithmetic step by step over a level
loop, with a leading batch dimension where the JAX package used ``vmap``;
the attention functions at the end are the JAX package's reference
attention (materialized scores, fp32).  They are
the CPU path of ``kernels.ops`` and the ground truth ``chip_smoke.py`` holds
the kernels against on the card (called there explicitly on CUDA tensors);
nothing on the main path calls them for tensors on the card.  All arithmetic
stays int32; only gather indices are int64, as torch indexing wants.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

# The int32 sentinels of core/tree.py, as plain ints (the kernels' own copy).
SENTINEL_VALUE = -1
NO_PRED_KEY = -(2**31)  # identity of the max-tracked predecessor
NO_SUCC_KEY = 2**31 - 1  # identity of the min-tracked successor

MAPPINGS = ("queue", "direct")

# Lanes per block of the delta resolution's broadcast compare: a block of
# lanes meets all C buffer slots at once, so one intermediate holds
# _RESOLVE_LANES * C elements (16 Mi at C = 4096) whatever the batch.
_RESOLVE_LANES = 4096

DeltaOperands = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _init_state(shape, device) -> List[torch.Tensor]:
    """(idx, val, found, pred_key, pred_value, succ_key, succ_value, rank)."""

    def full(v):
        return torch.full(shape, int(v), dtype=torch.int32, device=device)

    return [
        torch.zeros(shape, dtype=torch.int64, device=device),
        full(SENTINEL_VALUE),
        torch.zeros(shape, dtype=torch.bool, device=device),
        full(NO_PRED_KEY),
        full(SENTINEL_VALUE),
        full(NO_SUCC_KEY),
        full(SENTINEL_VALUE),
        torch.zeros(shape, dtype=torch.int32, device=device),
    ]


def _descend(keys, values, queries, gate, state, height, levels, ordered):
    """Compare-descend ``levels`` of a (R, n) forest, R in {1, T}, for (T, B)
    lanes; lanes outside ``gate`` and lanes that hit stay where they are.
    ``left`` is the left-subtree size ``2^{H-l} - 1``: a right turn skips the
    node plus that subtree, an exact hit skips just the subtree."""
    idx, val, found, pk, pv, sk, sv, rank = state
    T = queries.shape[0]
    n = keys.shape[1]
    keys = keys.expand(T, n)
    values = values.expand(T, n)
    for l in levels:
        left = (1 << (height - l)) - 1
        nk = torch.gather(keys, 1, idx)
        nv = torch.gather(values, 1, idx)
        live = gate & ~found
        hit = (nk == queries) & live
        go_right = live & ~hit & (queries > nk)
        val = torch.where(hit, nv, val)
        found = found | hit
        if ordered:
            go_left = live & ~hit & (queries < nk)
            pk = torch.where(go_right, nk, pk)  # right-turn keys increase: last == max
            pv = torch.where(go_right, nv, pv)
            sk = torch.where(go_left, nk, sk)  # left-turn keys decrease: last == min
            sv = torch.where(go_left, nv, sv)
            rank = rank + go_right.int() * (left + 1) + hit.int() * left
        nxt = torch.clamp(2 * idx + 1 + go_right.long(), max=n - 1)
        idx = torch.where(found | ~gate, idx, nxt)
    return [idx, val, found, pk, pv, sk, sv, rank]


def _outputs(state, active, ordered) -> Tuple[torch.Tensor, ...]:
    _, val, found, pk, pv, sk, sv, rank = state
    if not ordered:
        return val, found & active
    return val, found & active, pk, pv, sk, sv, rank


def _active(queries, active):
    if active is None:
        return torch.ones(queries.shape, dtype=torch.bool, device=queries.device)
    return active.to(torch.bool)


def bst_delta_resolve_ref(
    delta_keys: torch.Tensor,
    delta_values: torch.Tensor,
    delta_tombstone: torch.Tensor,
    delta_weight: torch.Tensor,
    queries: torch.Tensor,
    active: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The delta buffer's resolution, as the Pallas body writes it: one
    broadcast compare of every lane with every slot.

    Operands are the buffer's four (C,) int32 arrays (sorted keys with an
    INT32_MAX tail, values, tombstone flags, signed rank weights).  Returns
    per query ``(hit, dead, value, weight_below)``, where ``weight_below``
    sums the weights of the slots strictly below the query.  Queries may
    have any batch shape; the compare runs over blocks of lanes so memory
    stays bounded.  The kernel's binary search over the staged buffer must
    equal these sums bit for bit."""
    q = queries.reshape(-1)
    parts = []
    for lo in range(0, q.shape[0], _RESOLVE_LANES):
        qb = q[lo : lo + _RESOLVE_LANES, None]
        eq = qb == delta_keys
        parts.append((
            eq.any(dim=-1),
            torch.where(eq, delta_tombstone, 0).sum(dim=-1, dtype=torch.int32) != 0,
            torch.where(eq, delta_values, 0).sum(dim=-1, dtype=torch.int32),
            torch.where(delta_keys < qb, delta_weight, 0).sum(dim=-1, dtype=torch.int32),
        ))
    if parts:
        hit, dead, value, wbelow = (torch.cat(c).reshape(queries.shape) for c in zip(*parts))
    else:
        hit = dead = torch.zeros(queries.shape, dtype=torch.bool, device=queries.device)
        value = wbelow = torch.zeros(queries.shape, dtype=torch.int32, device=queries.device)
    if active is not None:
        hit = hit & active
        wbelow = torch.where(active, wbelow, 0)
    return hit, dead, value, wbelow


def merge_delta_resolution(
    out: Tuple[torch.Tensor, ...],
    hit: torch.Tensor,
    dead: torch.Tensor,
    value: torch.Tensor,
    weight_below: torch.Tensor,
) -> Tuple[torch.Tensor, ...]:
    """Fold a resolution into descent outputs: ``delta-hit > tombstone >
    tree-hit`` on value/found, and the merged rank on the 7-field ordered
    tuple (a membership tuple has no rank to correct)."""
    val = torch.where(hit, torch.where(dead, SENTINEL_VALUE, value), out[0])
    found = torch.where(hit, ~dead, out[1])
    if len(out) == 2:
        return val, found
    return (val, found) + tuple(out[2:6]) + (out[6] + weight_below,)


def _with_delta(out, delta: Optional[DeltaOperands], queries, active):
    if delta is None:
        return out
    return merge_delta_resolution(out, *bst_delta_resolve_ref(*delta, queries, active))


def bst_ordered_ref(
    forest_keys: torch.Tensor,
    forest_values: torch.Tensor,
    queries: torch.Tensor,
    height: int,
    active: Optional[torch.Tensor] = None,
    ordered: bool = True,
    delta: Optional[DeltaOperands] = None,
) -> Tuple[torch.Tensor, ...]:
    """Forest descent over (R, n) trees for (T, B) queries; R is T, or 1 for
    a row every query row shares (dup).  Returns ``(values, found,
    pred_keys, pred_values, succ_keys, succ_values, rank)``, each (T, B), or
    ``(values, found)`` with ``ordered=False``.  Inactive lanes keep the
    identities.  ``delta``, the write buffer's four operands, resolves
    after the descent: value/found/rank come back merged."""
    active = _active(queries, active)
    state = _init_state(queries.shape, queries.device)
    state = _descend(
        forest_keys, forest_values, queries, active, state, height,
        range(height + 1), ordered,
    )
    return _with_delta(_outputs(state, active, ordered), delta, queries, active)


def bst_search_ref(
    forest_keys: torch.Tensor,
    forest_values: torch.Tensor,
    queries: torch.Tensor,
    height: int,
    active: Optional[torch.Tensor] = None,
    delta: Optional[DeltaOperands] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Membership descent: ``(values, found)``, each (T, B)."""
    return bst_ordered_ref(
        forest_keys, forest_values, queries, height, active, ordered=False, delta=delta
    )


def _dispatch_lanes(dest, live, mapping: str, n_sub: int, capacity: int):
    """Per-chunk buffer placement over (n_chunks, block_q) lanes: which live
    lanes land in their subtree's buffer, and which overflow to the stall
    round.  ``queue`` labels same-destination lanes 0, 1, 2, ... by an
    exclusive prefix count; ``direct`` pins lane ``i`` to slot
    ``i % capacity`` and overflows when a live lane ``k * capacity``
    positions back shares its destination."""
    block_q = dest.shape[1]
    if mapping == "queue":
        cols = torch.arange(n_sub, dtype=torch.int64, device=dest.device)
        onehot = (dest[..., None] == cols).int() * live[..., None].int()
        label = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
        label = (label * onehot).sum(dim=2, dtype=torch.int32)  # own column
        placed = live & (label < capacity)
    elif mapping == "direct":
        clash = torch.zeros_like(live)
        for k in range(1, -(-block_q // capacity)):
            off = k * capacity
            prev_live = torch.zeros_like(live)
            prev_live[:, off:] = live[:, :-off]
            prev_dest = torch.full_like(dest, -1)
            prev_dest[:, off:] = dest[:, :-off]
            clash = clash | (live & prev_live & (prev_dest == dest))
        placed = live & ~clash
    else:
        raise ValueError(f"unknown mapping {mapping!r} (want one of {MAPPINGS})")
    return placed, live & ~placed


def bst_hybrid_ref(
    tree_keys: torch.Tensor,
    tree_values: torch.Tensor,
    queries: torch.Tensor,
    height: int,
    split_level: int,
    mapping: str,
    capacity: int,
    active: Optional[torch.Tensor] = None,
    ordered: bool = True,
    block_q: int = 512,
    overflow_out: Optional[torch.Tensor] = None,
    delta: Optional[DeltaOperands] = None,
) -> Tuple[torch.Tensor, ...]:
    """The hybrid pipeline over the (n,) flat FULL tree, one ``block_q``
    chunk at a time as the kernel runs it: route through levels
    ``[0, split_level)``, place the surviving lanes of each chunk into
    per-subtree buffers of depth ``capacity`` (queue or direct), descend the
    placed lanes through ``[split_level, H]``, then replay the overflow lanes
    through the same levels from the shared route state (the stall round).
    Padding lanes of the last chunk are inactive.  With ``block_q = B`` the
    whole batch is one chunk.  ``overflow_out``, an int32 (B,) tensor, if
    given receives the overflow mask.  ``delta`` resolves after the stall
    round, as in ``bst_ordered_ref``.  Returns (B,) tensors: the 7-field
    ordered tuple, or ``(values, found)`` with ``ordered=False``."""
    B = queries.shape[0]
    active = _active(queries, active)
    pad = (-B) % block_q
    q = torch.cat([queries, queries.new_zeros(pad)]).reshape(-1, block_q)
    act = torch.cat([active, active.new_zeros(pad)]).reshape(-1, block_q)
    keys, values = tree_keys[None, :], tree_values[None, :]
    n_sub = 1 << split_level

    state = _init_state(q.shape, q.device)
    state = _descend(keys, values, q, act, state, height, range(split_level), ordered)
    live = act & ~state[2]
    dest = torch.clamp(state[0] - (n_sub - 1), 0, n_sub - 1)
    placed, overflow = _dispatch_lanes(dest, live, mapping, n_sub, capacity)

    deep = range(split_level, height + 1)
    sub = _descend(keys, values, q, act & ~overflow, state, height, deep, ordered)
    if bool(overflow.any()):
        rep = _descend(keys, values, q, overflow, state, height, deep, ordered)
        sub = [torch.where(overflow, r, s) for r, s in zip(rep, sub)]
    if overflow_out is not None:
        overflow_out.copy_(overflow.reshape(-1)[:B])
    outs = tuple(o.reshape(-1)[:B] for o in _outputs(sub, act, ordered))
    return _with_delta(outs, delta, queries, active)


# ----------------------------------------------------------------- attention
def mha_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Reference attention.  q: (..., Sq, d), k/v: (..., Skv, d), with any
    leading batch dims; fp32 scores and sums, output in q's dtype.

    ``window`` masks keys older than ``window`` positions (sliding-window
    attention); q is aligned at the end of the kv sequence.  Rows that see
    no key give 0."""
    Sq, d = q.shape[-2], q.shape[-1]
    Skv = k.shape[-2]
    scale = scale if scale is not None else 1.0 / (d**0.5)
    logits = (q.float() @ k.float().transpose(-1, -2)) * scale
    qpos = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    probs = torch.nan_to_num(probs, nan=0.0)  # fully-masked rows
    return (probs @ v.float()).to(q.dtype)


def flash_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The plain version of K5 (``csrc/flash_attention.cu``): q (BH, Sq, d)
    against k/v (BHkv, Skv, d), each kv row repeated for the ``BH // BHkv``
    q rows that read it, then reference attention per row."""
    group = q.shape[0] // k.shape[0]
    kk = k.repeat_interleave(group, dim=0)
    vv = v.repeat_interleave(group, dim=0)
    return mha_attention_ref(q, kk, vv, causal=causal, window=window, scale=scale)
