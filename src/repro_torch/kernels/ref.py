"""Plain PyTorch versions of the Hopper kernels in ``csrc/``.

Each BST function repeats its kernel's arithmetic step by step over a level
loop, with a leading batch dimension where the JAX package used ``vmap``;
``queue_dispatch_ref`` is K4's one-hot and cumulative sum; the attention
functions at the end are the JAX package's reference attention
(materialized scores, fp32), with the row log-sum-exp K5 stores for
training, and K5's backward from the same saved tensors.  They are
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


# ------------------------------------------------------ the bodies' phases
# Twins of the phases of ``forest_descend_kernel`` and
# ``hybrid_descend_kernel`` (csrc/forest_search.cu), each repeating the
# kernel's own arithmetic; ``bst_forest_phases_ref`` and
# ``bst_hybrid_phases_ref`` compose them.  The tests hold them against
# ``_dispatch_lanes``, ``bst_ordered_ref``, ``bst_hybrid_ref`` and the JAX
# package's Pallas kernel.
WARP = 32
LEVELS_PER_TRIP = 2  # kLevelsPerTrip: global levels per round trip, both bodies
STAGED_LEVELS = 8  # kStagedLevels: the forest body's staged levels; the hybrid body's least,
HYBRID_MAX_STAGED_LEVELS = 11  # kHybMaxStagedLevels: and its most
DELTA_LINE = 32  # delta slots per sampled line (kLine)
DELTA_SAMPLE_INTS = 4096  # the sample's shared memory, in ints (kSampleInts)
_WARP_SUMS = 32


def hybrid_staged_levels(split_level: int) -> int:
    """Levels the kernel stages in shared memory (``hyb_staged_levels``):
    at least the route's, at most HYBRID_MAX_STAGED_LEVELS."""
    return min(max(STAGED_LEVELS, split_level), HYBRID_MAX_STAGED_LEVELS)


def warp_queue_labels(dest: torch.Tensor, live: torch.Tensor, n_sub: int):
    """The queue labels of (n_chunks, block_q) lanes as the kernel makes
    them: each warp of 32 lanes ranks its live lanes among their
    same-destination peers (``__match_any_sync``; rank = peers below), the
    warps' per-destination counts fill a (warps, n_sub) table, and each
    column is scanned over the warps.  label = prefix + rank on live lanes,
    0 elsewhere: the FIFO exclusive count of ``_dispatch_lanes``."""
    n, block_q = dest.shape
    W = block_q // WARP
    dev = dest.device
    lw = live.reshape(n, W, WARP)
    d = torch.where(lw, dest.reshape(n, W, WARP), -1)
    peers = (d[..., :, None] == d[..., None, :]) & lw[..., None, :]  # (n, W, lane, peer)
    lower = torch.ones(WARP, WARP, dtype=torch.bool, device=dev).tril(-1)  # peer < lane
    rank = (peers & lower).sum(-1, dtype=torch.int32)
    cols = torch.arange(n_sub, device=dev)
    table = ((d[..., None] == cols) & lw[..., None]).sum(2, dtype=torch.int32)  # (n, W, n_sub)
    prefix = torch.cumsum(table, 1, dtype=torch.int32) - table
    own = prefix.gather(2, d.clamp(min=0).long())
    return torch.where(lw, own + rank, 0).reshape(n, block_q)


def _walk_state(shape, device) -> List[torch.Tensor]:
    """(idx, found, hit, pred_key, pred_node, succ_key, succ_node, rank):
    the kernel's Walk, nodes by index (-1: none)."""

    def full(v, dtype=torch.int64):
        return torch.full(shape, int(v), dtype=dtype, device=device)

    return [full(0), torch.zeros(shape, dtype=torch.bool, device=device), full(-1),
            full(NO_PRED_KEY, torch.int32), full(-1), full(NO_SUCC_KEY, torch.int32), full(-1),
            full(0, torch.int32)]


def _walk_step(state, q, gate, nk, node, level, height, ordered):
    """One compare of the lanes in ``gate`` that have not hit, at ``node``
    of ``level`` with key ``nk``; returns the new state and the right turns."""
    idx, found, hit_node, pk, pn, sk, sn, rank = state
    live = gate & ~found
    hit = live & (nk == q)
    right = live & ~hit & (q > nk)
    if ordered:
        left_turn = live & ~hit & ~right
        size = (1 << (height - level)) - 1
        rank = rank + hit.int() * size + right.int() * (size + 1)
        pk, pn = torch.where(right, nk, pk), torch.where(right, node, pn)
        sk, sn = torch.where(left_turn, nk, sk), torch.where(left_turn, node, sn)
    hit_node = torch.where(hit, node, hit_node)
    idx = torch.where(live & ~hit, 2 * node + 1 + right.long(), idx)
    return [idx, found | hit, hit_node, pk, pn, sk, sn, rank], right


def walk_levels_ref(keys, queries, gate, state, height, l0, l1, staged, ordered):
    """Levels ``[l0, l1)`` of the flat tree ``keys`` (n,) for the lanes in
    ``gate``, as the kernel walks them: levels below ``staged`` one at a
    time, deeper ones LEVELS_PER_TRIP per round trip (fewer in a
    last group that reaches ``l1``) -- the 2^g - 1 keys under a
    lane's node (depth j: ``(idx + 1) 2^j - 1 + m``, m < 2^j) gathered at
    once, then resolved level by level, picking each level's key by the
    path ``m`` taken so far.  Nodes by index; no value is read."""
    n = keys.shape[0]
    l = l0
    while l < min(l1, staged):
        node = state[0]
        nk = keys[node.clamp(0, n - 1)]
        state, _ = _walk_step(state, queries, gate, nk, node, l, height, ordered)
        l += 1
    l = max(l, staged)
    while l < l1:
        g = min(LEVELS_PER_TRIP, l1 - l)
        i1 = state[0] + 1
        runs = [((i1 << j) - 1)[..., None] + torch.arange(1 << j, device=keys.device)
                for j in range(g)]
        kk = keys[torch.cat(runs, -1).clamp(0, n - 1)]  # the round trip: (..., 2^g - 1)
        m = torch.zeros_like(i1)
        for j in range(g):
            nk = kk.gather(-1, ((1 << j) - 1 + m)[..., None])[..., 0]
            node = (i1 << j) - 1 + m
            state, right = _walk_step(state, queries, gate, nk, node, l + j, height, ordered)
            m = 2 * m + right.long()
        l += g
    return state


def gather_values_ref(values, state, active, ordered):
    """The end of the descent: one gather of the values a result needs (the
    hit's; ordered, the last right and left turns'), into the kernel's
    outputs."""
    _, found, hit_node, pk, pn, sk, sn, rank = state

    def at(node):
        return torch.where(node >= 0, values[node.clamp(min=0)], SENTINEL_VALUE)

    found = found & active
    val = torch.where(found, at(hit_node), SENTINEL_VALUE)
    if not ordered:
        return val, found
    return val, found, pk, at(pn), sk, at(sn), rank


def delta_line(capacity: int, ordered: bool) -> int:
    """Delta slots per sampled line: the smallest 32 x 2^e whose sample
    fits the kernels' DELTA_SAMPLE_INTS (``delta_line_of``)."""
    line = DELTA_LINE
    while True:
        n_lines = -(-capacity // line)
        if (2 * n_lines + 1 + _WARP_SUMS if ordered else n_lines) <= DELTA_SAMPLE_INTS:
            return line
        line *= 2


def delta_line_probe_ref(
    delta_keys, delta_values, delta_tombstone, delta_weight, queries, active=None,
    line: int = DELTA_LINE,
):
    """Both kernels' delta resolution, per query ``(hit, dead, value,
    weight_below)`` as ``bst_delta_resolve_ref`` gives it: the sample (the
    first key of each ``line`` slots) places q after the sampled lines
    whose first key is below it; one line of keys (and weights) then counts
    the slots below q, pos; ``keys[pos] == q`` is a hit; weight_below is the
    weight of the lines before plus the line's slots below q."""
    C = delta_keys.shape[0]
    n_lines = -(-C // line)
    q = queries.reshape(-1)
    starts = torch.arange(n_lines, device=q.device) * line
    sample = delta_keys[starts]
    line_w = torch.zeros(n_lines * line, dtype=torch.int32, device=q.device)
    line_w[:C] = delta_weight
    line_w = line_w.reshape(n_lines, line).sum(1, dtype=torch.int32)
    line_pre = torch.cumsum(line_w, 0, dtype=torch.int32) - line_w
    lo = (sample[None, :] < q[:, None]).sum(1)  # sampled lines whose first key < q
    begin = (lo - 1).clamp(min=0) * line
    slots = begin[:, None] + torch.arange(line, device=q.device)
    inside = (slots < C) & (lo[:, None] > 0)
    kl = delta_keys[slots.clamp(max=C - 1)]
    below = inside & (kl < q[:, None])
    pos = begin + below.sum(1)
    end = torch.clamp(begin + line, max=C)
    nxt = sample[lo.clamp(max=n_lines - 1)]
    eq = (inside & (kl == q[:, None])).any(1)
    hit = torch.where(lo == 0, sample[0] == q,
                      eq | ((pos == end) & (lo < n_lines) & (nxt == q)))
    wsum = torch.where(below, delta_weight[slots.clamp(max=C - 1)], 0).sum(1, dtype=torch.int32)
    wbelow = torch.where(lo == 0, 0, line_pre[(lo - 1).clamp(min=0)] + wsum)
    at = pos.clamp(max=C - 1)
    dead = hit & (delta_tombstone[at] != 0)
    value = torch.where(hit, delta_values[at], 0)
    hit, dead, value, wbelow = (t.reshape(queries.shape) for t in (hit, dead, value, wbelow))
    if active is not None:
        hit = hit & active
        wbelow = torch.where(active, wbelow, 0)
    return hit, dead, value, wbelow


def bst_forest_phases_ref(
    forest_keys: torch.Tensor,
    forest_values: torch.Tensor,
    queries: torch.Tensor,
    height: int,
    active: Optional[torch.Tensor] = None,
    ordered: bool = True,
    delta: Optional[DeltaOperands] = None,
) -> Tuple[torch.Tensor, ...]:
    """``bst_ordered_ref``'s function through the forest kernel's own
    phases, one tree row at a time (row 0 for every query row when R is 1):
    the top ``min(STAGED_LEVELS, height + 1)`` levels one at a time, the
    rest LEVELS_PER_TRIP per round trip (``walk_levels_ref``), one gather
    of the values (``gather_values_ref``), and the delta buffer through its
    sample (``delta_line_probe_ref``).  Must equal ``bst_ordered_ref`` bit
    for bit."""
    active = _active(queries, active)
    R = forest_keys.shape[0]
    staged = min(STAGED_LEVELS, height + 1)
    rows = []
    for t in range(queries.shape[0]):
        r = t if R > 1 else 0
        state = _walk_state(queries[t].shape, queries.device)
        state = walk_levels_ref(forest_keys[r], queries[t], active[t], state, height, 0,
                                height + 1, staged, ordered)
        rows.append(gather_values_ref(forest_values[r], state, active[t], ordered))
    outs = tuple(torch.stack(o) for o in zip(*rows))
    if delta is None:
        return outs
    line = delta_line(delta[0].shape[0], ordered)
    return merge_delta_resolution(outs, *delta_line_probe_ref(*delta, queries, active, line))


def bst_hybrid_phases_ref(
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
    """``bst_hybrid_ref``'s function through the kernel's own phases: the
    route through ``[0, split_level)`` (``walk_levels_ref``), the warp
    labels (``warp_queue_labels``) or the direct clash, the descent of
    ``[split_level, H]`` for every active lane in one pass (an overflow
    lane's replay from the route state reads nothing another lane writes),
    one gather of the values, and the delta buffer through its sample
    (``delta_line_probe_ref``).  Must equal ``bst_hybrid_ref`` bit for
    bit."""
    B = queries.shape[0]
    active = _active(queries, active)
    pad = (-B) % block_q
    q = torch.cat([queries, queries.new_zeros(pad)]).reshape(-1, block_q)
    act = torch.cat([active, active.new_zeros(pad)]).reshape(-1, block_q)
    n_sub = 1 << split_level
    staged = min(hybrid_staged_levels(split_level), height + 1)
    state = _walk_state(q.shape, q.device)
    state = walk_levels_ref(tree_keys, q, act, state, height, 0, split_level, staged, ordered)
    live = act & ~state[1]
    dest = torch.clamp(state[0] - (n_sub - 1), 0, n_sub - 1)
    if mapping == "queue":
        overflow = live & (warp_queue_labels(dest, live, n_sub) >= capacity)
    else:
        overflow = _dispatch_lanes(dest, live, mapping, n_sub, capacity)[1]
    state = walk_levels_ref(tree_keys, q, act, state, height, split_level, height + 1,
                            staged, ordered)
    if overflow_out is not None:
        overflow_out.copy_(overflow.reshape(-1)[:B])
    outs = tuple(o.reshape(-1)[:B] for o in gather_values_ref(tree_values, state, act, ordered))
    if delta is None:
        return outs
    line = delta_line(delta[0].shape[0], ordered)
    return merge_delta_resolution(outs, *delta_line_probe_ref(*delta, queries, active, line))


# ------------------------------------------------------------ queue dispatch
def queue_dispatch_ref(
    dest: torch.Tensor, n_dest: int, capacity: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of K4 (``csrc/queue_dispatch.cu``): the JAX
    package's queue dispatch plan (``repro.core.buffers.queue_dispatch``,
    whose buffers, counts and overflow are its ``queue_dispatch_ref``'s),
    ``(slot (…, B) int32, kept (…, B) bool, buffers (…, n_dest, capacity)
    int32, counts (…, n_dest) int32, overflow (…, B) bool)`` for ``dest``
    (B,) or (G, B).

    A one-hot over the destinations, its exclusive cumulative sum over the
    lanes (each lane's FIFO label), and a scatter of the kept lanes' indices
    into the buffer image, with a sink slot for the rest; buffers hold
    source indices, -1 for an empty slot, and slot is the label of a kept
    lane, else -1.  A negative dest marks an inactive lane; a dest >= n_dest
    counts as n_dest - 1, as the kernel and the Pallas kernel clip it."""
    rows = dest if dest.ndim == 2 else dest[None]
    G, B = rows.shape
    dev = dest.device
    active = rows >= 0
    d = rows.clamp(max=n_dest - 1)
    iota = torch.arange(n_dest, dtype=torch.int32, device=dev)
    onehot = ((d[..., None] == iota) & active[..., None]).to(torch.int32)  # (G, B, n_dest)
    label = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
    label = label.gather(2, d.clamp(min=0).long()[..., None])[..., 0]
    kept = active & (label < capacity)
    slot = torch.where(kept, label, -1)
    sink = n_dest * capacity
    lin = torch.where(kept, d * capacity + label, sink).long()
    flat = torch.full((G, sink + 1), -1, dtype=torch.int32, device=dev)
    flat.scatter_(1, lin, torch.arange(B, dtype=torch.int32, device=dev).expand(G, B))
    buffers = flat[:, :sink].reshape(G, n_dest, capacity)
    counts = onehot.sum(dim=1, dtype=torch.int32).clamp(max=capacity)
    overflow = active & ~kept
    plan = (slot, kept, buffers, counts, overflow)
    return plan if dest.ndim == 2 else tuple(t[0] for t in plan)


# ----------------------------------------------------------------- attention
def _visible(Sq: int, Skv: int, causal: bool, window: Optional[int], device) -> torch.Tensor:
    """(Sq, Skv) bool: which keys each q row sees, q aligned at the end of kv."""
    qpos = torch.arange(Sq, device=device)[:, None] + (Skv - Sq)
    kpos = torch.arange(Skv, device=device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def _compute_dtype(q: torch.Tensor) -> torch.dtype:
    """fp32 for fp32 and bf16 operands (the kernels' sums), fp64 for fp64 ones
    (``gradcheck``)."""
    return torch.promote_types(q.dtype, torch.float32)


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
    return _attention(q, k, v, causal, window, scale, with_lse=False)


def _attention(q, k, v, causal, window, scale, with_lse: bool):
    Sq, d = q.shape[-2], q.shape[-1]
    Skv = k.shape[-2]
    cdt = _compute_dtype(q)
    scale = scale if scale is not None else 1.0 / (d**0.5)
    logits = (q.to(cdt) @ k.to(cdt).transpose(-1, -2)) * scale
    logits = logits.masked_fill(~_visible(Sq, Skv, causal, window, q.device), float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    probs = torch.nan_to_num(probs, nan=0.0)  # fully-masked rows
    out = (probs @ v.to(cdt)).to(q.dtype)
    return (out, torch.logsumexp(logits, dim=-1)) if with_lse else out


def _repeat_kv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """k and v (BHkv, Skv, d) with each row repeated for the ``BH // BHkv``
    q rows that read it."""
    group = q.shape[0] // k.shape[0]
    return k.repeat_interleave(group, dim=0), v.repeat_interleave(group, dim=0)


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
    return mha_attention_ref(q, *_repeat_kv(q, k, v), causal=causal, window=window, scale=scale)


def flash_attention_lse_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5 with its ``lse`` output: ``(out, lse)``, ``out`` as
    ``flash_attention_ref``'s and lse (BH, Sq) the log-sum-exp of each
    row's visible scaled scores, -inf for a row that sees none; fp32 (fp64
    for fp64 operands)."""
    return _attention(q, *_repeat_kv(q, k, v), causal, window, scale, with_lse=True)


BWD_REF_BLOCK_Q = 128  # q rows a step of flash_attention_bwd_ref
LOG2E = 1.4426950408889634


def flash_attention_bwd_pre_ref(out: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor,
                                dq_acc: torch.Tensor, delta: torch.Tensor,
                                sems: torch.Tensor) -> None:
    """The plain version of the backward's pre-pass (``flash_bwd_pre_kernel``
    in fp32, ``flash_bwd_pre_bf16_kernel`` in bf16) on a launch's rows of the
    wrapper's scratch (``flash_attention.bwd_scratch``): ``dq_acc`` (its
    padding rows too) and dQ's semaphores ``sems`` zeroed, and ``delta``, read as its flat 2 BH Sq64
    values, given delta = rowsum(dout o out) (fp32: the first BH Sq values;
    bf16: every head row padded to Sq64 = ``delta.shape[1] // 2`` rows, then
    each row's lse term -lse log2 e, -inf for a row that sees no key and for
    the padding)."""
    BH, Sq, _ = out.shape
    flat = delta.view(-1)
    rows = (dout.float() * out.float()).sum(dim=-1)
    if out.dtype == torch.float32:
        flat[:BH * Sq] = rows.reshape(-1)
    else:
        pad = delta.shape[1] // 2 - Sq
        term = torch.where(torch.isneginf(lse), lse, -lse * LOG2E)
        flat.copy_(torch.cat([torch.nn.functional.pad(rows, (0, pad)).reshape(-1),
                              torch.nn.functional.pad(term, (0, pad),
                                                      value=float("-inf")).reshape(-1)]))
    dq_acc.zero_()
    sems.zero_()


def flash_attention_bwd_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    dout: torch.Tensor,
    lse: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of K5's backward: ``(dq, dk, dv)`` in the operands'
    dtypes from the forward's operands, its output, the output's gradient
    and its lse, as the kernel computes them: delta = rowsum(dout * out),
    then per block of BWD_REF_BLOCK_Q q rows P = exp(scale S - lse) (0 where
    masked), dS = scale P (dout V^T - delta), dV += P^T dout, dK += dS^T Q,
    dQ = dS K, and dk, dv summed over each kv row's GQA group.  fp32 sums
    (fp64 for fp64 operands)."""
    BH, Sq, d = q.shape
    BHkv, Skv, _ = k.shape
    group = BH // BHkv
    cdt = _compute_dtype(q)
    scale = scale if scale is not None else 1.0 / (d**0.5)
    qf, dof = q.to(cdt), dout.to(cdt)
    kk, vv = (t.to(cdt) for t in _repeat_kv(q, k, v))
    delta = (dof * out.to(cdt)).sum(dim=-1)  # (BH, Sq)
    visible = _visible(Sq, Skv, causal, window, q.device)
    dq = torch.empty((BH, Sq, d), dtype=cdt, device=q.device)
    dkk = torch.zeros((BH, Skv, d), dtype=cdt, device=q.device)
    dvv = torch.zeros((BH, Skv, d), dtype=cdt, device=q.device)
    for i0 in range(0, Sq, BWD_REF_BLOCK_Q):
        rows = slice(i0, i0 + BWD_REF_BLOCK_Q)
        s = (qf[:, rows] @ kk.transpose(-1, -2)) * scale
        p = torch.exp(s - lse[:, rows, None].to(cdt))
        p = torch.where(visible[rows], p, torch.zeros((), dtype=cdt, device=q.device))
        dp = dof[:, rows] @ vv.transpose(-1, -2)
        ds = p * (dp - delta[:, rows, None]) * scale
        dvv += p.transpose(-1, -2) @ dof[:, rows]
        dkk += ds.transpose(-1, -2) @ qf[:, rows]
        dq[:, rows] = ds @ kk
    dk = dkk.view(BHkv, group, Skv, d).sum(dim=1)
    dv = dvv.view(BHkv, group, Skv, d).sum(dim=1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
