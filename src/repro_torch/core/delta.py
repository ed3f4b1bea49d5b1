"""The device-side delta buffer: the live write path.

Pending upserts and tombstones accumulate in a small sorted **delta
buffer** that every read resolves in the same descent as the tree (the
kernels' delta configuration, K2), and a bulk **compaction** merges the
buffer into a fresh perfect snapshot when it crosses a high-water mark.

Entry resolution per query: ``delta-hit > tombstone > tree-hit``.  Each
entry records, at ingest, whether its key exists in the backing snapshot
(``in_tree``) and the key's tree rank; both come out of one ordered descent
over the immutable snapshot.  From those two bits every entry gets a signed
**rank weight**

    w = +1  upsert of a new key        (grows the key set)
    w =  0  upsert of an existing key  (value override only)
    w = -1  tombstone of a stored key  (shrinks the key set)
    w =  0  tombstone of an absent key (kept only to shadow earlier upserts)

and the merged rank of a query is ``tree_rank(q) + sum of the weights of the
entries below q``.  The ordered epilogues select by merged rank
(``select_merged``): the element at merged rank ``j`` is a live buffer
upsert whose own merged rank is ``j``, or a tree key strictly inside one of
the C + 1 gaps between consecutive buffer keys, at tree rank ``j`` minus
that gap's weight prefix.

Everything here is torch on the buffer's device, with fixed shapes, so
ingest, reads and compaction stay on the card.  The one host sync of the
write path is the new key count at compaction (one counted
``runtime.device_fetch``), which fixes the next snapshot's height.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch

from repro_torch import runtime
from repro_torch.core import tree as tree_lib
from repro_torch.core.tree import OrderedResult, TreeData
from repro_torch.kernels import ops as kops

_SENTINEL_KEY = int(tree_lib.SENTINEL_KEY)
_SENTINEL_VALUE = int(tree_lib.SENTINEL_VALUE)
_NO_PRED_KEY = int(tree_lib.NO_PRED_KEY)
_NO_SUCC_KEY = int(tree_lib.NO_SUCC_KEY)

# A snapshot's key count: a host int, or its (1,) or () int32 device tensor
# (``tree.SortedView.count``), which a CUDA graph reads at every replay.
Count = Union[int, torch.Tensor]


class DeltaBuffer(NamedTuple):
    """Fixed-capacity sorted buffer of pending upserts and tombstones.

    keys:      (C,) int32, ascending; SENTINEL_KEY marks empty slots (they
               sort to the tail, like the tree's padding).
    values:    (C,) int32 upsert payloads (ignored for tombstones).
    tombstone: (C,) bool: the entry deletes its key.
    in_tree:   (C,) bool: the key exists in the backing snapshot (fixed at
               ingest; the snapshot is immutable until compaction).
    tree_rank: (C,) int32: the key's rank in the snapshot at ingest.
    count:     () int32: live entries (a device scalar; the engine keeps a
               host-side upper bound so the hot path never reads it).
    """

    keys: torch.Tensor
    values: torch.Tensor
    tombstone: torch.Tensor
    in_tree: torch.Tensor
    tree_rank: torch.Tensor
    count: torch.Tensor

    @property
    def capacity(self) -> int:
        return int(self.keys.shape[0])

    @property
    def device(self) -> torch.device:
        return self.keys.device


def empty(capacity: int, device="cuda") -> DeltaBuffer:
    """A fresh all-sentinel buffer of ``capacity`` slots on ``device``."""
    if capacity < 1:
        raise ValueError("delta capacity must be >= 1")

    def full(v):
        return torch.full((capacity,), v, dtype=torch.int32, device=device)

    return DeltaBuffer(
        keys=full(_SENTINEL_KEY),
        values=full(_SENTINEL_VALUE),
        tombstone=torch.zeros((capacity,), dtype=torch.bool, device=device),
        in_tree=torch.zeros((capacity,), dtype=torch.bool, device=device),
        tree_rank=full(0),
        count=torch.zeros((), dtype=torch.int32, device=device),
    )


def weights(delta: DeltaBuffer) -> torch.Tensor:
    """Per-entry signed rank weight (see the module doc); 0 on empty slots."""
    live = delta.keys != _SENTINEL_KEY
    tomb = delta.tombstone
    w = torch.where(
        delta.in_tree,
        torch.where(tomb, -1, 0),
        torch.where(tomb, 0, 1),
    )
    return torch.where(live, w, 0).to(torch.int32)


def net_keys(delta: DeltaBuffer) -> torch.Tensor:
    """Net change to the stored-key count once the buffer lands (() int32)."""
    return weights(delta).sum(dtype=torch.int32)


def operands(delta: DeltaBuffer) -> Tuple[torch.Tensor, ...]:
    """The four flat int32 operands the kernels take: (keys, values,
    tombstone, weight)."""
    return (
        delta.keys,
        delta.values,
        delta.tombstone.to(torch.int32),
        weights(delta),
    )


# ------------------------------------------------------------------- ingest
def ingest(
    delta: DeltaBuffer,
    new_keys: torch.Tensor,
    new_values: torch.Tensor,
    new_deletes: torch.Tensor,
    new_valid: torch.Tensor,
    new_in_tree: torch.Tensor,
    new_tree_rank: torch.Tensor,
) -> DeltaBuffer:
    """Merge a batch of write ops (submission order, last wins) into the
    buffer, on its device, with fixed shapes.

    A stable sort of ``old entries || batch`` by key puts, for every
    repeated key, the buffer's old entry first and the batch's occurrences
    in submission order, so keeping the LAST occurrence per key is the
    last-write-wins contract.  ``new_valid`` masks padding lanes (their key
    becomes the sentinel and drops).  Kept entries scatter to their slot,
    every dropped one to a sink slot past the end that is then cut off.
    The caller guarantees the merged live count fits the capacity (the
    engine compacts first otherwise).
    """
    C = delta.capacity
    m = int(new_keys.shape[0])
    nk = torch.where(new_valid, new_keys.to(torch.int32), _SENTINEL_KEY)
    keys_cat = torch.cat([delta.keys, nk])
    vals_cat = torch.cat([delta.values, new_values.to(torch.int32)])
    tomb_cat = torch.cat([delta.tombstone, new_deletes.to(torch.bool)])
    intree_cat = torch.cat([delta.in_tree, new_in_tree.to(torch.bool)])
    rank_cat = torch.cat([delta.tree_rank, new_tree_rank.to(torch.int32)])

    order = torch.argsort(keys_cat, stable=True)
    k = keys_cat[order]
    # last occurrence per key wins; sentinels (padding, empty slots) drop
    last = torch.ones_like(k, dtype=torch.bool)
    last[:-1] = k[:-1] != k[1:]
    keep = (k != _SENTINEL_KEY) & last
    keep_i = keep.to(torch.int32)
    sink = C + m
    # cumsum returns int64: the slot index stays int64 (an index), the count
    # is cast back to int32
    pos = torch.where(keep, torch.cumsum(keep_i, 0) - keep_i, sink)

    def place(src, fill):
        out = torch.full((sink + 1,), fill, dtype=src.dtype, device=src.device)
        out[pos] = src[order]
        return out[:C]

    return DeltaBuffer(
        keys=place(keys_cat, _SENTINEL_KEY),
        values=place(vals_cat, _SENTINEL_VALUE),
        tombstone=place(tomb_cat, False),
        in_tree=place(intree_cat, False),
        tree_rank=place(rank_cat, 0),
        count=torch.clamp(keep_i.sum(dtype=torch.int32), max=C),
    )


# ------------------------------------------------------------------ resolve
def resolve_operands(
    delta_ops: Tuple[torch.Tensor, ...],
    queries: torch.Tensor,
    active: torch.Tensor | None = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``resolve`` over the four flat operands (see ``operands``)."""
    return kops.bst_delta_resolve(*delta_ops, queries, active)


def resolve(
    delta: DeltaBuffer, queries: torch.Tensor, active: torch.Tensor | None = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-query buffer search: (hit, dead, value, weight_below).  What the
    kernels compute in the descent when the buffer rides as an operand."""
    return resolve_operands(operands(delta), queries, active)


def merge_lookup(value, found, hit, dead, delta_value):
    """delta-hit > tombstone > tree-hit, membership configuration."""
    return (
        torch.where(hit, torch.where(dead, _SENTINEL_VALUE, delta_value), value),
        torch.where(hit, ~dead, found),
    )


def merge_ordered(
    res: OrderedResult, hit, dead, delta_value, weight_below
) -> OrderedResult:
    """Fold a buffer resolution into a tree ``OrderedResult``: value/found
    resolve ``delta-hit > tombstone > tree-hit`` and the rank gains the
    signed weight of the entries below the query.  pred/succ stay
    tree-local: a tombstone can kill the tree's tracked ancestor, so the
    merged floor/ceiling comes from rank selection (``point_epilogue``)."""
    value, found = merge_lookup(res.value, res.found, hit, dead, delta_value)
    return res._replace(value=value, found=found, rank=res.rank + weight_below)


# ---------------------------------------------------------------- selection
def select_merged(
    sorted_keys: torch.Tensor,
    sorted_values: torch.Tensor,
    n_real: Count,
    delta: DeltaBuffer,
    j: torch.Tensor,
    valid: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The live key/value at merged in-order rank ``j`` (exact).

    Two disjoint cases (see the module doc): a live buffer upsert whose
    merged rank ``tree_rank + exclusive weight prefix`` is ``j``, or a tree
    key strictly inside one of the C + 1 gaps between consecutive buffer
    keys, at tree rank ``j - W_gap``.  Tombstoned and overwritten tree keys
    sit ON gap boundaries, so the strict test excludes them.  ``j`` and
    ``valid`` have any one batch shape; returns (keys, values, ok), with
    ``ok`` False only for masked or out-of-range lanes (their key and value
    are 0).

    ``sorted_keys``/``sorted_values`` is the snapshot's sorted view, of any
    length >= ``n_real`` and sentinel-padded past it (the engine's view is
    the whole perfect tree's); ``n_real`` is its key count, a host int or,
    on a CUDA graph's path, the view's device count (``tree.SortedView``):
    no shape here depends on it.

    The JAX package tests every lane against every entry and every gap,
    which at the serving shapes (8192 ranges x k = 8 lanes x 4097 gaps) is
    hundreds of millions of elements per intermediate.  Here each lane
    binary-searches the one candidate of each case instead, which gives the
    same answers: present entries' merged ranks strictly increase with
    their keys, and so do the gaps' first merged ranks (each the count of
    merged keys at or below the gap's lower bound), so the only entry that
    can hold rank ``j`` is the first whose running maximum reaches ``j``,
    and the only gap that can is the last one starting at or below ``j``.
    Memory is O(lanes + C).
    """
    C = delta.capacity
    n = _count(n_real, sorted_keys.device)
    w = weights(delta)
    live = delta.keys != _SENTINEL_KEY
    present = live & ~delta.tombstone
    w_inc = torch.cumsum(w, 0, dtype=torch.int32)
    entry_rank = delta.tree_rank + (w_inc - w)  # exclusive prefix

    jf = j.reshape(-1).to(torch.int32)
    vf = valid.reshape(-1)

    # case 1: a present entry at merged rank j
    run_max = torch.cummax(torch.where(present, entry_rank, -1), 0).values
    p = torch.clamp(torch.searchsorted(run_max, jf), max=C - 1)
    hit_e = present[p] & (entry_rank[p] == jf) & vf
    d_key = torch.where(hit_e, delta.keys[p], 0)
    d_val = torch.where(hit_e, delta.values[p], 0)

    # case 2: a tree key strictly inside a gap
    zero = torch.zeros((1,), dtype=torch.int32, device=w.device)
    w_gap = torch.cat([zero, w_inc])  # (C+1,) weight prefix per gap
    lo_b = torch.cat([zero + _NO_PRED_KEY, delta.keys])
    hi_b = torch.cat([delta.keys, zero + _SENTINEL_KEY])
    # tree keys at or below each gap's lower bound; every real key is below
    # the sentinel, so over the padded view only an empty slot's bound (the
    # sentinel) counts the padding, and the clamp takes it off
    at_or_below = torch.searchsorted(sorted_keys, lo_b, right=True, out_int32=True)
    tree_at_or_below = torch.minimum(at_or_below, n)
    gap_start = tree_at_or_below + w_gap  # first merged rank inside each gap
    g = torch.clamp(torch.searchsorted(gap_start, jf, right=True) - 1, min=0)
    s = jf - w_gap[g]  # candidate tree rank in that gap
    s_ok = (s >= 0) & (s < n) & vf
    safe = torch.clamp(s, 0, sorted_keys.shape[0] - 1).long()
    t_key = sorted_keys[safe]
    in_gap = s_ok & (t_key > lo_b[g]) & (t_key < hi_b[g])
    t_k = torch.where(in_gap, t_key, 0)
    t_v = torch.where(in_gap, sorted_values[safe], 0)

    ok = hit_e | in_gap
    key = torch.where(hit_e, d_key, t_k)
    val = torch.where(hit_e, d_val, t_v)
    return key.reshape(j.shape), val.reshape(j.shape), ok.reshape(j.shape)


def point_epilogue(
    op: str,
    queries: torch.Tensor,
    res: OrderedResult,
    sorted_keys: torch.Tensor,
    sorted_values: torch.Tensor,
    n_real: Count,
    delta: DeltaBuffer,
):
    """Delta-aware twin of ``plans.point_epilogue`` (same op contract).

    ``res`` carries MERGED found/value/rank (the kernel merged them);
    floor/ceiling resolve by rank selection, exact even when tombstones
    kill the tree's tracked ancestors.  With an empty buffer every branch
    gives the read-only answers.
    """
    if op == "lookup":
        return res.value, res.found
    if op == "predecessor":
        need = ~res.found & (res.rank > 0)
        k, v, sel_ok = select_merged(
            sorted_keys, sorted_values, n_real, delta, res.rank - 1, need
        )
        got = need & sel_ok
        keys = torch.where(res.found, queries, torch.where(got, k, _NO_PRED_KEY))
        values = torch.where(res.found, res.value, torch.where(got, v, _SENTINEL_VALUE))
        return keys, values, res.found | got
    # successor: ceiling(q) = the element at the query's own merged rank.
    total = _count(n_real, sorted_keys.device) + net_keys(delta)
    need = ~res.found & (res.rank < total)
    k, v, sel_ok = select_merged(sorted_keys, sorted_values, n_real, delta, res.rank, need)
    got = need & sel_ok
    keys = torch.where(res.found, queries, torch.where(got, k, _NO_SUCC_KEY))
    values = torch.where(res.found, res.value, torch.where(got, v, _SENTINEL_VALUE))
    return keys, values, res.found | got


def range_epilogue(
    op: str,
    sorted_keys: torch.Tensor,
    sorted_values: torch.Tensor,
    n_real: Count,
    delta: DeltaBuffer,
    r_lo: OrderedResult,
    r_hi: OrderedResult,
    *,
    k: int = 8,
):
    """Delta-aware twin of ``plans.range_epilogue``: counts are
    ``rank_le(hi) - rank_lt(lo)`` over MERGED ranks, and range_scan selects
    consecutive merged ranks through ``select_merged`` (the merged sorted
    view exists only logically until compaction)."""
    counts = torch.clamp(r_hi.rank + r_hi.found.to(torch.int32) - r_lo.rank, min=0)
    if op == "range_count":
        return counts
    take = torch.clamp(counts, max=k)
    steps = torch.arange(k, dtype=torch.int32, device=counts.device)[None, :]
    ranks = r_lo.rank[:, None] + steps
    valid = steps < take[:, None]
    keys, values, _ = select_merged(sorted_keys, sorted_values, n_real, delta, ranks, valid)
    keys = torch.where(valid, keys, _SENTINEL_KEY)
    values = torch.where(valid, values, _SENTINEL_VALUE)
    return keys, values, take


# --------------------------------------------------------------- compaction
def compact_sorted(
    tree_keys: torch.Tensor,
    tree_values: torch.Tensor,
    rank_to_bfs: torch.Tensor,
    n_real: Count,
    delta: DeltaBuffer,
    out_size: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Merge snapshot + buffer into one sorted view on the device: the
    snapshot's sorted view, one gather through ``rank_to_bfs``, then
    ``merge_sorted``.  Returns ``(sorted_keys (out_size,), sorted_values,
    count)`` with sentinel padding past ``count``."""
    idx = rank_to_bfs.long()
    return merge_sorted(tree_keys[idx], tree_values[idx], n_real, delta, out_size)


def merge_sorted(
    sorted_keys: torch.Tensor,
    sorted_values: torch.Tensor,
    n_real: Count,
    delta: DeltaBuffer,
    out_size: int,
    out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Merge a snapshot's sorted view (``n_real`` keys, sentinel-padded past
    them; a host int or the view's device count) with the buffer.

    Rank arithmetic, no sort: surviving old keys shift down by the shadowed
    keys below them and up by the live upserts below them; live buffer
    entries land at their ingest-time tree rank adjusted the same way.
    Each scatter sends its dropped lanes to a sink slot at ``out_size``
    that is cut off.  ``out_size`` must be >= n_real + capacity (the worst
    case); the engine gives ``n_nodes + capacity``, which no key count
    changes.  ``out``, two int32 tensors of ``out_size + 1`` slots, takes
    the scatters in place (a CUDA graph writes into its caller's fixed
    tensors).  Returns the sorted keys and values (``out_size``, sentinel
    past the count) and the count (() int32).
    """
    n = int(sorted_keys.shape[0])
    device = sorted_keys.device

    live = delta.keys != _SENTINEL_KEY
    pres = live & ~delta.tombstone
    # old ranks shadowed by a buffer entry (tombstoned OR overwritten)
    shadow_idx = torch.where(live & delta.in_tree, delta.tree_rank, n).long()
    # a fill kernel: ``shadowed[shadow_idx] = True`` would copy the scalar
    # from the host, which a CUDA graph cannot hold
    shadowed = torch.zeros((n + 1,), dtype=torch.bool, device=device)
    shadowed = shadowed.index_fill_(0, shadow_idx, True)[:n]
    real_old = torch.arange(n, dtype=torch.int32, device=device) < _count(n_real, device)
    keep_old = real_old & ~shadowed

    zero = torch.zeros((1,), dtype=torch.int32, device=device)
    pres_i = pres.to(torch.int32)
    pres_cum = torch.cumsum(pres_i, 0, dtype=torch.int32)
    pres_prefix = torch.cat([zero, pres_cum])
    # live upserts strictly below each old key (old keys never equal a
    # SURVIVING buffer key: equal keys are shadowed)
    pres_below_old = pres_prefix[torch.searchsorted(delta.keys, sorted_keys, out_int32=True).long()]
    keep_i = keep_old.to(torch.int32)
    pos_old = (torch.cumsum(keep_i, 0, dtype=torch.int32) - keep_i) + pres_below_old

    shadow_prefix = torch.cat([zero, torch.cumsum(shadowed.to(torch.int32), 0, dtype=torch.int32)])
    kept_below_entry = delta.tree_rank - shadow_prefix[delta.tree_rank.long()]
    pos_new = kept_below_entry + (pres_cum - pres_i)

    po = torch.where(keep_old, pos_old, out_size).long()
    pn = torch.where(pres, pos_new, out_size).long()

    def scatter(values_old, values_new, fill, dst):
        if dst is None:
            dst = torch.empty((out_size + 1,), dtype=torch.int32, device=device)
        dst.fill_(fill)
        dst[po] = values_old
        dst[pn] = values_new
        return dst[:out_size]

    out_k, out_v = (None, None) if out is None else out
    out_k = scatter(sorted_keys, delta.keys, _SENTINEL_KEY, out_k)
    out_v = scatter(sorted_values, delta.values, _SENTINEL_VALUE, out_v)
    count = keep_i.sum(dtype=torch.int32) + pres_i.sum(dtype=torch.int32)
    return out_k, out_v, count


def compact(tree: TreeData, delta: DeltaBuffer) -> TreeData:
    """Absorb the buffer into a fresh perfect snapshot, eagerly.

    The sorted merge and the Eytzinger re-layout are gathers and scatters on
    the device; the new key count is read back once (a counted
    ``runtime.device_fetch``), since it fixes the new snapshot's height.
    The engine runs the same merge as CUDA graphs into its own tensors
    (``BSTEngine.compact``); this is the route they are held against.
    """
    rank_to_bfs = tree_lib.rank_to_bfs_on(tree.height, tree.device)
    out_size = tree.n_nodes + delta.capacity
    sk, sv, count = compact_sorted(
        tree.keys, tree.values, rank_to_bfs, tree.n_real, delta, out_size
    )
    (n_real,) = runtime.device_fetch((count,))
    n_real = int(n_real)
    if n_real == 0:
        raise ValueError("compaction would empty the tree")
    return tree_lib.layout_from_sorted_device(sk, sv, n_real)


def _count(n_real: Count, device) -> torch.Tensor:
    """A key count as a () int32 tensor: the device count a graph reads as
    it is, a host int (an eager caller's) moved to ``device``."""
    if isinstance(n_real, torch.Tensor):
        return n_real.reshape(()).to(torch.int32)
    return torch.tensor(n_real, dtype=torch.int32, device=device)
