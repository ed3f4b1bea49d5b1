"""Complete-BST construction and level-major (Eytzinger/BFS) layout.

The paper stores the 32-bit keys and values of a complete binary tree level
by level in separate BRAM partitions.  The BFS (Eytzinger) layout is the
software analogue: node ``i``'s children are ``2i+1`` / ``2i+2`` and level
``l`` occupies the contiguous slice ``[2^l - 1, 2^{l+1} - 1)``, so each
descent step touches one contiguous region.  Trees are *perfect*
(``n = 2^{H+1} - 1`` nodes); sorted inputs are padded with a +inf sentinel.

The layout is built with numpy on the host and moved to the engine's device
once (``build_tree`` / ``tree_from_numpy``); a compaction re-lays a sorted
view out on the device itself (``layout_from_sorted_device``), into the
write-path engine's own tensors where the height holds (``Snapshot``,
``write_sorted_``).  Every tensor stays int32.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

# Sentinel key for padding to a perfect tree: int32 max keeps compare
# semantics intact for any real int32 key strictly below it.
SENTINEL_KEY = np.int32(np.iinfo(np.int32).max)
SENTINEL_VALUE = np.int32(-1)

# Ordered-query sentinels: "no predecessor" is the identity of the
# max-tracked right-turn ancestor (int32 min), "no successor" the identity of
# the min-tracked left-turn ancestor (int32 max, which is SENTINEL_KEY).
NO_PRED_KEY = np.int32(np.iinfo(np.int32).min)
NO_SUCC_KEY = SENTINEL_KEY


class OrderedResult(NamedTuple):
    """Per-query outputs of one ordered compare-descend pass.

    value/found: the exact-match payload (SENTINEL_VALUE when absent).
    pred_key/pred_value: deepest right-turn ancestor == largest stored key
        strictly below the query (NO_PRED_KEY/SENTINEL_VALUE when none).
    succ_key/succ_value: deepest left-turn ancestor == smallest stored key
        strictly above the query (NO_SUCC_KEY/SENTINEL_VALUE when none).
    rank: number of stored keys strictly below the query.
    """

    value: torch.Tensor
    found: torch.Tensor
    pred_key: torch.Tensor
    pred_value: torch.Tensor
    succ_key: torch.Tensor
    succ_value: torch.Tensor
    rank: torch.Tensor


def level_offset(level: int) -> int:
    """First BFS index of ``level`` (the start of its "BRAM partition")."""
    return (1 << level) - 1


def level_size(level: int) -> int:
    return 1 << level


def height_for(n_keys: int) -> int:
    """Height H of the smallest perfect tree holding ``n_keys`` nodes."""
    h = 0
    while ((1 << (h + 1)) - 1) < n_keys:
        h += 1
    return h


@dataclasses.dataclass(frozen=True)
class TreeData:
    """A perfect BST in BFS layout.

    keys/values: (n,) int32 tensors, n = 2^{height+1} - 1, BFS order, all on
    one device.  n_real: number of non-sentinel entries.
    """

    keys: torch.Tensor
    values: torch.Tensor
    height: int
    n_real: int

    @property
    def n_nodes(self) -> int:
        return int(self.keys.shape[0])

    @property
    def device(self) -> torch.device:
        return self.keys.device

    def subtree(self, split_level: int, index: int) -> "TreeData":
        """Vertical partition: the ``index``-th subtree rooted at ``split_level``
        (a host-side build step; it reads the sentinel count back)."""
        idx = torch.from_numpy(
            subtree_gather_indices(self.height, split_level, index)
        ).to(self.device)
        keys = self.keys[idx]
        return TreeData(
            keys=keys,
            values=self.values[idx],
            height=self.height - split_level,
            n_real=int((keys != int(SENTINEL_KEY)).sum()),
        )


def subtree_gather_indices(height: int, split_level: int, index: int) -> np.ndarray:
    """Global BFS indices of subtree ``index`` rooted at ``split_level``."""
    out = []
    for l_local in range(height - split_level + 1):
        l = split_level + l_local
        p = index * (1 << l_local) + np.arange(1 << l_local)
        out.append(level_offset(l) + p)
    return np.concatenate(out)


def all_subtree_gather_indices(height: int, split_level: int) -> np.ndarray:
    """(n_subtrees, subtree_nodes) gather map for every vertical partition."""
    n_sub = 1 << split_level
    return np.stack(
        [subtree_gather_indices(height, split_level, s) for s in range(n_sub)]
    )


def eytzinger_from_sorted(
    sorted_keys: np.ndarray, sorted_values: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """Lay out sorted key/value pairs as a perfect BFS tree (vectorized).

    For a perfect tree of height H, the node at level ``l`` offset ``p`` has
    in-order rank ``(2p + 1) * 2^{H-l} - 1``; inverting that map assigns each
    sorted element its BFS slot without recursion.
    """
    sorted_keys = np.asarray(sorted_keys)
    sorted_values = np.asarray(sorted_values)
    if sorted_keys.ndim != 1 or sorted_keys.shape != sorted_values.shape:
        raise ValueError("keys/values must be equal-length 1-D arrays")
    if sorted_keys.size == 0:
        raise ValueError("empty tree")
    if not np.all(sorted_keys[:-1] < sorted_keys[1:]):
        raise ValueError("keys must be strictly increasing")

    n_real = sorted_keys.size
    H = height_for(n_real)
    n = (1 << (H + 1)) - 1

    padded_keys = np.full(n, SENTINEL_KEY, dtype=np.int32)
    padded_vals = np.full(n, SENTINEL_VALUE, dtype=np.int32)
    padded_keys[:n_real] = sorted_keys.astype(np.int32)
    padded_vals[:n_real] = sorted_values.astype(np.int32)

    bfs_keys = np.empty(n, dtype=np.int32)
    bfs_vals = np.empty(n, dtype=np.int32)
    for l in range(H + 1):
        p = np.arange(1 << l)
        rank = (2 * p + 1) * (1 << (H - l)) - 1
        o = level_offset(l)
        bfs_keys[o : o + (1 << l)] = padded_keys[rank]
        bfs_vals[o : o + (1 << l)] = padded_vals[rank]
    return bfs_keys, bfs_vals, H, n_real


def tree_from_numpy(
    keys_bfs: np.ndarray,
    values_bfs: np.ndarray,
    height: int,
    n_real: int,
    device="cuda",
) -> TreeData:
    """A TreeData from host BFS arrays (for example the JAX package's
    snapshot taken as numpy), moved to ``device`` once.  The arrays are
    copied: the tensors never alias the caller's (possibly read-only)
    buffers."""
    keys = np.array(keys_bfs, dtype=np.int32)
    values = np.array(values_bfs, dtype=np.int32)
    if keys.ndim != 1 or keys.shape != values.shape:
        raise ValueError("keys/values must be equal-length 1-D arrays")
    if keys.shape[0] != (1 << (height + 1)) - 1:
        raise ValueError(f"{keys.shape[0]} nodes is not a perfect tree of height {height}")
    return TreeData(
        keys=torch.from_numpy(keys).to(device),
        values=torch.from_numpy(values).to(device),
        height=int(height),
        n_real=int(n_real),
    )


def build_tree(keys: np.ndarray, values: np.ndarray, device="cuda") -> TreeData:
    """Build a TreeData from (unsorted) unique keys + values on the host and
    move it to ``device``."""
    keys = np.asarray(keys, dtype=np.int32)
    values = np.asarray(values, dtype=np.int32)
    order = np.argsort(keys, kind="stable")
    k, v, h, n_real = eytzinger_from_sorted(keys[order], values[order])
    return tree_from_numpy(k, v, h, n_real, device)


def left_subtree_sizes(height: int) -> np.ndarray:
    """Per-level left-subtree size ``2^{H-l} - 1`` of a height-``H`` tree:
    a right turn at level ``l`` skips the node plus that whole subtree."""
    levels = np.arange(height + 1)
    return ((1 << (height - levels)) - 1).astype(np.int32)


@functools.lru_cache(maxsize=None)
def rank_to_bfs_indices(height: int) -> np.ndarray:
    """BFS index of every in-order rank (the sorted view of the layout).

    Inverts ``rank = (2p + 1) * 2^{H-l} - 1``: with ``t = rank + 1``, the
    number of trailing zero bits of ``t`` is ``H - l`` and the remaining odd
    factor is ``2p + 1``.  Memoized per height; callers treat the array as
    read-only.
    """
    n = (1 << (height + 1)) - 1
    t = np.arange(1, n + 1, dtype=np.int64)
    z = np.log2(t & -t).astype(np.int64)  # trailing zeros, exact for 2^k
    level = height - z
    offset = ((t >> z) - 1) >> 1
    return (((1 << level) - 1) + offset).astype(np.int32)


@functools.lru_cache(maxsize=None)
def bfs_inorder_ranks(height: int) -> np.ndarray:
    """In-order rank of every BFS index (inverse of ``rank_to_bfs_indices``).
    Memoized per height like its inverse (read-only contract)."""
    n = (1 << (height + 1)) - 1
    out = np.empty(n, dtype=np.int32)
    for l in range(height + 1):
        p = np.arange(1 << l)
        o = level_offset(l)
        out[o : o + (1 << l)] = (2 * p + 1) * (1 << (height - l)) - 1
    return out


@functools.lru_cache(maxsize=8)
def rank_to_bfs_on(height: int, device: torch.device) -> torch.Tensor:
    """``rank_to_bfs_indices(height)`` as an int32 tensor on ``device``,
    memoized like the host map (read-only contract): a new plan or a
    compaction reuses it instead of copying it to the device again."""
    return torch.from_numpy(rank_to_bfs_indices(height)).to(device)


@functools.lru_cache(maxsize=8)
def bfs_inorder_ranks_on(height: int, device: torch.device) -> torch.Tensor:
    """``bfs_inorder_ranks(height)`` as an int32 tensor on ``device``
    (memoized, read-only)."""
    return torch.from_numpy(bfs_inorder_ranks(height)).to(device)


def layout_from_sorted_device(
    sorted_keys: torch.Tensor, sorted_values: torch.Tensor, n_real: int
) -> TreeData:
    """A TreeData from a sorted view on the device, in one gather.

    ``sorted_keys/values`` hold ``n_real`` real pairs in ascending key order
    followed by sentinel padding (any length >= n_real).  The perfect tree's
    height follows from ``n_real`` (a host int: the one scalar a compaction
    reads back); the BFS image is a single gather through
    ``bfs_inorder_ranks`` on the tensors' device, so the arrays stay there.
    """
    if n_real < 1:
        raise ValueError("empty tree")
    h = height_for(n_real)
    sorted_keys, sorted_values = _padded(sorted_keys, sorted_values, (1 << (h + 1)) - 1)
    ranks = bfs_inorder_ranks_on(h, sorted_keys.device)
    return TreeData(keys=sorted_keys[ranks], values=sorted_values[ranks], height=h, n_real=n_real)


class SortedView(NamedTuple):
    """A snapshot's in-order view: ``keys``/``values`` (n,) int32, the
    ``count`` real pairs ascending and sentinel padding after them, and
    ``count``, a (1,) int32 tensor on the same device.  The delta
    epilogues read the count from the device, so that a CUDA graph that
    reads the view answers for whatever snapshot the tensors hold."""

    keys: torch.Tensor
    values: torch.Tensor
    count: torch.Tensor


def sorted_view_of(tree: TreeData) -> SortedView:
    """A fresh sorted view of ``tree``: one gather through ``rank_to_bfs``
    (the BFS layout pads its in-order tail with sentinels)."""
    idx = rank_to_bfs_on(tree.height, tree.device).long()
    count = torch.full((1,), tree.n_real, dtype=torch.int32, device=tree.device)
    return SortedView(tree.keys[idx], tree.values[idx], count)


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """The tensors of a write-path engine's snapshot, at fixed addresses
    for as long as its height holds: the BFS image (``keys``, ``values``),
    its sorted ``view`` (the key count on the device) and the height.  A
    compaction that keeps the height writes the new snapshot into these
    tensors (``write_sorted_``), so every CUDA graph that reads them stays
    valid; one that changes the height makes a new set
    (``snapshot_from_sorted``)."""

    keys: torch.Tensor
    values: torch.Tensor
    view: SortedView
    height: int

    @property
    def n_nodes(self) -> int:
        return int(self.keys.shape[0])

    def tree(self, n_real: int) -> TreeData:
        """The snapshot as a TreeData over the same tensors (``n_real`` is
        the host's copy of the count, from the compaction's one fetch)."""
        return TreeData(self.keys, self.values, self.height, n_real)


def snapshot_of(tree: TreeData) -> Snapshot:
    """A snapshot set holding a copy of ``tree`` (its owner writes into it
    in place, so it never aliases the caller's tensors)."""
    keys, values = tree.keys.clone(), tree.values.clone()
    view = sorted_view_of(TreeData(keys, values, tree.height, tree.n_real))
    return Snapshot(keys, values, view, tree.height)


def snapshot_from_sorted(
    sorted_keys: torch.Tensor, sorted_values: torch.Tensor, count: torch.Tensor, n_real: int
) -> Snapshot:
    """A new snapshot set of the height that ``n_real`` keys need, laid out
    from a sorted view on the device (``count`` is ``n_real`` there).  The
    view is cut or sentinel-padded to the new size, as in
    ``layout_from_sorted_device``."""
    if n_real < 1:
        raise ValueError("empty tree")
    h = height_for(n_real)
    n = (1 << (h + 1)) - 1
    keys, values = _padded(sorted_keys, sorted_values, n)
    if n <= int(sorted_keys.shape[0]):  # a cut of the caller's tensors: copy it
        keys, values = keys.clone(), values.clone()
    ranks = bfs_inorder_ranks_on(h, keys.device)
    view = SortedView(keys, values, count.reshape(1).to(torch.int32).clone())
    return Snapshot(keys[ranks], values[ranks], view, h)


def write_sorted_(
    snap: Snapshot, sorted_keys: torch.Tensor, sorted_values: torch.Tensor, count: torch.Tensor
) -> None:
    """Lay a sorted view of at most ``snap.n_nodes`` keys (sentinel-padded,
    any length >= ``snap.n_nodes``) into ``snap``'s own tensors: its view,
    its BFS image (one gather through ``bfs_inorder_ranks``, the same as
    ``layout_from_sorted_device``'s) and its device count.  Every write is
    in place and reads no host value, so a CUDA graph can hold it."""
    n = snap.n_nodes
    snap.view.keys.copy_(sorted_keys[:n])
    snap.view.values.copy_(sorted_values[:n])
    ranks = bfs_inorder_ranks_on(snap.height, snap.keys.device)
    torch.index_select(snap.view.keys, 0, ranks, out=snap.keys)
    torch.index_select(snap.view.values, 0, ranks, out=snap.values)
    snap.view.count.copy_(count.reshape(1))


def _padded(sorted_keys: torch.Tensor, sorted_values: torch.Tensor, n: int):
    """The first ``n`` slots of a sorted view, sentinel-padded where it is
    shorter."""
    pad = n - int(sorted_keys.shape[0])
    if pad > 0:
        sorted_keys = torch.cat([sorted_keys, sorted_keys.new_full((pad,), int(SENTINEL_KEY))])
        sorted_values = torch.cat(
            [sorted_values, sorted_values.new_full((pad,), int(SENTINEL_VALUE))]
        )
    return sorted_keys[:n], sorted_values[:n]


def init_ordered(B: int, device) -> OrderedResult:
    """The ordered descent's identity state (also the inactive-lane output)."""

    def full(v):
        return torch.full((B,), int(v), dtype=torch.int32, device=device)

    return OrderedResult(
        value=full(SENTINEL_VALUE),
        found=torch.zeros((B,), dtype=torch.bool, device=device),
        pred_key=full(NO_PRED_KEY),
        pred_value=full(SENTINEL_VALUE),
        succ_key=full(NO_SUCC_KEY),
        succ_value=full(SENTINEL_VALUE),
        rank=torch.zeros((B,), dtype=torch.int32, device=device),
    )


def _ordered_step(keys, values, queries, active, idx, r, left: int, idx_clamp):
    """One ordered compare-descend step over BFS-layout operands: the single
    implementation behind both tree-level descents (the full reference and
    the register-layer route; ``kernels/ref.py`` keeps its own twin of the
    kernels' phases).  ``left`` is the level's left-subtree size.
    ``idx_clamp`` bounds the child index for full-tree descents; the
    register route leaves it None, because its final index must step past
    the register block to name the subtree.  Returns ``(idx, r)``."""
    nk = keys[idx]
    nv = values[idx]
    live = ~r.found if active is None else active & ~r.found
    hit = (nk == queries) & live
    go_right = live & ~hit & (queries > nk)
    go_left = live & ~hit & (queries < nk)
    r = OrderedResult(
        value=torch.where(hit, nv, r.value),
        found=r.found | hit,
        pred_key=torch.where(go_right, nk, r.pred_key),
        pred_value=torch.where(go_right, nv, r.pred_value),
        succ_key=torch.where(go_left, nk, r.succ_key),
        succ_value=torch.where(go_left, nv, r.succ_value),
        rank=r.rank + go_right.int() * (left + 1) + hit.int() * left,
    )
    nxt = 2 * idx + 1 + go_right.long()
    if idx_clamp is not None:
        nxt = torch.clamp(nxt, max=idx_clamp)
    frozen = r.found if active is None else r.found | ~active
    return torch.where(frozen, idx, nxt), r


def search_reference_ordered(
    tree: TreeData, queries: torch.Tensor, active: Optional[torch.Tensor] = None
) -> OrderedResult:
    """Plain oracle for the ordered descent: one root-to-leaf pass per query
    yields the exact-match payload, the strict predecessor/successor
    ancestors and the query's rank boundary.  Queries must be real keys,
    strictly inside (NO_PRED_KEY, SENTINEL_KEY)."""
    B = queries.shape[0]
    if active is None:
        active = torch.ones((B,), dtype=torch.bool, device=queries.device)
    idx = torch.zeros((B,), dtype=torch.int64, device=queries.device)
    r = init_ordered(B, queries.device)
    for left in left_subtree_sizes(tree.height).tolist():
        idx, r = _ordered_step(
            tree.keys, tree.values, queries, active, idx, r, left, tree.n_nodes - 1
        )
    return r


def search_reference(
    tree: TreeData, queries: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain oracle: batched BST descent in BFS layout -> (values, found).
    Not-found queries get SENTINEL_VALUE."""
    res = search_reference_ordered(tree, queries)
    return res.value, res.found


def register_layer_route(
    tree: TreeData, queries: torch.Tensor, register_levels: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Descend the register layer only; route survivors to subtrees.

    Returns (subtree_id, value, found), each (B,):
      * found=True  -> the key matched inside the register layer, value valid;
      * found=False -> subtree_id in [0, 2^register_levels) names the vertical
        partition in which the descent must continue (paper Fig. 3).
    """
    if register_levels < 1:
        raise ValueError("need at least one register level (the root)")
    B = queries.shape[0]
    device = queries.device
    idx = torch.zeros((B,), dtype=torch.int64, device=device)
    val = torch.full((B,), int(SENTINEL_VALUE), dtype=torch.int32, device=device)
    found = torch.zeros((B,), dtype=torch.bool, device=device)
    for _ in range(register_levels):
        node_key = tree.keys[idx]
        hit = (node_key == queries) & ~found
        val = torch.where(hit, tree.values[idx], val)
        found = found | hit
        nxt = 2 * idx + 1 + (queries > node_key).long()
        idx = torch.where(found, idx, nxt)
    return _subtree_ids(idx, found, register_levels), val, found


def _subtree_ids(idx: torch.Tensor, found: torch.Tensor, register_levels: int) -> torch.Tensor:
    """After ``register_levels`` steps a live key's index lies at level
    ``register_levels``, and its offset there is the subtree id; lanes that
    hit in the register layer get -1."""
    subtree_id = torch.clamp(idx - level_offset(register_levels), min=0)
    return torch.where(found, -1, subtree_id).to(torch.int32)


def register_layer_route_ordered(
    tree: TreeData, queries: torch.Tensor, register_levels: int, full_height: int
) -> Tuple[torch.Tensor, OrderedResult]:
    """Ordered variant of ``register_layer_route``: (subtree_id, partial
    OrderedResult), the register layer's part of the predecessor/successor
    tracking and of the rank.  Rank contributions use ``full_height``
    left-subtree sizes -- the register layer is a prefix of the FULL tree, so
    a right turn at global level ``l`` skips ``2^{full_height - l}`` keys
    wherever the split sits; the subtree descent's local rank adds on."""
    if register_levels < 1:
        raise ValueError("need at least one register level (the root)")
    B = queries.shape[0]
    idx = torch.zeros((B,), dtype=torch.int64, device=queries.device)
    r = init_ordered(B, queries.device)
    for left in left_subtree_sizes(full_height)[:register_levels].tolist():
        idx, r = _ordered_step(tree.keys, tree.values, queries, None, idx, r, left, None)
    return _subtree_ids(idx, r.found, register_levels), r


def subtree_search(
    sub_keys: torch.Tensor,
    sub_values: torch.Tensor,
    sub_height: int,
    queries: torch.Tensor,
    active: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Descend one vertical partition (local BFS layout) -> (values, found).
    ``active`` masks padded or irrelevant slots so they cannot fake a hit."""
    n = sub_keys.shape[0]
    B = queries.shape[0]
    device = queries.device
    idx = torch.zeros((B,), dtype=torch.int64, device=device)
    val = torch.full((B,), int(SENTINEL_VALUE), dtype=torch.int32, device=device)
    found = torch.zeros((B,), dtype=torch.bool, device=device)
    for _ in range(sub_height + 1):
        node_key = sub_keys[idx]
        hit = (node_key == queries) & ~found & active
        val = torch.where(hit, sub_values[idx], val)
        found = found | hit
        nxt = torch.clamp(2 * idx + 1 + (queries > node_key).long(), max=n - 1)
        idx = torch.where(found, idx, nxt)
    return val, found & active
