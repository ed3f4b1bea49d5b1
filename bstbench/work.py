"""The bytes a batch of point lookups must move: the read roofline's
numerator, over the benchmark's own inputs.

The yardstick is a plain binary search of the sorted keys, laid out as
the perfect BFS (Eytzinger) tree of height ``H = height_for(n)`` that the
paper's accelerator searches, padded past the last key with keys above
every query.  A lookup walks from the root and stops at its key, or at a
leaf where the key is absent.  Any implementation must read, at least:

* each query once (4 bytes) and write its value and found flag (4 + 1);
* each distinct tree node on the lanes' search paths once (its key, 4
  bytes), and the value of each distinct node a lane stops at (4);
* with a live write buffer of ``m`` sorted keys, each distinct buffer slot
  a lane's lower-bound search of those ``m`` keys compares (4), and at a
  slot holding the lane's key its entry's kind (4) and value (4).

Nodes are named by in-order position, so no layout is built: with the
stored keys at positions 1..n, the node at depth ``d`` of block ``b`` is
``b * 2^(H-d+1) + 2^(H-d)``.  In doubled positions a present key of rank
``r`` sits at ``Y = 2 (r + 1)`` and an absent one between the keys at
``Y = 2 r + 1``; the lane passes depth ``d`` at block ``Y >> (H - d + 2)``
unless ``Y`` is a multiple of ``2^(H-d+2)`` (it stopped above).  Paths and
buffer intervals keep the order of the queries, so with the queries sorted
the distinct nodes of a level are the changes along it.
"""

from __future__ import annotations

import numpy as np

QUERY_BYTES = 4
LOOKUP_OUT_BYTES = 4 + 1  # value and found
NODE_KEY_BYTES = 4
NODE_VALUE_BYTES = 4
SLOT_KEY_BYTES = 4
SLOT_ENTRY_BYTES = 4 + 4  # the entry's kind and its value


def height_for(n: int) -> int:
    """Height of the smallest perfect tree holding ``n >= 1`` keys."""
    return int(n).bit_length() - 1


def _distinct(sorted_values: np.ndarray) -> int:
    if sorted_values.size == 0:
        return 0
    return 1 + int(np.count_nonzero(sorted_values[1:] != sorted_values[:-1]))


def tree_bytes(ranks: np.ndarray, present: np.ndarray, n: int) -> int:
    """Node bytes of lookups whose keys have ``ranks`` (stored keys below
    them) among ``n`` sorted keys, ``present`` where stored."""
    H = height_for(n)
    ranks = np.asarray(ranks, np.int64)
    Y = np.sort(np.where(present, 2 * (ranks + 1), 2 * ranks + 1))
    nodes = 0
    for d in range(H + 1):
        s = H - d + 2
        visits = (Y & ((1 << s) - 1)) != 0
        nodes += _distinct(Y[visits] >> s)
    hits = _distinct(Y[(Y & 1) == 0])  # Y is even exactly where the key is stored
    return NODE_KEY_BYTES * nodes + NODE_VALUE_BYTES * hits


def buffer_bytes(queries: np.ndarray, buffered: np.ndarray) -> int:
    """Bytes of the lower-bound searches of ``queries`` over the sorted
    distinct buffered keys ``buffered``."""
    m = int(np.size(buffered))
    if m == 0:
        return 0
    q = np.sort(np.asarray(queries, np.int64))
    keys = np.asarray(buffered, np.int64)
    lo = np.zeros(q.size, np.int64)
    hi = np.full(q.size, m, np.int64)
    slots = 0  # each slot is the midpoint of one interval: counted once
    while True:
        live = lo < hi
        if not live.any():
            break
        mid = (lo + hi) >> 1
        slots += _distinct(mid[live])
        right = live & (keys[np.minimum(mid, m - 1)] < q)
        lo = np.where(right, mid + 1, lo)
        hi = np.where(live & ~right, mid, hi)
    # a lane that lands inside the buffer lands on a slot it compared
    inside = lo < m
    landed = lo[inside]
    hits = _distinct(landed[keys[landed] == q[inside]])
    return SLOT_KEY_BYTES * slots + SLOT_ENTRY_BYTES * hits


def lookup_bytes(queries: np.ndarray, ranks: np.ndarray, present: np.ndarray, n: int,
                 buffered: np.ndarray) -> int:
    """All the bytes of one chunk of point lookups (see the docstring)."""
    lanes = int(np.size(queries))
    return (lanes * (QUERY_BYTES + LOOKUP_OUT_BYTES) + tree_bytes(ranks, present, n)
            + buffer_bytes(queries, buffered))
