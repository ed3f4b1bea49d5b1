"""``work.py``'s byte counts at tiny heights against an explicit walk of
the BFS (Eytzinger) tree and an explicit lower-bound search per lane."""

import numpy as np
import pytest

from bstbench import work

_PAD = np.iinfo(np.int64).max


def _eytzinger(sorted_keys):
    """The perfect BFS tree of ``sorted_keys``, padded with keys above all."""
    n = sorted_keys.size
    H = work.height_for(n)
    m = (1 << (H + 1)) - 1
    padded = np.concatenate([sorted_keys.astype(np.int64), np.full(m - n, _PAD)])
    tree = np.empty(m, np.int64)
    it = iter(padded)

    def fill(i):
        if i >= m:
            return
        fill(2 * i + 1)
        tree[i] = next(it)
        fill(2 * i + 2)

    fill(0)
    return tree


def _walk_bytes(sorted_keys, queries):
    tree = _eytzinger(sorted_keys)
    nodes, hits = set(), set()
    for q in queries:
        i = 0
        while i < tree.size:
            nodes.add(i)
            if tree[i] == q:
                hits.add(i)
                break
            i = 2 * i + 1 if q < tree[i] else 2 * i + 2
    return work.NODE_KEY_BYTES * len(nodes) + work.NODE_VALUE_BYTES * len(hits)


def _search_bytes(buffered, queries):
    slots, hits = set(), set()
    for q in queries:
        lo, hi = 0, len(buffered)
        while lo < hi:
            mid = (lo + hi) // 2
            slots.add(mid)
            if buffered[mid] < q:
                lo = mid + 1
            else:
                hi = mid
        if lo < len(buffered) and buffered[lo] == q:
            hits.add(lo)
    return work.SLOT_KEY_BYTES * len(slots) + work.SLOT_ENTRY_BYTES * len(hits)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 7, 12, 15, 16, 31, 40])
def test_tree_bytes_are_the_walks(n):
    rng = np.random.default_rng(n)
    keys = np.arange(1, n + 1, dtype=np.int32) * 2
    for _ in range(5):
        q = rng.integers(0, 2 * n + 3, rng.integers(1, 3 * n + 2)).astype(np.int32)
        ranks = np.searchsorted(keys, q)
        present = np.isin(q, keys)
        assert work.tree_bytes(ranks, present, n) == _walk_bytes(keys, q)


@pytest.mark.parametrize("m", [0, 1, 2, 5, 8, 13])
def test_buffer_bytes_are_the_searches(m):
    rng = np.random.default_rng(100 + m)
    buffered = np.sort(rng.choice(np.arange(0, 60, 2), m, replace=False)).astype(np.int32)
    for _ in range(5):
        q = rng.integers(-1, 62, rng.integers(1, 30)).astype(np.int32)
        want = _search_bytes(buffered.tolist(), q.tolist()) if m else 0
        assert work.buffer_bytes(q, buffered) == want


def test_lookup_bytes_add_the_lanes():
    keys = np.arange(1, 8, dtype=np.int32) * 2
    q = np.array([2, 2, 9], np.int32)
    got = work.lookup_bytes(q, np.searchsorted(keys, q), np.isin(q, keys), keys.size,
                            np.array([2], np.int32))
    assert got == 3 * 9 + _walk_bytes(keys, q) + _search_bytes([2], q.tolist())


def test_a_padded_read_chunk_counts_only_the_lanes_that_carry_a_request():
    """The server pads a read stream's last chunk with key 0; the traced
    segment's log keeps the lanes of the requests alone, so the roofline's
    bytes are the requests' bytes, however much padding a chunk holds."""
    from bstbench import kvloop, spec
    from bstbench.drivers import bst_server
    from bstbench.reference.sorted_index import SortedIndex
    from bstbench.tests.conftest import tiny

    cell = tiny(spec.cell("hrz.ycsb-a.zipf"))
    keys, values = kvloop.make_records(cell.config, 3)
    adapter = bst_server.make(cell.config, keys, values, "cpu")
    chunk = cell.config["server"]["chunk_size"]
    rng = np.random.default_rng(4)
    requests = [rng.choice(keys, m) for m in (chunk // 2, chunk // 2 + 7)]  # one chunk and 7 lanes
    log: list = []
    adapter.instrument(log)
    try:
        for r in requests:
            adapter.submit_read(r)
        adapter.drain()
    finally:
        adapter.instrument(None)
    stream = np.concatenate(requests)
    assert [q.size for q, _ in log] == [chunk, 7]
    assert np.array_equal(np.concatenate([q for q, _ in log]), stream)
    ref = SortedIndex(keys, values)
    ranks = np.searchsorted(keys, stream[chunk:])
    want = work.lookup_bytes(stream[chunk:], ranks, np.ones(7, bool), keys.size,
                             np.empty(0, np.int32))
    assert kvloop.chunk_bytes(ref, log)[1] == want
    padded = np.pad(stream[chunk:], (0, chunk - 7))
    assert want < work.lookup_bytes(padded, np.searchsorted(keys, padded), np.isin(padded, keys),
                                    keys.size, np.empty(0, np.int32))
