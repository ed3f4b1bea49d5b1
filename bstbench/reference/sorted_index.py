"""The plain reference of a live int32 -> int32 index, in NumPy.

``SortedIndex`` holds the sorted keys the benchmark made and their values,
and applies each write in submission order, the last write of a key in a
batch winning.  A lookup of ``q`` gives ``(values, found)``: the key's value
where ``q`` is stored, ``MISSING_VALUE`` and ``False`` elsewhere.  Keys are
located by a direct-address table built from the sorted keys where they
are non-negative and below ``DIRECT_LIMIT`` (one gather a lookup; the
records' keys here run to 2^25), and by ``np.searchsorted`` otherwise.

``StaleIndex`` is the control: the same reference in the program's place,
made to break the configuration's guarantee.  Its reads see a write only
after ``high_water`` writes have been buffered since the last flush, as a
server whose reads skipped its delta buffer would; every write is still
acknowledged at once.

Nothing here imports the program: the reference takes the keys and values
that the benchmark made and the requests it sent, never what the program
derived from them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

MISSING_VALUE = np.int32(-1)  # the value a lookup of an absent key answers
DIRECT_LIMIT = 1 << 28


class SortedIndex:
    """Sorted unique int32 keys and their int32 values."""

    def __init__(self, keys: np.ndarray, values: np.ndarray):
        keys = np.asarray(keys, np.int32)
        if keys.ndim != 1 or keys.shape != np.shape(values):
            raise ValueError("keys and values must be equal-length 1-D arrays")
        if keys.size and not np.all(keys[:-1] < keys[1:]):
            raise ValueError("keys must be strictly increasing")
        self.keys = keys
        self.values = np.array(values, np.int32)
        self._slot = None
        if keys.size and keys[0] >= 0 and keys[-1] < DIRECT_LIMIT:
            self._slot = np.full(int(keys[-1]) + 1, -1, np.int32)
            self._slot[keys] = np.arange(keys.size, dtype=np.int32)

    def index_of(self, q: np.ndarray) -> np.ndarray:
        """The position of each key of ``q`` among the sorted keys, -1 where
        it is not stored."""
        q = np.asarray(q, np.int32)
        if self._slot is not None:
            inside = (q >= 0) & (q < self._slot.size)
            return np.where(inside, self._slot[np.where(inside, q, 0)], -1)
        pos = np.searchsorted(self.keys, q)
        hit = pos < self.keys.size
        hit[hit] = self.keys[pos[hit]] == q[hit]
        return np.where(hit, pos, -1)

    def rank(self, q: np.ndarray) -> np.ndarray:
        """How many stored keys lie below each key of ``q`` (a plain binary
        search of the sorted keys)."""
        return np.searchsorted(self.keys, np.asarray(q, np.int32))

    def get(self, q: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        idx = self.index_of(q)
        found = idx >= 0
        return np.where(found, self.values[np.where(found, idx, 0)], MISSING_VALUE), found

    def put(self, q: np.ndarray, v: np.ndarray) -> None:
        """Upsert of stored keys, in order (the last of a repeated key
        wins).  The records are fixed, so a key that is not stored is a
        fault of the traffic, not a write."""
        idx = self.index_of(q).astype(np.int64)
        if np.any(idx < 0):
            raise ValueError("a write of a key that is not stored")
        m = idx.size
        # sorted by (position, lane): the last lane of each position wins
        c = np.sort(idx * m + np.arange(m))
        pos, lane = np.divmod(c, m)
        last = np.ones(m, bool)
        last[:-1] = pos[1:] != pos[:-1]
        self.values[pos[last]] = np.asarray(v, np.int32)[lane[last]]


class StaleIndex:
    """The control (see the module's docstring), behind the loop's adapter
    interface (``kvloop.py``): it has no counters, no device and nothing
    to trace, and reads every record back as its reads see them."""

    def __init__(self, keys: np.ndarray, values: np.ndarray, high_water: int):
        self.index = SortedIndex(keys, values)  # what reads see
        self.high_water = high_water
        self._held: List[Tuple[np.ndarray, np.ndarray]] = []
        self._held_n = 0
        self._pending: List[Tuple[int, np.ndarray, Optional[np.ndarray]]] = []

    def submit_read(self, q) -> int:
        self._pending.append((len(self._pending), np.asarray(q, np.int32), None))
        return len(self._pending) - 1

    def submit_write(self, q, v) -> int:
        self._pending.append((len(self._pending), np.asarray(q, np.int32), np.asarray(v, np.int32)))
        return len(self._pending) - 1

    def drain(self) -> Dict[int, tuple]:
        out = {}
        for ticket, q, v in self._pending:
            if v is None:
                out[ticket] = self.index.get(q)
                continue
            self._held.append((q, v))
            self._held_n += q.size
            if self._held_n >= self.high_water:
                self.flush()
            out[ticket] = (np.asarray(q.size, np.int32),)
        self._pending = []
        return out

    def flush(self) -> None:
        for q, v in self._held:
            self.index.put(q, v)
        self._held, self._held_n = [], 0

    def warmup(self) -> None:
        pass

    def counters(self) -> Dict[str, float]:
        return {}

    def read_back(self, keys):
        return self.index.get(keys)

    def settle(self) -> None:
        self.flush()

    def instrument(self, log) -> None:
        pass

    def kernel_markers(self) -> tuple:
        return ()

    def close(self) -> None:
        pass
