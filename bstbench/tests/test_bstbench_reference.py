"""The reference (``reference/sorted_index.py``) against a brute-force
model: a Python dict written in submission order."""

import numpy as np
import pytest

from bstbench.reference.sorted_index import MISSING_VALUE, SortedIndex, StaleIndex


def _model_get(model, q):
    return (np.array([model.get(int(k), int(MISSING_VALUE)) for k in q], np.int32),
            np.array([int(k) in model for k in q], bool))


@pytest.mark.parametrize("keys", [
    np.arange(1, 600, dtype=np.int32) * 2,  # the direct-address table
    np.sort(np.random.default_rng(3).choice(np.arange(-2**31, 2**31 - 1, 9973), 500,
                                            replace=False)).astype(np.int32),  # searchsorted
])
def test_reference_matches_a_dict_written_in_order(keys):
    rng = np.random.default_rng(0)
    values = rng.integers(0, 1000, keys.size, dtype=np.int32)
    ref = SortedIndex(keys, values)
    model = dict(zip(keys.tolist(), values.tolist()))
    for step in range(30):
        q = np.concatenate([keys[rng.integers(0, keys.size, 40)],
                            rng.integers(-2**31, 2**31 - 1, 10, dtype=np.int64).astype(np.int32)])
        got = ref.get(q)
        want = _model_get(model, q)
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
        w = keys[rng.integers(0, keys.size, 64)]  # repeats: the last one wins
        v = rng.integers(0, 2**31 - 1, w.size, dtype=np.int32)
        ref.put(w, v)
        for k, x in zip(w.tolist(), v.tolist()):
            model[k] = x
    assert np.array_equal(ref.values, np.array([model[k] for k in keys.tolist()], np.int32))


def test_rank_counts_the_keys_below():
    keys = np.array([2, 4, 6, 8], np.int32)
    ref = SortedIndex(keys, keys)
    assert ref.rank(np.array([0, 2, 3, 8, 9])).tolist() == [0, 0, 1, 3, 4]


def test_a_write_of_a_key_not_stored_is_refused():
    ref = SortedIndex(np.array([2, 4], np.int32), np.array([1, 2], np.int32))
    with pytest.raises(ValueError):
        ref.put(np.array([3], np.int32), np.array([9], np.int32))


def test_the_control_hides_writes_until_its_high_water():
    keys = np.arange(1, 100, dtype=np.int32) * 2
    stale = StaleIndex(keys, np.zeros(keys.size, np.int32), high_water=8)
    stale.submit_write(keys[:4], np.full(4, 7, np.int32))
    r = stale.submit_read(keys[:4])
    out = stale.drain()
    assert out[0][0] == 4 and out[r][0].tolist() == [0, 0, 0, 0]  # acknowledged, not visible
    stale.submit_write(keys[4:8], np.full(4, 9, np.int32))
    r = stale.submit_read(keys[:8])
    assert stale.drain()[r][0].tolist() == [7] * 4 + [9] * 4  # the high water flushed both
