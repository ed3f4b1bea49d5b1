"""The YCSB generator copy (``traffic/ycsb.py``) against a transcription of
YCSB's Java, the FNV-1a test vector, and the pool's promises."""

import math

import numpy as np
import pytest
import torch

from bstbench import spec
from bstbench.traffic import ycsb

_M64 = (1 << 64) - 1


def _fnv1a64(data: bytes) -> int:
    """FNV-1a over bytes, in Python integers (mod 2^64)."""
    h = 0xCBF29CE484222325
    for byte in data:
        h = ((h ^ byte) * 1099511628211) & _M64
    return h


def _java_fnvhash64(val: int) -> int:
    """YCSB's ``Utils.fnvhash64`` line by line: the long's eight bytes low
    first, FNV-1a, then ``Math.abs`` of the signed result."""
    h = _fnv1a64((val & _M64).to_bytes(8, "little"))
    signed = h - (1 << 64) if h >> 63 else h
    return abs(signed) if signed != -(1 << 63) else signed


def _java_zipfian(u: float) -> int:
    """``ZipfianGenerator(0, 10^10, 0.99, ZETAN).nextValue()`` given its
    ``nextDouble()`` draw ``u``, line by line."""
    items, theta, zetan = 10_000_000_000 + 1, 0.99, 26.46902820178302
    zeta2theta = sum(1 / math.pow(i + 1, theta) for i in range(2))
    alpha = 1.0 / (1.0 - theta)
    eta = (1 - math.pow(2.0 / items, 1 - theta)) / (1 - zeta2theta / zetan)
    uz = u * zetan
    if uz < 1.0:
        return 0
    if uz < 1.0 + math.pow(0.5, theta):
        return 1
    return int(items * math.pow(eta * u - eta + 1, alpha))


def test_fnv1a_transcription_meets_the_published_test_vector():
    assert _fnv1a64(b"") == 0xCBF29CE484222325
    assert _fnv1a64(b"a") == 0xAF63DC4C8601EC8C
    assert _fnv1a64(b"foobar") == 0x85944171F73967E8


@pytest.mark.parametrize("val", [0, 1, 255, 256, 2**32 + 7, 10**10, 123456789012, 2**40 - 3])
def test_fnvhash64_is_ycsbs(val):
    got = ycsb.fnvhash64(torch.tensor([val], dtype=torch.int64))
    assert int(got[0]) == _java_fnvhash64(val)


@pytest.mark.parametrize("u", [0.0, 0.02, 0.0377, 0.0378, 0.05, 0.0715, 0.0716, 0.2, 0.5, 0.9,
                               0.999999])
def test_zipfian_ranks_are_ycsbs(u):
    got = ycsb.zipfian_ranks(torch.tensor([u], dtype=torch.float64))
    assert int(got[0]) == _java_zipfian(u)


def test_fixed_draws_of_the_scrambled_chooser():
    """Record indices for fixed draws, each worked out by the Java
    transcription: rank, hash, and the modulo of the record count."""
    n = 16_777_215
    us = [0.0, 0.05, 0.3, 0.75, 0.999]
    got = torch.fmod(ycsb.fnvhash64(ycsb.zipfian_ranks(torch.tensor(us, dtype=torch.float64))), n)
    want = [_java_fnvhash64(_java_zipfian(u)) % n for u in us]
    assert got.tolist() == want
    assert want[0] == _java_fnvhash64(0) % n  # rank 0, the hottest record


def test_hottest_record_takes_its_zipf_share():
    gen = torch.Generator().manual_seed(5)
    idx = ycsb.scrambled_zipfian(400_000, 16_777_215, gen).numpy()
    assert idx.min() >= 0 and idx.max() < 16_777_215
    top = _java_fnvhash64(0) % 16_777_215
    share = np.mean(idx == top)
    assert abs(share - 1 / ycsb.ZETAN) < 0.003  # 1 / zeta(10^10, 0.99) = 3.78%


def _pool(seed, **kw):
    cell = spec.cell("hyb8q.ycsb-b.zipf")
    traffic = dict(cell.traffic, request_keys=64, pool_keys=64 * 100, **kw)
    keys = (np.arange(1, 4096) * 2).astype(np.int32)
    return ycsb.RequestPool(ycsb.Mix.from_traffic(traffic), keys, seed, "cpu"), keys


def test_the_pool_is_the_seeds_and_every_seed_sends_the_same_work():
    a, keys = _pool(2**31 + 3)
    b, _ = _pool(2**31 + 3)
    c, _ = _pool(7)
    for seq in (0, 5, 99, 100, 250):
        assert np.array_equal(a.keys(seq), b.keys(seq))
        assert a.is_write(seq) == b.is_write(seq)
    assert not all(np.array_equal(a.keys(s), c.keys(s)) for s in range(20))
    assert a.kinds.sum() == c.kinds.sum() == 5  # 5% of 100 requests a pass, every seed
    assert np.isin(a.keys(3), keys).all()


def test_no_two_requests_of_a_run_are_one_batch_and_writes_write_new_values():
    pool, _ = _pool(11)
    batches = {pool.keys(s).tobytes() for s in range(400)}  # four passes
    assert len(batches) == 400
    assert not np.array_equal(pool.values(3), pool.values(4))
    assert (pool.values(3) >= 0).all()


@pytest.mark.parametrize("traffic", ["ycsb-b.zipf", "ycsb-a.zipf"])
def test_each_mix_reads_as_a_closed_loop(traffic, bench_root):
    import json

    with open(bench_root / "bstbench" / "traffic" / f"{traffic}.json") as f:
        mix = ycsb.Mix.from_traffic(json.load(f))
    assert mix.clients == 64 and mix.request_keys == 4096
    assert mix.update_proportion == {"ycsb-b.zipf": 0.05, "ycsb-a.zipf": 0.5}[traffic]
