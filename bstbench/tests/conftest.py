"""Fixtures of the benchmark's own tests, and its card marker.

The tests run on the CPU at a tiny size: the records, the chunk, the
buffer and the requests are cut, every other setting of a cell is its
own.  A test marked ``bstbench_card`` needs a CUDA card and decides inside
itself whether to skip.
"""

import dataclasses
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "bstbench_card: runs the benchmark on a CUDA card; skips without one")


def tiny(cell, records=4095, chunk=256, capacity=256, clients=8, request_keys=64,
         pool_requests=64, **traffic):
    """``cell`` cut to a size that a test run holds."""
    config = dict(cell.config, records=records, server={"chunk_size": chunk})
    config["engine"] = dict(config["engine"], delta_capacity=capacity)
    mix = dict(cell.traffic, clients=clients, request_keys=request_keys,
               pool_keys=pool_requests * request_keys, warmup_rounds=2, trace_rounds=2, **traffic)
    return dataclasses.replace(cell, config=config, traffic=mix)


def run_tiny(cell, seed=2**31 + 11, rounds=4, make_adapter=None):
    """One run of ``cell`` on the CPU through its driver, ``rounds`` rounds
    in the window, untraced."""
    from bstbench import spec

    drv = spec.driver(cell.config["kind"])
    kw = {} if make_adapter is None else {"make_adapter": make_adapter}
    return drv.run(cell, seed=seed, seconds=60.0, trace=False, device="cpu",
                   t_start=time.perf_counter(),
                   device_info=lambda: {"platform": "cpu", "memory_peak_bytes": 0},
                   sync=lambda: None, max_rounds=rounds, **kw)


@pytest.fixture
def bench_root():
    return ROOT
