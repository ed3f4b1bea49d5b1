"""On a CUDA card: a traced run of each cell at a small size, through the
port's kernels and graphs.  Skips without a card."""

import time

import pytest
import torch

from bstbench import spec
from bstbench.tests.conftest import tiny

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.mark.bstbench_card
@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_on_the_card_is_correct_and_reads_every_metric(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = tiny(spec.cell(name), records=(1 << 16) - 1, chunk=4096, capacity=4096, clients=16,
                request_keys=1024, pool_requests=256)
    out = spec.driver(cell.config["kind"]).run(
        cell, seed=2**31 + 99, seconds=1.0, trace=True, device="cuda",
        t_start=time.perf_counter(),
        device_info=lambda: {"memory_peak_bytes": torch.cuda.max_memory_allocated()},
        sync=torch.cuda.synchronize)
    assert out.correct, out.checks
    assert out.context["counters"]["captures"] == 0
    trace = out.context["trace"]
    assert trace is not None and trace["busy_s"] > 0
    for m in cell.per_layer:
        if trace["complete"] or m["source"] != "device_trace":
            assert spec.metric_reader(m["name"]).read(out.context) is not None, m["name"]
