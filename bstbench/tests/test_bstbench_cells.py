"""Whole runs on the CPU at a tiny size: every cell as committed, a cell
added as data alone, the control, and the faults the comparison must
catch; and what a run may load."""

import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

from bstbench import harness, spec
from bstbench.control import high_water, run_control
from bstbench.drivers import bst_server
from bstbench.tests.conftest import ROOT, run_tiny, tiny

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_json_keeps_to_its_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m["workloads"]) <= set(CELLS)
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert spec.metric_reader(m["name"]).read  # a reader of its own
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] == 1


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_runs_correct(name):
    out = run_tiny(tiny(spec.cell(name)), rounds=3)
    assert out.correct, out.checks
    assert out.context["read_lanes_compared"] > 0
    assert set(out.end_to_end) == {m["name"] for m in spec.cell(name).end_to_end}


def test_a_cell_added_as_data_alone_is_found_and_runs(tmp_path):
    """A later change adds a mix and a cell as files and entries only."""
    for rel in ("bstbench/configs", "bstbench/traffic"):
        shutil.copytree(ROOT / rel, tmp_path / rel)
    with open(tmp_path / "bstbench/traffic/ycsb-b.zipf.json") as f:
        mix = json.load(f)
    mix.update(read_proportion=0.8, update_proportion=0.2)
    with open(tmp_path / "bstbench/traffic/ycsb-x.zipf.json", "w") as f:
        json.dump(mix, f)
    bench = dict(BENCH, workloads=BENCH["workloads"] + [
        {"name": "hyb8q.ycsb-x.zipf", "config": "bst-hyb8q-16m", "traffic": "ycsb-x.zipf",
         "chips": 1, "why": "a test's cell"}])
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    cell = spec.cell("hyb8q.ycsb-x.zipf", root=tmp_path)
    assert cell.traffic["update_proportion"] == 0.2
    assert [m["name"] for m in cell.per_layer] == []  # no metric lists the new cell yet
    out = run_tiny(tiny(cell), rounds=3)
    assert out.correct, out.checks


def _fails(out, *numbers):
    assert not out.correct
    for n in numbers:
        assert out.checks[n]["value"] > out.checks[n]["limit"], out.checks


def test_the_control_comes_out_not_correct():
    cell = tiny(spec.cell("hrz.ycsb-a.zipf"), update_proportion=0.25, read_proportion=0.75)
    out = run_control(cell, seed=5, seconds=60.0, t_start=0.0, max_rounds=4)
    assert high_water(cell.config) == 192
    _fails(out, "lanes_wrong")


class _Faulty(bst_server.Adapter):
    """The program with one fault planted under the timed path."""

    fault = None

    def __init__(self, *args):
        super().__init__(*args)
        eng, srv = self.server.engine, self.server
        if self.fault == "state_unchanged":  # the write step returns its state as it was
            eng.apply_ops = lambda *a, **k: None
        elif self.fault == "half_left_out":  # half of a round's requests get no answer
            drain = srv.drain
            srv.drain = lambda: {t: a for t, a in drain().items() if t % 2}
        elif self.fault == "answers_short":  # half of each read request is never served
            submit = srv.submit
            srv.submit = lambda keys, op="lookup": submit(np.asarray(keys)[: len(keys) // 2], op)
        elif self.fault == "answer_altered":  # one answer of each read chunk changed
            query_static = eng.query_static

            def altered(*a, **k):
                res = query_static(*a, **k)
                res[0][0] += 1
                return res

            eng.query_static = altered


@pytest.mark.parametrize("fault,numbers", [
    ("state_unchanged", ("lanes_wrong", "final_values_wrong")),
    ("half_left_out", ("lanes_wrong", "final_values_wrong")),
    ("answers_short", ("lanes_wrong", "final_values_wrong")),
    ("answer_altered", ("lanes_wrong", "final_values_wrong")),
])
def test_a_planted_fault_comes_out_not_correct(fault, numbers):
    # the Hrz configuration under YCSB-B's proportions
    cell = tiny(spec.cell("hrz.ycsb-a.zipf"), sample_reads=1.0, update_proportion=0.05,
                read_proportion=0.95)
    faulty = type("Faulty", (_Faulty,), {"fault": fault})
    _fails(run_tiny(cell, rounds=3, make_adapter=faulty), *numbers)


def test_module_names_are_compared_whole():
    assert harness.forbidden_modules(["repro_torch", "repro_torch.core", "jaxtyping"]) == []
    assert harness.forbidden_modules(["repro.core.tree", "jax.numpy", "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "repro"]


def _python(code_or_args, **kw):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT), str(ROOT / "src")]))
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run([sys.executable, *code_or_args], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300, **kw)


def test_a_run_of_the_harness_loads_no_jax_and_no_jax_package():
    code = (
        "import json, sys\n"
        "from bstbench import harness, spec\n"
        "from bstbench.tests.conftest import run_tiny, tiny\n"
        "out = run_tiny(tiny(spec.cell('hyb8q.ycsb-b.zipf')), rounds=2)\n"
        "print(json.dumps([out.correct, harness.forbidden_modules()]))\n"
    )
    res = _python(["-c", code])
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == [True, []]


def test_without_a_card_a_run_fails_and_prints_no_result():
    res = _python(["bstbench/run.py", "--workload", "hyb8q.ycsb-b.zipf", "--seed", "1",
                   "--seconds", "1"])
    assert res.returncode != 0
    assert "{" not in res.stdout
