"""repro_torch.analysis: lint rules, contracts, dead code, the serve gate.

The port's counterpart of ``tests/test_analysis.py``: plant the bug
classes each pass exists to catch (a branch on a tensor, a host op inside
a graphed step, a capture per loop iteration, an implicit pull, an
unbudgeted fetch, a drifted contract row, a drain of a second batch
length) and assert the right pass flags each one; then assert the port's
own tree is clean and the steady-state serve gate holds on every strategy,
single-chip and sharded at world 1.  Two tests hold the port to the JAX
package: the contract rows, and the gate's drain on both servers.  On the
CPU the sync debug mode does nothing and the engine captures no graph, so
the planted-sync and capture controls run on the card
(``tests/test_torch_cuda.py``).
"""

import contextlib
import textwrap
import unittest.mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.analysis import contracts as J_contracts  # noqa: E402
from repro.analysis import runtime as J_runtime  # noqa: E402
from repro.core.engine import EngineConfig as JConfig  # noqa: E402
from repro.serving import BSTServer as JServer  # noqa: E402
from repro_torch.analysis import (  # noqa: E402
    contracts,
    deadcode,
    gate,
    invariants,
    lint,
    report,
    runtime,
)
from repro_torch.analysis.__main__ import DEFAULT_PATHS, main  # noqa: E402
from repro_torch.serving import bst_server  # noqa: E402


def _lint_src(tmp_path, src, name="case.py"):
    p = tmp_path / name
    p.write_text(textwrap.dedent(src))
    hard, _soft = lint.lint_paths([str(p)], allowlist=None)
    return {v.rule for v in hard}, hard


# --------------------------------------------------------------------- lint
def test_lint_catches_tensor_control_flow(tmp_path):
    # Branching on a tensor: on the card a copy of the flag and a wait.
    rules, hard = _lint_src(
        tmp_path,
        """
        import torch

        def route(x):
            y = torch.abs(x)
            if y.sum() > 0:
                return y
            assert bool(y.any())
            return x
        """,
    )
    assert rules == {"ANA001"}
    assert len(hard) == 2  # the if and the bool()


def test_lint_catches_host_ops_in_graphed_step(tmp_path):
    rules, hard = _lint_src(
        tmp_path,
        """
        import numpy as np
        from repro_torch import graphs

        class Engine:
            def _query_step(self, q):
                n = q.sum().item()
                print(n)
                return q + 1

            def query(self, q):
                return self._run(("lookup", None, 8), Engine._query_step, q)

        def capture(model, tokens):
            return graphs.Graph(lambda: np.asarray(model(tokens)))
        """,
    )
    assert rules == {"ANA002"}
    assert len(hard) == 3  # .item() + print in the step, np.asarray in the lambda


def test_lint_catches_capture_hazards(tmp_path):
    rules, hard = _lint_src(
        tmp_path,
        """
        import torch
        from repro_torch import graphs

        def capture_all(steps):
            out = []
            for s in steps:
                out.append(graphs.Graph(s))
            return out

        def _step(x, seen=[]):
            return x + 1

        g = graphs.Graph(_step)
        """,
    )
    assert rules == {"ANA004"}
    assert len(hard) == 2  # the capture in a loop, the mutable default


def test_lint_catches_implicit_host_pull(tmp_path):
    rules, hard = _lint_src(
        tmp_path,
        """
        import torch

        def count(x: torch.Tensor, host):
            total = torch.sum(x)
            host.cpu()
            n = int(total)
            return n, x.tolist()
        """,
    )
    assert rules == {"ANA005"}
    assert len(hard) == 3  # int(), .tolist(), and .cpu() on anything


def test_lint_tensor_metadata_is_not_a_pull(tmp_path):
    # int(x.shape[0]), x.numel(), x.device: host metadata, not a sync.
    rules, _ = _lint_src(
        tmp_path,
        """
        import torch

        def pad(x):
            y = torch.abs(x)
            n = int(y.shape[0]) + int(y.numel())
            if y.device.type == "cuda" and y.dtype == torch.int32 or y.is_cpu:
                return n
            return n
        """,
    )
    assert rules == set()


@pytest.mark.parametrize("call", ["runtime.device_fetch((x,))", "runtime.device_put(x, y)",
                                  "torch.cuda.synchronize()", "event.synchronize()",
                                  "runtime.device_fetch_into(x, y)"])
def test_lint_flags_unallowlisted_explicit_fetch(tmp_path, call):
    serving = tmp_path / "serving"
    serving.mkdir()
    p = serving / "hot.py"
    p.write_text(
        "import torch\nfrom repro_torch.analysis import runtime\n\n"
        f"def pull(x, y, event):\n    return {call}\n"
    )
    hard, _ = lint.lint_paths([str(p)], allowlist=None)
    assert {v.rule for v in hard} == {"ANA006"}


def test_hot_path_tree_is_lint_clean():
    hard, soft = lint.lint_paths(list(DEFAULT_PATHS))
    assert hard == [], report.render_all(hard)
    # the sanctioned syncs stay visible as allowlisted, not invisible
    assert {v.rule for v in soft} >= {"ANA006"}
    budgets = {e[0] for e in lint.load_allowlist(lint.DEFAULT_ALLOWLIST) if e[1] == "ANA006"}
    for glob in budgets:
        assert glob.startswith("src/repro_torch/") and "budget" in next(
            e[2] for e in lint.load_allowlist(lint.DEFAULT_ALLOWLIST) if e[0] == glob
        )


# ---------------------------------------------------------- runtime detector
def test_capture_watch_counts_the_eager_route_as_nothing():
    # On the CPU the engine is eager: a drain captures nothing by
    # construction, and the watch unregisters itself.
    from repro_torch import graphs

    srv = bst_server.BSTServer(gate.gate_keys(), gate.gate_keys(), _cfg("hrz"), chunk_size=16)
    with runtime.capture_watch() as cw:
        srv.lookup(np.arange(40, dtype=np.int32))
    assert cw.count == 0 and cw.keys == []
    assert graphs.WATCHERS == []


def test_transfer_watch_counts_sanctioned_fetches_and_puts():
    x = torch.arange(4, dtype=torch.int32)
    out = torch.empty_like(x)
    with runtime.transfer_watch() as tw:
        (got,) = runtime.device_fetch((x + 1,))
        runtime.device_put(x, out)
    np.testing.assert_array_equal(got, np.arange(4) + 1)
    assert torch.equal(out, x)
    assert (tw.fetches, tw.puts) == (1, 1)


def test_device_put_takes_only_host_tensors():
    with pytest.raises(ValueError, match="host tensor"):
        runtime.device_put(torch.empty(4, device="meta"), torch.empty(4))


# ---------------------------------------------------------------- contracts
def test_contracts_pass_on_current_tree():
    errors = contracts.run_contracts("cpu")
    assert errors == [], report.render_all(errors)


def test_contract_rows_catch_output_drift():
    errors = []
    # lookup declares (values, found); a bare values row must fail
    contracts._check_outputs(
        "t", "lookup", (torch.empty(8, dtype=torch.int32, device="meta"),), 8, 4, errors
    )
    assert errors
    errors = []
    # wrong dtype on found
    contracts._check_outputs(
        "t", "lookup",
        (torch.empty(8, dtype=torch.int32, device="meta"),
         torch.empty(8, dtype=torch.int32, device="meta")),
        8, 4, errors,
    )
    assert errors


def test_contracts_catch_a_drifted_row(monkeypatch):
    # A row that no longer matches the code (range_count's counts declared
    # int64) must fail the query check and the sharded one.
    monkeypatch.setitem(contracts.OP_CONTRACTS, "range_count", ((lambda B, k: (B,), torch.int64),))
    errors = contracts.check_query_contracts("cpu") + contracts.check_sharded_builders("cpu")
    assert errors and all("range_count" in v.msg for v in errors)
    assert {v.path for v in errors} == {"contracts:query[hrz/cpu/plain]", "contracts:query[hrz/cpu/delta]",
                                        "contracts:query[dup/cpu/plain]", "contracts:query[dup/cpu/delta]",
                                        "contracts:query[hyb/cpu/plain]", "contracts:query[hyb/cpu/delta]",
                                        "contracts:sharded[hrz/plain]", "contracts:sharded[hrz/delta]",
                                        "contracts:sharded[dup/plain]", "contracts:sharded[dup/delta]",
                                        "contracts:sharded[hyb/plain]", "contracts:sharded[hyb/delta]"}


@pytest.mark.parametrize("B,k", [(1, 1), (8, 4), (512, 8), (8192, 16)])
def test_op_contracts_match_the_jax_package(B, k):
    dtypes = {torch.int32: np.dtype(np.int32), torch.bool: np.dtype(bool)}
    assert set(contracts.OP_CONTRACTS) == set(J_contracts.OP_CONTRACTS)
    for op, rows in contracts.OP_CONTRACTS.items():
        j_rows = J_contracts.OP_CONTRACTS[op]
        assert len(rows) == len(j_rows), op
        for (shape, dtype), (j_shape, j_dtype) in zip(rows, j_rows):
            assert tuple(shape(B, k)) == tuple(j_shape(B, k)), op
            assert dtypes[dtype] == np.dtype(j_dtype), op


def test_invariants_reject_bad_configs():
    with pytest.raises(ValueError):
        invariants.check_delta_config(8, 9)
    with pytest.raises(ValueError):
        invariants.check_chunk_divides(100, 8, "model")
    with pytest.raises(ValueError):
        invariants.check_forest_nodes(30, 4)
    assert invariants.split_level_for(4) == 2


# ----------------------------------------------------------------- deadcode
def _package(tmp_path):
    pkg = tmp_path / "src" / "repro_torch"
    (pkg / "launch").mkdir(parents=True)
    (pkg / "__init__.py").write_text("")
    (pkg / "launch" / "__init__.py").write_text("")
    return pkg


def test_deadcode_flags_unreachable_module(tmp_path):
    pkg = _package(tmp_path)
    (pkg / "launch" / "serve.py").write_text("from repro_torch import used\n")
    (pkg / "used.py").write_text("")
    (pkg / "smoke_only.py").write_text("")
    (pkg / "unused.py").write_text("")
    (tmp_path / "chip_smoke.py").write_text("from repro_torch import smoke_only\n")
    classes = deadcode.dead_modules(str(tmp_path))
    assert classes == {"repro_torch.unused": "DEAD"}


def test_deadcode_follows_dynamic_registry_imports(tmp_path):
    pkg = _package(tmp_path)
    (pkg / "configs").mkdir()
    (pkg / "launch" / "serve.py").write_text("import repro_torch.configs\n")
    (pkg / "configs" / "__init__.py").write_text(
        "import importlib\n"
        "def load(name):\n"
        "    return importlib.import_module(f'repro_torch.configs.{name}')\n"
    )
    (pkg / "configs" / "tiny.py").write_text("")
    classes = deadcode.dead_modules(str(tmp_path))
    assert classes == {}  # tiny.py kept alive through the registry


def test_deadcode_resolves_reexported_names(tmp_path):
    # A root that takes a name from a package reaches the module that
    # defines it, not every module the package re-exports.
    pkg = _package(tmp_path)
    (pkg / "core").mkdir()
    (pkg / "core" / "__init__.py").write_text(
        "from repro_torch.core.engine import Engine\n"
        "from repro_torch.core.sim import simulate\n"
    )
    (pkg / "core" / "engine.py").write_text("class Engine: ...\n")
    (pkg / "core" / "sim.py").write_text("def simulate(): ...\n")
    (pkg / "launch" / "serve.py").write_text("from repro_torch.core import Engine\n")
    (tmp_path / "tests").mkdir()
    (tmp_path / "tests" / "test_sim.py").write_text("from repro_torch.core import simulate\n")
    classes = deadcode.dead_modules(str(tmp_path))
    assert classes == {"repro_torch.core.sim": "TEST_ONLY"}


def test_deadcode_quarantine_covers_real_tree():
    errors, classes = deadcode.report_dead(".")
    assert errors == [], report.render_all(errors)
    # the quarantined modules stay tracked, not silently dead
    assert set(classes) == set(deadcode.load_quarantine())


# ------------------------------------------------------------ runtime gate
def _cfg(strategy):
    from repro_torch.core.engine import EngineConfig

    return EngineConfig(strategy=strategy, n_trees=1 if strategy == "hrz" else 4, device="cpu",
                        delta_capacity=64, delta_high_water=64)


@pytest.mark.parametrize("sharded", [False, True], ids=["single", "sharded"])
@pytest.mark.parametrize("strategy", ["hrz", "dup", "hyb"])
def test_serve_gate_steady_state_clean(strategy, sharded):
    with gate.world1_group("cpu") if sharded else contextlib.nullcontext():
        errors = gate.serve_gate(strategy, n_chunks=3, sharded=sharded, device="cpu")
    assert errors == [], report.render_all(errors)
    assert not torch.distributed.is_initialized()


def test_serve_gate_reports_a_second_batch_length():
    # Negative control: measured chunks half the warmed length break the
    # fetch and put budgets here (on the card, the captures too).
    class SecondLength(bst_server.BSTServer):
        def warmup(self, ops=("lookup",)):
            super().warmup(ops)
            self.chunk_size //= 2

    with unittest.mock.patch.object(bst_server, "BSTServer", SecondLength):
        errors = gate.serve_gate("hrz", device="cpu")
    assert [v.rule for v in errors] == ["GAT001", "GAT001"]
    assert "36 counted device fetches, budget is 18" in errors[0].msg
    assert "50 counted device puts, budget is 26" in errors[1].msg


def test_gate_drain_matches_the_jax_server():
    # hyb on both servers (the JAX one on its plain route): the same
    # answers and the same fetch count over the gate's measured drain.
    keys = gate.gate_keys()
    jcfg = JConfig(strategy="hyb", n_trees=4, use_kernel=False, delta_capacity=64,
                   delta_high_water=64)
    jsrv = JServer(keys, keys * 7, jcfg, chunk_size=64, scan_k=4)
    jsrv.warmup(gate.GATE_OPS)
    jsrv.submit_write(np.int32([keys[1], keys[3]]), np.int32([1, 3]))
    jsrv.drain()
    srv = bst_server.BSTServer(keys, keys * 7, _cfg("hyb"), chunk_size=64, scan_k=4)
    gate.warm(srv, keys, gate.GATE_OPS)

    f0 = J_runtime.fetch_count()
    want, _, _ = gate.measured_drain(jsrv, keys, gate.GATE_OPS, 3, 64)
    j_fetches = J_runtime.fetch_count() - f0
    with runtime.transfer_watch() as tw:
        got, read_chunks, _ = gate.measured_drain(srv, keys, gate.GATE_OPS, 3, 64)
    assert tw.fetches == j_fetches == sum(n for _, n in read_chunks) == 18
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for (gt, gcols), (wt, wcols) in zip(sorted(g.items()), sorted(w.items())):
            assert len(gcols) == len(wcols)
            for gc, wc in zip(gcols, wcols):
                np.testing.assert_array_equal(np.asarray(gc), np.asarray(wc))


# ---------------------------------------------------------------------- CLI
def test_cli_exit_codes(tmp_path):
    bad = tmp_path / "hot.py"
    bad.write_text("import torch\n\ndef f(x):\n    return int(torch.sum(x))\n")
    assert main([str(bad), "--skip-contracts", "--repo-root", "."]) == 1
    clean = tmp_path / "ok.py"
    clean.write_text("def f(x):\n    return x\n")
    out = tmp_path / "report.json"
    assert main([str(clean), "--skip-contracts", "--repo-root", ".", "--report", str(out)]) == 0
    assert out.exists()
    # the whole default run, the serve gate included, on the CPU
    assert main(["--repo-root", ".", "--serve-gate", "--device", "cpu"]) == 0
    assert not torch.distributed.is_initialized()
    if not torch.cuda.is_available():  # the card is the default device: no silent CPU
        with pytest.raises(SystemExit) as e:
            main(["--repo-root", "."])
        assert e.value.code == 2
