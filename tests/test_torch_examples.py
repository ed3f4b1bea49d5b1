"""The "dots" remat policy and the port's four examples, on the CPU.

``remat_policy="dots"`` (``models/model.py``'s ``_run_layers``: each layer
under a selective ``torch.utils.checkpoint`` that keeps the outputs of its
matrix products without batch dims) against "none" and against the JAX
package's ``remat_policy="dots"`` ``jax.value_and_grad``, at smoke size for
the dense (qwen3) and moe (mixtral) families: the loss within 1e-5 and
every gradient within 1e-4 (``tests/test_torch_train_grads.py``'s rule;
"dots" and "none" compute the same ops, so they agree to the bit).  What
each setting keeps through the forward is the bytes still allocated when
it ends (``MemTracker``): ``saved_tensors_hooks`` cannot tell the two
policies apart, since a checkpointed region's saves never reach an outer
hook and the selective policy keeps its products in a cache of its own.

Each example's ``main`` runs with ``--device cpu`` and tiny arguments: its
own assertions hold (every strategy's answers identical, the served keys
found, the fresh writes read back, queue drops at most direct drops), the
quickstart's Fig. 7 matrix equals the JAX package's ``run_paper_matrix``
on the same tree and key sets field for field, and the port's dead-code
gate passes with the cycle model reachable from the quickstart.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.core import tree as JT  # noqa: E402
from repro.core.cyclesim import run_paper_matrix as j_run_paper_matrix  # noqa: E402
from repro.data.keysets import make_key_sets as j_make_key_sets  # noqa: E402
from repro.data.keysets import make_tree_data  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.analysis import deadcode  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import jax_leaf, params_from_jax  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
ARCHS = ("qwen3_1p7b", "mixtral_8x7b")
BATCH, SEQ = 2, 24


def _import_example(name: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "examples",
                                                                     f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _weights(jcfg, seed=0):
    """The JAX package's ``init_params`` tree of shapes drawn with numpy:
    norm scales 1, every other leaf N(0, 0.02)."""
    rng = np.random.default_rng(seed)
    norms = {"ln1", "ln2", "ln_cross", "q_norm", "k_norm", "norm", "final_norm",
             "enc_final_norm"}

    def draw(path, spec):
        if path[-1].key in norms:
            return np.ones(spec.shape, np.float32)
        return (rng.standard_normal(spec.shape) * 0.02).astype(np.float32)

    shapes = jax.eval_shape(lambda: JM.init_params(jcfg, jax.random.key(0)))
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _inputs(cfg, seed=0):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (BATCH, SEQ + 1))
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)


def _close_rel(got, want, tol, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol, err_msg=name)
    scale = np.abs(want).max(initial=0.0)
    assert scale > 0, f"{name}: the reference gradient is all zero"
    assert np.abs(got - want).max(initial=0.0) <= tol * scale, name


def _port(cfg, params, tokens, labels):
    model = params_from_jax(cfg, params, device="cpu", trainable=True)
    loss, _ = TM.forward_train(cfg, model, torch.from_numpy(tokens).long(),
                               torch.from_numpy(labels).long())
    loss.backward()
    return loss.item(), {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_matches_none_and_the_jax_packages_dots(arch):
    jcfg = dataclasses.replace(jsmoke_config(arch), remat=True, remat_policy="dots")
    params = _weights(jcfg)
    tokens, labels = _inputs(jcfg)

    def loss_fn(p):
        return JM.forward_train(jcfg, p, tokens, labels, None)

    (jloss, _), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    jgrads = jax.tree.map(np.asarray, jgrads)
    base = dataclasses.replace(tconfigs.smoke_config(arch), remat=True)
    dots_loss, dots = _port(dataclasses.replace(base, remat_policy="dots"), params, tokens,
                            labels)
    none_loss, none = _port(dataclasses.replace(base, remat_policy="none"), params, tokens,
                            labels)
    assert abs(dots_loss - float(jloss)) <= LOSS_TOL
    assert dots_loss == none_loss
    for name, g in dots.items():
        torch.testing.assert_close(g, none[name], atol=0, rtol=0)
        _close_rel(g.numpy(), jax_leaf(jgrads, name), GRAD_TOL, name)


def _kept_bytes(cfg, seq: int) -> int:
    """Bytes still allocated when ``forward_train`` returns, the model's
    own aside: what the forward keeps for the backward (and the loss)."""
    from torch.distributed._tools.mem_tracker import MemTracker

    model = TM.init_params(cfg, seed=0, device="cpu", trainable=True)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, seq + 1)))
    mem = MemTracker()
    mem.track_external(model)

    def total() -> int:
        return sum(row["Total"] for row in mem.get_tracker_snapshot("current").values())

    with mem:
        before = total()
        loss, _ = TM.forward_train(cfg, model, toks[:, :-1], toks[:, 1:])
        kept = total() - before
    loss.backward()
    return kept


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_keeps_more_than_none_and_less_than_no_remat(arch):
    base = tconfigs.smoke_config(arch)
    kept = {name: _kept_bytes(dataclasses.replace(base, **variant), 64) for name, variant in (
        ("off", {"remat": False}), ("none", {"remat": True, "remat_policy": "none"}),
        ("dots", {"remat": True, "remat_policy": "dots"}))}
    assert kept["none"] < kept["dots"] < kept["off"], kept


# ----------------------------------------------------------------- examples
def test_quickstart_runs_and_its_fig7_matrix_is_the_jax_packages(capsys):
    quickstart = _import_example("torch_quickstart")
    got = quickstart.main(["--device", "cpu", "--tree-keys", "1023", "--queries", "512",
                           "--stream", "2048"])
    assert "identical results" in capsys.readouterr().out
    keys, values = make_tree_data(1023, seed=0)
    jtree = JT.build_tree(keys, values)
    want = j_run_paper_matrix(jtree, j_make_key_sets(jtree, 2048))
    assert list(got) == list(want)
    for set_name, row in want.items():
        assert list(got[set_name]) == list(row)
        for impl, w in row.items():
            assert dataclasses.asdict(got[set_name][impl]) == dataclasses.asdict(w), (
                set_name, impl)


def test_serve_bst_runs_with_its_sharded_sections_at_world_one(capsys):
    _import_example("torch_serve_bst").main(
        ["--device", "cpu", "--requests", "4096", "--chunk", "512", "--tree-keys", "2047"])
    out = capsys.readouterr().out
    for line in ("Hyb8q", "ordered workload mix", "post-write lookups: found 8/8",
                 "deleted 1000 (still found 0)", "vertical(all_to_all)", "sharded write path"):
        assert line in out, line


def test_moe_dispatch_queue_drops_no_more_than_direct():
    rows = _import_example("torch_moe_dispatch").main(["--device", "cpu"])
    assert [cf for cf, *_ in rows] == [0.5, 0.75, 1.0, 1.25, 1.5, 2.0]
    assert all(queue <= direct for _, _, queue, direct in rows)
    assert any(queue < direct for _, _, queue, direct in rows)


def test_train_lm_trains_and_checkpoints(tmp_path):
    state = _import_example("torch_train_lm").main(
        ["--device", "cpu", "--steps", "4", "--batch", "2", "--seq", "16", "--ckpt-every", "2",
         "--ckpt-dir", str(tmp_path)])
    assert int(state.opt.step) == 4
    assert sorted(os.listdir(tmp_path)) == ["step_00000001", "step_00000003"]


def test_deadcode_gate_passes_with_the_cycle_model_reached_by_the_quickstart():
    errors, classes = deadcode.report_dead(ROOT)
    assert errors == [], errors
    assert "repro_torch.core.cyclesim" not in classes
    assert "repro_torch.core.cyclesim" not in deadcode.load_quarantine()
    assert "examples/torch_quickstart.py" in deadcode.ROOT_FILES
