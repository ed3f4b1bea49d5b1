"""The port's checkpoints against the JAX package's, on the CPU.

``repro_torch.checkpoint`` writes the JAX package's format: the JAX
package's own checkpoint tests (``tests/test_checkpoint.py``) one for one
on the port, a checkpoint of every family written by either package and
restored by the other bit for bit (the same path list in the same order,
bf16 as ``uint16``, the int8 error feedback included), the launcher's
restart after a deadline exit against an uninterrupted run, its deadline
holding a step and not the checkpoint saved before it, the port's
``param_specs``/``state_specs``/``batch_specs`` against the JAX package's
over ``AbstractMesh``es (the published configs and their ``dp_only``
variants), and ``elastic.shard_slices`` against
``NamedSharding.devices_indices_map`` on a forced 8-device host.

Tolerances: a round trip and a cross-package restore are bit for bit; a
resumed run equals an uninterrupted one within 1e-6 (the JAX package's
``test_elastic_restore_resumes_training``; on the CPU both are the same
sequence of deterministic steps).
"""

import contextlib
import dataclasses
import importlib
import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.checkpoint import restore_checkpoint as jrestore  # noqa: E402
from repro.checkpoint import save_checkpoint as jsave  # noqa: E402
from repro.checkpoint.store import _flatten_with_paths  # noqa: E402
from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.sharding import specs as jspecs  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint import CheckpointManager, restore_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.checkpoint import store as tstore  # noqa: E402
from repro_torch.checkpoint.store import latest_step  # noqa: E402
from repro_torch.data.pipeline import TokenPipeline  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models.convert import adamw_state_from_jax, jax_key, jax_leaf, params_from_jax  # noqa: E402
from repro_torch.sharding import specs as tspecs  # noqa: E402

jtrain = importlib.import_module("repro.training.train_loop")
ttrain = importlib.import_module("repro_torch.training.train_loop")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "tinyllama_1p1b"
RESUME_TOL = 1e-6
# One smoke config a family, and qwen3 once more in bf16.
CROSS = [("qwen3_1p7b", "float32"), ("mixtral_8x7b", "float32"), ("mamba2_1p3b", "float32"),
         ("hymba_1p5b", "float32"), ("seamless_m4t_medium", "float32"),
         ("internvl2_2b", "float32"), ("qwen3_1p7b", "bfloat16")]
SPEC_VARIANTS = {"dp_only": {"sharding_strategy": "dp_only"},
                 "dp_only_zero1": {"sharding_strategy": "dp_only", "zero1": True}}
MESHES = [((1, 1), ("data", "model")), ((2, 2), ("data", "model")), ((4, 2), ("data", "model")),
          ((8,), ("data",)), ((2, 16, 16), ("pod", "data", "model"))]


def _bits(t) -> np.ndarray:
    """A tensor's or array's bits as a numpy array (bf16 as uint16)."""
    if isinstance(t, torch.Tensor):
        t = t.detach()
        return t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16 else t.numpy()
    t = np.asarray(t)
    return t.view(np.uint16) if t.dtype == jnp.bfloat16 else t


def _same(got, want, tag=""):
    g, w = _bits(got), _bits(want)
    assert g.dtype == w.dtype and g.shape == w.shape, (tag, g.dtype, w.dtype, g.shape, w.shape)
    np.testing.assert_array_equal(g, w, err_msg=tag)


def _state(cfg=None, compression=None, seed=0):
    cfg = cfg or tconfigs.smoke_config(ARCH)
    return ttrain.init_train_state(cfg, ttrain.TrainConfig(compression=compression), seed=seed,
                                   device="cpu")


def _tensors(state):
    """Every tensor of a port ``TrainState``, in a fixed order."""
    return ([p for p in state.params.parameters()] + [state.opt.step] + state.opt.master
            + state.opt.mu + state.opt.nu + list(state.error_feedback))


def _randomise(state, seed):
    """Fill the optimizer state and the error feedback with draws (the
    step 5, nu positive), so no leaf is a constant."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        state.opt.step.fill_(5)
        for lst, scale in ((state.opt.master, 0.02), (state.opt.mu, 1e-3), (state.opt.nu, 1e-6),
                           (state.error_feedback, 1e-4)):
            for t in lst:
                t.copy_(torch.randn(t.shape, generator=gen) * scale)
        for t in state.opt.nu:
            t.abs_()
    return state


def _port_cfg(arch, dtype):
    return dataclasses.replace(tconfigs.smoke_config(arch), dtype=dtype)


def _jax_cfg(arch, dtype):
    return dataclasses.replace(jsmoke_config(arch), dtype=dtype)


def _jax_state(jcfg, seed=0):
    """A JAX int8 ``TrainState`` of numpy draws in ``init_train_state``'s
    shapes and dtypes (norm-free draws are enough for a file format)."""
    like = jax.eval_shape(lambda: jtrain.init_train_state(
        jcfg, jtrain.TrainConfig(compression="int8"), jax.random.key(0)))
    rng = np.random.default_rng(seed)

    def draw(spec):
        if spec.shape == ():
            return np.asarray(3, spec.dtype)
        return (rng.standard_normal(spec.shape) * 0.02).astype(spec.dtype)

    return jax.tree.map(draw, like), like


# ------------------------------------------- the JAX package's tests, ported
def test_save_restore_roundtrip(tmp_path):
    state = _randomise(_state(compression="int8"), seed=1)
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 7, state, extra={"pipeline_step": 7})
    restored, step, extra = restore_checkpoint(d, _state(compression="int8", seed=3))
    assert step == 7 and extra["pipeline_step"] == 7
    for a, b in zip(_tensors(state), _tensors(restored), strict=True):
        assert a.dtype == b.dtype
        _same(b, a)


def test_latest_step_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 5, 9):
        mgr.save(s, {"x": torch.tensor([s])})
    assert latest_step(str(tmp_path)) == 9
    assert sorted(os.listdir(tmp_path)) == ["step_00000005", "step_00000009"]


def test_async_save(tmp_path):
    """The snapshot is taken at ``save``: a state changed in place while the
    write runs does not reach the checkpoint; a writer's error is raised
    at the next ``wait``."""
    state = _state()
    before = [t.clone() for t in _tensors(state)]
    mgr = CheckpointManager(str(tmp_path), save_async=True)
    snap = mgr.save(3, state)
    with torch.no_grad():
        for p in state.params.parameters():
            p.add_(1.0)
    mgr.wait()
    assert snap.nbytes == sum(t.numel() * t.element_size() for t in before)
    restored, step, _ = mgr.restore(_state(seed=4))
    assert step == 3
    for a, b in zip(before, _tensors(restored), strict=True):
        _same(b, a)
    blocked = tmp_path / "file"
    blocked.write_text("not a directory")
    bad = CheckpointManager(str(blocked), save_async=True)
    bad.save(1, {"x": torch.ones(2)})
    with pytest.raises(OSError):
        bad.wait()


def test_interrupted_save_never_corrupts(tmp_path):
    """A stale temp dir must not shadow or break the good checkpoint."""
    d = str(tmp_path)
    save_checkpoint(d, 1, {"x": torch.tensor([1.0])})
    os.makedirs(os.path.join(d, ".tmp_save_dead"), exist_ok=True)  # crashed writer
    restored, step, _ = restore_checkpoint(d, {"x": torch.tensor([0.0])})
    assert step == 1 and float(restored["x"][0]) == 1.0


def test_structure_mismatch_rejected(tmp_path):
    save_checkpoint(str(tmp_path), 0, {"a": torch.ones(3)})
    with pytest.raises(ValueError):
        restore_checkpoint(str(tmp_path), {"b": torch.ones(3)})
    with pytest.raises(ValueError, match="float64"):  # same path, another dtype
        restore_checkpoint(str(tmp_path), {"a": torch.ones(3, dtype=torch.float64)})
    with pytest.raises(ValueError, match=r"\(4,\)"):  # same path, another shape
        restore_checkpoint(str(tmp_path), {"a": torch.ones(4)})
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), {"a": torch.ones(3)})


def test_elastic_restore_resumes_training(tmp_path):
    """Save mid-training, restore into a fresh state, continue: the restored
    run matches the continuous run (pure-function steps)."""
    cfg = tconfigs.smoke_config(ARCH)
    tcfg = ttrain.TrainConfig(peak_lr=1e-3, warmup_steps=2, total_steps=20)
    pipe = TokenPipeline(cfg.vocab_size, 16, 4, seed=5)
    step = ttrain.make_train_step(cfg, tcfg)

    def batch(s):
        return [torch.from_numpy(a).long() for a in pipe.batch_at(s)]

    state = ttrain.init_train_state(cfg, tcfg, seed=0, device="cpu")
    losses = []
    for s in range(6):
        if s == 3:
            save_checkpoint(str(tmp_path), s, state)
        state, m = step(state, *batch(s))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    state2, ck_step, _ = restore_checkpoint(
        str(tmp_path), ttrain.init_train_state(cfg, tcfg, seed=1, device="cpu"))
    assert ck_step == 3 and int(state2.opt.step) == 3
    for s in range(ck_step, 6):
        state2, _ = step(state2, *batch(s))
    for a, b in zip(_tensors(state), _tensors(state2), strict=True):
        np.testing.assert_allclose(b.detach().float().numpy(), a.detach().float().numpy(),
                                   atol=RESUME_TOL, rtol=0)


# ------------------------------------------------------- one format for both
@pytest.mark.parametrize("arch,dtype", CROSS)
def test_port_restores_a_jax_checkpoint(tmp_path, arch, dtype):
    """A JAX ``save_checkpoint`` of a JAX int8 ``TrainState`` restored by the
    port equals ``params_from_jax`` + ``adamw_state_from_jax`` (and the
    error feedback's ``jax_leaf``s) bit for bit."""
    jstate, _ = _jax_state(_jax_cfg(arch, dtype))
    jsave(str(tmp_path), 3, jstate, extra={"pipeline_step": 3})
    cfg = _port_cfg(arch, dtype)
    state, step, extra = restore_checkpoint(str(tmp_path), _state(cfg, "int8", seed=2))
    assert step == 3 and extra == {"pipeline_step": 3}
    want = params_from_jax(cfg, jstate.params, device="cpu")
    opt = adamw_state_from_jax(want, jstate.opt)
    assert int(state.opt.step) == int(opt.step) == 3
    for i, ((name, got), ref) in enumerate(zip(state.params.named_parameters(),
                                               want.parameters(), strict=True)):
        assert got.dtype == ref.dtype == cfg.param_dtype
        _same(got, ref, name)
        for lst, ref_lst in ((state.opt.master, opt.master), (state.opt.mu, opt.mu),
                             (state.opt.nu, opt.nu)):
            _same(lst[i], ref_lst[i], name)
        _same(state.error_feedback[i], jax_leaf(jstate.error_feedback, name), name)


@pytest.mark.parametrize("arch,dtype", CROSS)
def test_jax_restores_a_port_checkpoint(tmp_path, arch, dtype):
    """A port checkpoint is restored by the JAX package's
    ``restore_checkpoint(d, like)``: the same path list in the same order,
    the same dtypes, every leaf bit for bit (each layer's tensor at its
    index of the stacked leaf)."""
    cfg = _port_cfg(arch, dtype)
    state = _randomise(_state(cfg, "int8", seed=1), seed=2)
    save_checkpoint(str(tmp_path), 5, state, extra={"pipeline_step": 5})
    _, like = _jax_state(_jax_cfg(arch, dtype))
    with open(tmp_path / "step_00000005" / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["paths"] == _flatten_with_paths(like)[0]
    restored, step, extra = jrestore(str(tmp_path), like)
    assert step == 5 and extra == {"pipeline_step": 5}
    assert int(restored.opt.step) == 5 and restored.opt.step.dtype == np.int32
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(like), strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
    for i, (name, p) in enumerate(state.params.named_parameters()):
        _same(jax_leaf(restored.params, name), p, name)
        for tree, lst in ((restored.opt.master, state.opt.master), (restored.opt.mu, state.opt.mu),
                          (restored.opt.nu, state.opt.nu),
                          (restored.error_feedback, state.error_feedback)):
            _same(jax_leaf(tree, name), lst[i], name)


def test_launcher_resumes_after_a_deadline_exit(tmp_path):
    """``launch/train.py`` as a user runs it: a run whose second step
    exceeds ``--step-deadline-s`` exits with code 42 after its step-0
    checkpoint is written (``--ckpt-every 1``); ``--resume`` (``--ckpt-every
    2``) continues from step 1 to the end; its final checkpoint equals an
    uninterrupted run's state within 1e-6."""
    d = str(tmp_path / "ckpt")
    flags = ["--arch", "tinyllama-1.1b", "--smoke", "--device", "cpu", "--steps", "6",
             "--batch", "2", "--seq", "16"]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))

    def run(*extra):
        return subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *flags, *extra],
                              capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)

    first = run("--ckpt-dir", d, "--ckpt-every", "1", "--step-deadline-s", "1e-9")
    assert first.returncode == tlaunch.DEADLINE_EXIT, first.stdout + first.stderr
    assert "step 1 exceeded deadline" in first.stdout
    assert latest_step(d) == 0
    second = run("--ckpt-dir", d, "--ckpt-every", "2", "--resume")
    assert second.returncode == 0, second.stdout + second.stderr
    assert "resumed from step 0" in second.stdout
    assert [ln.split()[1] for ln in second.stdout.splitlines() if ln.startswith("step")] == \
        ["1", "2", "3", "4", "5"]
    assert latest_step(d) == 5
    with contextlib.redirect_stdout(io.StringIO()):
        whole = tlaunch.main(flags)
    cfg = tconfigs.smoke_config(ARCH)
    resumed, step, extra = restore_checkpoint(d, _state(cfg, seed=7))
    assert step == 5 and extra == {"pipeline_step": 5}
    for a, b in zip(_tensors(whole), _tensors(resumed), strict=True):
        np.testing.assert_allclose(b.detach().float().numpy(), a.detach().float().numpy(),
                                   atol=RESUME_TOL, rtol=0)


def test_launcher_deadline_times_the_step_alone(tmp_path, monkeypatch):
    """The deadline holds a step, not the checkpoint before it: on the
    launcher's clock every save takes 100 s more (its host snapshot and
    each ``wait`` for the writer, which ``save`` makes first), and a
    deadline of 50 s, far above a smoke step's time, does not trip
    (``--ckpt-every 1`` saves after every step); no step's printed time
    includes a save."""
    save_s, offset = 100.0, [0.0]

    class Clock:  # the launcher's ``time``: the real clock plus the saves' extra time
        @staticmethod
        def perf_counter():
            return time.perf_counter() + offset[0]

    def slow_snapshot(state):
        if not isinstance(state, tstore.HostSnapshot):  # the copy in ``save``, not the writer's
            offset[0] += save_s
        return real_snapshot(state)

    def slow_wait(self):
        real_wait(self)
        offset[0] += save_s

    real_snapshot, real_wait = tstore.host_snapshot, tstore.CheckpointManager.wait
    monkeypatch.setattr(tlaunch, "time", Clock)
    monkeypatch.setattr(tstore, "host_snapshot", slow_snapshot)
    monkeypatch.setattr(tstore.CheckpointManager, "wait", slow_wait)
    flags = ["--arch", "tinyllama-1.1b", "--smoke", "--device", "cpu", "--steps", "3",
             "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path / "ckpt"),
             "--ckpt-every", "1", "--step-deadline-s", str(save_s / 2)]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        state = tlaunch.main(flags)
    assert int(state.opt.step) == 3 and offset[0] >= 8 * save_s, (offset, out.getvalue())
    assert latest_step(str(tmp_path / "ckpt")) == 2
    ms = [float(ln.split()[5][:-2]) for ln in out.getvalue().splitlines() if ln.startswith("step")]
    assert len(ms) == 3 and max(ms) < save_s / 2 * 1e3, ms


# -------------------------------------------------------------- spec parity
def _jax_spec(tree, name):
    keys, _ = jax_key(name)
    for key in keys:
        tree = tree[key]
    return tuple(tree)


def _got(spec, name):
    return spec.stacked() if jax_key(name)[1] is not None else tuple(spec)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_jax(arch):
    """``param_specs``, ``state_specs`` (mixtral's ZeRO-1 among them) and
    ``batch_specs`` of the published config equal the JAX package's over
    ``AbstractMesh`` at (1,1), (2,2), (4,2), (8,) and (2,16,16): each port
    tensor's spec, with its layer entry in front for a layer's, is its JAX
    leaf's, and every JAX leaf has a port tensor."""
    _check_specs(arch, {})


@pytest.mark.parametrize("variant", ["dp_only", "dp_only_zero1"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_dp_only_specs_match_jax(arch, variant):
    """The same with ``sharding_strategy="dp_only"`` (the parameters
    replicated, the batch split over every mesh axis), without and with
    ZeRO-1, as the JAX package's ``launch/perf.py`` sets it."""
    _check_specs(arch, SPEC_VARIANTS[variant])


def _check_specs(arch, change):
    cfg = dataclasses.replace(tconfigs.get_config(arch), **change)
    jcfg = dataclasses.replace(jget_config(arch), **change)
    zero1_layers = 0
    for sizes, names in MESHES:
        jmesh = AbstractMesh(sizes, names)
        mesh = dict(zip(names, sizes))
        jp, tp = jspecs.param_specs(jcfg, jmesh), tspecs.param_specs(cfg, mesh)
        assert len({jax_key(n)[0] for n in tp}) == len(
            jax.tree.leaves(jp, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
        js, ts = jspecs.state_specs(jcfg, jmesh), tspecs.state_specs(cfg, mesh)
        assert tuple(js.opt.step) == tuple(ts.opt.step) == () and js.error_feedback == ts.error_feedback == ()
        for name in tp:
            assert _got(tp[name], name) == _jax_spec(jp, name), (arch, sizes, name)
            assert _got(ts.params[name], name) == _jax_spec(js.params, name), (arch, sizes, name)
            for field in ("master", "mu", "nu"):
                got = _got(getattr(ts.opt, field)[name], name)
                assert got == _jax_spec(getattr(js.opt, field), name), (arch, sizes, name, field)
            zero1_layers += getattr(ts.opt.master[name], "layer", None) is not None
        jb, tb = jspecs.batch_specs(jcfg, jmesh), tspecs.batch_specs(cfg, mesh)
        assert {k: tuple(v) for k, v in jb.items()} == {k: tuple(v) for k, v in tb.items()}
    assert (zero1_layers > 0) == cfg.zero1, (arch, zero1_layers)


def test_zero1_splits_mixtral_layers_over_data():
    """The JAX package's example: at data 2, mixtral's
    ``opt.master['layers']['moe']['w_gate']`` is P('data', None, None,
    'model'); the port's per-layer tensor keeps (None, None, 'model') and
    splits its layers over ``data``."""
    mesh = {"data": 2, "model": 2}
    spec = tspecs.state_specs(tconfigs.get_config("mixtral_8x7b"), mesh).opt.master[
        "layers.5.moe.w_gate"]
    assert tuple(spec) == (None, None, "model") and spec.layer == "data"
    assert spec.stacked() == tuple(jspecs.state_specs(
        jget_config("mixtral_8x7b"), AbstractMesh((2, 2), ("data", "model"))
    ).opt.master["layers"]["moe"]["w_gate"])


SLICING = """
from jax.sharding import NamedSharding, PartitionSpec as P
from repro_torch import configs as TC
from repro_torch.checkpoint.elastic import holds_layer, shard_slices
from repro_torch.models.convert import jax_key
from repro_torch.models.model import Model
from repro_torch.sharding import specs as TS

def norm(slices, shape):
    return tuple(s.indices(n)[:2] for s, n in zip(slices, shape))

checked = 0
for sizes, names in (((4, 2), ("data", "model")), ((2, 2, 2), ("pod", "data", "model")),
                     ((8,), ("data",)), ((2, 4), ("data", "model"))):
    mesh = make_mesh(sizes, names)
    shape_of = dict(zip(names, sizes))
    cases = [((16, 24), ("model", None)), ((16, 24), (("data", "model"), None)),
             ((16, 24), (None, ("model", "data"))), ((8, 6, 4), ("data",)), ((5,), (None,)),
             ((32, 4, 8), (tuple(names), None, None))]
    for arch in ("mixtral_8x7b", "qwen3_1p7b", "hymba_1p5b", "seamless_m4t_medium"):
        cfg = TC.get_config(arch)
        st = TS.state_specs(cfg, shape_of)
        counts = {"layers": cfg.n_layers, "enc_layers": cfg.encoder_layers}
        for name, p in Model(cfg, device="meta").named_parameters():
            keys, layer = jax_key(name)
            if layer not in (None, 0):
                continue
            for spec in (st.params[name], st.opt.master[name]):
                if layer is None:
                    cases.append((tuple(p.shape), tuple(spec)))
                    continue
                L = counts[keys[0]]
                want = NamedSharding(mesh, P(*spec.stacked())).devices_indices_map((L, *p.shape))
                for dev, idx in want.items():
                    coord = dict(zip(names, (int(c) for c in np.argwhere(mesh.devices == dev)[0])))
                    held = [i for i in range(L) if holds_layer(spec, i, L, shape_of, coord)]
                    lo, hi = idx[0].indices(L)[:2]
                    assert held == list(range(lo, hi)), (arch, name, sizes, coord, held, idx)
                    got = norm(shard_slices(tuple(p.shape), spec, shape_of, coord), p.shape)
                    assert got == norm(idx[1:], p.shape), (arch, name, sizes, coord, got, idx)
                    checked += 1
    for shape, spec in cases:
        axes = {a for e in spec if e is not None for a in ((e,) if isinstance(e, str) else e)}
        if not axes <= set(names):
            continue
        want = NamedSharding(mesh, P(*spec)).devices_indices_map(shape)
        for dev, idx in want.items():
            coord = dict(zip(names, (int(c) for c in np.argwhere(mesh.devices == dev)[0])))
            got = norm(shard_slices(shape, spec, shape_of, coord), shape)
            assert got == norm(idx, shape), (shape, spec, sizes, coord, got, idx)
            checked += 1
print("CHECKED", checked)
"""


def test_shard_slices_match_named_sharding(multi_device_host):
    """``elastic.shard_slices`` (and ``holds_layer`` for ZeRO-1's layer
    split) give every device of a forced 8-device host the block that
    ``NamedSharding(mesh, spec).devices_indices_map(shape)`` gives it: the
    specs of four archs' states and hand-picked specs with multi-axis
    entries, on four meshes.  Nothing is compiled."""
    out = multi_device_host(SLICING, devices=8, timeout=600)
    assert int(out.split("CHECKED")[1]) > 1000
