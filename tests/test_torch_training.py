"""The port's training substrate against the JAX package, on the CPU.

The token pipeline (bit for bit), the optimizer's functions on the same
inputs, one train step from the same weights and state, microbatch
accumulation, a resume from the JAX package's own mid-run ``AdamWState``
carried across by ``adamw_state_from_jax``, the memorise-one-batch run the
JAX package's ``tests/test_training.py`` makes, the data-parallel step at
world 1, and the launcher at smoke size with its checkpoints.  Everything is fp32 at smoke size (tinyllama, as the JAX package's
training tests use); the JAX step is jitted once per microbatch count (the
module fixture ``jax_steps``).

Tolerances: the optimizer's functions within 1e-6 (atol = rtol; elementwise
fp32 on both sides, the global norm summed in another order).  A train
step: the loss within 1e-5, the gradients (read as the first moment, which
after one step is (1 - b1) times the clipped gradient) within 1e-5 of
their scale, and the updated parameters within the JAX package's own
accumulation tolerance (atol 5e-3, rtol 5e-2, ``tests/test_training.py``):
a first AdamW step moves a parameter by about lr sign(g), so a gradient
near 0 that rounds the other way moves it by 2 lr.
"""

import contextlib
import importlib
import io
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.data.pipeline import TokenPipeline as JTokenPipeline  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import optimizer as jopt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.analysis import gate  # noqa: E402
from repro_torch.data.pipeline import TokenPipeline  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models.convert import adamw_state_from_jax, jax_leaf, params_from_jax  # noqa: E402
from repro_torch.optim import optimizer as topt  # noqa: E402

# The packages re-export the function ``train_loop``, which hides the module
# of the same name from ``from ... import``.
jtrain = importlib.import_module("repro.training.train_loop")
ttrain = importlib.import_module("repro_torch.training.train_loop")

ARCH = "tinyllama_1p1b"
OPT_TOL = 1e-6
LOSS_TOL = 1e-5
GRAD_TOL = 1e-5
STEP_ATOL, STEP_RTOL = 5e-3, 5e-2  # tests/test_training.py's accumulation tolerance
BATCH, SEQ = 8, 16


def _close(got, want, atol, rtol=None):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=atol, rtol=atol if rtol is None else rtol)


def _close_scaled(got, want, tol, name=""):
    """Within ``tol`` of the tensor's scale element by element, and max
    |got - want| at most ``tol`` times max |want|: a gradient's test
    whatever its scale."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max(initial=0.0)
    _close(got, want, tol * max(1.0, scale), tol)
    assert scale > 0, f"{name}: the reference is all zero"
    err = np.abs(got - want).max(initial=0.0)
    assert err <= tol * scale, f"{name}: max |diff| {err!r} > {tol} x max |want| {scale!r}"


def _weights(jcfg, seed=0):
    """A tree of the JAX ``init_params`` shapes as numpy: norm scales 1,
    every other leaf N(0, 0.02) from numpy."""
    rng = np.random.default_rng(seed)

    def draw(path, spec):
        if path[-1].key in ("ln1", "ln2", "q_norm", "k_norm", "final_norm"):
            return np.ones(spec.shape, np.float32)
        return (rng.standard_normal(spec.shape) * 0.02).astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        draw, jax.eval_shape(lambda: JM.init_params(jcfg, jax.random.key(0))))


def _tcfg(mb=1):
    return ttrain.TrainConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10, microbatches=mb)


def _jtcfg(mb=1):
    return jtrain.TrainConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10, microbatches=mb)


@pytest.fixture(scope="module")
def jax_steps():
    """microbatches -> the JAX package's jitted train step (no donation)."""
    jcfg = jsmoke_config(ARCH)
    cache = {}

    def get(mb):
        if mb not in cache:
            cache[mb] = jtrain.make_train_step(jcfg, _jtcfg(mb), donate=False)
        return cache[mb]

    return get


def _batch(step, seed=1):
    return TokenPipeline(tconfigs.smoke_config(ARCH).vocab_size, SEQ, BATCH, seed=seed).batch_at(step)


def _port_state(params_np, opt_np=None):
    cfg = tconfigs.smoke_config(ARCH)
    model = params_from_jax(cfg, params_np, device="cpu", trainable=True)
    opt = (topt.adamw_init(list(model.parameters())) if opt_np is None
           else adamw_state_from_jax(model, opt_np))
    return ttrain.TrainState(model, opt, [])


def _port_step(state, step, mb=1):
    cfg = tconfigs.smoke_config(ARCH)
    tokens, labels = (torch.from_numpy(a).long() for a in _batch(step))
    return ttrain.make_train_step(cfg, _tcfg(mb))(state, tokens, labels)


def _check_state(state, jstate, moments=True):
    """The port's parameters within the step tolerance of the JAX state's,
    and (``moments``) its first moments within GRAD_TOL of their scale
    (``_close_scaled``)."""
    mu = jax.tree.map(np.asarray, jstate.opt.mu)
    for i, (name, p) in enumerate(state.params.named_parameters()):
        _close(p.detach().numpy(), jax_leaf(jax.tree.map(np.asarray, jstate.params), name),
               STEP_ATOL, STEP_RTOL)
        if moments:
            _close_scaled(state.opt.mu[i].numpy(), jax_leaf(mu, name), GRAD_TOL, name)


# ------------------------------------------------------------------ pipeline
def test_pipeline_is_the_jax_packages_bit_for_bit():
    """The same tokens and labels for every (seed, host, step): numpy's
    Philox on both sides."""
    for seed, host, count in ((0, 0, 1), (42, 1, 2), (7, 3, 4)):
        mine = TokenPipeline(1000, 12, 8, seed=seed, host_index=host, host_count=count)
        theirs = JTokenPipeline(1000, 12, 8, seed=seed, host_index=host, host_count=count)
        for step in (0, 1, 17, 1000):
            for a, b in zip(mine.batch_at(step), theirs.batch_at(step)):
                assert a.dtype == b.dtype == np.int32
                np.testing.assert_array_equal(a, b)
    it_mine, it_theirs = iter(TokenPipeline(50, 4, 2)), iter(JTokenPipeline(50, 4, 2))
    for _ in range(3):
        np.testing.assert_array_equal(next(it_mine)[0], next(it_theirs)[0])


def test_pipeline_stateless_resume_and_host_sharding():
    pipe = TokenPipeline(1000, seq_len=8, global_batch=4, seed=42)
    np.testing.assert_array_equal(pipe.batch_at(17)[0], pipe.batch_at(17)[0])
    p0 = TokenPipeline(1000, 8, 4, seed=42, host_index=0, host_count=2)
    p1 = TokenPipeline(1000, 8, 4, seed=42, host_index=1, host_count=2)
    assert p0.local_batch == 2
    assert not np.array_equal(p0.batch_at(3)[0], p1.batch_at(3)[0])
    toks, labs = TokenPipeline(1000, seq_len=8, global_batch=2).batch_at(0)
    np.testing.assert_array_equal(toks[:, 1:], labs[:, :-1])
    with pytest.raises(ValueError):
        _ = TokenPipeline(1000, 8, 5, host_count=2).local_batch


# ----------------------------------------------------------------- optimizer
def test_optimizer_functions_match_jax():
    """``adamw_init``, ``cosine_schedule``, ``clip_by_global_norm`` and two
    ``adamw_update`` steps (weight decay on, a clipped gradient) on the same
    inputs as the JAX package's."""
    rng = np.random.default_rng(0)
    shapes = ((3, 5), (7,), (2, 2, 4))
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) * 3 for s in shapes] for _ in range(2)]
    for s in (0, 3, 9, 10, 55, 100, 130):
        _close(float(topt.cosine_schedule(torch.tensor(s, dtype=torch.int32), 2e-3, 10, 100)),
               float(jopt.cosine_schedule(jnp.asarray(s, jnp.int32), 2e-3, 10, 100)), OPT_TOL)
    mine = topt.adamw_init([torch.from_numpy(p) for p in params])
    theirs = jopt.adamw_init({str(i): jnp.asarray(p) for i, p in enumerate(params)})
    assert int(mine.step) == int(theirs.step) == 0
    for step_grads in grads:
        clipped, gn = topt.clip_by_global_norm([torch.from_numpy(g) for g in step_grads], 1.0)
        jclipped, jgn = jopt.clip_by_global_norm(
            {str(i): jnp.asarray(g) for i, g in enumerate(step_grads)}, 1.0)
        _close(float(gn), float(jgn), OPT_TOL)
        for i, c in enumerate(clipped):
            _close(c.numpy(), np.asarray(jclipped[str(i)]), OPT_TOL)
        lr = topt.cosine_schedule(mine.step, 0.1, 1, 10)
        new, mine = topt.adamw_update(clipped, mine, lr, weight_decay=0.1,
                                      compute_dtype=torch.float32)
        jnew, theirs = jopt.adamw_update(jclipped, theirs, jopt.cosine_schedule(
            theirs.step, 0.1, 1, 10), weight_decay=0.1, compute_dtype=jnp.float32)
        assert int(mine.step) == int(theirs.step)
        for i in range(len(shapes)):
            for got, want in ((new[i], jnew[str(i)]), (mine.mu[i], theirs.mu[str(i)]),
                              (mine.nu[i], theirs.nu[str(i)]),
                              (mine.master[i], theirs.master[str(i)])):
                _close(got.numpy(), np.asarray(want), OPT_TOL)


def test_adamw_reference_behaviour():
    """The JAX package's own optimizer checks, on the port: a first step
    moves by about lr against the gradient; weight decay pulls toward 0;
    the clip and the schedule's shape; bf16 parameters come back bf16 over
    fp32 masters, which keep a step too small for bf16."""
    state = topt.adamw_init([torch.full((4,), 2.0)])
    (p1,), state = topt.adamw_update([torch.ones(4)], state, torch.tensor(0.1),
                                     weight_decay=0.0, compute_dtype=torch.float32)
    _close(p1.numpy(), 1.9, 1e-3)
    (p2,), _ = topt.adamw_update([torch.ones(4)], topt.adamw_init([torch.full((4,), 2.0)]),
                                 torch.tensor(0.1), weight_decay=1.0, compute_dtype=torch.float32)
    assert float(p2[0]) < float(p1[0])
    clipped, gn = topt.clip_by_global_norm([torch.full((3,), 100.0)], 1.0)
    assert abs(float(torch.linalg.norm(clipped[0])) - 1.0) < 1e-5 and float(gn) > 100
    lrs = [float(topt.cosine_schedule(torch.tensor(s), 1.0, 10, 100)) for s in range(100)]
    assert abs(lrs[0] - 0.1) < 1e-6 and abs(lrs[9] - 1.0) < 0.01
    assert lrs[99] < 0.2 and all(lr > 0 for lr in lrs)
    assert all(b <= a + 1e-6 for a, b in zip(lrs[10:], lrs[11:]))
    state = topt.adamw_init([torch.full((2,), 1.0, dtype=torch.bfloat16)])
    (p,), state = topt.adamw_update([torch.ones(2, dtype=torch.bfloat16)], state,
                                    torch.tensor(1e-4), weight_decay=0.0)
    assert p.dtype == torch.bfloat16 and float(p[0]) == 1.0  # 1 - 1e-4 rounds to 1 in bf16
    assert state.master[0].dtype == torch.float32 and float(state.master[0][0]) < 1.0


# ---------------------------------------------------------------- train step
def test_train_step_matches_jax(jax_steps):
    """One step of the port's ``make_train_step`` against the JAX package's
    from the same weights and batch: the metrics, the gradients (as the
    first moments) and the updated parameters."""
    jcfg = jsmoke_config(ARCH)
    params = _weights(jcfg)
    jstate = jtrain.TrainState(params=params, opt=jopt.adamw_init(params), error_feedback=())
    jstate, jmetrics = jax_steps(1)(jstate, *map(jnp.asarray, _batch(0)))
    state, metrics = _port_step(_port_state(params), 0)
    assert set(metrics) == set(jmetrics) == {"loss", "moe_dropped", "grad_norm", "lr"}
    for key in ("loss", "moe_dropped", "grad_norm", "lr"):
        _close(float(metrics[key]), float(jmetrics[key]), LOSS_TOL)
    assert int(state.opt.step) == int(jstate.opt.step) == 1
    _check_state(state, jstate)
    for p in state.params.parameters():
        assert p.grad is None and p.requires_grad


def test_microbatch_accumulation_matches_one_batch_and_jax(jax_steps):
    """microbatches=4 equals microbatches=1 on the same global batch (the
    JAX package's ``test_grad_accumulation_equivalence``), and the JAX
    package's 4-microbatch step."""
    jcfg = jsmoke_config(ARCH)
    params = _weights(jcfg, seed=2)
    one, m1 = _port_step(_port_state(params), 0, mb=1)
    four, m4 = _port_step(_port_state(params), 0, mb=4)
    _close(float(m4["loss"]), float(m1["loss"]), LOSS_TOL)
    _close(float(m4["grad_norm"]), float(m1["grad_norm"]), LOSS_TOL)
    for (name, a), b in zip(one.params.named_parameters(), four.params.parameters()):
        _close(b.detach().numpy(), a.detach().numpy(), STEP_ATOL, STEP_RTOL)
    for (name, _), a, b in zip(one.params.named_parameters(), one.opt.mu, four.opt.mu):
        _close_scaled(b.numpy(), a.numpy(), GRAD_TOL, name)
    jstate = jtrain.TrainState(params=params, opt=jopt.adamw_init(params), error_feedback=())
    jstate, jm = jax_steps(4)(jstate, *map(jnp.asarray, _batch(0)))
    _close(float(m4["loss"]), float(jm["loss"]), LOSS_TOL)
    _check_state(four, jstate)


def test_resume_from_a_carried_jax_state(jax_steps):
    """The JAX package trains two steps; the port resumes from its state
    after the first (weights by ``params_from_jax``, the optimizer by
    ``adamw_state_from_jax``) and takes the second: the same metrics, step
    counter, moments and parameters."""
    jcfg = jsmoke_config(ARCH)
    params = _weights(jcfg, seed=3)
    jstate = jtrain.TrainState(params=params, opt=jopt.adamw_init(params), error_feedback=())
    jstate, _ = jax_steps(1)(jstate, *map(jnp.asarray, _batch(0)))
    mid = jax.tree.map(np.asarray, jstate)
    jstate, jm = jax_steps(1)(jstate, *map(jnp.asarray, _batch(1)))
    state = _port_state(mid.params, mid.opt)
    assert int(state.opt.step) == 1
    state, m = _port_step(state, 1)
    for key in ("loss", "grad_norm", "lr"):
        _close(float(m[key]), float(jm[key]), LOSS_TOL)
    assert int(state.opt.step) == 2
    _check_state(state, jstate, moments=False)
    nu = jax.tree.map(np.asarray, jstate.opt.nu)
    for i, (name, _) in enumerate(state.params.named_parameters()):
        _close(state.opt.nu[i].numpy(), jax_leaf(nu, name), GRAD_TOL)


def test_loss_decreases_memorising_one_batch():
    """The JAX package's ``test_loss_decreases_over_steps`` on the port:
    25 steps on one fixed batch take the loss well below its start near
    ln(V), every loss finite."""
    cfg = tconfigs.smoke_config(ARCH)
    tcfg = ttrain.TrainConfig(peak_lr=3e-3, warmup_steps=2, total_steps=30)

    class FixedBatch:
        def __init__(self, pipe):
            self._b = pipe.batch_at(0)

        def batch_at(self, step):
            return self._b

    pipe = FixedBatch(TokenPipeline(cfg.vocab_size, seq_len=32, global_batch=4, seed=0))
    _, hist = ttrain.train_loop(cfg, tcfg, pipe, steps=25, device="cpu")
    first = hist[0]["loss"]
    last = np.mean([h["loss"] for h in hist[-5:]])
    assert abs(first - np.log(cfg.vocab_size)) < 0.05
    assert last < first - 0.5, (first, last)
    assert all(np.isfinite(h["loss"]) for h in hist)


def test_single_device_options():
    """int8 compression allocates the error-feedback zeros (one per
    parameter, as the JAX package does) and the one-device step ignores
    it; a mesh takes the data-parallel step (at world 1 over gloo the plain
    step's loss and gradient norm, the error feedback updated), and the
    pjit step at world 1 (every tensor whole, compression ignored as the
    JAX package's pjit step does) is the plain step."""
    cfg = tconfigs.smoke_config(ARCH)
    tcfg = ttrain.TrainConfig(compression="int8")
    state = ttrain.init_train_state(cfg, tcfg, seed=0, device="cpu")
    params = list(state.params.parameters())
    assert len(state.error_feedback) == len(params)
    for e, p in zip(state.error_feedback, params):
        assert e.shape == p.shape and e.dtype == torch.float32 and not e.any()
    assert ttrain.init_train_state(cfg, ttrain.TrainConfig(), device="cpu").error_feedback == []
    tokens, labels = (torch.from_numpy(a).long() for a in _batch(0))
    plain, m_plain = ttrain.make_train_step(cfg, tcfg)(
        ttrain.init_train_state(cfg, tcfg, seed=0, device="cpu"), tokens, labels)
    assert not any(e.any() for e in plain.error_feedback)
    with gate.world1_group("cpu"):
        mesh = make_host_mesh(device_type="cpu")
        pjit_state = ttrain.init_train_state(cfg, tcfg, seed=0, device="cpu")
        _, m_pjit = ttrain.make_train_step(cfg, tcfg, mesh=mesh)(pjit_state, tokens, labels)
        assert not any(e.any() for e in pjit_state.error_feedback)
        state, m = ttrain.make_train_step(cfg, tcfg, mesh=mesh, mode="dp_shard_map")(
            state, tokens, labels)
    for key in ("loss", "grad_norm"):
        _close(float(m_pjit[key]), float(m_plain[key]), LOSS_TOL)
    _close(float(m["loss"]), float(m_plain["loss"]), LOSS_TOL)
    _close(float(m["grad_norm"]), float(m_plain["grad_norm"]), 2e-2)  # int8-quantized gradients
    assert all(e.any() for e in state.error_feedback)


def test_launch_train_smoke_on_cpu(tmp_path):
    """``launch/train.py --smoke --device cpu`` trains and prints each
    step's loss, gradient norm, learning rate, ms and tok/s; with
    ``--ckpt-dir`` it saves every ``--ckpt-every`` steps and at the end,
    and ``--resume`` continues from the latest checkpoint."""
    out = io.StringIO()
    ckpt = str(tmp_path / "ckpt")
    args = ["--arch", "tinyllama-1.1b", "--smoke", "--device", "cpu", "--batch", "2",
            "--seq", "16", "--ckpt-dir", ckpt, "--ckpt-every", "2"]
    with contextlib.redirect_stdout(out):
        state = tlaunch.main([*args, "--steps", "3"])
    lines = [ln for ln in out.getvalue().splitlines() if ln.startswith("step")]
    assert len(lines) == 3
    for ln in lines:
        assert all(key in ln for key in ("loss=", "gnorm=", "lr=", "ms", "tok/s"))
    assert int(state.opt.step) == 3
    assert sorted(os.listdir(ckpt)) == ["step_00000001", "step_00000002"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        state = tlaunch.main([*args, "--steps", "5", "--resume"])
    assert "resumed from step 2" in out.getvalue()
    assert [ln.split()[1] for ln in out.getvalue().splitlines() if ln.startswith("step")] == \
        ["3", "4"]
    assert int(state.opt.step) == 5
    assert sorted(os.listdir(ckpt)) == ["step_00000001", "step_00000002", "step_00000003",
                                        "step_00000004"][-3:]


@pytest.mark.parametrize("arch", ["internvl2-2b", "seamless-m4t-medium"])
def test_launch_train_feeds_the_frontend(arch):
    """The launcher hands a vlm's patch embeddings and an encdec's frontend
    memory to every step (``train_loop``'s ``frontend``): one smoke step
    with a finite loss and gradient norm."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        state = tlaunch.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "1",
                              "--batch", "2", "--seq", "16"])
    (line,) = [ln for ln in out.getvalue().splitlines() if ln.startswith("step")]
    loss = float(line.split("loss=")[1].split()[0])
    gnorm = float(line.split("gnorm=")[1].split()[0])
    assert np.isfinite(loss) and np.isfinite(gnorm) and gnorm > 0
    assert int(state.opt.step) == 1
