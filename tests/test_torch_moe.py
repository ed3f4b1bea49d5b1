"""The port's MoE serving path against the JAX package, on the CPU.

Inputs come from numpy seeds and go to both sides.  On the CPU the port's
dispatch runs K4's plain version (``ref.queue_dispatch_ref``); the JAX side
runs its Pallas kernel in interpret mode, its plain version and
``repro.core.buffers``.  Tolerances, each with its reason:

* integer plans (K4's plain version, every function of ``core/buffers.py``)
  and ``dropped``: equal;
* ``moe_ffn`` outputs: 1e-5 (fp32: the same products and softmax in
  another library, in another summation order);
* model logits: 2e-5, as in ``tests/test_torch_lm.py`` (such differences in
  attention and every matrix product, over 2 layers and a 503-wide
  unembedding); greedy tokens: equal.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.core import buffers as JB  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.queue_dispatch import queue_dispatch_pallas  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.serving import serve_loop as jserve  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import buffers as TB  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving import serve_loop as tserve_loop  # noqa: E402

MOE_TOL = 1e-5
LOGIT_TOL = 2e-5

# The JAX side, jitted with its size arguments static: one compile per
# shape, where eager JAX compiles every primitive and retraces every scan
# (most of this file's time); the functions compute the same.
pallas_qd = jax.jit(queue_dispatch_pallas, static_argnums=(1, 2, 3))
jref_qd = jax.jit(jref.queue_dispatch_ref, static_argnums=(1, 2))
jqueue = jax.jit(JB.queue_dispatch, static_argnums=(1, 2))
jdirect = jax.jit(JB.direct_dispatch, static_argnums=(1, 2))
jdispatch = jax.jit(JB.dispatch, static_argnums=(0, 2, 3))
jgather = jax.jit(JB.gather_from_buffers, static_argnums=(2,))
jcombine = jax.jit(JB.combine_to_chunk, static_argnums=(2, 3))


def _jax_moe_ffn(cfg, params, x):
    return jax.jit(functools.partial(jmoe.moe_ffn, cfg))(params, x)

# (n_dest, capacity, lanes): the JAX package's sweep (tests/test_kernels.py).
SWEEP = [(2, 2, 16), (8, 16, 128), (16, 8, 64), (4, 1, 33)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), w)


def _close(got, want, tol):
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(want, np.float32), atol=tol, rtol=tol
    )


def _numpy_queue_model(dest, n_dest, capacity):
    """The paper's serial labeling network (Fig. 6), one lane at a time:
    the plan ``(slot, kept, buffers, counts, overflow)``."""
    buffers = np.full((n_dest, capacity), -1, np.int32)
    counts = np.zeros(n_dest, np.int32)
    slot = np.full(len(dest), -1, np.int32)
    overflow = np.zeros(len(dest), bool)
    for i, d in enumerate(dest):
        if d < 0:
            continue
        if counts[d] < capacity:
            buffers[d, counts[d]] = i
            slot[i] = counts[d]
            counts[d] += 1
        else:
            overflow[i] = True
    return slot, slot >= 0, buffers, counts, overflow


def _skewed(skew, size, rng):
    if skew == "all_one_dest":
        return np.zeros(size, np.int32)
    if skew == "two_hot":
        return rng.choice(np.array([1, 2], np.int32), size)
    if skew == "mixed_inactive":
        return rng.choice(np.array([-1, 0, 0, 0, 3], np.int32), size)
    return np.full(size, -1, np.int32)  # all_inactive


# ------------------------------------------------------- K4's plain version
# K4's plan is (slot, kept, buffers, counts, overflow): the JAX package's
# DispatchPlan, whose last three fields are the Pallas kernel's outputs.
@pytest.mark.parametrize("n_dest,capacity,size", SWEEP)
def test_queue_dispatch_ref_matches_pallas_and_buffers(n_dest, capacity, size):
    rng = np.random.default_rng(size)
    dest = rng.integers(-1, n_dest, size=size).astype(np.int32)
    got = tops.queue_dispatch(_t(dest), n_dest, capacity)
    assert got[1].dtype == torch.bool and got[4].dtype == torch.bool
    _equal(got[2:], pallas_qd(jnp.asarray(dest), n_dest, capacity, True))
    _equal(got[2:], jref_qd(jnp.asarray(dest), n_dest, capacity))
    _equal(got, tuple(jqueue(jnp.asarray(dest), n_dest, capacity)))


@pytest.mark.parametrize("skew", ["all_one_dest", "two_hot", "mixed_inactive", "all_inactive"])
def test_queue_dispatch_ref_overflow_skews(skew):
    """Overflow past capacity: flagged, never placed, never counted, FIFO
    among the kept lanes -- as the Pallas kernel and the serial model say."""
    n_dest, capacity, size = 4, 3, 40
    dest = _skewed(skew, size, np.random.default_rng(17))
    got = tref.queue_dispatch_ref(_t(dest), n_dest, capacity)
    _equal(got[2:], pallas_qd(jnp.asarray(dest), n_dest, capacity, True))
    _equal(got, _numpy_queue_model(dest, n_dest, capacity))
    assert bool(got[4].any()) == (skew != "all_inactive")


def test_queue_dispatch_ref_takes_group_rows_and_clips_like_the_kernel():
    """A (G, B) call equals G row calls; a dest >= n_dest counts as
    n_dest - 1, as the Pallas kernel (and K4) clip it."""
    rng = np.random.default_rng(3)
    n_dest, capacity = 8, 5
    dest = rng.integers(-1, n_dest, size=(6, 50)).astype(np.int32)
    dest[2] = -1  # an all-inactive row
    got = tops.queue_dispatch(_t(dest), n_dest, capacity)
    assert tuple(got[2].shape) == (6, n_dest, capacity)
    for g in range(dest.shape[0]):
        _equal([o[g] for o in got][2:], pallas_qd(jnp.asarray(dest[g]), n_dest, capacity, True))
        _equal([o[g] for o in got], _numpy_queue_model(dest[g], n_dest, capacity))
    wide = rng.integers(-1, n_dest + 4, size=70).astype(np.int32)
    got = tops.queue_dispatch(_t(wide), n_dest, capacity)
    _equal(got[2:], pallas_qd(jnp.asarray(wide), n_dest, capacity, True))
    _equal(got, _numpy_queue_model(np.minimum(wide, n_dest - 1), n_dest, capacity))


# (what, n_dest, capacity, shape of dest): the JAX sweep, the overflow
# skews, group rows (the MoE prefill's 8 x 80 among them), rows of B not a
# multiple of a warp (up to the kernel's narrow limit of 32 destinations),
# and B = 0.
PLAN_CASES = [
    *(("sweep", n, c, (b,)) for n, c, b in SWEEP),
    *((skew, 4, 3, (40,)) for skew in ("all_one_dest", "two_hot", "mixed_inactive",
                                       "all_inactive")),
    ("rows", 8, 5, (3, 50)),
    ("rows", 8, 80, (2, 512)),
    ("ragged", 8, 3, (2, 45)),
    ("ragged", 32, 2, (1, 100)),
    ("empty", 4, 3, (0,)),
    ("empty", 8, 2, (2, 0)),
]


@pytest.mark.parametrize("what,n_dest,capacity,shape", PLAN_CASES,
                         ids=[f"{c[0]}-{c[1]}x{c[2]}-{'x'.join(map(str, c[3]))}"
                              for c in PLAN_CASES])
def test_queue_dispatch_plan_matches_jax(what, n_dest, capacity, shape):
    """All five outputs of ``ops.queue_dispatch`` (K4's plan): slot and kept
    against the JAX package's ``core.buffers.queue_dispatch``, buffers,
    counts and overflow against the Pallas kernel in interpret mode (which
    takes no B = 0: there, all five against the JAX plan), row by row."""
    rng = np.random.default_rng(sum(shape) + n_dest)
    if what in ("sweep", "rows", "ragged", "empty"):
        dest = rng.integers(-1, n_dest, size=shape).astype(np.int32)
    else:
        dest = _skewed(what, shape[0], rng)
    got = tops.queue_dispatch(_t(dest), n_dest, capacity)
    lead = shape[:-1]
    assert [tuple(o.shape) for o in got] == [shape, shape, lead + (n_dest, capacity),
                                             lead + (n_dest,), shape]
    assert [o.dtype for o in got] == [torch.int32, torch.bool, torch.int32, torch.int32,
                                      torch.bool]
    n_rows = int(np.prod(lead))
    for g, row in enumerate(dest.reshape(n_rows, shape[-1])):
        mine = [o.reshape((n_rows,) + tuple(o.shape[len(lead):]))[g] for o in got]
        plan = jqueue(jnp.asarray(row), n_dest, capacity)
        _equal(mine[:2], (plan.slot, plan.kept))
        if row.size == 0:
            _equal(mine[2:], (plan.buffers, plan.counts, plan.overflow))
        else:
            _equal(mine[2:], pallas_qd(jnp.asarray(row), n_dest, capacity, True))


def test_queue_dispatch_rejects_bad_operands_on_the_cpu():
    dest = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        tops.queue_dispatch(dest.long(), 4, 2)
    with pytest.raises(ValueError, match=r"\(G, B\)"):
        tops.queue_dispatch(dest.reshape(2, 2, 2), 4, 2)
    with pytest.raises(ValueError, match="contiguous"):
        tops.queue_dispatch(dest.reshape(2, 4).t(), 4, 2)
    with pytest.raises(ValueError, match=">= 1"):
        tops.queue_dispatch(dest, 4, 0)


# ---------------------------------------------------------- core/buffers.py
def _plan_equal(got, want):
    _equal(got, tuple(want))
    assert got._fields == want._fields


@pytest.mark.parametrize("n_dest,capacity,size", SWEEP + [(4, 3, 40)])
def test_buffers_match_jax(n_dest, capacity, size):
    rng = np.random.default_rng(size + 1)
    dest = rng.integers(-1, n_dest, size=size).astype(np.int32)
    active = rng.random(size) > 0.2
    base = rng.integers(-1, capacity + 1, size=n_dest).astype(np.int32)
    occupied = rng.random((n_dest, capacity)) > 0.7
    jd, ja = jnp.asarray(dest), jnp.asarray(active)
    td, ta = _t(dest), _t(active)
    _plan_equal(TB.queue_dispatch(td, n_dest, capacity), jqueue(jd, n_dest, capacity))
    _plan_equal(TB.queue_dispatch(td, n_dest, capacity, active=ta),
                jqueue(jd, n_dest, capacity, active=ja))
    _plan_equal(TB.queue_dispatch(td, n_dest, capacity, active=ta, base=_t(base)),
                jqueue(jd, n_dest, capacity, active=ja, base=jnp.asarray(base)))
    _plan_equal(TB.direct_dispatch(td, n_dest, capacity, active=ta),
                jdirect(jd, n_dest, capacity, active=ja))
    _plan_equal(TB.direct_dispatch(td, n_dest, capacity, occupied=_t(occupied)),
                jdirect(jd, n_dest, capacity, occupied=jnp.asarray(occupied)))
    for mapping in ("queue", "direct"):
        _plan_equal(TB.dispatch(mapping, td, n_dest, capacity),
                    jdispatch(mapping, jd, n_dest, capacity))
    with pytest.raises(ValueError, match="unknown mapping"):
        TB.dispatch("ring", td, n_dest, capacity)

    plan = jqueue(jd, n_dest, capacity)
    items = rng.standard_normal((size, 3)).astype(np.float32)
    per_dest = jgather(jnp.asarray(items), plan.buffers, -2.0)
    got = TB.gather_from_buffers(_t(items), _t(plan.buffers), fill_value=-2.0)
    _equal([got], [per_dest])
    _equal([TB.combine_to_chunk(got, _t(plan.buffers), size, fill_value=7.0)],
           [jcombine(per_dest, plan.buffers, size, 7.0)])


def test_dispatch_takes_group_rows():
    """One (G, B) call of every dispatch function equals G row calls, as the
    JAX package's vmap over groups gives them."""
    rng = np.random.default_rng(9)
    n_dest, capacity = 4, 6
    dest = rng.integers(-1, n_dest, size=(3, 40)).astype(np.int32)
    base = rng.integers(0, 3, size=(3, n_dest)).astype(np.int32)
    occupied = rng.random((3, n_dest, capacity)) > 0.6
    for got, fn in (
        (TB.queue_dispatch(_t(dest), n_dest, capacity),
         lambda g: jqueue(jnp.asarray(dest[g]), n_dest, capacity)),
        (TB.queue_dispatch(_t(dest), n_dest, capacity, base=_t(base)),
         lambda g: jqueue(jnp.asarray(dest[g]), n_dest, capacity, base=jnp.asarray(base[g]))),
        (TB.direct_dispatch(_t(dest), n_dest, capacity, occupied=_t(occupied)),
         lambda g: jdirect(jnp.asarray(dest[g]), n_dest, capacity,
                           occupied=jnp.asarray(occupied[g]))),
    ):
        for g in range(dest.shape[0]):
            _equal([f[g] for f in got], tuple(fn(g)))


# ------------------------------------------------------------------ moe_ffn
def _moe_case(cfg, seed=0):
    """Numpy weights and input for one MoE FFN of ``cfg``: the JAX package's
    dict and the port's ``MoE`` module holding the same numbers."""
    rng = np.random.default_rng(seed)
    params = {name: (rng.standard_normal(shape) * 0.05).astype(np.float32)
              for name, shape in tmoe.moe_params_shape(cfg).items()}
    x = (rng.standard_normal((4, 16, cfg.d_model)) * 0.3).astype(np.float32)
    mod = tmoe.MoE(cfg, "cpu", torch.float32).requires_grad_(False)
    for name, arr in params.items():
        getattr(mod, name).copy_(_t(arr))
    return params, mod, x


@pytest.mark.parametrize("groups", [None, 2])
@pytest.mark.parametrize("cf", [0.25, 1.25, 4.0])
@pytest.mark.parametrize("mapping", ["queue", "direct"])
def test_moe_ffn_matches_jax(mapping, cf, groups):
    base = jsmoke_config("mixtral_8x7b")
    over = dict(moe_dispatch=mapping, capacity_factor=cf, moe_groups=groups)
    jcfg = dataclasses.replace(base, **over)
    tcfg = dataclasses.replace(tconfigs.smoke_config("mixtral_8x7b"), **over)
    params, mod, x = _moe_case(tcfg)
    want, jdrop = _jax_moe_ffn(jcfg, jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    got, tdrop = tmoe.moe_ffn(tcfg, mod, _t(x))
    assert got.shape == x.shape and got.dtype == torch.float32
    _close(got, want, MOE_TOL)
    assert tdrop.dtype == torch.float32 and tdrop.ndim == 0
    assert float(tdrop) == float(jdrop)
    if cf >= tcfg.n_experts / tcfg.top_k:  # no expert can overflow
        assert float(tdrop) == 0.0


def test_top_k_breaks_ties_as_jax_does():
    """Tied logits pick the lower expert first, as ``jax.lax.top_k`` does:
    on integer-valued logits (many ties), and through the whole MoE FFN with
    tied router columns at a capacity that drops (so the k-major order of
    the choices decides which tokens keep their experts)."""
    logits = np.random.default_rng(4).integers(0, 3, (64, 8)).astype(np.float32)
    logits[0] = 1.0  # every expert tied
    values, idx = tmoe.top_k(_t(logits), 3)
    jvalues, jidx = jax.lax.top_k(jnp.asarray(logits), 3)
    _equal([idx, values], [jidx, jvalues])
    assert idx[0].tolist() == [0, 1, 2]

    cfg = dataclasses.replace(tconfigs.smoke_config("mixtral_8x7b"), capacity_factor=0.5)
    params, mod, x = _moe_case(cfg, seed=2)
    params["router"][:, 2] = params["router"][:, 0]
    params["router"][:, 3] = params["router"][:, 1]
    mod.router.copy_(_t(params["router"]))
    jcfg = dataclasses.replace(jsmoke_config("mixtral_8x7b"), capacity_factor=0.5)
    want, jdrop = _jax_moe_ffn(jcfg, jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    got, tdrop = tmoe.moe_ffn(cfg, mod, _t(x))
    _close(got, want, MOE_TOL)
    assert float(tdrop) == float(jdrop) > 0


# -------------------------------------------------------------------- model
def _weights(jcfg, seed=0):
    """The JAX package's init tree as numpy, norm scales set to 1 (as in
    ``tests/test_torch_lm.py``): both sides get this tree."""
    params = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.key(seed)))
    for name in ("ln1", "ln2"):
        params["layers"][name] = np.ones_like(params["layers"][name])
    return params


def test_smoke_model_matches_jax():
    """mixtral's smoke config (2 layers, 4 experts top-2, window 16): prefill
    logits and caches, 4 decode-step logits (one dispatch group of 2 tokens,
    capacity 1 per expert) and greedy tokens, against the JAX package
    with the same weights; the JAX side attends naively, the port through
    K5's plain version."""
    jcfg = jsmoke_config("mixtral_8x7b")
    tcfg = tconfigs.smoke_config("mixtral_8x7b")
    params = _weights(jcfg)
    jparams = jax.tree.map(jnp.asarray, params)
    model = params_from_jax(tcfg, params, device="cpu")
    S, extra = 24, 4
    toks = np.random.default_rng(5).integers(0, tcfg.vocab_size, (2, S + extra)).astype(np.int32)

    jprefill = jax.jit(functools.partial(JM.prefill, jcfg, max_len=S + extra))
    jdecode = jax.jit(functools.partial(JM.decode_step, jcfg))
    jlog, jstate = jprefill(jparams, jnp.asarray(toks[:, :S]))
    tlog, tstate = TM.prefill(tcfg, model, _t(toks[:, :S]).long(), max_len=S + extra)
    _close(tlog, jlog, LOGIT_TOL)
    _close(tstate.kv.k, jstate.kv.k, LOGIT_TOL)
    _close(tstate.kv.v, jstate.kv.v, LOGIT_TOL)
    for t in range(extra):
        tok = toks[:, S + t: S + t + 1]
        jlog, jstate = jdecode(jparams, jnp.asarray(tok), jstate)
        tlog, tstate = TM.decode_step(tcfg, model, _t(tok).long(), tstate)
        _close(tlog, jlog, LOGIT_TOL)

    jgen = jserve.greedy_generate(jcfg, jparams, jnp.asarray(toks[:, :S]), 5)
    tgen = tserve_loop.greedy_generate(tcfg, model, _t(toks[:, :S]).long(), 5)
    np.testing.assert_array_equal(tgen.numpy(), np.asarray(jgen))


@pytest.mark.parametrize("mapping", ["queue", "direct"])
def test_decode_agrees_with_longer_prefill_at_ample_capacity(mapping):
    """At capacity_factor 4 (= 2 x n_experts / top_k for the smoke config)
    no expert can overflow in prefill or decode, so decode steps against
    the cache give the logits of a prefill of the longer prompt."""
    tcfg = dataclasses.replace(tconfigs.smoke_config("mixtral_8x7b"), capacity_factor=4.0,
                               moe_dispatch=mapping)
    model = TM.init_params(tcfg, seed=3, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, tcfg.vocab_size, (2, 23)))
    S, extra = 20, 3
    logits, state = TM.prefill(tcfg, model, toks[:, :S], max_len=S + extra)
    for t in range(extra):
        logits, state = TM.decode_step(tcfg, model, toks[:, S + t: S + t + 1], state)
        assert all(float(lp.moe.dropped) == 0.0 for lp in model.layers)
        want, _ = TM.prefill(tcfg, model, toks[:, : S + t + 1])
        _close(logits, want, LOGIT_TOL)


def test_moe_serving_entry_point_on_the_cpu(capsys):
    tserve.main(["--arch", "mixtral-8x7b", "--smoke", "--device", "cpu",
                 "--batch", "2", "--prompt-len", "8", "--new-tokens", "4"])
    out = capsys.readouterr().out
    assert "prefill: 2x8" in out and "decode: 4 tokens x 2 seqs" in out


def test_moe_layer_checks_k4_n_dest_at_construction(monkeypatch):
    """On a CUDA device a queue-dispatched MoE layer applies K4's limit on
    its destinations (the experts) before it allocates its weights; the
    limit is patched, so no card is needed."""
    from repro_torch.kernels import queue_dispatch as QD

    monkeypatch.setattr(QD, "max_dest", lambda: 2)
    cfg = tconfigs.smoke_config("mixtral_8x7b")
    assert cfg.moe_dispatch == "queue" and cfg.n_experts > 2
    with pytest.raises(ValueError, match=f"n_dest {cfg.n_experts} is above K4's limit of 2"):
        tmoe.MoE(cfg, "cuda", torch.float32)
    tmoe.MoE(cfg, "cpu", torch.float32)  # the plain version has no limit
    tmoe.MoE(dataclasses.replace(cfg, moe_dispatch="direct"), "meta", torch.float32)
