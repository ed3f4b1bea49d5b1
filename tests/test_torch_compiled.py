"""What the port's compiled serving steps rest on, against the JAX package, on the CPU.

On the card the LM decode step and the BST engine's bound queries run as
CUDA graphs (``repro_torch.graphs``; their tests are in
``tests/test_torch_cuda.py``).  A graph replays fixed addresses and reads
nothing on the host, so the step must take its position from the device
and the engine must keep its delta buffer at fixed addresses.  On the CPU
both steps run eagerly, through the same code.  Tolerances: logits and
caches 2e-5, as in ``tests/test_torch_lm.py`` (the same fp32 ops in another
library, over 2 layers and a 503-wide unembedding); positions, tokens and
BST answers equal.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import delta as TD  # noqa: E402
from repro_torch.core.engine import PAPER_CONFIGS, BSTEngine  # noqa: E402
from repro_torch.data.keysets import make_tree_data  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving import serve_loop as tserve_loop  # noqa: E402

LOGIT_TOL = 2e-5


def _close(got, want, tol=LOGIT_TOL):
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(want, np.float32), atol=tol, rtol=tol
    )


def _weights(jcfg, seed=0):
    """The JAX package's init tree as numpy with every norm scale 1, as in
    ``tests/test_torch_lm.py``: both sides get this tree."""
    params = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.key(seed)))
    lay = params["layers"]
    for leaf in (lay, lay.get("attn", {})):
        for name in ("ln1", "ln2", "q_norm", "k_norm"):
            if name in leaf:
                leaf[name] = np.ones_like(leaf[name])
    return params


def _assert_position(state, want: int):
    length = state.kv.length
    assert isinstance(length, torch.Tensor) and length.dim() == 0
    assert length.dtype == torch.int32 and length.device == state.kv.k.device
    assert int(length) == want


# (arch, window, prompt, steps): qwen3 with a full cache, qwen3 with a
# 16-slot ring that decode wraps (positions 12 .. 19), and mixtral (moe,
# its own window of 16) wrapped the same way.
DECODE_CASES = [
    ("qwen3-1.7b", None, 10, 6),
    ("qwen3-1.7b", 16, 12, 8),
    ("mixtral-8x7b", 16, 12, 8),
]


@pytest.mark.parametrize("arch,window,S,steps", DECODE_CASES)
def test_decode_with_the_position_on_the_device_matches_jax(arch, window, S, steps):
    """Prefill, then decode steps across the ring's wrap: every step's
    logits against the JAX package's ``decode_step`` with the same weights;
    the position is a 0-d int32 tensor on the caches' device after the
    prefill and after every step, advanced in place; the caches equal JAX's
    at the end."""
    jcfg = dataclasses.replace(jsmoke_config(arch), sliding_window=window)
    tcfg = dataclasses.replace(tconfigs.smoke_config(arch), sliding_window=window)
    params = _weights(jcfg)
    jparams = jax.tree.map(jnp.asarray, params)
    model = params_from_jax(tcfg, params, device="cpu")
    toks = np.random.default_rng(7).integers(0, tcfg.vocab_size, (2, S + steps)).astype(np.int32)
    jprefill = jax.jit(functools.partial(JM.prefill, jcfg, max_len=S + steps))
    jdecode = jax.jit(functools.partial(JM.decode_step, jcfg))

    jlog, jstate = jprefill(jparams, jnp.asarray(toks[:, :S]))
    tlog, state = TM.prefill(tcfg, model, torch.from_numpy(toks[:, :S]).long(), max_len=S + steps)
    _close(tlog, jlog)
    _assert_position(state, S)
    for t in range(steps):
        tok = toks[:, S + t: S + t + 1]
        jlog, jstate = jdecode(jparams, jnp.asarray(tok), jstate)
        tlog, advanced = TM.decode_step(tcfg, model, torch.from_numpy(tok).long(), state)
        assert advanced is state
        _close(tlog, jlog)
        _assert_position(state, S + t + 1)
        assert np.all(np.asarray(jstate.kv.length) == S + t + 1)  # one per layer there
    if window is not None:
        assert state.kv.k.shape[2] == window < S + steps  # the ring wrapped
    _close(state.kv.k, jstate.kv.k)
    _close(state.kv.v, jstate.kv.v)


def test_prefill_writes_into_the_state_it_is_given():
    """``prefill(out=state)`` gives the logits, caches and position of a
    fresh prefill in ``state`` itself (a graphed decode step reads its
    addresses), and refuses a state of another shape."""
    cfg = tconfigs.smoke_config("mixtral-8x7b")
    model = TM.init_params(cfg, seed=2, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 20)))
    want, fresh = TM.prefill(cfg, model, toks, max_len=24)
    out = TM.make_decode_state(cfg, 2, 24, device="cpu")
    out.kv.k.fill_(7.0)
    ptr = out.kv.k.data_ptr()
    got, state = TM.prefill(cfg, model, toks, max_len=24, out=out)
    assert state is out and state.kv.k.data_ptr() == ptr
    assert torch.equal(got, want)
    assert torch.equal(state.kv.k, fresh.kv.k) and torch.equal(state.kv.v, fresh.kv.v)
    _assert_position(state, 20)
    with pytest.raises(ValueError, match="out state"):
        TM.prefill(cfg, model, toks, max_len=24, out=TM.make_decode_state(cfg, 1, 24, "cpu"))


def test_eager_route_gives_the_same_tokens_on_the_cpu():
    """``eager=True`` names the route the card takes only on request; on
    the CPU both routes are the eager ops and give the same tokens."""
    cfg = tconfigs.smoke_config("qwen3-1.7b")
    model = TM.init_params(cfg, seed=4, device="cpu")
    prompt = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 9)))
    a = tserve_loop.greedy_generate(cfg, model, prompt, 5)
    b = tserve_loop.greedy_generate(cfg, model, prompt, 5, eager=True)
    assert a.shape == (2, 5) and torch.equal(a, b)


@pytest.mark.parametrize("name", ["Hrz", "Dup4", "Hyb8q"])
def test_engine_keeps_its_delta_buffer_at_fixed_addresses(name):
    """Ingests and compactions copy into one buffer and one set of kernel
    operands, whose addresses the query graphs read: every field keeps its
    storage, the operands stay those of the buffer, and every op's answer
    through ``query``, ``query_static`` and the eager route agree."""
    keys, values = make_tree_data(4095, seed=1)
    cfg = dataclasses.replace(PAPER_CONFIGS[name], device="cpu", delta_capacity=64)
    eng = BSTEngine(keys, values, cfg)
    ptrs = [t.data_ptr() for t in (*eng.delta, *eng._delta_ops)]
    rng = np.random.default_rng(2)
    q = rng.choice(np.concatenate([keys, keys + 1]), 700).astype(np.int32)
    for _ in range(3):
        wk = rng.integers(1, 2 * keys.size, 50).astype(np.int32)
        eng.apply_ops(wk, wk, rng.random(50) < 0.3)
        assert [t.data_ptr() for t in (*eng.delta, *eng._delta_ops)] == ptrs
        for got, want in zip(eng._delta_ops, TD.operands(eng.delta)):
            assert torch.equal(got, want)
        for op, args in (("lookup", (q,)), ("predecessor", (q,)), ("successor", (q,)),
                         ("range_count", (q[:300], q[:300] + 30)),
                         ("range_scan", (q[:300], q[:300] + 30))):
            results = [eng.query(op, *args), eng.query_static(op, *args),
                       eng.query(op, *args, eager=True)]
            results = [r if isinstance(r, tuple) else (r,) for r in results]
            for r in results[1:]:
                assert all(torch.equal(a, b) for a, b in zip(results[0], r))
    assert eng.compactions >= 1
