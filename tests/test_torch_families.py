"""The port's ssm, hybrid, encdec and vlm families against the JAX package, on the CPU.

mamba2 (ssm: the SSD mixer alone), hymba (hybrid: attention and SSD heads
side by side; GQA with 2 kv heads for 4 query heads and a prompt longer
than its 16-slot window, so the cache is the ring's roll and decode wraps
it), seamless-m4t (encdec: a non-causal encoder over 20 frames and decoder
cross-attention over its 20-slot memory, longer than the 12-token prompt)
and internvl2 (vlm: 8 patch embeddings in place of the first positions), at
smoke size.  Inputs come from numpy seeds and go to both sides; weights are
the JAX package's ``init_params`` tree, carried into the port by
``models.convert.params_from_jax``.  The JAX side runs its Pallas attention
kernel in interpret mode (``attention_impl="flash_pallas"``), the port K5's
plain version (``"flash"`` on the CPU).  Everything is fp32.

Tolerance: ``LOGIT_TOL`` = 2e-5 for logits, caches and the SSD mixer's
outputs and states, as in ``tests/test_torch_lm.py``.  The SSD scan adds
sums whose order may differ between the libraries (``jnp.cumsum`` and
``torch.cumsum`` over a chunk, the three-operand state einsum); the largest
difference seen is 3e-7, inside it.  Greedy tokens and positions: equal.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.models import config as jconfig  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.serving import serve_loop as jserve  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import config as tconfig  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving import serve_loop as tserve_loop  # noqa: E402

LOGIT_TOL = 2e-5


def _close(got, want, tol=LOGIT_TOL):
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(want, np.float32), atol=tol, rtol=tol
    )


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _weights(jcfg, seed=0):
    """The JAX package's init tree as numpy, with every norm scale set to 1
    (its init draws them from N(0, 0.02), as in ``tests/test_torch_lm.py``);
    the SSD mixer's ``A_log``, ``dt_bias`` and ``Dskip`` keep their draws.
    Both sides get this tree."""
    params = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.key(seed)))
    for stack in (params["layers"], params.get("enc_layers")):
        if stack is None:
            continue
        for leaf in (stack, stack.get("attn", {}), stack.get("ssm", {})):
            for name in ("ln1", "ln2", "ln_cross", "q_norm", "k_norm", "norm"):
                if name in leaf:
                    leaf[name] = np.ones_like(leaf[name])
    return params


# ---------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_count_matches_the_formula_and_the_jax_tree(arch):
    """The port's ``Model`` (on the meta device: nothing is allocated) holds
    ``cfg.n_params()`` parameters for the published and the smoke config,
    and as many as the JAX package's ``init_params`` tree at smoke size
    (the counterpart of ``tests/test_models.py``'s formula test)."""
    for cfg in (tconfigs.get_config(arch), tconfigs.smoke_config(arch)):
        model = TM.Model(cfg, device="meta")
        assert sum(p.numel() for p in model.parameters()) == cfg.n_params(), cfg.name
    jtree = jax.eval_shape(lambda: JM.init_params(jsmoke_config(arch), jax.random.key(0)))
    assert sum(x.size for x in jax.tree.leaves(jtree)) == tconfigs.smoke_config(arch).n_params()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_jax(arch):
    """Every input of every kind, the frontends' stub embeddings among them,
    has the JAX package's shape; the specs are meta tensors (no data), the
    embeddings in the parameter dtype, the tokens in the port's int64."""
    cfg, jcfg = tconfigs.get_config(arch), jget_config(arch)
    for kind, S, B in (("train", 4096, 8), ("prefill", 2048, 4), ("decode", 32768, 128)):
        got = tconfig.input_specs(cfg, tconfig.ShapeConfig(kind, S, B, kind))
        want = jconfig.input_specs(jcfg, jconfig.ShapeConfig(kind, S, B, kind))
        assert set(got) == set(want), (kind, set(got), set(want))
        for name, spec in got.items():
            assert spec.device.type == "meta"
            assert tuple(spec.shape) == tuple(want[name].shape), (kind, name)
            assert spec.dtype == (cfg.param_dtype if name == "frontend_embeds" else torch.int64)


def test_every_family_is_ported():
    assert set(TM.PORTED_FAMILIES) == set(tconfig.FAMILIES)


# -------------------------------------------------------------- SSD mixer
def _family(arch, over):
    jcfg = dataclasses.replace(jsmoke_config(arch), attention_impl="flash_pallas", **over)
    tcfg = dataclasses.replace(tconfigs.smoke_config(arch), attention_impl="flash", **over)
    return jcfg, tcfg


def _ssm_case(cfg, seed=0):
    """Random SSD mixer weights N(0, 0.1) with A_log = 0 (A = -1: stable
    dynamics), as ``tests/test_ssm.py`` draws them: (JAX dict, port module)."""
    rng = np.random.default_rng(seed)
    jp = {name: (rng.standard_normal(shape) * 0.1).astype(np.float32)
          for name, shape in JS.ssm_params_shape(cfg).items()}
    jp["A_log"] = np.zeros_like(jp["A_log"])
    tp = TS.SSM(cfg, "cpu", torch.float32)
    with torch.no_grad():
        for name, p in tp.named_parameters():
            p.copy_(_t(jp[name]))
    return jax.tree.map(jnp.asarray, jp), tp


@pytest.mark.parametrize("chunk", [4, 8, 24])
def test_ssd_parallel_matches_jax(chunk):
    """The chunked scan over S = 27 (a ragged last chunk at 4, 8 and 24,
    padded with dt = 0), from zeros and from a given state: y and the final
    state."""
    jcfg, cfg = _family("mamba2-1.3b", {"ssm_chunk": chunk})
    jp, tp = _ssm_case(cfg)
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 27, cfg.d_model)) * 0.5).astype(np.float32)
    h0 = (rng.standard_normal((2, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)) * 0.1)
    h0 = h0.astype(np.float32)
    for start in (None, h0):
        jy, jh = JS.ssd_parallel(jcfg, jp, jnp.asarray(x), None if start is None else jnp.asarray(start))
        with torch.no_grad():
            ty, th = TS.ssd_parallel(cfg, tp, _t(x), None if start is None else _t(start))
        _close(ty, jy)
        _close(th, jh)
        assert th.dtype == torch.float32


@pytest.mark.parametrize("S", [27, 2])
def test_ssd_prefill_cache_matches_jax(S):
    """The prefill's output and cache: the conv tail (S = 2 pads it with a
    zero row in front), the state and the length."""
    jcfg, cfg = _family("hymba-1.5b", {})
    jp, tp = _ssm_case(cfg, seed=2)
    x = (np.random.default_rng(3).standard_normal((2, S, cfg.d_model)) * 0.5).astype(np.float32)
    jy, jc = JS.ssd_prefill(jcfg, jp, jnp.asarray(x))
    with torch.no_grad():
        ty, tc = TS.ssd_prefill(cfg, tp, _t(x))
    _close(ty, jy)
    _close(tc.conv, jc.conv)
    _close(tc.state, jc.state)
    assert tc.conv.shape == (2, TS.CONV_K - 1, cfg.d_inner + 2 * cfg.ssm_state)
    assert int(tc.length) == int(jc.length) == S
    if S < TS.CONV_K - 1:
        assert not tc.conv[:, : TS.CONV_K - 1 - S].any()


def test_ssd_decode_matches_jax_in_place():
    """Three recurrent steps from a random cache: each step's output, and
    the conv tail and state, which the port updates in place (the same
    storage) and the JAX package returns anew."""
    jcfg, cfg = _family("mamba2-1.3b", {})
    jp, tp = _ssm_case(cfg, seed=4)
    rng = np.random.default_rng(5)
    conv = rng.standard_normal((2, TS.CONV_K - 1, cfg.d_inner + 2 * cfg.ssm_state)).astype(np.float32)
    state = (rng.standard_normal((2, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)) * 0.1)
    jc = JS.SSMCache(conv=jnp.asarray(conv), state=jnp.asarray(state.astype(np.float32)),
                     length=jnp.asarray(5, jnp.int32))
    tc = TS.SSMCache(conv=_t(conv).clone(), state=_t(state.astype(np.float32)).clone(),
                     length=torch.tensor(5, dtype=torch.int32))
    ptrs = (tc.conv.data_ptr(), tc.state.data_ptr())
    for step in range(3):
        x = (rng.standard_normal((2, 1, cfg.d_model)) * 0.5).astype(np.float32)
        jy, jc = JS.ssd_decode(jcfg, jp, jnp.asarray(x), jc)
        with torch.no_grad():
            ty = TS.ssd_decode(cfg, tp, _t(x), tc)
        _close(ty, jy)
        _close(tc.conv, jc.conv)
        _close(tc.state, jc.state)
    assert (tc.conv.data_ptr(), tc.state.data_ptr()) == ptrs
    assert int(tc.length) == 5  # the caller advances the position


# ------------------------------------------------------------------ model
# (arch, config overrides, prompt length, frontend length): see the module
# docstring.
FAMILY_CASES = [
    ("mamba2-1.3b", {}, 27, 0),
    ("hymba-1.5b", {"n_kv_heads": 2}, 24, 0),
    ("seamless-m4t-medium", {}, 12, 20),
    ("internvl2-2b", {}, 12, 8),
]
DECODE_STEPS = 4


def _caches(state):
    """A decode state's caches by name, on either side (the JAX package's
    ``DecodeState`` has the same fields but the position)."""
    out = {}
    if state.kv is not None:
        out.update({"kv.k": state.kv.k, "kv.v": state.kv.v})
    if state.ssm is not None:
        out.update({"ssm.conv": state.ssm.conv, "ssm.state": state.ssm.state})
    if state.cross_kv is not None:
        out.update({"cross.k": state.cross_kv[0], "cross.v": state.cross_kv[1]})
    return out


def _assert_same_caches(tstate, jstate):
    got, want = _caches(tstate), _caches(jstate)
    assert set(got) == set(want)
    for name in got:
        assert tuple(got[name].shape) == tuple(want[name].shape), name
        _close(got[name], want[name])


@pytest.mark.parametrize("arch,over,S,flen", FAMILY_CASES)
def test_family_model_matches_jax(arch, over, S, flen):
    """Prefill logits, every cache (KV ring, SSM conv tails and states, cross
    memory) and the position, 4 decode steps' logits and the caches after
    them, and greedy tokens, against the JAX package with the same
    weights; the state's caches share its one position tensor."""
    jcfg, tcfg = _family(arch, over)
    params = _weights(jcfg)
    jparams = jax.tree.map(jnp.asarray, params)
    model = params_from_jax(tcfg, params, device="cpu")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, tcfg.vocab_size, (2, S + DECODE_STEPS)).astype(np.int32)
    fe = None
    if flen:
        fe = rng.standard_normal((2, flen, tcfg.d_model)).astype(np.float32)
    jfe = None if fe is None else jnp.asarray(fe)
    tfe = None if fe is None else _t(fe)

    jlog, jstate = JM.prefill(jcfg, jparams, jnp.asarray(toks[:, :S]), jfe,
                              max_len=S + DECODE_STEPS)
    tlog, tstate = TM.prefill(tcfg, model, _t(toks[:, :S]).long(), tfe, max_len=S + DECODE_STEPS)
    _close(tlog, jlog)
    _assert_same_caches(tstate, jstate)
    assert int(tstate.position) == S
    for cache in (tstate.kv, tstate.ssm):
        assert cache is None or cache.length is tstate.position
    if tcfg.sliding_window:
        assert tstate.kv.k.shape[2] == tcfg.sliding_window < S  # the roll
    if tcfg.family == "encdec":
        assert tstate.cross_kv[0].shape[2] == flen != S  # the memory, unpadded

    jdecode = jax.jit(functools.partial(JM.decode_step, jcfg))
    for t in range(DECODE_STEPS):
        tok = toks[:, S + t: S + t + 1]
        jlog, jstate = jdecode(jparams, jnp.asarray(tok), jstate)
        tlog, advanced = TM.decode_step(tcfg, model, _t(tok).long(), tstate)
        assert advanced is tstate
        _close(tlog, jlog)
    _assert_same_caches(tstate, jstate)
    assert int(tstate.position) == S + DECODE_STEPS

    jgen = jserve.greedy_generate(jcfg, jparams, jnp.asarray(toks[:, :S]), 6, jfe)
    tgen = tserve_loop.greedy_generate(tcfg, model, _t(toks[:, :S]).long(), 6, tfe)
    np.testing.assert_array_equal(tgen.numpy(), np.asarray(jgen))


@pytest.mark.parametrize("arch,over", [("mamba2-1.3b", {}), ("hymba-1.5b", {"n_kv_heads": 2})])
def test_decode_agrees_with_longer_prefill(arch, over):
    """Decode steps against the caches give the logits of a prefill of the
    longer prompt (for mamba2 the SSD duality through the model: the
    recurrent step against the chunked scan; hymba's decode wraps its
    16-slot ring), and hymba's naive route agrees with its flash route."""
    _, tcfg = _family(arch, over)
    model = TM.init_params(tcfg, seed=3, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, tcfg.vocab_size, (2, 23)))
    S, extra = 19, 4
    logits, state = TM.prefill(tcfg, model, toks[:, :S], max_len=S + extra)
    if tcfg.has_attention:
        naive = dataclasses.replace(tcfg, attention_impl="naive")
        _close(TM.prefill(naive, model, toks[:, :S], max_len=S + extra)[0], logits)
    for t in range(extra):
        logits, state = TM.decode_step(tcfg, model, toks[:, S + t: S + t + 1], state)
        want, _ = TM.prefill(tcfg, model, toks[:, : S + t + 1])
        _close(logits, want)


def test_init_params_sets_only_norm_scales_to_one():
    """Norm scales are 1; every other parameter, the SSD mixer's A_log,
    dt_bias and Dskip among them, is drawn N(0, 0.02) like the matrices."""
    cfg = tconfigs.smoke_config("hymba-1.5b")
    model = TM.init_params(cfg, seed=0, device="cpu")
    drawn = []
    for name, p in model.named_parameters():
        if name.rsplit(".", 1)[-1] in TM.NORM_SCALES:
            assert torch.equal(p, torch.ones_like(p)), name
        else:
            assert p.abs().max() < 0.15 and p.std() > 0, name
            drawn.append(p.flatten())
    assert 0.0195 < float(torch.cat(drawn).std()) < 0.0205
    names = {n for n, _ in model.named_parameters()}
    assert {"layers.0.ssm.norm", "layers.0.ssm.A_log", "layers.0.ssm.dt_bias",
            "layers.0.ssm.Dskip"} <= names


def test_encdec_state_is_sized_to_the_memory():
    """The cross memory is never padded: a state needs the encoder's length,
    and a prefill refuses a state sized to another one, as it refuses a
    prefill without frames."""
    cfg = tconfigs.smoke_config("seamless-m4t-medium")
    model = TM.init_params(cfg, seed=1, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 10)))
    frames = torch.from_numpy(
        np.random.default_rng(7).standard_normal((2, 14, cfg.d_model)).astype(np.float32))
    with pytest.raises(ValueError, match="memory_len"):
        TM.make_decode_state(cfg, 2, 12, device="cpu")
    with pytest.raises(ValueError, match="frontend_embeds"):
        TM.prefill(cfg, model, toks, max_len=12)
    want, fresh = TM.prefill(cfg, model, toks, frames, max_len=12)
    out = TM.make_decode_state(cfg, 2, 12, device="cpu", memory_len=14)
    got, state = TM.prefill(cfg, model, toks, frames, max_len=12, out=out)
    assert state is out and torch.equal(got, want)
    for name, t in TM.state_tensors(state).items():
        assert torch.equal(t, TM.state_tensors(fresh)[name]), name
    with pytest.raises(ValueError, match="out state"):
        TM.prefill(cfg, model, toks, frames, max_len=12,
                   out=TM.make_decode_state(cfg, 2, 12, device="cpu", memory_len=12))
