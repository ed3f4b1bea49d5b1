"""The port's LM serving path against the JAX package, on the CPU.

Inputs come from numpy seeds and go to both sides; weights are the JAX
package's ``init_params`` tree, carried into the port by
``models.convert.params_from_jax``.  On the CPU the port's attention runs
K5's plain version (``ref.flash_attention_ref``); the JAX side runs its
Pallas kernel in interpret mode (``attention_impl="flash_pallas"``).
Everything is fp32.  Tolerances, each with its reason:

* layers: 1e-6 (the same fp32 ops in another library); rope 1e-5 (XLA's
  and torch's pow/cos/sin may differ by an ulp of an angle up to 64 rad);
* attention: 1e-5 (one-pass softmax against the kernel's online softmax
  over 128-wide blocks: other summation orders);
* model logits and caches: 2e-5 (such differences in attention and in every
  matrix product, compounded over 2 layers and a 503-wide unembedding; the
  largest seen is 1e-6); greedy tokens: equal.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import serve_loop as jserve  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.analysis import gate  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving import serve_loop as tserve_loop  # noqa: E402

LAYER_TOL = 1e-6
ROPE_TOL = 1e-5
ATTN_TOL = 1e-5
LOGIT_TOL = 2e-5


def _close(got, want, tol):
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(want, np.float32), atol=tol, rtol=tol
    )


def _t(a):
    return torch.from_numpy(np.asarray(a))


# -------------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_are_the_jax_packages(arch):
    """Every field the port keeps, and n_params, equal the JAX config's, for
    the published config and the smoke config (whose attention_impl is the
    port's own default).  The port's n_params also counts the encdec
    encoder's final norm (d_model scales), which the JAX package's formula
    leaves out and its ``init_params`` makes."""
    for port, ref in ((tconfigs.get_config(arch), jget_config(arch)),
                      (tconfigs.smoke_config(arch), jsmoke_config(arch))):
        for f in dataclasses.fields(port):
            if f.name != "attention_impl":
                assert getattr(port, f.name) == getattr(ref, f.name), (arch, f.name)
        enc_final_norm = ref.d_model if ref.family == "encdec" else 0
        assert port.n_params() == ref.n_params() + enc_final_norm
        assert port.n_active_params() == ref.n_active_params() + enc_final_norm
        assert port.resolved_head_dim == ref.resolved_head_dim
        assert port.has_attention == ref.has_attention
        assert port.supports_long_decode == ref.supports_long_decode
        assert port.param_dtype == getattr(torch, str(ref.param_dtype))
    alias = {v: k for k, v in tconfigs.ALIASES.items()}[arch]
    assert tconfigs.canonical(alias) == arch


# --------------------------------------------------------------------- layers
def test_layers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    _close(tlayers.rms_norm(_t(x), _t(scale), 1e-5),
           jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5), LAYER_TOL)

    pos = rng.integers(0, 64, (2, 5))
    tc, ts = tlayers.rope_angles(_t(pos), 16, 1e6)
    jc, js = jlayers.rope_angles(jnp.asarray(pos), 16, 1e6)
    _close(tc, jc, ROPE_TOL)
    _close(ts, js, ROPE_TOL)
    _close(tlayers.apply_rope(_t(x), tc[:, :, None, :], ts[:, :, None, :]),
           jlayers.apply_rope(jnp.asarray(x), jc[:, :, None, :], js[:, :, None, :]), ROPE_TOL)

    h = rng.standard_normal((2, 5, 8)).astype(np.float32)
    w = [rng.standard_normal(s).astype(np.float32) * 0.3 for s in ((8, 12), (8, 12), (12, 8))]
    _close(tlayers.swiglu(_t(h), *map(_t, w)),
           jlayers.swiglu(jnp.asarray(h), *map(jnp.asarray, w)), LAYER_TOL)

    table = rng.standard_normal((11, 8)).astype(np.float32)
    tok = rng.integers(0, 11, (2, 5))
    _close(tlayers.embed(_t(tok), _t(table)),
           jlayers.embed(jnp.asarray(tok), jnp.asarray(table)), 0.0)
    _close(tlayers.unembed(_t(h), _t(table)),
           jlayers.unembed(jnp.asarray(h), jnp.asarray(table)), LAYER_TOL)


# ------------------------------------------------------------------ attention
@pytest.mark.parametrize("BH,BHkv,Sq,Skv,d,causal,window", [
    (4, 2, 256, 256, 64, True, None),    # GQA causal
    (4, 4, 128, 256, 32, True, None),    # decode-style offset, Sq < Skv
    (2, 1, 256, 256, 16, True, 160),     # sliding window wider than a block
    (8, 2, 128, 128, 128, False, None),  # bidirectional
    (2, 1, 256, 128, 32, True, None),    # Sq > Skv: rows with no key give 0
])
def test_flash_attention_matches_pallas(BH, BHkv, Sq, Skv, d, causal, window):
    rng = np.random.default_rng(BH * 1000 + Sq + d)
    q = rng.standard_normal((BH, Sq, d)).astype(np.float32)
    k = rng.standard_normal((BHkv, Skv, d)).astype(np.float32)
    v = rng.standard_normal((BHkv, Skv, d)).astype(np.float32)
    got = tops.flash_attention(_t(q), _t(k), _t(v), causal=causal, window=window)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=causal, window=window)
    assert got.shape == (BH, Sq, d) and got.dtype == torch.float32
    _close(got, want, ATTN_TOL)
    if Sq > Skv:
        assert not got[:, : Sq - Skv].any()


def test_flash_attention_rejects_bad_operands_on_the_cpu():
    q = torch.zeros(4, 8, 16)
    with pytest.raises(ValueError, match="multiple"):
        tops.flash_attention(q, torch.zeros(3, 8, 16), torch.zeros(3, 8, 16))
    with pytest.raises(ValueError, match="head dim"):
        tops.flash_attention(q, torch.zeros(2, 8, 32), torch.zeros(2, 8, 32))
    with pytest.raises(ValueError, match="window"):
        tops.flash_attention(q, torch.zeros(2, 8, 16), torch.zeros(2, 8, 16), window=0)
    with pytest.raises(ValueError, match="contiguous"):
        tops.flash_attention(q.transpose(0, 1).contiguous().transpose(0, 1),
                             torch.zeros(2, 8, 16), torch.zeros(2, 8, 16))


# ---------------------------------------------------------------------- model
def _smoke(sliding_window=None):
    """qwen3's smoke config with GQA (2 kv heads for 4 query heads) and the
    flash route on both sides."""
    over = dict(n_kv_heads=2, sliding_window=sliding_window)
    jcfg = dataclasses.replace(jsmoke_config("qwen3-1.7b"), attention_impl="flash_pallas", **over)
    tcfg = dataclasses.replace(tconfigs.smoke_config("qwen3-1.7b"), attention_impl="flash", **over)
    return jcfg, tcfg


def _weights(jcfg, seed=0):
    """The JAX package's init tree as numpy, with every norm scale set to 1
    (its init draws them from N(0, 0.02), which would leave attention
    nearly uniform and the comparison weak); both sides get this tree."""
    params = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.key(seed)))
    lay = params["layers"]
    for leaf in (lay, lay["attn"]):
        for name in ("ln1", "ln2", "q_norm", "k_norm"):
            if name in leaf:
                leaf[name] = np.ones_like(leaf[name])
    return params


@pytest.mark.parametrize("window,S,extra", [(None, 24, 4), (16, 32, 4)])
def test_smoke_model_matches_jax(window, S, extra):
    """Prefill logits, the decode caches (a ring of 16 slots and
    ``_ring_pack``'s roll with the window), 4 decode-step logits and
    greedy tokens, against the JAX package with the same weights."""
    jcfg, tcfg = _smoke(window)
    params = _weights(jcfg)
    jparams = jax.tree.map(jnp.asarray, params)
    model = params_from_jax(tcfg, params, device="cpu")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, tcfg.vocab_size, (2, S + extra)).astype(np.int32)

    jlog, jstate = JM.prefill(jcfg, jparams, jnp.asarray(toks[:, :S]), max_len=S + extra)
    tlog, tstate = TM.prefill(tcfg, model, _t(toks[:, :S]).long(), max_len=S + extra)
    _close(tlog, jlog, LOGIT_TOL)
    _close(tstate.kv.k, jstate.kv.k, LOGIT_TOL)
    _close(tstate.kv.v, jstate.kv.v, LOGIT_TOL)
    assert tstate.kv.k.shape == jstate.kv.k.shape
    assert tstate.kv.length == S and np.all(np.asarray(jstate.kv.length) == S)

    for t in range(extra):
        tok = toks[:, S + t: S + t + 1]
        jlog, jstate = JM.decode_step(jcfg, jparams, jnp.asarray(tok), jstate)
        tlog, tstate = TM.decode_step(tcfg, model, _t(tok).long(), tstate)
        _close(tlog, jlog, LOGIT_TOL)
    _close(tstate.kv.k, jstate.kv.k, LOGIT_TOL)
    assert tstate.kv.length == S + extra

    jgen = jserve.greedy_generate(jcfg, jparams, jnp.asarray(toks[:, :S]), 6)
    tgen = tserve_loop.greedy_generate(tcfg, model, _t(toks[:, :S]).long(), 6)
    np.testing.assert_array_equal(tgen.numpy(), np.asarray(jgen))


@pytest.mark.parametrize("window", [None, 16])
def test_decode_agrees_with_longer_prefill(window):
    """Decode steps against the cache give the logits of a prefill of the
    longer prompt (the port's own consistency, as tests/test_models.py checks
    the JAX package's), and the naive route agrees with the flash route; at
    batch 1, where a (B*H, S, hd) reshape is a view that is not contiguous."""
    _, tcfg = _smoke(window)
    model = TM.init_params(tcfg, seed=3, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, tcfg.vocab_size, (1, 27)))
    S, extra = 24, 3
    logits, state = TM.prefill(tcfg, model, toks[:, :S], max_len=S + extra)
    naive = dataclasses.replace(tcfg, attention_impl="naive")
    _close(TM.prefill(naive, model, toks[:, :S], max_len=S + extra)[0], logits, LOGIT_TOL)
    for t in range(extra):
        logits, state = TM.decode_step(tcfg, model, toks[:, S + t: S + t + 1], state)
        want, _ = TM.prefill(tcfg, model, toks[:, : S + t + 1])
        _close(logits, want, LOGIT_TOL)


def test_serving_entry_points_on_the_cpu(capsys):
    tserve.main(["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu",
                 "--batch", "2", "--prompt-len", "8", "--new-tokens", "4"])
    out = capsys.readouterr().out
    assert "prefill: 2x8" in out and "decode: 4 tokens x 2 seqs" in out
    # the ssm, hybrid, encdec and vlm families (internvl2's smoke config
    # takes 8 patch embeddings, seamless's encoder a frame per position)
    for arch in ("mamba2-1.3b", "hymba-1.5b", "seamless-m4t-medium", "internvl2-2b"):
        tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                     "--batch", "2", "--prompt-len", "12", "--new-tokens", "3"])
        out = capsys.readouterr().out
        assert "prefill: 2x12" in out and "decode: 3 tokens x 2 seqs" in out, arch
    # the sharded BST store at world 1 (gloo on the CPU)
    tserve.main(["--bst", "--device", "cpu", "--requests", "500", "--chunk", "128"])
    out = capsys.readouterr().out
    assert "sharded hyb x 1 gloo ranks on cpu: 500 lookups" in out and "500 found" in out
    # the mesh steps at world 1 (gloo, mesh (1, 1)): the unsharded steps' logits
    cfg = tconfigs.smoke_config("qwen3-1.7b")
    model = TM.init_params(cfg, seed=0, device="cpu")
    prompt = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 8)))
    want, state = TM.prefill(cfg, model, prompt, max_len=10)
    nxt = want.argmax(dim=-1, keepdim=True)
    with gate.world1_group("cpu"):
        mesh = make_host_mesh(device_type="cpu")
        # the prefill's cache with its slots split over the (1-rank) model axis
        seq_state = tserve_loop.place_state(cfg, mesh, 2, state, seq_shard=True)
        want_step, _ = TM.decode_step(cfg, model, nxt, state)
        tm = tserve_loop.shard_model(cfg, model, mesh)
        got, mstate = tserve_loop.make_prefill_fn(cfg, mesh, 2, 10)(tm, prompt)
        # the step takes the cache layout it was made for, and no other
        with pytest.raises(ValueError, match="takes a sequence-sharded KV cache"):
            tserve_loop.make_serve_step(cfg, mesh, 2, seq_shard=True)(tm, nxt, mstate)
        with pytest.raises(ValueError, match="takes a head-sharded KV cache"):
            tserve_loop.make_serve_step(cfg, mesh, 2)(tm, nxt, seq_state)
        got_step, _ = tserve_loop.make_serve_step(cfg, mesh, 2)(tm, nxt, mstate)
        got_seq, _ = tserve_loop.make_serve_step(cfg, mesh, 2, seq_shard=True)(tm, nxt, seq_state)
        with pytest.raises(ValueError, match="tensor-parallel model"):
            tserve_loop.make_prefill_fn(cfg, mesh, 2)(model, prompt)
    assert torch.equal(got, want) and torch.equal(got_step, want_step)
    torch.testing.assert_close(got_seq, want_step, atol=1e-5, rtol=1e-5)
