"""The port's training forward and its gradients against the JAX package, on the CPU.

One arch per family at smoke size, in fp32: qwen3 (dense, q/k norms),
mixtral (moe: K4's plain version and the dropped share), mamba2 (ssm: the
SSD scan's Python loop under autograd), hymba (hybrid: GQA with a window),
seamless-m4t (encdec: the encoder and each decoder layer's cross K/V from
its memory) and internvl2 (vlm: 8 patch embeddings and the loss mask that
leaves them out).  Weights are the JAX package's ``init_params`` tree with
every norm scale set to 1, carried across by ``params_from_jax``; tokens,
labels and frontend embeddings come from numpy seeds.  The JAX side is
``jax.value_and_grad`` of its ``forward_train`` under ``jax.jit``, compiled
once per family (the module fixture ``jax_grads``); its smoke configs run
the naive attention, the port's K5's plain version through
``ops.FlashAttention``, whose backward is ``flash_attention_bwd_ref``.

Tolerances: the loss within 1e-5, every parameter's gradient within 1e-4
(atol = rtol) element by element and within 1e-4 of the tensor's largest
magnitude (max |got - want| / max |want|; an absolute 1e-4 alone could
pass a zeroed gradient whose elements are all small): the two libraries
sum in other orders (matrix products, the SSD scan's cumulative sums, the
cross-entropy's logsumexp), and the largest differences seen are about
1e-7.  The attention backward's plain
version against autograd: 1e-5 in fp32, against ``jax.grad`` 1e-5;
``gradcheck`` in fp64 at its defaults.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import jax_leaf, params_from_jax  # noqa: E402

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
ATTN_TOL = 1e-5
FAMILY_ARCHS = ("qwen3_1p7b", "mixtral_8x7b", "mamba2_1p3b", "hymba_1p5b",
                "seamless_m4t_medium", "internvl2_2b")
BATCH, SEQ = 2, 24  # SEQ > hymba's 16-key window, 3 chunks of the smoke logit_chunk 8


def _close(got, want, tol):
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(want, np.float32), atol=tol, rtol=tol
    )


def _close_rel(got, want, tol, name=""):
    """Element by element (``_close``), and max |got - want| at most ``tol``
    times max |want|: the test of a gradient, whatever its scale."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    _close(got, want, tol)
    scale = np.abs(want).max(initial=0.0)
    err = np.abs(got - want).max(initial=0.0)
    assert scale > 0, f"{name}: the reference gradient is all zero"
    assert err <= tol * scale, f"{name}: max |diff| {err!r} > {tol} x max |want| {scale!r}"


def _weights(jcfg, seed=0):
    """A tree of the JAX package's ``init_params`` shapes as numpy: every
    norm scale 1 (its init draws them from N(0, 0.02), which would shrink
    every gradient), every other leaf N(0, 0.02) from numpy (cheaper than
    its eager init, with the same distribution)."""
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
    """tokens, labels (B, S) int32 and the frontend's embeddings (or None)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (BATCH, SEQ + 1)).astype(np.int32)
    fe = None
    if cfg.family == "encdec":
        fe = (rng.standard_normal((BATCH, SEQ, cfg.d_model)) * 0.5).astype(np.float32)
    elif cfg.family == "vlm":
        fe = (rng.standard_normal((BATCH, cfg.frontend_len, cfg.d_model)) * 0.5).astype(np.float32)
    return toks[:, :-1], toks[:, 1:], fe


@pytest.fixture(scope="module")
def jax_grads():
    """arch -> (params, inputs, JAX loss, JAX moe_dropped, JAX grads), each
    family's value_and_grad compiled once."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg = jsmoke_config(arch)
            params = _weights(jcfg)
            tokens, labels, fe = _inputs(jcfg)

            def loss_fn(p, t, lab, f):
                return JM.forward_train(jcfg, p, t, lab, f)

            fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
            (loss, metrics), grads = fn(params, tokens, labels, fe)
            cache[arch] = (params, (tokens, labels, fe), float(loss),
                           float(metrics["moe_dropped"]), jax.tree.map(np.asarray, grads))
        return cache[arch]

    return get


def _port_grads(cfg, params, inputs):
    model = params_from_jax(cfg, params, device="cpu", trainable=True)
    tokens, labels, fe = inputs
    loss, metrics = TM.forward_train(
        cfg, model, torch.from_numpy(tokens).long(), torch.from_numpy(labels).long(),
        None if fe is None else torch.from_numpy(fe))
    loss.backward()
    return model, loss, metrics


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_forward_train_loss_and_every_gradient_match_jax(arch, jax_grads):
    """The loss within 1e-5 and every parameter's gradient within 1e-4 of
    ``jax.value_and_grad`` of the JAX ``forward_train``; every parameter
    gets a gradient (none is frozen or cut off from the loss)."""
    params, inputs, jloss, jdropped, jgrads = jax_grads(arch)
    cfg = tconfigs.smoke_config(arch)
    model, loss, metrics = _port_grads(cfg, params, inputs)
    _close(loss.item(), jloss, LOSS_TOL)
    _close(metrics["moe_dropped"].item(), jdropped, LOSS_TOL)
    assert metrics["loss"] is loss
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        _close_rel(p.grad.numpy(), jax_leaf(jgrads, name), GRAD_TOL, name)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_remat_matches_no_remat(arch, jax_grads):
    """``remat=True`` (each layer under ``torch.utils.checkpoint``, the
    encoder's too) gives the same loss and gradients as ``remat=False``,
    and the layers run twice: the flash route's forward launches once a
    layer more in the backward (counted on the CPU route's calls)."""
    params, inputs, _, _, _ = jax_grads(arch)
    cfg = tconfigs.smoke_config(arch)
    calls = []
    real = tref.flash_attention_lse_ref

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    out = {}
    for remat in (False, True):
        calls.clear()
        tref.flash_attention_lse_ref = counted
        try:
            model, loss, _ = _port_grads(dataclasses.replace(cfg, remat=remat), params, inputs)
        finally:
            tref.flash_attention_lse_ref = real
        out[remat] = (loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()},
                      len(calls))
    assert out[True][0] == out[False][0]
    for name, g in out[False][1].items():
        torch.testing.assert_close(out[True][1][name], g, atol=0, rtol=0)
    assert out[True][2] == 2 * out[False][2]
    n_attn = cfg.n_layers * (cfg.family != "ssm") + (cfg.family == "encdec") * (
        cfg.encoder_layers + cfg.n_layers)
    assert out[False][2] == n_attn


def test_chunked_xent_value_and_gradient_match_jax():
    """The chunked cross-entropy (3 chunks, a mask) and its gradient in x
    and in the head against JAX's; and the unchunked case (a sequence the
    chunk does not divide is one chunk)."""
    rng = np.random.default_rng(3)
    B, S, D, V = 2, 24, 16, 37
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    head = (rng.standard_normal((V, D)) * 0.3).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    mask = rng.random((B, S)) > 0.3
    for chunk, m in ((8, mask), (8, None), (7, mask)):
        jm = None if m is None else jnp.asarray(m)
        jval, (jgx, jgh) = jax.jit(jax.value_and_grad(
            lambda a, h: jlayers.chunked_softmax_xent(a, h, jnp.asarray(labels), chunk, jm),
            argnums=(0, 1)))(jnp.asarray(x), jnp.asarray(head))
        tx = torch.from_numpy(x).requires_grad_()
        th = torch.from_numpy(head).requires_grad_()
        val = tlayers.chunked_softmax_xent(tx, th, torch.from_numpy(labels).long(), chunk,
                                           None if m is None else torch.from_numpy(m))
        val.backward()
        _close(val.item(), float(jval), LOSS_TOL)
        _close_rel(tx.grad.numpy(), np.asarray(jgx), ATTN_TOL, "x")
        _close_rel(th.grad.numpy(), np.asarray(jgh), ATTN_TOL, "head")


# (B, Sq, Skv, H, KV, hd, causal, window): GQA causal, a window, non-causal
# with Sq != Skv (cross-attention), and a group of 5 with a window.
ATTN_CASES = [
    (2, 16, 16, 4, 2, 8, True, None),
    (1, 20, 20, 2, 1, 16, True, 6),
    (2, 12, 20, 4, 4, 8, False, None),
    (1, 18, 18, 5, 1, 8, True, 7),
]


def _attn_inputs(case, seed):
    B, Sq, Skv, H, KV, hd, _, _ = case
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32) for s in
                 ((B, Sq, H, hd), (B, Skv, KV, hd), (B, Skv, KV, hd), (B, Sq, H, hd)))


def _heads(x):  # (B, S, H, hd) numpy -> (B*H, S, hd) torch
    B, S, H, hd = x.shape
    return torch.from_numpy(x).transpose(1, 2).reshape(B * H, S, hd).contiguous()


@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: "x".join(map(str, c)))
def test_attention_backward_plain_version_matches_autograd_and_jax(case):
    """``flash_attention_bwd_ref`` (from the forward's output and lse)
    against torch autograd of the port's ``_naive_attn`` and ``jax.grad``
    of the JAX package's ``_naive_attn``, in the model's (B, S, H, hd)
    layout: dq, dk, dv within 1e-5."""
    B, Sq, Skv, H, KV, hd, causal, window = case
    q, k, v, g = _attn_inputs(case, seed=sum(case[:6]))
    scale = hd ** -0.5
    qf, kf, vf, gf = (_heads(a) for a in (q, k, v, g))
    out, lse = tref.flash_attention_lse_ref(qf, kf, vf, causal=causal, window=window, scale=scale)
    got = tref.flash_attention_bwd_ref(qf, kf, vf, out, gf, lse, causal=causal, window=window,
                                       scale=scale)
    got = [t.reshape(B, -1, t.shape[1], hd).transpose(1, 2).numpy() for t in got]

    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = tattn._naive_attn(tq, tk, tv, causal, window, scale)
    want_t = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(g))
    want_j = jax.jit(jax.grad(lambda a, b, c: jnp.sum(
        jattn._naive_attn(a, b, c, causal, window, scale) * g), argnums=(0, 1, 2)))(q, k, v)
    for name, mine, wt, wj in zip(("dq", "dk", "dv"), got, want_t, want_j):
        _close_rel(mine, wt.numpy(), ATTN_TOL, name)
        _close_rel(mine, np.asarray(wj), ATTN_TOL, name)


def test_flash_attention_function_gradcheck():
    """``ops.FlashAttention`` (the CPU route: the lse forward and the
    backward's plain version) passes ``torch.autograd.gradcheck`` in fp64
    on tiny shapes: GQA causal, a window, and non-causal Sq != Skv, and a
    causal Sq > Skv whose first rows see no key (their gradient is 0)."""
    torch.manual_seed(0)
    for BH, BHkv, Sq, Skv, d, causal, window in ((4, 2, 5, 5, 4, True, None),
                                                 (3, 1, 6, 6, 4, True, 2),
                                                 (2, 2, 3, 5, 4, False, None),
                                                 (2, 1, 6, 4, 4, True, None)):
        args = [torch.randn(s, dtype=torch.float64, requires_grad=True)
                for s in ((BH, Sq, d), (BHkv, Skv, d), (BHkv, Skv, d))]
        fn = lambda q, k, v: tops.FlashAttention.apply(q, k, v, causal, window, d ** -0.5)  # noqa: E731
        assert torch.autograd.gradcheck(fn, args)
        if Sq > Skv:
            out = fn(*args)
            (dq,) = torch.autograd.grad(out.sum(), args[:1])
            assert not dq[:, : Sq - Skv].any()


def test_flash_route_is_differentiable_and_serving_route_is_not():
    """``ops.flash_attention`` takes the Function where a gradient is wanted
    (its output has a grad_fn and matches the serving route's) and the plain
    no-grad route otherwise."""
    q, k, v = (torch.randn(s) for s in ((4, 8, 16), (2, 8, 16), (2, 8, 16)))
    served = tops.flash_attention(q, k, v)
    assert served.grad_fn is None
    qg = q.clone().requires_grad_()
    trained = tops.flash_attention(qg, k, v)
    assert trained.grad_fn is not None
    torch.testing.assert_close(trained.detach(), served, atol=1e-6, rtol=1e-6)
    with torch.no_grad():
        assert tops.flash_attention(qg, k, v).grad_fn is None
