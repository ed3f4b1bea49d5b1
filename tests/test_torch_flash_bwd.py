"""K5's bf16 backward body and the kernel build, on the CPU.

``flash_bwd_bf16_kernel<D>`` (``csrc/flash_attention_bwd.cu``) computes the
five products of the attention backward on the tensor cores: bf16 operands,
fp32 sums, and P and dS rounded to bf16 before the products that take them
(dV = P^T dO, dK = dS^T Q, dQ = dS K), where the plain version
(``ref.flash_attention_bwd_ref``) keeps them in fp32.  The card is not here,
so ``_bf16_body`` repeats that rounding in plain torch, and the tests hold
it to the plain version's fp32 result and to ``jax.grad`` of the JAX
package's attention within the card check's bf16 limits (``BWD_TOL``
elementwise, ``BWD_NORM_TOL`` in norm, as ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` phase 9): the limits can hold before the kernel runs.

The build: ``_build.library_name`` hashes the headers the sources share
(``csrc/*.cuh``) as well as the sources, so an edited header builds a new
library; ``sources`` still lists the ``.cu`` files alone.  The C entry of
the backward takes a mask of its three kernels (``FA.BWD_STAGES``), which
``FA.bwd_stage_calls`` launches one by one to time them; on the CPU it
raises before it launches anything.
"""

import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

BWD_TOL = 2e-2  # bf16, atol = rtol: the card's elementwise limit
BWD_NORM_TOL = 1e-2  # bf16, |got - want|_2 / |want|_2 per tensor
LOG2E = 1.4426950408889634

# (BH, BHkv, Sq, Skv, d, causal, window): causal GQA (group 4), a window with
# a group of 5, non-causal with Sq != Skv (cross-attention).
CASES = [
    (8, 2, 160, 160, 32, True, None),
    (10, 2, 150, 150, 16, True, 40),
    (4, 4, 96, 200, 32, False, None),
]


def _bf16_inputs(case, seed):
    """q, k, v and the output gradient, drawn with numpy and rounded to
    bf16 (the card's operands), as fp32 torch tensors."""
    BH, BHkv, Sq, Skv, d, _, _ = case
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 .to(torch.bfloat16).float()
                 for s in ((BH, Sq, d), (BHkv, Skv, d), (BHkv, Skv, d), (BH, Sq, d)))


def _visible(Sq, Skv, causal, window):
    qpos = torch.arange(Sq)[:, None] + (Skv - Sq)  # q sits at the end of kv
    kpos = torch.arange(Skv)[None, :]
    vis = torch.ones(Sq, Skv, dtype=torch.bool)
    if causal:
        vis &= kpos <= qpos
    if window is not None:
        vis &= qpos - kpos < window
    return vis


def _bf16_body(q, k, v, out, dout, lse, causal, window, scale):
    """The bf16 body's arithmetic in plain torch: delta = rowsum(dO o o)
    and the lse term -lse log2 e (-inf where a row sees no key) as the
    pre-pass writes them; P = 2^(S scale log2 e + term) (0 where masked),
    dS = P o (dP - delta) scale from the fp32 P; then P and dS rounded to
    bf16 for dV += P^T dO, dK += dS^T Q (summed over the GQA group in fp32)
    and dQ = dS K; dq, dk, dv rounded to bf16 once."""
    BH, Sq, d = q.shape
    BHkv, Skv, _ = k.shape
    group = BH // BHkv
    kk, vv = (t.repeat_interleave(group, dim=0) for t in (k, v))
    delta = (dout * out).sum(-1)
    term = torch.where(torch.isinf(lse), torch.full_like(lse, -torch.inf), -lse * LOG2E)
    p = torch.exp2((q @ kk.transpose(-1, -2)) * (scale * LOG2E) + term[..., None])
    p = torch.where(_visible(Sq, Skv, causal, window), p, torch.zeros(()))
    ds = p * (dout @ vv.transpose(-1, -2) - delta[..., None]) * scale
    p16, ds16 = (t.to(torch.bfloat16).float() for t in (p, ds))
    dv = (p16.transpose(-1, -2) @ dout).view(BHkv, group, Skv, d).sum(1)
    dk = (ds16.transpose(-1, -2) @ q).view(BHkv, group, Skv, d).sum(1)
    dq = ds16 @ kk
    return tuple(t.to(torch.bfloat16).float() for t in (dq, dk, dv))


def _rel_norm(got, want):
    return float((got - want).norm() / want.norm())


def _check_bf16(got, want, name):
    torch.testing.assert_close(got, want, atol=BWD_TOL, rtol=BWD_TOL, msg=name)
    assert _rel_norm(got, want) <= BWD_NORM_TOL, (name, _rel_norm(got, want))


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_bf16_body_rounding_holds_the_plain_versions_fp32_result(case):
    """The body's rounding against ``flash_attention_bwd_ref`` in fp32 on
    the same bf16 operands, output and lse: within BWD_TOL elementwise and
    BWD_NORM_TOL in norm, and not equal (the rounding is there)."""
    BH, BHkv, Sq, Skv, d, causal, window = case
    q, k, v, g = _bf16_inputs(case, seed=sum(case[:5]))
    scale = d ** -0.5
    out, lse = tref.flash_attention_lse_ref(q, k, v, causal=causal, window=window, scale=scale)
    out = out.to(torch.bfloat16).float()  # the forward's bf16 output
    got = _bf16_body(q, k, v, out, g, lse, causal, window, scale)
    want = tref.flash_attention_bwd_ref(q, k, v, out, g, lse, causal=causal, window=window,
                                        scale=scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and b.dtype == torch.float32
        _check_bf16(a, b, name)
        assert _rel_norm(a, b) > 0, name


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_bf16_body_rounding_holds_jax_grad_of_the_reference_attention(case):
    """The body's rounding against ``jax.grad`` of the JAX package's
    ``_naive_attn`` in fp32 on the same bf16-rounded inputs, in the model's
    (B, S, H, hd) layout (one batch row, the heads grouped as the kernel
    reads them): within BWD_TOL elementwise and BWD_NORM_TOL in norm."""
    BH, BHkv, Sq, Skv, d, causal, window = case
    q, k, v, g = _bf16_inputs(case, seed=7 + sum(case[:5]))
    scale = d ** -0.5
    out, lse = tref.flash_attention_lse_ref(q, k, v, causal=causal, window=window, scale=scale)
    got = _bf16_body(q, k, v, out.to(torch.bfloat16).float(), g, lse, causal, window, scale)

    def model_layout(t):  # (heads, S, d) -> (1, S, heads, d)
        return jnp.asarray(t.numpy().transpose(1, 0, 2)[None])

    gj = model_layout(g)
    want = jax.jit(jax.grad(lambda a, b, c: jnp.sum(
        jattn._naive_attn(a, b, c, causal, window, scale) * gj), argnums=(0, 1, 2)))(
        model_layout(q), model_layout(k), model_layout(v))
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        _check_bf16(a, torch.from_numpy(np.asarray(w)[0].transpose(1, 0, 2).copy()), name)


def test_library_name_hashes_the_headers_and_compiles_only_sources(tmp_path):
    """A copy of ``csrc``: editing a shared header changes the library's
    name (so the next ``library()`` builds anew), as editing a source does;
    ``sources`` lists the ``.cu`` files only, ``headers`` the ``.cuh``."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    heads = _build.headers(csrc)
    assert [h.name for h in heads] == ["hopper.cuh"]
    assert all(s.suffix == ".cu" for s in _build.sources(csrc)) and _build.sources(csrc)
    assert "flash_attention_bwd.cu" in [s.name for s in _build.sources(csrc)]
    name = _build.library_name(csrc)
    assert name == _build.library_name(_build.CSRC)
    heads[0].write_text(heads[0].read_text() + "\n// edited\n")
    edited = _build.library_name(csrc)
    assert edited != name and edited.startswith("librepro_kernels-")
    src = csrc / "flash_attention_bwd.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert _build.library_name(csrc) not in (name, edited)


def test_bwd_stage_calls_name_each_kernel_once_and_take_only_cuda_tensors():
    """``BWD_STAGES`` gives the pre-pass, the main kernel and the cast one
    bit each of the C entry's mask, the whole launch all three; the C entry
    takes the mask before the stream; ``bwd_stage_calls`` raises on CPU
    tensors and counts no launch."""
    bits = list(FA.BWD_STAGES.values())
    assert list(FA.BWD_STAGES) == ["pre", "main", "cast"]
    assert sorted(bits) == [1, 2, 4] and sum(bits) == FA._BWD_ALL_STAGES
    import ctypes

    assert _build._SIGNATURES["flash_attention_bwd"][-2:] == [ctypes.c_int, ctypes.c_void_p]
    q = torch.zeros(4, 32, 64, dtype=torch.bfloat16)
    k = torch.zeros(2, 32, 64, dtype=torch.bfloat16)
    lse = torch.zeros(4, 32)
    FA.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        FA.bwd_stage_calls(q, k, k, q, q, lse)
    assert FA.LAUNCHES["flash_attention_bwd"] == 0
