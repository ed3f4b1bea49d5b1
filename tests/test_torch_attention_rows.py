"""K5 past a launch's head rows, on the CPU.

A launch of K5 takes at most ``FA.MAX_HEAD_ROWS`` (65,535) head rows on a
grid dimension: the forward's q rows, the fp32 backward's kv rows.  A call
past that is launched in chunks of whole GQA groups (``FA.head_row_chunks``)
on views that start at each chunk's first head row (``FA.run_head_rows``).
The card is not here, so the tests drive ``run_head_rows`` with the limit
lowered and the plain versions standing in for the launches, chunk by
chunk, on the wrapper's own outputs and scratch, and hold the result to the
JAX package: the forward (with lse) to ``flash_attention_pallas`` in
interpret mode, within 1e-5 (the kernel's online softmax over 128-wide
blocks against the plain one-pass softmax), and ``(dq, dk, dv)`` to
``jax.grad`` of ``_blockwise_attn``, within 1e-4 (fp32 sums in other
orders, through the saved lse).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

FWD_TOL = 1e-5
BWD_TOL = 1e-4
SEQ, D = 64, 16


# (BH, BHkv, limit): groups 1, 2, 4, 5 and 8, BH below, at and above the
# limit, and a group past it.
PLANS = [
    (6, 6, 7), (7, 7, 7), (8, 8, 7), (20, 20, 7),          # group 1
    (6, 3, 6), (8, 4, 6), (14, 7, 6), (64, 32, 5),         # group 2: an odd limit
    (8, 2, 8), (12, 3, 8), (40, 10, 9), (16, 4, 3),        # group 4, the last past the limit
    (10, 2, 10), (15, 3, 12), (55, 11, 12), (25, 5, 4),    # group 5
    (16, 2, 8), (24, 3, 16), (80, 10, 17), (16, 2, 6),     # group 8
    (65568, 16392, 65535), (131088, 65544, 65535),         # the card's boundary shapes
]


@pytest.mark.parametrize("whole_groups", [False, True])
@pytest.mark.parametrize("BH,BHkv,limit", PLANS, ids=lambda x: str(x))
def test_head_row_chunks_cover_every_row_once_within_the_limit(monkeypatch, BH, BHkv, limit,
                                                               whole_groups):
    """The chunks cover [0, BH) and [0, BHkv) once, in order.  The forward's
    chunks hold at most ``limit`` q rows (so as many kv rows); each is whole
    groups, its q rows group times its kv rows, except where a group alone
    passes the limit: then each piece is one kv row's.  The backward's
    (``whole_groups``) never cut a group and hold at most ``limit`` kv
    rows.  A call within the limit is one chunk."""
    monkeypatch.setattr(FA, "MAX_HEAD_ROWS", limit)
    group = BH // BHkv
    chunks = FA.head_row_chunks(BH, BHkv, whole_groups)
    q_edges = [0] + [c[1] for c in chunks]
    assert [c[0] for c in chunks] == q_edges[:-1] and q_edges[-1] == BH
    kv_ends = [c[3] for c in chunks]
    for (q0, q1, kv0, kv1), prev_end in zip(chunks, [0] + kv_ends):
        assert q0 < q1 and kv0 < kv1
        if whole_groups or group <= limit:
            assert kv0 == prev_end  # each kv row in exactly one chunk
            assert (q0, q1) == (kv0 * group, kv1 * group)
        else:
            assert kv1 == kv0 + 1 and kv0 * group <= q0 < q1 <= kv1 * group
        if whole_groups:
            assert kv1 - kv0 <= limit
        else:
            assert q1 - q0 <= limit and kv1 - kv0 <= limit
    assert kv_ends[-1] == BHkv
    if (BHkv if whole_groups else BH) <= limit:
        assert chunks == [(0, BH, 0, BHkv)]


@pytest.mark.parametrize("BH,BHkv,Sq,Skv,causal,window", [
    (65568, 16392, 128, 128, True, None),
    (65550, 13110, 192, 192, True, 50),
    (131088, 65544, 64, 64, True, None),
])
def test_chunking_leaves_the_counted_work_as_it_is(BH, BHkv, Sq, Skv, causal, window):
    """The dry run's shapes-only route counts a call's work from its whole
    shape (``forward_work``, ``backward_work``): summed over the chunks the
    card launches, the work is the same."""
    for whole_groups, work in ((False, FA.forward_work), (True, FA.backward_work)):
        chunks = FA.head_row_chunks(BH, BHkv, whole_groups)
        assert len(chunks) > 1 or (whole_groups and BHkv <= FA.MAX_HEAD_ROWS)
        parts = [work(q1 - q0, kv1 - kv0, Sq, Skv, 64, causal, window, 2)
                 for q0, q1, kv0, kv1 in chunks]
        assert tuple(map(sum, zip(*parts))) == work(BH, BHkv, Sq, Skv, 64, causal, window, 2)


def _inputs(BH, BHkv, seed, grad=False):
    rng = np.random.default_rng(seed)
    shapes = [(BH, SEQ, D), (BHkv, SEQ, D), (BHkv, SEQ, D)] + ([(BH, SEQ, D)] if grad else [])
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _model_layout(a):  # (heads, S, d) -> (1, S, heads, d): the kernel's GQA order
    return jnp.asarray(a.transpose(1, 0, 2)[None])


def _rows_layout(a):  # back
    return np.asarray(a)[0].transpose(1, 0, 2)


@pytest.mark.parametrize("limit", [1, 3, 6])
@pytest.mark.parametrize("window", [None, 24])
def test_chunked_forward_matches_the_pallas_kernel(monkeypatch, limit, window):
    """The forward with lse at BH 16, BHkv 4 (group 4), causal, with and
    without a window, launched chunk by chunk with the limit lowered (6:
    one kv row a chunk; 3 and 1: a group cut into pieces), each chunk the
    plain version on the chunk's views: the output against the Pallas
    kernel in interpret mode, the lse against the plain version's on the
    whole call."""
    monkeypatch.setattr(FA, "MAX_HEAD_ROWS", limit)
    q, k, v = _inputs(16, 4, seed=limit + (window or 0))
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    out, lse = torch.full_like(qt, float("nan")), torch.full((16, SEQ), float("nan"))
    seen = []

    def plain_launch(qc, oc, lc, kc, vc):
        seen.append((qc.shape[0], kc.shape[0]))
        o, l = ref.flash_attention_lse_ref(qc, kc, vc, causal=True, window=window)
        oc.copy_(o)
        lc.copy_(l)

    n = FA.run_head_rows(plain_launch, (qt, out, lse), (kt, vt))
    assert n == len(FA.head_row_chunks(16, 4)) == len(seen) > 1
    assert all(bh <= limit for bh, _ in seen)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                                  window=window, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=FWD_TOL, rtol=FWD_TOL)
    _, want_lse = ref.flash_attention_lse_ref(qt, kt, vt, causal=True, window=window)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), atol=FWD_TOL, rtol=FWD_TOL)


@pytest.mark.parametrize("limit", [1, 3])
@pytest.mark.parametrize("window", [None, 24])
def test_chunked_backward_matches_jax_grad(monkeypatch, limit, window):
    """The backward at BH 16, BHkv 4 with the limit lowered to 1 and 3 kv
    rows, over the wrapper's own outputs and scratch (``bwd_scratch``),
    each chunk the plain version on the chunk's views: ``(dq, dk, dv)``
    against ``jax.grad`` of ``_blockwise_attn``."""
    monkeypatch.setattr(FA, "MAX_HEAD_ROWS", limit)
    q, k, v, g = _inputs(16, 4, seed=10 + limit + (window or 0), grad=True)
    qt, kt, vt, gt = map(torch.from_numpy, (q, k, v, g))
    scale = D ** -0.5
    out, lse = ref.flash_attention_lse_ref(qt, kt, vt, causal=True, window=window, scale=scale)
    dq, dk, dv = (torch.full_like(t, float("nan")) for t in (qt, kt, vt))
    dq_acc, delta, sems = FA.bwd_scratch(qt, dq)
    assert dq_acc is dq and delta.shape[0] == sems.shape[0] == 16
    seen = []

    def plain_launch(qc, oc, doc, lc, dqc, accc, deltac, semc, kc, vc, dkc, dvc):
        seen.append((qc.shape[0], kc.shape[0], deltac.shape[0]))
        assert semc.shape[0] == qc.shape[0]
        for t, grad in zip((dqc, dkc, dvc), ref.flash_attention_bwd_ref(
                qc, kc, vc, oc, doc, lc, causal=True, window=window, scale=scale)):
            t.copy_(grad)

    n = FA.run_head_rows(plain_launch, (qt, out, gt, lse, dq, dq_acc, delta, sems),
                         (kt, vt, dk, dv), whole_groups=True)
    assert n == -(-4 // limit) and all(kv <= limit and bh == 4 * kv == dl for bh, kv, dl in seen)
    want = jax.grad(lambda a, b, c: jnp.sum(
        jattn._blockwise_attn(a, b, c, True, window, 32, scale) * _model_layout(g)),
        argnums=(0, 1, 2))(_model_layout(q), _model_layout(k), _model_layout(v))
    for got, w in zip((dq, dk, dv), want):
        np.testing.assert_allclose(got.numpy(), _rows_layout(w), atol=BWD_TOL, rtol=BWD_TOL)
