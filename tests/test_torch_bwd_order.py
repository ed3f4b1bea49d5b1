"""K5's backward adds dQ in a fixed order: its schedule and scratch, on the CPU.

Every kv tile that sees a 64-row q tile adds its dQ partial sums into the
same fp32 rows; the kernels make them add kv tile by kv tile, from the q
tile's first visible kv tile on, behind a semaphore per (q head row, q
tile) that the pre-pass zeroes (``csrc/flash_attention_bwd.cu``, "dQ's
order").  The card is not here, so the tests hold the order's two halves
as the kernels compute them (``FA.bwd_visible_q_tiles``,
``FA.bwd_first_kv_tile``) to the attention mask itself, and the scratch the
wrapper gives each launch (``FA.bwd_scratch``, per chunk of
``FA.run_head_rows``) to the pre-pass's plain version
(``ref.flash_attention_bwd_pre_ref``) and to what the shapes-only route of
the dry run allocates.  On the card, ``tests/test_torch_cuda.py`` holds the
backward to itself bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

# (Sq, Skv, causal, window): causal and full, q at the end of kv (Sq <
# Skv), rows that see no key (Sq > Skv), windows inside and across tiles,
# ragged last tiles, and the training shapes' tiling at a short length.
ORDER_SHAPES = [
    (300, 300, True, None),
    (200, 77, True, None),
    (130, 260, True, 40),
    (300, 300, True, 100),
    (129, 300, False, None),
    (256, 256, True, 96),
    (257, 257, True, 1),
    (1, 257, True, None),
    (640, 640, True, 300),
    (512, 1000, False, 200),
    (2048, 2048, True, None),
    (2048, 2048, True, 1024),
]


def _visible_q_tiles(Sq, Skv, causal, window, k0, k1):
    """The q tiles with a row that sees a key of [k0, k1): from the mask."""
    qpos = np.arange(Sq)[:, None] + (Skv - Sq)
    kpos = np.arange(k0, k1)[None, :]
    vis = np.ones((Sq, k1 - k0), bool)
    if causal:
        vis &= kpos <= qpos
    if window is not None:
        vis &= qpos - kpos < window
    rows = np.flatnonzero(vis.any(axis=1))
    return sorted(set(rows // FA.BWD_ROW_PAD))


@pytest.mark.parametrize("kv_rows", sorted(FA.BWD_KV_ROWS.values()))
@pytest.mark.parametrize("Sq,Skv,causal,window", ORDER_SHAPES)
def test_each_q_tile_takes_its_kv_tiles_dq_in_turn(Sq, Skv, causal, window, kv_rows):
    """A kv tile walks exactly the q tiles that see one of its keys (the
    mask's, a row at a time); the kv tiles that walk a q tile are a run
    from ``bwd_first_kv_tile`` on, so kv tile j's turn j - that tile counts
    0, 1, 2, ... with no gap: every wait is for a turn that comes, and the
    order is the kv tiles'."""
    n_kv = -(-Skv // kv_rows)
    walkers = {}
    for j in range(n_kv):
        tiles = FA.bwd_visible_q_tiles(j, kv_rows, Sq, Skv, causal, window)
        assert list(tiles) == _visible_q_tiles(Sq, Skv, causal, window, j * kv_rows,
                                               min((j + 1) * kv_rows, Skv))
        for qt in tiles:
            walkers.setdefault(qt, []).append(j)
    for qt, tiles in walkers.items():
        first = FA.bwd_first_kv_tile(qt, kv_rows, Sq, Skv, window)
        assert [j - first for j in tiles] == list(range(len(tiles))), (qt, tiles, first)
    # a q tile no kv tile walks has no turn to wait for
    assert set(walkers) <= set(range(-(-Sq // FA.BWD_ROW_PAD)))


@pytest.mark.parametrize("dtype", FA.DTYPES)
@pytest.mark.parametrize("limit", [1, 3, 4])
def test_each_launch_gets_its_own_scratch_rows_zeroed_by_the_pre_pass(monkeypatch, dtype, limit):
    """``bwd_scratch`` at BH 16, BHkv 4, Sq 200 (4 q tiles): dq_acc (dq
    itself in fp32, (16, 256, 16) in bf16), delta (16, 2 x 256) and the
    semaphores int32 (16, 4 + 1); with the launch's head rows lowered to
    ``limit`` kv rows each chunk's rows of all three are its own, and the
    pre-pass's plain version on them zeroes dq_acc and every semaphore (the
    ticket counters in column 4 too) and writes each launch's delta and lse
    term."""
    monkeypatch.setattr(FA, "MAX_HEAD_ROWS", limit)
    gen = torch.Generator().manual_seed(limit)
    out, dout = (torch.randn(16, 200, 16, generator=gen).to(dtype) for _ in range(2))
    lse = torch.randn(16, 200, generator=gen)
    lse[3, :7] = float("-inf")  # rows that see no key
    dq = torch.empty_like(out)
    dq_acc, delta, sems = FA.bwd_scratch(out, dq)
    assert (dq_acc is dq) == (dtype == torch.float32) and dq_acc.dtype == torch.float32
    assert dq_acc.shape == ((16, 200, 16) if dtype == torch.float32 else (16, 256, 16))
    assert delta.shape == (16, 512) and sems.shape == (16, 5) and sems.dtype == torch.int32
    for t in (dq_acc, delta):
        t.fill_(float("nan"))
    sems.fill_(7)
    seen = []

    def pre(oc, doc, lc, accc, deltac, semc, kc):
        seen.append((oc.shape[0], kc.shape[0], semc.shape[0]))
        ref.flash_attention_bwd_pre_ref(oc, doc, lc, accc, deltac, semc)

    kv = torch.empty(4, 1)
    n = FA.run_head_rows(pre, (out, dout, lse, dq_acc, delta, sems), (kv,), whole_groups=True)
    assert n == -(-4 // limit) and all(bh == 4 * k == s for bh, k, s in seen)
    assert not sems.any() and not dq_acc.any()
    rows = (dout.float() * out.float()).sum(dim=-1)
    term = torch.where(torch.isneginf(lse), lse, -lse * ref.LOG2E)
    r0 = 0
    for bh, _, _ in seen:
        flat = delta[r0:r0 + bh].reshape(-1)
        if dtype == torch.float32:
            torch.testing.assert_close(flat[:bh * 200], rows[r0:r0 + bh].reshape(-1))
        else:
            d, t = flat.view(2, bh, 256)
            torch.testing.assert_close(d[:, :200], rows[r0:r0 + bh])
            assert not d[:, 200:].any()
            torch.testing.assert_close(t[:, :200], term[r0:r0 + bh])
            assert bool(torch.isneginf(t[:, 200:]).all())
        r0 += bh


@pytest.mark.parametrize("dtype", FA.DTYPES)
def test_shapes_only_backward_allocates_the_cards_scratch(monkeypatch, dtype):
    """The dry run's shapes-only backward (fake tensors) allocates the
    scratch the card's call does, through the same ``bwd_scratch``: for q
    (6, 20, 16), delta (6, 128) fp32 and the semaphores (6, 2) int32, and
    in bf16 dq_acc (6, 64, 16) fp32 (whole q tiles) beside them."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    allocated = []
    real = FA.bwd_scratch

    def recording(q, dq):
        parts = real(q, dq)
        allocated.append([(tuple(t.shape), t.dtype, t.nbytes) for t in parts if t is not dq])
        return parts

    monkeypatch.setattr(FA, "bwd_scratch", recording)
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(s, generator=gen).to(dtype) for s in ((6, 20, 16), (3, 24, 16),
                                                                  (3, 24, 16)))
    with FakeTensorMode() as mode:
        q, k, v = (mode.from_tensor(t).requires_grad_() for t in (q, k, v))
        ops.flash_attention(q, k, v, causal=True, window=7).float().sum().backward()
    want = [((6, 128), torch.float32, 6 * 128 * 4), ((6, 2), torch.int32, 6 * 2 * 4)]
    if dtype == torch.bfloat16:
        want.insert(0, ((6, 64, 16), torch.float32, 6 * 64 * 16 * 4))
    assert allocated == [want]
