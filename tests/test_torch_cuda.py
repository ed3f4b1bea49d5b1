"""The port's CUDA kernels on the card, held against their plain versions.

Every test here needs a CUDA card and skips without one.  The file imports
torch, numpy and the port only (the machine with the card has no JAX), so it
runs there on its own:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as TC  # noqa: E402
from repro_torch import invariants  # noqa: E402
from repro_torch.core import delta as TD  # noqa: E402
from repro_torch.core import tree as TT  # noqa: E402
from repro_torch.core.engine import PAPER_CONFIGS, BSTEngine  # noqa: E402
from repro_torch.data.keysets import make_tree_data  # noqa: E402
from repro_torch.kernels import bst_search as K  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving import BSTServer  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    return torch.device("cuda")


def _case(n_keys, size, seed):
    keys, values = make_tree_data(n_keys, seed=seed)
    rng = np.random.default_rng(seed)
    q = rng.choice(np.concatenate([keys, keys + 1, keys - 1]), size).astype(np.int32)
    return keys, values, TT.build_tree(keys, values, device="cpu"), torch.from_numpy(q)


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.is_cuda and g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.cpu(), w.cpu())


def test_ops_on_cuda_tensors_launch_the_kernels(cuda_device):
    _, _, tt, q = _case(1023, 2000, seed=7)
    tk, tv, qc = tt.keys.to(cuda_device), tt.values.to(cuda_device), q.to(cuda_device)
    K.reset_launches()
    got = ops.bst_ordered_forest(tk[None], tv[None], qc[None], tt.height)
    assert K.LAUNCHES == {"forest_descend": 1, "hybrid_descend": 0,
                          "forest_descend_delta": 0, "hybrid_descend_delta": 0}
    _same(got, ref.bst_ordered_ref(tt.keys[None], tt.values[None], q[None], tt.height))
    got = ops.bst_search_forest(tk[None], tv[None], qc.reshape(4, -1), tt.height,
                                shared_tree=True)
    assert K.LAUNCHES["forest_descend"] == 2
    _same(got, ref.bst_search_ref(tt.keys[None], tt.values[None], q.reshape(4, -1), tt.height))

    overflow = torch.zeros(2000, dtype=torch.int32, device=cuda_device)
    got = ops.bst_hybrid_forest(tk, tv, qc, tt.height, 3, "queue", 16, overflow_out=overflow)
    assert K.LAUNCHES["hybrid_descend"] == 1
    want_ovf = torch.zeros(2000, dtype=torch.int32)
    want = ref.bst_hybrid_ref(tt.keys, tt.values, q, tt.height, 3, "queue", 16,
                              overflow_out=want_ovf)
    _same(got + (overflow,), want + (want_ovf,))
    assert int(want_ovf.sum()) > 0  # a depth of 16 per subtree overflows


def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    _, _, tt, q = _case(63, 64, seed=1)
    tk, tv, qc = tt.keys.to(cuda_device), tt.values.to(cuda_device), q.to(cuda_device)
    with pytest.raises(ValueError, match="int32"):
        K.bst_ordered_forest_cuda(tk[None], tv[None], qc[None].long(), tt.height)
    with pytest.raises(ValueError, match="contiguous"):
        K.bst_ordered_forest_cuda(tk[None], tv[None], qc.reshape(8, 8).t(), tt.height,
                                  shared_tree=True)
    with pytest.raises(ValueError, match="is on cpu"):
        K.bst_ordered_forest_cuda(tt.keys[None], tt.values[None], qc[None], tt.height)
    with pytest.raises(ValueError, match="overflow_out"):
        K.bst_hybrid_forest_cuda(tk, tv, qc, tt.height, 2, "queue", 4,
                                 overflow_out=torch.zeros_like(qc[:-1]))


@pytest.mark.parametrize("name", list(PAPER_CONFIGS))
def test_engine_on_the_card_matches_the_engine_on_the_cpu(cuda_device, name):
    keys, values, _, q = _case(4095, 3000, seed=3)
    eng = BSTEngine(keys, values, PAPER_CONFIGS[name])
    cpu = BSTEngine(keys, values, dataclasses.replace(PAPER_CONFIGS[name], device="cpu"))
    lo, hi = q[:1000], q[:1000] + 40
    for op, args in (("lookup", (q,)), ("predecessor", (q,)), ("successor", (q,)),
                     ("range_count", (lo, hi)), ("range_scan", (lo, hi))):
        got, want = eng.query(op, *args), cpu.query(op, *args)
        if not isinstance(got, tuple):
            got, want = (got,), (want,)
        _same(got, want)


def _buffer(keys, tree, C, seed, device):
    """A delta buffer of capacity C on ``device``, filled by the port's own
    ingest: upserts of new odd keys, overwrites and tombstones of stored
    keys, tombstones of absent keys."""
    rng = np.random.default_rng(seed)
    m = C
    k = np.concatenate([keys[rng.choice(keys.size, m - m // 2, replace=False)],
                        rng.choice(keys.size, m // 2, replace=False).astype(np.int32) * 2 + 1])
    k = torch.from_numpy(rng.permutation(k).astype(np.int32)).to(device)
    v = torch.from_numpy(rng.integers(0, 2**31 - 1, m, dtype=np.int32)).to(device)
    d = torch.from_numpy(rng.random(m) < 0.3).to(device)
    res = ops.bst_ordered_forest(tree.keys[None], tree.values[None], k[None], tree.height)
    ok = torch.ones(m, dtype=torch.bool, device=device)
    return TD.ingest(TD.empty(C, device), k, v, d, ok, res[1][0], res[6][0])


@pytest.mark.parametrize("C", [1, 64, 4096])
def test_delta_kernels_match_their_plain_versions(cuda_device, C):
    keys, values = make_tree_data(32767, seed=C)
    tree = TT.build_tree(keys, values, device=cuda_device)
    buf = _buffer(keys, tree, C, seed=C, device=cuda_device)
    d_ops = TD.operands(buf)
    rng = np.random.default_rng(1)
    pool = np.concatenate([keys, keys + 1, buf.keys[: int(buf.count)].cpu().numpy()])
    q = torch.from_numpy(rng.choice(pool, 4096).astype(np.int32)).to(cuda_device)
    act = torch.from_numpy(rng.random(4096) > 0.1).to(cuda_device)
    K.reset_launches()
    for ordered in (False, True):
        for T in (1, 4):
            qq, aa = q.reshape(T, -1), act.reshape(T, -1)
            got = K.bst_ordered_forest_cuda(tree.keys[None], tree.values[None], qq, tree.height,
                                            active=aa, shared_tree=T > 1, ordered=ordered,
                                            delta=d_ops)
            want = ref.bst_ordered_ref(tree.keys[None], tree.values[None], qq, tree.height, aa,
                                       ordered=ordered, delta=d_ops)
            _same(got, want)
        for split, mapping in ((2, "queue"), (3, "direct")):
            cap = invariants.buffer_capacity(512, 1 << split, 2.0)
            ko, ro = torch.zeros_like(q), torch.zeros_like(q)
            got = K.bst_hybrid_forest_cuda(tree.keys, tree.values, q, tree.height, split, mapping,
                                           cap, active=act, ordered=ordered, overflow_out=ko,
                                           delta=d_ops)
            want = ref.bst_hybrid_ref(tree.keys, tree.values, q, tree.height, split, mapping, cap,
                                      active=act, ordered=ordered, overflow_out=ro, delta=d_ops)
            _same(got + (ko,), want + (ro,))
    assert K.LAUNCHES["forest_descend_delta"] == 4 and K.LAUNCHES["hybrid_descend_delta"] == 4
    assert K.LAUNCHES["forest_descend"] == K.LAUNCHES["hybrid_descend"] == 0


def test_delta_capacity_past_the_shared_memory_limit_raises(cuda_device):
    keys, values = make_tree_data(1023, seed=1)
    tree = TT.build_tree(keys, values, device=cuda_device)
    limit = K.delta_capacity_limit(cuda_device, False)
    assert 4096 < limit < 65536
    big = tuple(torch.zeros(limit + 1, dtype=torch.int32, device=cuda_device) for _ in range(4))
    q = torch.from_numpy(keys[:8]).to(cuda_device)
    with pytest.raises(ValueError, match=f"the limit is {limit} entries"):
        K.bst_ordered_forest_cuda(tree.keys[None], tree.values[None], q[None], tree.height,
                                  delta=big)


@pytest.mark.parametrize("name", list(PAPER_CONFIGS))
def test_write_path_server_round_matches_an_oracle(cuda_device, name):
    keys, values = make_tree_data(8191, seed=2)
    cfg = dataclasses.replace(PAPER_CONFIGS[name], delta_capacity=256)
    srv = BSTServer(keys, values, cfg, chunk_size=1024, scan_k=4)
    rng = np.random.default_rng(3)
    wk = np.concatenate([rng.choice(keys, 150, replace=False),
                         rng.choice(keys.size, 150, replace=False).astype(np.int32) * 2 + 1])
    wv = rng.integers(0, 2**31 - 1, wk.size, dtype=np.int32)
    dk = np.concatenate([rng.choice(keys, 90, replace=False), keys[:30] + 1])
    q = rng.choice(np.concatenate([keys, wk, dk, keys + 1]), 3000).astype(np.int32)
    srv.submit_write(wk, wv)
    srv.submit_delete(dk)
    t_look = srv.submit(q)
    t_pred = srv.submit(q, op="predecessor")
    t_succ = srv.submit(q, op="successor")
    t_scan = srv.submit_range(q[:500], q[:500] + 40, op="range_scan")
    K.reset_launches()
    got = srv.drain()
    assert srv.stats.compactions >= 1

    kv = dict(zip(keys.tolist(), values.tolist()))
    kv.update(zip(wk.tolist(), wv.tolist()))
    for k in dk.tolist():
        kv.pop(k, None)
    sk = np.array(sorted(kv), np.int32)
    sv = np.array([kv[k] for k in sk.tolist()], np.int32)
    i = np.clip(np.searchsorted(sk, q), 0, sk.size - 1)
    found = sk[i] == q
    np.testing.assert_array_equal(got[t_look][1], found)
    np.testing.assert_array_equal(got[t_look][0], np.where(found, sv[i], -1))
    i = np.searchsorted(sk, q, "right") - 1
    np.testing.assert_array_equal(got[t_pred][0], np.where(i >= 0, sk[np.clip(i, 0, None)],
                                                           np.int32(TT.NO_PRED_KEY)))
    i = np.searchsorted(sk, q)
    np.testing.assert_array_equal(got[t_succ][0], np.where(i < sk.size, sk[np.clip(i, 0, sk.size - 1)],
                                                           np.int32(TT.NO_SUCC_KEY)))
    start = np.searchsorted(sk, q[:500])
    counts = np.searchsorted(sk, q[:500] + 40, "right") - start
    np.testing.assert_array_equal(got[t_scan][2], np.minimum(counts, 4))
    np.testing.assert_array_equal(got[t_scan][0][:, 0], np.where(counts > 0, sk[np.clip(start, 0, sk.size - 1)],
                                                                 np.int32(TT.SENTINEL_KEY)))
    kern = "hybrid_descend" if cfg.strategy == "hyb" else "forest_descend"
    read_chunks = sum(srv.stats.per_op[op].chunks for op in
                      ("lookup", "predecessor", "successor", "range_scan"))
    assert read_chunks == 10
    assert K.LAUNCHES[kern + "_delta"] == read_chunks  # every read resolves the buffer
    assert K.LAUNCHES[kern] == 2  # ingest: 420 writes and deletes in chunks of 256


# ------------------------------------------------------------ K5: attention
# fp32: the kernel's FMA order and expf against torch's matmul and softmax
# (TF32 off); bf16: both compute in fp32 from the same bf16 inputs, so they
# differ by at most about one bf16 rounding of the output (the JAX sweep's
# 2e-2).
ATTN_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BH,BHkv,Sq,Skv,d,causal,window", [
    (8, 4, 300, 300, 128, True, None),  # GQA causal, ragged last tiles
    (4, 2, 200, 77, 64, True, None),    # Sq > Skv: rows with no key give 0
    (2, 2, 130, 260, 16, True, 40),     # offset and a sliding window
])
def test_flash_attention_matches_its_plain_version(cuda_device, no_tf32, dtype, BH, BHkv,
                                                   Sq, Skv, d, causal, window):
    gen = torch.Generator(device=cuda_device).manual_seed(BH + Sq)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
               for shape in ((BH, Sq, d), (BHkv, Skv, d), (BHkv, Skv, d)))
    FA.reset_launches()
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert FA.LAUNCHES["flash_attention"] == 1
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == dtype and got.shape == (BH, Sq, d)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    if Sq > Skv:
        assert not got[:, : Sq - Skv].any()


def test_flash_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    def qkv(dtype=torch.bfloat16, d=64, kv_rows=2):
        return (torch.zeros(4, 32, d, dtype=dtype, device=cuda_device),
                torch.zeros(kv_rows, 32, d, dtype=dtype, device=cuda_device),
                torch.zeros(kv_rows, 32, d, dtype=dtype, device=cuda_device))

    FA.reset_launches()
    with pytest.raises(ValueError, match="dtype"):
        FA.flash_attention_cuda(*qkv(torch.float16))
    q, k, v = qkv()
    with pytest.raises(ValueError, match="dtype"):
        FA.flash_attention_cuda(q, k.float(), v)
    with pytest.raises(ValueError, match="contiguous"):
        FA.flash_attention_cuda(q.transpose(0, 1).contiguous().transpose(0, 1), k, v)
    with pytest.raises(ValueError, match="multiple"):
        FA.flash_attention_cuda(*qkv(kv_rows=3))
    with pytest.raises(ValueError, match="head dim 48"):
        FA.flash_attention_cuda(*qkv(d=48))
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_attention_cuda(*(t.cpu() for t in qkv()))
    assert FA.LAUNCHES["flash_attention"] == 0


def test_smoke_model_on_the_card_matches_the_cpu(cuda_device, no_tf32):
    """qwen3's smoke config (GQA: 2 kv heads) in fp32, the same weights on
    both devices: prefill logits, caches and decode logits to 1e-4 (kernel
    and plain attention, and the card's and the CPU's matrix products), and
    one K5 launch per layer per prefill."""
    cfg = dataclasses.replace(TC.smoke_config("qwen3-1.7b"), n_kv_heads=2)
    cpu = TM.init_params(cfg, seed=1, device="cpu")
    card = TM.Model(cfg, cuda_device)
    card.load_state_dict(cpu.state_dict())
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, (3, 40)))
    S = 36
    FA.reset_launches()
    got, g_state = TM.prefill(cfg, card, toks[:, :S].to(cuda_device), max_len=40)
    assert FA.LAUNCHES["flash_attention"] == cfg.n_layers
    want, w_state = TM.prefill(cfg, cpu, toks[:, :S], max_len=40)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(g_state.kv.k.cpu(), w_state.kv.k, atol=1e-4, rtol=1e-4)
    for t in range(S, 40):
        got, g_state = TM.decode_step(cfg, card, toks[:, t:t + 1].to(cuda_device), g_state)
        want, w_state = TM.decode_step(cfg, cpu, toks[:, t:t + 1], w_state)
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    assert FA.LAUNCHES["flash_attention"] == cfg.n_layers  # decode runs no K5
