#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one card: the BST read and write paths and LM serving.

    python3 chip_smoke.py [--json PATH]

Phases, in order; any failure raises and exits non-zero:

1. identify the card (name and power limit from nvidia-smi, versions);
2. build the kernels from ``src/repro_torch/kernels/csrc`` with nvcc (one
   process per source, all at once), and report ptxas's registers per
   kernel and K2's theoretical occupancy;
3. hold each kernel against its plain PyTorch version on the card, bit for
   bit, over a 2^24 - 1 key tree and 65,536 lanes (the paper's equal,
   random and split key sets, absent keys and inactive lanes), plus the
   height-0 and minimal hybrid trees; then the delta configuration (K2)
   of both kernels the same way, against a full 4096-entry write buffer
   (upserts, overwrites, tombstones of stored and absent keys), an empty
   one and a one-entry one;
4. serve the paper's streams through ``BSTServer`` for each of the seven
   paper configurations over the same tree, check every answer against a
   numpy searchsorted oracle, and check that each kernel of the path was
   launched and that each retired chunk made exactly one device fetch;
   then profile Hrz lookup drains for the device's idle share;
4w. the live write path: each paper configuration with a 4096-entry delta
   buffer serves one stream of interleaved writes, deletes and reads of
   all five ops over the same tree, every answer held against a numpy
   oracle of the state the read must see; the fetch budget (one per read
   chunk, one per compaction) and the launch counts (K2 once per read
   chunk, K1 or K3 once per ingest chunk) are checked, and so is the
   snapshot after a final compaction;
5. at the main path's shapes, hold each kernel configuration against its
   plain version once more, then time the kernel, its plain version and
   ``torch.searchsorted`` (the library yardstick, never called by the port)
   with CUDA events, beside the byte bound of the same work; K2 likewise
   with the full buffer, its yardstick searching the merged sorted view;
6. LM serving of qwen3-1.7b at full width and depth (28 layers): kernel K5
   (flash attention) against its plain version in fp32 and bf16 at the JAX
   package's sweep shapes, at Sq > Skv and at the serving shape; the whole
   model in fp32 (1 x 512 prompt), the flash route against the naive route
   over prefill and 4 decode steps, and decode against a prefill of the
   longer prompt; then the bf16 serving run through ``greedy_generate``
   (4 prompts x 2048 tokens + 32 new), one K5 launch per layer, every
   logit finite, with prefill and decode times, peak memory and a decode
   step's device idle share; then K5 timed at the serving shape beside its
   bound, its plain version and ``scaled_dot_product_attention``;
7. print the ``{"kernels": [...]}`` line, the card's line, and last the
   ``{"ok": true, ...}`` line.

Needs one CUDA card; exits with code 2 and prints no result without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import invariants, runtime  # noqa: E402
from repro_torch.core import PAPER_CONFIGS, QUERY_OPS  # noqa: E402
from repro_torch.core import delta as delta_lib  # noqa: E402
from repro_torch.core import plans as plans_lib  # noqa: E402
from repro_torch.core import tree as tree_lib  # noqa: E402
from repro_torch.core.tree import (  # noqa: E402
    NO_PRED_KEY,
    NO_SUCC_KEY,
    SENTINEL_KEY,
    SENTINEL_VALUE,
    build_tree,
    rank_to_bfs_indices,
)
from repro_torch.data.keysets import make_key_sets, make_tree_data  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import bst_search as K  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.models import model as lm  # noqa: E402
from repro_torch.serving import BSTServer, greedy_generate, make_prefill_fn, make_serve_step  # noqa: E402

N_KEYS = (1 << 24) - 1  # H = 23: 2 x 64 MiB of int32 keys and values
CHECK_LANES = 1 << 16
STREAM = 1 << 18  # the paper's 256K key sets
RANGE_STREAM = 1 << 17
CHUNK = 8192  # the server's chunk: the main path's lookup shape
SCAN_K = 8
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
TIMING_REPS = 30
SPIN_CYCLES = 2_000_000  # about 1 ms of the SM clock
PROFILE_CHUNKS = 128
PROFILE_RUNS = 3
SOURCE = "src/repro_torch/kernels/csrc/forest_search.cu"
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention.py:100"
REPLACES = {
    "forest_descend": "src/repro/kernels/bst_search.py:255",
    "hybrid_descend": "src/repro/kernels/bst_search.py:404",
    "forest_descend_delta": "src/repro/kernels/bst_search.py:228",
    "hybrid_descend_delta": "src/repro/kernels/bst_search.py:228",
}
# The write phase (4w): the engine capacity of examples/serve_bst.py and
# launch/serve.py, its default high-water mark (3/4), and per round of the
# stream the op counts below.
W_CAPACITY = 4096
W_ROUNDS = 8
W_WRITES = 4096  # half new odd keys, half overwrites of stored keys
W_DELETES = 2048  # three quarters stored keys, one quarter absent
W_LOOKUPS = 8192  # written, deleted and random keys
W_POINTS = 8192  # predecessor, and as many successor, queries of odd keys
W_RANGES = 4096  # range_count, and as many range_scan, spans near written keys
# The LM phase (6): qwen3-1.7b at its published width and depth.
LM_ARCH = "qwen3-1.7b"
LM_BATCH, LM_PROMPT, LM_NEW = 4, 2048, 32  # the serving run
LM_CHECK_PROMPT, LM_CHECK_STEPS = 512, 4  # the fp32 full-depth check
LM_CHECK_TOL = 1e-3  # fp32 logits after 28 layers: the routes' rounding differs
LM_PROFILE_STEPS = 4
BF16_FLOP_PER_S = 989e12  # H100 SXM data sheet, dense bf16 tensor cores
# K5 against its plain version: fp32, the kernel's FMA order and expf
# against torch's matmul and softmax (TF32 off); bf16, both compute in fp32
# from the same bf16 inputs, so they differ by about one bf16 rounding of
# the output (the JAX sweep's 2e-2).  atol = rtol = the value.
FLASH_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# (BH, BHkv, Sq, Skv, d, causal, window): the JAX package's sweep
# (tests/test_kernels.py), a causal Sq > Skv case, and the serving shape.
FLASH_SHAPES = [
    (4, 2, 256, 256, 64, True, None),
    (4, 4, 128, 256, 32, True, None),
    (2, 1, 256, 256, 64, True, 128),
    (8, 2, 128, 128, 128, False, None),
    (2, 2, 384, 384, 64, True, 256),
    (4, 2, 512, 256, 128, True, None),
    (LM_BATCH * 16, LM_BATCH * 8, LM_PROMPT, LM_PROMPT, 128, True, None),
]


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# Per kernel, over every comparison with its plain version (phases 3 and 5):
# lanes where any output differed, and the largest absolute difference.
AGREEMENT = {kern: {"mismatches": 0, "max_abs_err": 0} for kern in REPLACES}


def compare(got, want, kernel: str, tag: str) -> int:
    """Bit-for-bit comparison of a kernel's outputs with its plain version's;
    adds to ``AGREEMENT`` and fails on any difference.  Returns the number of
    mismatching lanes."""
    check(len(got) == len(want), f"{tag}: {len(got)} outputs vs {len(want)}")
    bad = torch.zeros(got[0].shape, dtype=torch.bool, device=got[0].device)
    worst = 0
    for i, (g, w) in enumerate(zip(got, want)):
        check(g.shape == w.shape and g.dtype == w.dtype, f"{tag}[{i}]: shape/dtype")
        diff = (g.long() - w.long()).abs()
        bad |= diff != 0
        worst = max(worst, int(diff.max()) if diff.numel() else 0)
    n_bad = int(bad.sum())
    AGREEMENT[kernel]["mismatches"] += n_bad
    AGREEMENT[kernel]["max_abs_err"] = max(AGREEMENT[kernel]["max_abs_err"], worst)
    check(n_bad == 0, f"{tag}: {n_bad} mismatching lanes")
    return n_bad


# ------------------------------------------------------- phase 2: resources
# Per-SM limits of sm_90 (the CUDA occupancy calculator's table): threads,
# CTAs, registers (allocated per warp in units of 256), shared memory (1 KiB
# reserved per CTA, allocated in units of 128 bytes).
SM_THREADS, SM_CTAS, SM_REGS, SM_SMEM, CTA_RESERVED_SMEM = 2048, 32, 65536, 233472, 1024
FOREST_CTA = 256  # threads per CTA of forest_descend (kForestBlock)


def ptxas_resources(build_log: str) -> dict:
    """Per kernel instantiation, from ptxas's report in the build log:
    ``{"forest_descend_kernel<ORDERED,WITH_DELTA>" (or hybrid's
    <ORDERED,MAPPING,WITH_DELTA>, or "flash_fwd_kernel<float|bf16,D>"):
    (registers, static shared memory bytes, spill line)}``."""
    out, label, spills = {}, None, ""
    for line in build_log.splitlines():
        entry = "Compiling entry" in line and re.search(r"(forest|hybrid)_descend_kernel(I\w*?)EEv", line)
        flash = "Compiling entry" in line and re.search(r"flash_fwd_kernelI(f|13__nv_bfloat16)Li(\d+)E", line)
        if entry:
            targs = ",".join(re.findall(r"L[bi](\d+)E", entry.group(2) + "E"))
            label = f"{entry.group(1)}_descend_kernel<{targs}>"
        elif flash:
            label = f"flash_fwd_kernel<{'float' if flash.group(1) == 'f' else 'bf16'},{flash.group(2)}>"
        elif label and "spill" in line:
            spills = line.strip()
        elif label and "registers" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            out[label] = (regs, int(smem.group(1)) if smem else 0, spills)
            label = None
    return out


def delta_smem_bytes(capacity: int, ordered: int) -> int:
    """The delta staging's dynamic shared memory (``delta_smem_ints`` in
    forest_search.cu): keys, values, tombstones, and ordered adds the
    weight prefix and the scan's 32 per-warp partials."""
    return 4 * (4 * capacity + 1 + 32 if ordered else 3 * capacity)


def ctas_per_sm(threads: int, regs: int, smem: int) -> int:
    """Theoretical CTAs per SM of a kernel with ``regs`` registers per
    thread and ``smem`` bytes of shared memory per CTA."""
    regs_per_cta = threads // 32 * -(-regs * 32 // 256) * 256
    smem_per_cta = -(-(smem + CTA_RESERVED_SMEM) // 128) * 128
    return min(SM_THREADS // threads, SM_CTAS, SM_REGS // regs_per_cta, SM_SMEM // smem_per_cta)


# ----------------------------------------------------------- phase 3: checks
def check_kernels(tree, lanes, active) -> None:
    """Every kernel configuration of the path against its plain version."""
    H = tree.height
    fk, fv = tree.keys[None], tree.values[None]
    for ordered in (False, True):
        tag = "ordered" if ordered else "membership"
        got = K.bst_ordered_forest_cuda(fk, fv, lanes[None], H, active=active[None], ordered=ordered)
        want = ref.bst_ordered_ref(fk, fv, lanes[None], H, active[None], ordered=ordered)
        compare(got, want, "forest_descend", f"K1 hrz {tag}")
        for T in (4, 8):
            q, a = lanes.reshape(T, -1), active.reshape(T, -1)
            got = K.bst_ordered_forest_cuda(fk, fv, q, H, active=a, shared_tree=True, ordered=ordered)
            want = ref.bst_ordered_ref(fk, fv, q, H, a, ordered=ordered)
            compare(got, want, "forest_descend", f"K1 dup{T} {tag}")
        for n_trees in (4, 8):
            split = invariants.split_level_for(n_trees)
            cap = invariants.buffer_capacity(K.HYBRID_BLOCK_Q, n_trees, 2.0)
            for mapping in ("queue", "direct"):
                k_ovf = torch.full_like(lanes, -7)
                r_ovf = torch.full_like(lanes, -7)
                got = K.bst_hybrid_forest_cuda(
                    tree.keys, tree.values, lanes, H, split, mapping, cap,
                    active=active, ordered=ordered, overflow_out=k_ovf,
                )
                want = ref.bst_hybrid_ref(
                    tree.keys, tree.values, lanes, H, split, mapping, cap,
                    active=active, ordered=ordered, overflow_out=r_ovf,
                )
                t = f"K3 split={split} {mapping} {tag}"
                compare(got + (k_ovf,), want + (r_ovf,), "hybrid_descend", t)
                # the equal key set (the first quarter) must take the stall round
                n_ovf = int(k_ovf[: lanes.shape[0] // 4].sum())
                check(n_ovf > 0, f"{t}: the equal key set did not overflow")
                log(f"  {t}: 0 mismatches, {int(k_ovf.sum())} lanes replayed")
    log("  K1 hrz, dup4, dup8 (membership, ordered): 0 mismatches")


def check_edge_trees() -> None:
    dev = "cuda"
    for keys in (np.array([100], np.int32), np.arange(2, 16, 2, dtype=np.int32)):
        tree = build_tree(keys, keys * 3, device=dev)
        H = tree.height
        q = torch.arange(-2, 2 * int(keys.max()) + 3, dtype=torch.int32, device=dev)
        q = torch.cat([q, torch.tensor([-(2**31) + 1, 2**31 - 2], dtype=torch.int32, device=dev)])
        fk, fv = tree.keys[None], tree.values[None]
        for ordered in (False, True):
            got = K.bst_ordered_forest_cuda(fk, fv, q[None], H, ordered=ordered)
            compare(got, ref.bst_ordered_ref(fk, fv, q[None], H, ordered=ordered),
                    "forest_descend", f"K1 H={H}")
            for split in range(H + 1):
                for mapping in ("queue", "direct"):
                    ko, ro = torch.zeros_like(q), torch.zeros_like(q)
                    got = K.bst_hybrid_forest_cuda(tree.keys, tree.values, q, H, split, mapping, 2,
                                                   ordered=ordered, overflow_out=ko)
                    want = ref.bst_hybrid_ref(tree.keys, tree.values, q, H, split, mapping, 2,
                                              ordered=ordered, overflow_out=ro)
                    compare(got + (ko,), want + (ro,), "hybrid_descend",
                            f"K3 H={H} split={split} {mapping}")
        log(f"  edge tree H={H}: K1 and K3 (every split) 0 mismatches")


def buffer_of(tree, wk, wv, wd, capacity: int) -> delta_lib.DeltaBuffer:
    """A write buffer holding the distinct writes ``wk/wv/wd`` (wd: delete),
    classified by K1 and merged by the port's own ingest."""
    k, v, d = (torch.from_numpy(x).cuda() for x in (wk, wv, wd))
    res = K.bst_ordered_forest_cuda(tree.keys[None], tree.values[None], k[None], tree.height)
    ok = torch.ones(wk.size, dtype=torch.bool, device="cuda")
    buf = delta_lib.ingest(delta_lib.empty(capacity, "cuda"), k, v, d, ok, res[1][0], res[6][0])
    check(int(buf.count) == wk.size, f"buffer holds {int(buf.count)} of {wk.size} entries")
    return buf


def full_buffer(tree, keys, capacity: int, seed: int) -> delta_lib.DeltaBuffer:
    """A write buffer filled to ``capacity`` distinct live entries, a quarter
    each: overwrites of stored keys, upserts of new odd keys, tombstones of
    stored keys, tombstones of absent odd keys."""
    rng = np.random.default_rng(seed)
    q = capacity // 4
    stored = keys[rng.choice(keys.size, 2 * q, replace=False)]
    odd = (rng.choice(keys.size + 1, 2 * q, replace=False) * 2 + 1).astype(np.int32)
    wk = np.concatenate([stored[:q], odd[:q], stored[q:], odd[q:]])
    wd = np.arange(wk.size) >= 2 * q
    order = rng.permutation(wk.size)
    wv = rng.integers(0, 2**31 - 1, wk.size, dtype=np.int32)
    return buffer_of(tree, wk[order], wv, wd[order], capacity)


def check_delta_kernels(tree, lanes, active, buffers) -> None:
    """K2, the delta configuration of both kernels, against its plain
    version for every buffer: forest hrz, dup4, dup8 and hybrid split 2 and
    3 x queue/direct, membership and ordered."""
    H = tree.height
    fk, fv = tree.keys[None], tree.values[None]
    for label, buf in buffers.items():
        d_ops = delta_lib.operands(buf)
        hit, dead, _, _ = ref.bst_delta_resolve_ref(*d_ops, lanes, active)
        for ordered in (False, True):
            tag = f"{label} {'ordered' if ordered else 'membership'}"
            for T in (1, 4, 8):
                q, a = lanes.reshape(T, -1), active.reshape(T, -1)
                got = K.bst_ordered_forest_cuda(fk, fv, q, H, active=a, shared_tree=T > 1,
                                                ordered=ordered, delta=d_ops)
                want = ref.bst_ordered_ref(fk, fv, q, H, a, ordered=ordered, delta=d_ops)
                compare(got, want, "forest_descend_delta", f"K2 forest T={T} {tag}")
            for n_trees in (4, 8):
                split = invariants.split_level_for(n_trees)
                cap = invariants.buffer_capacity(K.HYBRID_BLOCK_Q, n_trees, 2.0)
                for mapping in ("queue", "direct"):
                    k_ovf, r_ovf = torch.full_like(lanes, -7), torch.full_like(lanes, -7)
                    args = (tree.keys, tree.values, lanes, H, split, mapping, cap)
                    got = K.bst_hybrid_forest_cuda(*args, active=active, ordered=ordered,
                                                   overflow_out=k_ovf, delta=d_ops)
                    want = ref.bst_hybrid_ref(*args, active=active, ordered=ordered,
                                              overflow_out=r_ovf, delta=d_ops)
                    t = f"K2 hybrid split={split} {mapping} {tag}"
                    compare(got + (k_ovf,), want + (r_ovf,), "hybrid_descend_delta", t)
                    check(int(k_ovf[: lanes.shape[0] // 4].sum()) > 0,
                          f"{t}: the equal key set did not overflow")
        log(f"  K2 {label} (C={buf.capacity}, {int(buf.count)} live): forest hrz/dup4/dup8 "
            f"and hybrid split 2, 3 x queue/direct, membership and ordered: 0 mismatches; "
            f"{int(hit.sum())} active lanes hit the buffer, {int((hit & dead).sum())} of them "
            f"tombstones")


# ------------------------------------------------------------ phase 4: server
def oracle(sk, sv, op, a, b=None, k=SCAN_K):
    """Ground truth from np.searchsorted over the sorted key/value view."""
    if op == "lookup":
        i = np.clip(np.searchsorted(sk, a, "left"), 0, sk.size - 1)
        found = sk[i] == a
        return np.where(found, sv[i], SENTINEL_VALUE).astype(np.int32), found
    if op == "predecessor":
        i = np.searchsorted(sk, a, "right") - 1
        ok = i >= 0
        ii = np.clip(i, 0, None)
        return (np.where(ok, sk[ii], NO_PRED_KEY).astype(np.int32),
                np.where(ok, sv[ii], SENTINEL_VALUE).astype(np.int32), ok)
    if op == "successor":
        i = np.searchsorted(sk, a, "left")
        ok = i < sk.size
        ii = np.clip(i, 0, sk.size - 1)
        return (np.where(ok, sk[ii], NO_SUCC_KEY).astype(np.int32),
                np.where(ok, sv[ii], SENTINEL_VALUE).astype(np.int32), ok)
    start = np.searchsorted(sk, a, "left")
    counts = (np.searchsorted(sk, b, "right") - start).clip(0).astype(np.int32)
    if op == "range_count":
        return (counts,)
    take = np.minimum(counts, k)
    pos = start[:, None] + np.arange(k)[None, :]
    valid = np.arange(k)[None, :] < take[:, None]
    pos = np.clip(pos, 0, sk.size - 1)
    keys = np.where(valid, sk[pos], SENTINEL_KEY).astype(np.int32)
    vals = np.where(valid, sv[pos], SENTINEL_VALUE).astype(np.int32)
    return keys, vals, take.astype(np.int32)


def serve_all_configs(keys, values, sets, smi: str, device="cuda") -> list:
    """Each paper config's server over the same keys: the lookup key sets,
    predecessor/successor of absent keys, range_count/range_scan of random
    spans, every answer held against the oracle."""
    sk, sv = keys, values  # make_tree_data's keys are sorted and unique
    rng = np.random.default_rng(3)
    absent = (rng.integers(0, keys.size + 1, STREAM) * 2 + 1).astype(np.int32)
    lo = rng.integers(1, 2 * keys.size, RANGE_STREAM).astype(np.int32)
    hi = (lo + rng.integers(-8, 64, RANGE_STREAM)).astype(np.int32)
    rows = []
    for name, cfg in PAPER_CONFIGS.items():
        cfg = dataclasses.replace(cfg, device=device)
        srv = BSTServer(keys, values, cfg, chunk_size=CHUNK, scan_k=SCAN_K)
        srv.warmup(QUERY_OPS)
        before = dict(K.LAUNCHES)
        fetches = runtime.fetch_count()
        tickets = {f"lookup/{s}": (srv.submit(q), "lookup", q, None) for s, q in sets.items()}
        tickets["predecessor"] = (srv.submit(absent, op="predecessor"), "predecessor", absent, None)
        tickets["successor"] = (srv.submit(absent, op="successor"), "successor", absent, None)
        for op in ("range_count", "range_scan"):
            tickets[op] = (srv.submit_range(lo, hi, op=op), op, lo, hi)
        t0 = time.perf_counter()
        res = srv.drain()
        drain_s = time.perf_counter() - t0
        n_fetch = runtime.fetch_count() - fetches
        check(n_fetch == srv.stats.chunks, f"{name}: {n_fetch} fetches for {srv.stats.chunks} chunks")
        for tag, (ticket, op, a, b) in tickets.items():
            want = oracle(sk, sv, op, a, b)
            got = res[ticket]
            check(len(got) == len(want), f"{name} {tag}: arity")
            for g, w in zip(got, want):
                check(np.array_equal(g, w), f"{name} {tag}: answers differ from the oracle")
        kernel = "hybrid_descend" if cfg.strategy == "hyb" else "forest_descend"
        launched = K.LAUNCHES[kernel] - before[kernel]
        check(launched == srv.stats.chunks, f"{name}: {launched} {kernel} launches for {srv.stats.chunks} chunks")
        st = srv.stats
        row = {
            "config": name,
            "kernel": kernel,
            "lanes": st.lanes,
            "chunks": st.chunks,
            "fetches": n_fetch,
            "busy_s": st.busy_s,
            "lanes_per_sec": st.lanes_per_sec,
            "drain_s": drain_s,
            "lanes_per_drain_sec": st.lanes / drain_s,
            "per_op_lanes_per_sec": {op: s.lanes_per_sec for op, s in st.per_op.items()},
        }
        rows.append(row)
        log(f"  {name}: lanes_per_sec={st.lanes_per_sec!r} (busy), "
            f"{row['lanes_per_drain_sec']!r} (drain wall) over {st.lanes} lanes, "
            f"{st.chunks} chunks, {n_fetch} fetches, answers == oracle ({smi})")
        del srv
    return rows


def profile_drain(keys, values, q) -> dict:
    """Where a steady lookup drain's time goes, over PROFILE_RUNS drains of
    the same keys (see ``profiled_drains``)."""
    srv = BSTServer(keys, values, dataclasses.replace(PAPER_CONFIGS["Hrz"], device="cuda"),
                    chunk_size=CHUNK)
    srv.warmup(("lookup",))
    return {"chunks": PROFILE_CHUNKS, "runs": profiled_drains(srv, lambda _: srv.submit(q))}


def profile_write_drains(keys, values, rounds) -> list:
    """Where a write-path drain's time goes: an Hrz server with the phase-4w
    buffer, two profiled drains of half the stream's rounds each."""
    cfg = dataclasses.replace(PAPER_CONFIGS["Hrz"], device="cuda", delta_capacity=W_CAPACITY)
    srv = BSTServer(keys, values, cfg, chunk_size=CHUNK, scan_k=SCAN_K)
    srv.warmup(QUERY_OPS)
    half = len(rounds) // 2

    def submit(i):
        for rnd in rounds[i * half:(i + 1) * half]:
            srv.submit_write(*rnd["writes"])
            srv.submit_delete(rnd["deletes"])
            for op, a, b, _ in rnd["reads"]:
                srv.submit(a, op=op) if b is None else srv.submit_range(a, b, op=op)

    return profiled_drains(srv, submit, runs=2)


def profiled_drains(srv, submit, runs: int = PROFILE_RUNS) -> list:
    """``runs`` drains of ``srv``, each of what ``submit(i)`` queues: each
    drain's wall time and, from torch.profiler on that same drain, its
    device time (kernels and copies, summed by name).  The profiler's own
    host cost is inside the wall time, so the idle share is an upper
    estimate."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    out = []
    for i in range(runs):
        with torch.profiler.profile(activities=activities) as prof:
            t0 = time.perf_counter()
            submit(i)
            srv.drain()
            wall = time.perf_counter() - t0
        by_name, host = {}, {}
        for ev in prof.key_averages():
            # device-side events (kernels, copies) by their own device time:
            # a host op's row repeats the device time of what it launched
            if ev.device_type == torch.autograd.DeviceType.CUDA and ev.self_device_time_total > 0:
                by_name[ev.key] = by_name.get(ev.key, 0.0) + ev.self_device_time_total
            elif ev.device_type == torch.autograd.DeviceType.CPU and ev.self_cpu_time_total > 0:
                host[ev.key] = host.get(ev.key, 0.0) + ev.self_cpu_time_total
        device_s = sum(by_name.values()) / 1e6
        check(device_s > 0, "the profiler saw no device time")
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        top_host = sorted(host.items(), key=lambda kv: -kv[1])[:8]
        out.append({"wall_s": wall, "device_s": device_s, "idle_share": 1 - device_s / wall,
                    "top": [(name[:80], us) for name, us in top],
                    "top_host_self_us": [(name[:80], us) for name, us in top_host]})
    return out


def log_profile(label: str, runs) -> None:
    for i, run in enumerate(runs):
        log(f"    {label} {i}: wall {run['wall_s']!r} s, device busy {run['device_s']!r} s, "
            f"idle share {run['idle_share']!r}")
        for name, us in run["top"]:
            log(f"      {us!r} us  {name}")
        log("      host ops by self CPU time:")
        for name, us in run["top_host_self_us"]:
            log(f"      {us!r} us  {name}")


# ------------------------------------------------------- phase 4w: the writes
def write_stream(keys, values, seed: int = 11) -> tuple:
    """W_ROUNDS rounds of the write phase's stream, each with the oracle's
    answers for its reads: the reads of a round follow its writes and
    deletes, so they must see the state after them.  The stream is the
    same for every config, so the oracle runs once."""
    rng = np.random.default_rng(seed)
    sk, sv = keys.copy(), values.copy()  # make_tree_data's keys are sorted and unique
    n_odd = keys.size + 1  # odd keys 1 .. 2 n + 1 lie among and beside the even ones
    rounds = []
    for _ in range(W_ROUNDS):
        half = W_WRITES // 2
        wk = np.concatenate([
            (rng.integers(0, n_odd, half) * 2 + 1).astype(np.int32),  # new keys
            sk[rng.integers(0, sk.size, W_WRITES - half)],  # overwrites
        ])
        wk = wk[rng.permutation(wk.size)]
        wv = rng.integers(0, 2**31 - 1, wk.size, dtype=np.int32)
        # upserts, last write wins
        uk, first = np.unique(wk[::-1], return_index=True)
        uv = wv[::-1][first]
        pos = np.searchsorted(sk, uk)
        hit = pos < sk.size
        hit[hit] = sk[pos[hit]] == uk[hit]
        sv = sv.copy()
        sv[pos[hit]] = uv[hit]
        sk, sv = np.insert(sk, pos[~hit], uk[~hit]), np.insert(sv, pos[~hit], uv[~hit])
        n_stored = W_DELETES * 3 // 4
        dk = np.concatenate([
            sk[rng.integers(0, sk.size, n_stored)],
            (rng.integers(0, n_odd, W_DELETES - n_stored) * 2 + 1).astype(np.int32),
        ])
        pos = np.searchsorted(sk, dk)
        hit = pos < sk.size
        hit[hit] = sk[pos[hit]] == dk[hit]
        drop = np.unique(pos[hit])
        sk, sv = np.delete(sk, drop), np.delete(sv, drop)

        third = W_LOOKUPS // 3
        look = np.concatenate([
            wk[rng.integers(0, wk.size, third)],
            dk[rng.integers(0, dk.size, third)],
            rng.integers(1, 2 * n_odd, W_LOOKUPS - 2 * third).astype(np.int32),
        ])
        pred = (rng.integers(0, n_odd, W_POINTS) * 2 + 1).astype(np.int32)
        succ = (rng.integers(0, n_odd, W_POINTS) * 2 + 1).astype(np.int32)
        lo = (wk[rng.integers(0, wk.size, W_RANGES)] + rng.integers(-8, 1, W_RANGES)).astype(np.int32)
        hi = (lo + rng.integers(-8, 64, W_RANGES)).astype(np.int32)
        reads = [("lookup", look, None), ("predecessor", pred, None), ("successor", succ, None),
                 ("range_count", lo, hi), ("range_scan", lo, hi)]
        rounds.append({
            "writes": (wk, wv),
            "deletes": dk,
            "reads": [(op, a, b, oracle(sk, sv, op, a, b)) for op, a, b in reads],
        })
    return rounds, (sk, sv)


def serve_write_path(keys, values, rounds, final, smi: str, device="cuda"):
    """Phase 4w: every paper config with a W_CAPACITY delta buffer serves
    the whole stream in one drain.  Returns the per-config rows and the
    launches of each kernel summed over the configs' drains (each counted
    from 0 just before its drain)."""
    rows, launches = [], {kern: 0 for kern in K.LAUNCHES}
    for name, cfg in PAPER_CONFIGS.items():
        cfg = dataclasses.replace(cfg, device=device, delta_capacity=W_CAPACITY)
        srv = BSTServer(keys, values, cfg, chunk_size=CHUNK, scan_k=SCAN_K)
        srv.warmup(QUERY_OPS)
        tickets = []
        for rnd in rounds:
            srv.submit_write(*rnd["writes"])
            srv.submit_delete(rnd["deletes"])
            for op, a, b, want in rnd["reads"]:
                t = srv.submit(a, op=op) if b is None else srv.submit_range(a, b, op=op)
                tickets.append((t, op, want))
        fetches = runtime.fetch_count()
        K.reset_launches()
        t0 = time.perf_counter()
        res = srv.drain()
        drain_s = time.perf_counter() - t0
        counts = dict(K.LAUNCHES)
        n_fetch = runtime.fetch_count() - fetches
        for kern, n in counts.items():
            launches[kern] += n

        for i, (t, op, want) in enumerate(tickets):
            got = res[t]
            check(len(got) == len(want), f"{name} write phase {op} #{i}: arity")
            for g, w in zip(got, want):
                check(np.array_equal(g, w), f"{name} write phase {op} #{i}: answers differ from the oracle")
        st = srv.stats
        read_chunks = sum(st.per_op[op].chunks for op in QUERY_OPS)
        ingest_chunks = st.chunks - read_chunks
        check(st.compactions >= 1, f"{name}: no compaction in the write phase")
        check(n_fetch == read_chunks + st.compactions,
              f"{name}: {n_fetch} fetches for {read_chunks} read chunks + {st.compactions} compactions")
        kern = "hybrid_descend" if cfg.strategy == "hyb" else "forest_descend"
        other = "forest_descend" if cfg.strategy == "hyb" else "hybrid_descend"
        check(counts[kern + "_delta"] == read_chunks,
              f"{name}: {counts[kern + '_delta']} K2 launches for {read_chunks} read chunks")
        check(counts[kern] == ingest_chunks,
              f"{name}: {counts[kern]} {kern} launches for {ingest_chunks} ingest chunks")
        check(counts[other] == counts[other + "_delta"] == 0, f"{name}: {other} launched")

        # One compaction and one ingest chunk, timed on the state the drain
        # left (neither result is installed), then the final compaction.
        eng = srv.engine
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        delta_lib.compact(eng.tree, eng.delta)
        torch.cuda.synchronize()
        compact_s = time.perf_counter() - t0
        wk, wv = rounds[-1]["writes"]
        k, v = torch.from_numpy(wk).to(device), torch.from_numpy(wv).to(device)
        d = torch.zeros(wk.size, dtype=torch.bool, device=device)
        ok = torch.ones(wk.size, dtype=torch.bool, device=device)
        fresh = delta_lib.empty(W_CAPACITY, device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cls = plans_lib.execute_plan_ordered(eng.plan, k)
        delta_lib.ingest(fresh, k, v, d, ok, cls.found, cls.rank)
        torch.cuda.synchronize()
        ingest_s = time.perf_counter() - t0
        eng.compact()
        skd, svd = eng.plan.sorted_view()
        n_real = eng.tree.n_real
        check(n_real == final[0].size, f"{name}: {n_real} keys after compaction, oracle {final[0].size}")
        check(np.array_equal(skd[:n_real].cpu().numpy(), final[0])
              and np.array_equal(svd[:n_real].cpu().numpy(), final[1]),
              f"{name}: the compacted snapshot differs from the oracle")

        row = {
            "config": name,
            "lanes": st.lanes,
            "read_chunks": read_chunks,
            "ingest_chunks": ingest_chunks,
            "compactions": st.compactions,
            "fetches": n_fetch,
            "launches": counts,
            "busy_s": st.busy_s,
            "lanes_per_sec": st.lanes_per_sec,
            "drain_s": drain_s,
            "lanes_per_drain_sec": st.lanes / drain_s,
            "compaction_s": compact_s,
            "ingest_chunk_s": ingest_s,
            "final_height": eng.tree.height,
            "per_op_lanes_per_sec": {op: s.lanes_per_sec for op, s in st.per_op.items()},
        }
        rows.append(row)
        log(f"  {name}: lanes_per_sec={st.lanes_per_sec!r} (busy), "
            f"{row['lanes_per_drain_sec']!r} (drain wall) over {st.lanes} lanes; "
            f"{read_chunks} read chunks, {ingest_chunks} ingest chunks, {st.compactions} "
            f"compactions, {n_fetch} fetches; one compaction {compact_s!r} s, one ingest "
            f"chunk of {wk.size} {ingest_s!r} s; answers and final snapshot == oracle ({smi})")
        del srv, eng, skd, svd
    return rows, launches


# ------------------------------------------------------------ phase 5: timing
class ColdTimer:
    """Median CUDA-event time of a call, with the L2 flushed before each run
    (the tree is 128 MiB; a serving chunk finds its deep levels cold).  A
    spin kernel holds the stream while the host enqueues the call, so the
    timed region holds device time only, not the host's launch latency
    (a call that enqueues for longer than the spin, as the plain versions
    do, still counts its enqueue time)."""

    def __init__(self):
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, reps: int = TIMING_REPS) -> float:
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))


def touched_bytes(tree, q, ordered: bool) -> int:
    """Bytes this batch must move: queries in, outputs out, and each distinct
    tree node the lanes visit read once (its key; its value where a result
    needs it: at a hit, or at every node of an ordered descent)."""
    H, n = tree.height, tree.n_nodes
    idx = torch.zeros(q.shape, dtype=torch.int64, device=q.device)
    found = torch.zeros(q.shape, dtype=torch.bool, device=q.device)
    visited, hits = [], []
    for _ in range(H + 1):
        live = ~found
        visited.append(idx[live])
        nk = tree.keys[idx]
        hit = (nk == q) & live
        hits.append(idx[hit])
        found |= hit
        nxt = torch.clamp(2 * idx + 1 + (q > nk).long(), max=n - 1)
        idx = torch.where(found, idx, nxt)
    n_visit = int(torch.unique(torch.cat(visited)).numel())
    n_val = n_visit if ordered else int(torch.unique(torch.cat(hits)).numel())
    out_per_lane = 4 * 6 + 1 if ordered else 4 + 1
    return q.numel() * (4 + out_per_lane) + 4 * n_visit + 4 * n_val


def delta_touched_bytes(d_ops, q, ordered: bool) -> int:
    """Bytes of the write buffer that resolving the batch ``q`` must read,
    counted as ``touched_bytes`` counts the tree's: each distinct key slot
    the lanes' lower-bound searches compare, the tombstone at each distinct
    slot a lane hits and the value where that hit is live, and (ordered)
    every weight, since the rank correction sums the weights below q."""
    keys, _, tomb, _ = d_ops
    C = keys.shape[0]
    q = q.reshape(-1)
    lo = torch.zeros(q.shape, dtype=torch.int64, device=q.device)
    hi = torch.full(q.shape, C, dtype=torch.int64, device=q.device)
    seen = []
    while bool((lo < hi).any()):
        open_ = lo < hi
        mid = (lo + hi) >> 1
        seen.append(mid[open_])
        right = open_ & (keys[mid.clamp(max=C - 1)] < q)
        lo = torch.where(right, mid + 1, lo)
        hi = torch.where(open_ & ~right, mid, hi)
    in_range = lo < C
    seen.append(lo[in_range])
    hit_slots = torch.unique(lo[in_range][keys[lo[in_range]] == q[in_range]])
    n_keys = int(torch.unique(torch.cat(seen)).numel())
    n_live = int((tomb[hit_slots] == 0).sum())
    return 4 * n_keys + 4 * hit_slots.numel() + 4 * n_live + (4 * C if ordered else 0)


def kernel_and_plain(tree, cfg, q, ordered: bool, delta=None):
    """The kernel call a config's engine makes for a batch ``q`` (with the
    write buffer's operands ``delta``: K2), and the same call to its plain
    version: ``(kernel name, run, plain, agree)``, where ``agree(tag)`` holds
    the two against each other (with the overflow mask, for the hybrid
    kernel)."""
    H = tree.height
    suffix = "" if delta is None else "_delta"
    if cfg.strategy == "hyb":
        kern = "hybrid_descend" + suffix
        split = invariants.split_level_for(cfg.n_trees)
        cap = invariants.buffer_capacity(K.HYBRID_BLOCK_Q, cfg.n_trees, cfg.buffer_slack)
        args = (tree.keys, tree.values, q, H, split, cfg.mapping, cap)
        run = functools.partial(K.bst_hybrid_forest_cuda, *args, ordered=ordered, delta=delta)
        plain = functools.partial(ref.bst_hybrid_ref, *args, ordered=ordered, delta=delta)

        def agree(tag):
            k_ovf, r_ovf = torch.full_like(q, -7), torch.full_like(q, -7)
            got = run(overflow_out=k_ovf) + (k_ovf,)
            compare(got, plain(overflow_out=r_ovf) + (r_ovf,), kern, tag)
            return int(k_ovf.sum())

        return kern, run, plain, agree
    kern = "forest_descend" + suffix
    T = cfg.n_trees if cfg.strategy == "dup" else 1
    args = (tree.keys[None], tree.values[None], q.reshape(T, -1), H)
    run = functools.partial(K.bst_ordered_forest_cuda, *args, shared_tree=T > 1,
                            ordered=ordered, delta=delta)
    plain = functools.partial(ref.bst_ordered_ref, *args, ordered=ordered, delta=delta)

    def agree(tag):
        compare(run(), plain(), kern, tag)
        return 0

    return kern, run, plain, agree


def time_kernels(tree, pool, skewed, timer, delta=None, library_keys=None) -> list:
    """Each kernel configuration of the main path at its serving shape: held
    against its plain version there on the timing keys and on the skewed
    ``equal`` set (which forces the hybrid kernel's stall round), then
    timed on the timing keys.  With ``delta`` (a write buffer) the kernels
    run their delta configuration, the byte bound adds the buffer bytes the
    batch must read (``delta_touched_bytes``), and the yardstick searches
    ``library_keys`` (the merged sorted view) instead of the snapshot's."""
    H = tree.height
    if library_keys is None:
        library_keys = tree.keys[torch.from_numpy(rank_to_bfs_indices(H)).long().cuda()]
    d_ops = None if delta is None else delta_lib.operands(delta)
    rows = []
    for name, cfg in PAPER_CONFIGS.items():
        for ordered in (False, True):
            lanes = 2 * CHUNK if ordered else CHUNK  # range ops descend lo || hi
            mode = "ordered" if ordered else "membership"
            q = pool[:lanes].contiguous()
            kern, _, _, agree = kernel_and_plain(tree, cfg, skewed[:lanes].contiguous(), ordered, d_ops)
            replayed = agree(f"{name} {mode} x{lanes} equal keys")
            check(cfg.strategy != "hyb" or replayed > 0,
                  f"{name} {mode}: the equal key set did not overflow")
            kern, run, plain, agree = kernel_and_plain(tree, cfg, q, ordered, d_ops)
            agree(f"{name} {mode} x{lanes}")
            n_bytes = touched_bytes(tree, q, ordered)
            if d_ops is not None:
                n_bytes += delta_touched_bytes(d_ops, q, ordered)
            rows.append({
                "kernel": kern,
                "config": f"{name} {mode}",
                "lanes": lanes,
                "ms": timer(run),
                "plain_ms": timer(plain, reps=5),
                "library_ms": timer(functools.partial(torch.searchsorted, library_keys, q)),
                "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
            })
            r = rows[-1]
            log(f"  {kern} {r['config']} x{lanes}: 0 mismatches ({replayed} equal-set "
                f"lanes replayed), ms={r['ms']!r} "
                f"plain_ms={r['plain_ms']!r} library_ms={r['library_ms']!r} "
                f"bound_ms={r['bound_ms']!r}")
    return rows


# ------------------------------------------------------------- phase 6: LM
def visible_pairs(Sq: int, Skv: int, causal: bool, window) -> int:
    """(q row, key) pairs one head row attends to: the work K5 must do."""
    qpos = np.arange(Sq, dtype=np.int64) + (Skv - Sq)
    lo = np.zeros(Sq, np.int64) if window is None else np.maximum(0, qpos - window + 1)
    hi = np.minimum(Skv - 1, qpos) if causal else np.full(Sq, Skv - 1, np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def flash_operands(shape, dtype, seed: int):
    BH, BHkv, Sq, Skv, d, _, _ = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(s, generator=gen, device="cuda").to(dtype)
                 for s in ((BH, Sq, d), (BHkv, Skv, d), (BHkv, Skv, d)))


def check_flash_kernel() -> list:
    """K5 against its plain version at every FLASH_SHAPES shape, fp32 and
    bf16: per case the elements outside the tolerance (``mismatches``) and
    the largest absolute difference.  Fails on any mismatch, and if a row
    with no visible key is not 0."""
    rows = []
    for i, shape in enumerate(FLASH_SHAPES):
        _, _, Sq, Skv, d, causal, window = shape
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = flash_operands(shape, dtype, seed=i)
            got = FA.flash_attention_cuda(q, k, v, causal=causal, window=window)
            want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
            tol = FLASH_TOL[dtype]
            diff = (got.float() - want.float()).abs()
            bad = int((diff > tol + tol * want.float().abs()).sum())
            err = float(diff.max())
            empty = causal and Sq > Skv and bool(got[:, : Sq - Skv].any())
            rows.append({"shape": list(shape), "dtype": str(dtype).replace("torch.", ""),
                         "mismatches": bad, "max_abs_err": err, "tol": tol})
            log(f"  K5 {shape} {rows[-1]['dtype']}: mismatches {bad}, max_abs_err {err!r} "
                f"(tolerance atol = rtol = {tol})")
            check(bad == 0, f"K5 {shape} {dtype}: {bad} elements outside the tolerance")
            check(not empty, f"K5 {shape} {dtype}: a row with no visible key is not 0")
            del q, k, v, got, want, diff
    return rows


def check_full_model_fp32(cfg, smi: str) -> dict:
    """qwen3-1.7b in fp32 at full width and depth, 1 x LM_CHECK_PROMPT: the
    flash route (K5) against the naive route (plain attention) over prefill
    and LM_CHECK_STEPS decode steps, then each decode step against a prefill
    of the longer prompt."""
    cfg32 = dataclasses.replace(cfg, dtype="float32", attention_impl="flash")
    naive = dataclasses.replace(cfg32, attention_impl="naive")
    model = lm.init_params(cfg32, seed=0, device="cuda")
    total = LM_CHECK_PROMPT + LM_CHECK_STEPS
    toks = torch.from_numpy(np.random.default_rng(7).integers(0, cfg.vocab_size, (1, total))).cuda()

    def run(c):
        logits, state = lm.prefill(c, model, toks[:, :LM_CHECK_PROMPT], max_len=total)
        check(bool(torch.isfinite(logits).all()), f"fp32 {c.attention_impl} prefill: a logit is not finite")
        out = [logits]
        for t in range(LM_CHECK_PROMPT, total):
            logits, state = lm.decode_step(c, model, toks[:, t:t + 1], state)
            out.append(logits)
        return out

    FA.reset_launches()
    flash = run(cfg32)
    check(FA.LAUNCHES["flash_attention"] == cfg.n_layers,
          f"fp32 prefill: {FA.LAUNCHES['flash_attention']} K5 launches for {cfg.n_layers} layers")
    plain = run(naive)
    route_err = max(float((a - b).abs().max()) for a, b in zip(flash, plain))
    for a, b in zip(flash, plain):
        torch.testing.assert_close(a, b, atol=LM_CHECK_TOL, rtol=LM_CHECK_TOL)
    consistency_err = 0.0
    for t, logits in enumerate(flash[1:], start=1):
        want, _ = lm.prefill(cfg32, model, toks[:, :LM_CHECK_PROMPT + t])
        consistency_err = max(consistency_err, float((logits - want).abs().max()))
        torch.testing.assert_close(logits, want, atol=LM_CHECK_TOL, rtol=LM_CHECK_TOL)
    row = {"prompt": LM_CHECK_PROMPT, "decode_steps": len(flash) - 1,
           "flash_vs_naive_max_abs_err": route_err,
           "decode_vs_prefill_max_abs_err": consistency_err, "tol": LM_CHECK_TOL,
           "logit_scale": float(flash[0].abs().max())}
    log(f"  fp32 {cfg.name}, {cfg.n_layers} layers, 1 x {LM_CHECK_PROMPT}: flash vs naive route "
        f"max_abs_err {route_err!r}, decode vs longer prefill {consistency_err!r} over "
        f"{len(flash) - 1} steps (tolerance {LM_CHECK_TOL}; largest logit "
        f"{row['logit_scale']!r}) ({smi})")
    del model, flash, plain
    torch.cuda.empty_cache()
    return row


def serve_lm(cfg, smi: str) -> dict:
    """The serving run: qwen3-1.7b in bf16 through ``greedy_generate`` with
    K5's launches counted from 0, then the same prefill and decode steps
    timed one by one through the serve loop's units, their logits checked
    finite and their tokens held against greedy_generate's, and a profile of
    decode steps."""
    model = lm.init_params(cfg, seed=0, device="cuda")
    prompts = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT))).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    FA.reset_launches()
    tokens = greedy_generate(cfg, model, prompts, LM_NEW)
    torch.cuda.synchronize()
    launches = FA.LAUNCHES["flash_attention"]
    peak = torch.cuda.max_memory_allocated()
    check(launches == cfg.n_layers, f"serving: {launches} K5 launches for one prefill of "
                                    f"{cfg.n_layers} layers")
    check(tuple(tokens.shape) == (LM_BATCH, LM_NEW), f"greedy_generate gave {tuple(tokens.shape)}")

    prefill_fn = make_prefill_fn(cfg, max_len=LM_PROMPT + LM_NEW)
    step = make_serve_step(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, state = prefill_fn(model, prompts)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    all_logits = [logits]
    tok = logits.argmax(dim=-1, keepdim=True)
    outs = [tok]
    for _ in range(LM_NEW - 1):
        logits, state = step(model, tok, state)
        all_logits.append(logits)
        tok = logits.argmax(dim=-1, keepdim=True)
        outs.append(tok)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    check(all(bool(torch.isfinite(lg).all()) for lg in all_logits), "serving: a logit is not finite")
    check(torch.equal(torch.cat(outs, dim=1), tokens),
          "serving: the timed steps' tokens differ from greedy_generate's")
    prefill_s, decode_s = t1 - t0, t2 - t1
    n_steps = LM_NEW - 1

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        torch.cuda.synchronize()
        p0 = time.perf_counter()
        for _ in range(LM_PROFILE_STEPS):
            logits, state = step(model, tok, state)
            tok = logits.argmax(dim=-1, keepdim=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - p0
    by_name, host, device_events = {}, {}, 0
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.self_device_time_total > 0:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + ev.self_device_time_total
            device_events += ev.count
        elif ev.device_type == torch.autograd.DeviceType.CPU and ev.self_cpu_time_total > 0:
            host[ev.key] = host.get(ev.key, 0.0) + ev.self_cpu_time_total
    device_s = sum(by_name.values()) / 1e6
    check(device_s > 0, "the profiler saw no device time in the decode steps")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    top_host = sorted(host.items(), key=lambda kv: -kv[1])[:8]
    row = {
        "arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads, "head_dim": cfg.resolved_head_dim,
        "vocab": cfg.vocab_size, "dtype": cfg.dtype, "params": cfg.n_params(),
        "batch": LM_BATCH, "prompt": LM_PROMPT, "new_tokens": LM_NEW,
        "flash_launches": launches, "peak_bytes": peak,
        "prefill_s": prefill_s, "prefill_tok_per_s": LM_BATCH * LM_PROMPT / prefill_s,
        "decode_steps": n_steps, "decode_ms_per_step": decode_s / n_steps * 1e3,
        "decode_tok_per_s": LM_BATCH * n_steps / decode_s,
        "decode_profile": {"steps": LM_PROFILE_STEPS, "wall_s": wall, "device_s": device_s,
                           "idle_share": 1 - device_s / wall,
                           "device_events_per_step": device_events / LM_PROFILE_STEPS,
                           "top": [(name[:80], us) for name, us in top],
                           "top_host_self_us": [(name[:80], us) for name, us in top_host]},
        "sample_ids": tokens[0, :16].tolist(),
    }
    log(f"  {cfg.name} bf16, {cfg.n_layers} layers, {LM_BATCH} x {LM_PROMPT} + {LM_NEW}: "
        f"K5 launches {launches}, prefill {prefill_s!r} s ({row['prefill_tok_per_s']!r} tok/s), "
        f"decode {row['decode_ms_per_step']!r} ms/step ({row['decode_tok_per_s']!r} tok/s), "
        f"peak {peak} bytes, every logit finite ({smi})")
    log(f"    decode profile, {LM_PROFILE_STEPS} steps: wall {wall!r} s, device busy "
        f"{device_s!r} s, idle share {row['decode_profile']['idle_share']!r}, "
        f"{device_events / LM_PROFILE_STEPS!r} device kernels and copies per step")
    for name, us in top:
        log(f"      {us!r} us  {name[:120]}")
    log("      host ops by self CPU time:")
    for name, us in top_host:
        log(f"      {us!r} us  {name[:120]}")
    log(f"    sample ids {row['sample_ids']}")
    del model, state, all_logits
    torch.cuda.empty_cache()
    return row


def time_flash(timer) -> dict:
    """K5 at the serving shape (bf16), its plain version and
    scaled_dot_product_attention (the library yardstick, never called by the
    port), beside the least time the card could take for the same work."""
    shape = FLASH_SHAPES[-1]
    BH, BHkv, Sq, Skv, d, causal, window = shape
    q, k, v = flash_operands(shape, torch.bfloat16, seed=99)
    got = FA.flash_attention_cuda(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    err = float((got.float() - want.float()).abs().max())
    B = LM_BATCH
    q4, k4, v4 = (t.view(B, t.shape[0] // B, t.shape[1], d) for t in (q, k, v))
    sdpa = functools.partial(torch.nn.functional.scaled_dot_product_attention, q4, k4, v4,
                             is_causal=True, enable_gqa=True)
    lib_err = float((sdpa().reshape(BH, Sq, d).float() - want.float()).abs().max())
    flop = 4 * BH * d * visible_pairs(Sq, Skv, causal, window)
    n_bytes = sum(t.numel() * t.element_size() for t in (q, k, v, got))
    row = {
        "shape": list(shape), "dtype": "bfloat16",
        "ms": timer(functools.partial(FA.flash_attention_cuda, q, k, v, causal=causal, window=window)),
        "plain_ms": timer(functools.partial(ref.flash_attention_ref, q, k, v, causal=causal,
                                            window=window), reps=5),
        "library_ms": timer(sdpa),
        "flop": flop, "bytes": n_bytes,
        "flop_ms": flop / BF16_FLOP_PER_S * 1e3, "bytes_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
        "max_abs_err": err, "library_max_abs_err": lib_err,
    }
    row["bound_ms"] = max(row["flop_ms"], row["bytes_ms"])
    row["bound_by"] = "operations" if row["flop_ms"] >= row["bytes_ms"] else "bytes"
    log(f"  K5 {shape} bf16: ms={row['ms']!r} plain_ms={row['plain_ms']!r} "
        f"library_ms={row['library_ms']!r} bound_ms={row['bound_ms']!r} ({row['bound_by']}: "
        f"{flop} FLOP over {BF16_FLOP_PER_S:.3g}/s = {row['flop_ms']!r} ms, {n_bytes} bytes over "
        f"{HBM_BYTES_PER_S:.3g}/s = {row['bytes_ms']!r} ms); max_abs_err vs plain {err!r}, "
        f"sdpa vs plain {lib_err!r}")
    return row


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", help="also write every measurement to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    # fp32 matrix products in full fp32 for every check (the defaults, set
    # so that no environment changes them): TF32 keeps about 3 digits.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    log(f"[1] card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")

    built = _build.library()
    log(f"[2] built {os.path.relpath(built.path, ROOT)} in {built.seconds:.3f} s")
    resources = ptxas_resources(built.log)
    for kern, (regs, smem, spills) in resources.items():
        log(f"    {kern}: {regs} registers, {smem} bytes static shared memory, {spills}")
    occupancy = {}
    for kern, threads in (("forest_descend_kernel", FOREST_CTA),
                          ("hybrid_descend_kernel", K.HYBRID_BLOCK_Q)):
        for ordered in (0, 1):
            for mapping in ((0, 1) if kern.startswith("hybrid") else (None,)):
                targs = (ordered, 1) if mapping is None else (ordered, mapping, 1)
                label = f"{kern}<{','.join(map(str, targs))}>"
                check(label in resources, f"ptxas reported no resources for {label}")
                regs, smem, _ = resources[label]
                ctas = ctas_per_sm(threads, regs, smem + delta_smem_bytes(W_CAPACITY, ordered))
                tag = (f"{kern.replace('_kernel', '_delta')} {'ordered' if ordered else 'membership'}"
                       + ("" if mapping is None else f" {('queue', 'direct')[mapping]}"))
                occupancy[tag] = {"registers": regs, "blocks_per_sm": ctas,
                                  "threads_per_sm": ctas * threads,
                                  "theoretical_occupancy": ctas * threads / SM_THREADS}
                log(f"    {tag} at C={W_CAPACITY}: {ctas} CTAs of {threads} threads per SM "
                    f"(theoretical occupancy {ctas * threads / SM_THREADS!r})")
    limits = {kern: K.delta_capacity_limit(torch.device("cuda"), hybrid)
              for hybrid, kern in ((False, "forest_descend_delta"), (True, "hybrid_descend_delta"))}
    log(f"    delta capacity limit (shared memory of one CTA): {limits}")

    keys, values = make_tree_data(N_KEYS)
    tree = build_tree(keys, values, device="cuda")
    check(tree.height == 23, f"tree height {tree.height}")
    sets = make_key_sets(tree, CHECK_LANES // 4)
    rng = np.random.default_rng(2)
    absent = (sets["random"] + 1).astype(np.int32)  # keys are even: odd ones are absent
    lanes_np = np.concatenate([sets["equal"], sets["random"], sets["split"], absent])
    lanes = torch.from_numpy(lanes_np).cuda()
    active = torch.from_numpy(rng.random(CHECK_LANES) > 1 / 16).cuda()
    log(f"[3] kernels vs plain versions, H={tree.height}, {CHECK_LANES} lanes")
    check_kernels(tree, lanes, active)
    check_edge_trees()
    full = full_buffer(tree, keys, W_CAPACITY, seed=5)
    live = full.keys.cpu().numpy()
    d_lanes = lanes.clone()
    d_lanes[-W_CAPACITY:] = torch.from_numpy(rng.permutation(live)).cuda()  # in place of absent keys
    # C = 1: a tombstone of a stored key among the lanes (the random set's first)
    one = buffer_of(tree, sets["random"][:1], np.zeros(1, np.int32), np.ones(1, bool), 1)
    check_delta_kernels(tree, d_lanes, active, {
        "full buffer": full, "empty buffer": delta_lib.empty(W_CAPACITY, "cuda"), "one entry": one,
    })
    torch.cuda.synchronize()

    log(f"[4] BSTServer, chunk {CHUNK}, every paper config")
    K.reset_launches()
    served = serve_all_configs(keys, values, make_key_sets(tree, STREAM), smi)
    launches = dict(K.LAUNCHES)
    for kern, n in launches.items():
        if kern.endswith("_delta"):
            check(n == 0, f"{kern} launched on the read-only path")
        else:
            check(n > 0, f"{kern} never launched on the main path")
    log(f"    launches on the read path: {launches}")
    busy = profile_drain(keys, values, make_key_sets(tree, PROFILE_CHUNKS * CHUNK)["random"])
    log_profile(f"Hrz lookup drain of {PROFILE_CHUNKS} chunks", busy["runs"])

    log(f"[4w] the write path: BSTServer, chunk {CHUNK}, delta capacity {W_CAPACITY}, "
        f"every paper config; {W_ROUNDS} rounds of {W_WRITES} writes, {W_DELETES} deletes, "
        f"{W_LOOKUPS} lookups, {W_POINTS} predecessor, {W_POINTS} successor, {W_RANGES} "
        f"range_count, {W_RANGES} range_scan")
    t0 = time.perf_counter()
    rounds, final = write_stream(keys, values)
    log(f"    stream and oracle built in {time.perf_counter() - t0!r} s")
    for h in (tree.height, tree.height + 1):  # set-up: the re-layout maps a compaction reads
        tree_lib.rank_to_bfs_on(h, tree.device)
        tree_lib.bfs_inorder_ranks_on(h, tree.device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    written, w_launches = serve_write_path(keys, values, rounds, final, smi)
    peak = torch.cuda.max_memory_allocated()
    for kern, n in w_launches.items():
        check(n > 0, f"{kern} never launched on the write path")
    log(f"    launches on the write path: {w_launches}")
    log(f"    peak device memory of the write phase: {peak} bytes "
        f"(torch.cuda.max_memory_allocated, the phase 3 tree and buffers included)")
    write_profile = profile_write_drains(keys, values, rounds)
    log_profile(f"Hrz write-path drain of {W_ROUNDS // 2} rounds", write_profile)

    log("[5] kernels vs plain versions at the main path's shapes; times (CUDA events, L2 flushed, median)")
    serving_sets = make_key_sets(tree, 2 * CHUNK)
    pool = torch.from_numpy(serving_sets["random"]).cuda()
    skewed = torch.from_numpy(serving_sets["equal"]).cuda()
    timer = ColdTimer()
    timings = time_kernels(tree, pool, skewed, timer)
    # K2 with the full phase-3 buffer; its yardstick searches the merged
    # sorted view (snapshot and buffer), built here outside the timing.
    m_keys, _, m_count = delta_lib.compact_sorted(
        tree.keys, tree.values, tree_lib.rank_to_bfs_on(tree.height, tree.device),
        tree.n_real, full, tree.n_real + full.capacity,
    )
    merged = m_keys[: int(m_count)].contiguous()
    timings += time_kernels(tree, pool, skewed, timer, delta=full, library_keys=merged)

    log(f"    [5] done at {time.perf_counter() - t_start:.1f} s")

    log(f"[6] LM serving: {LM_ARCH}; K5 vs its plain version (fp32, bf16)")
    for kern in ("flash_fwd_kernel<bf16,128>", "flash_fwd_kernel<float,128>"):
        check(kern in resources, f"ptxas reported no resources for {kern}")
    cfg = get_config(LM_ARCH)
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
           cfg.vocab_size, cfg.dtype) == (28, 2048, 16, 8, 128, 151936, "bfloat16"),
          f"{LM_ARCH} is not at its published width and depth: {cfg}")
    del tree, full, pool, skewed, merged, m_keys
    torch.cuda.empty_cache()
    flash_checks = check_flash_kernel()
    full_model = check_full_model_fp32(cfg, smi)
    lm_served = serve_lm(cfg, smi)
    flash_timing = time_flash(timer)
    flash_resources = {k: v for k, v in resources.items() if k.startswith("flash")}

    # The headline row of each kernel: the lookup chunk of Hrz and of Hyb8q.
    headline = {"forest_descend": "Hrz membership", "hybrid_descend": "Hyb8q membership",
                "forest_descend_delta": "Hrz membership",
                "hybrid_descend_delta": "Hyb8q membership"}
    path_launches = {**{k: launches[k] for k in ("forest_descend", "hybrid_descend")},
                     **{k: w_launches[k] for k in ("forest_descend_delta", "hybrid_descend_delta")}}
    kernels = []
    for kern, config in headline.items():
        row = next(r for r in timings if r["config"] == config and r["kernel"] == kern)
        kernels.append({
            "name": kern,
            "route": "cuda",
            "source": SOURCE,
            "replaces": REPLACES[kern],
            "launches": path_launches[kern],
            "mismatches": AGREEMENT[kern]["mismatches"],
            "max_abs_err": AGREEMENT[kern]["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": "bytes",
            "library_ms": row["library_ms"],
            "config": f"{config} x{row['lanes']}",
            "configs": [r for r in timings if r["kernel"] == kern],
        })
    kernels.append({
        "name": "flash_attention",
        "route": "cuda",
        "source": FLASH_SOURCE,
        "replaces": FLASH_REPLACES,
        "launches": lm_served["flash_launches"],
        "mismatches": sum(r["mismatches"] for r in flash_checks),
        "max_abs_err": max(r["max_abs_err"] for r in flash_checks),
        "tolerance": {str(k).replace("torch.", ""): v for k, v in FLASH_TOL.items()},
        "ms": flash_timing["ms"],
        "plain_ms": flash_timing["plain_ms"],
        "bound_ms": flash_timing["bound_ms"],
        "bound_by": flash_timing["bound_by"],
        "library_ms": flash_timing["library_ms"],
        "config": f"{LM_ARCH} prefill attention {flash_timing['shape']} bf16",
        "ptxas": {k: list(v) for k, v in flash_resources.items()},
    })
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"card": smi, "kernels": kernels, "served": served,
                       "hrz_drain_profile": busy, "written": written,
                       "write_phase_launches": w_launches, "write_phase_peak_bytes": peak,
                       "hrz_write_drain_profile": write_profile,
                       "delta_occupancy": occupancy, "delta_capacity_limit": limits,
                       "flash_checks": flash_checks, "lm_full_model_fp32": full_model,
                       "lm_served": lm_served, "flash_timing": flash_timing,
                       "seconds": time.perf_counter() - t_start}, f, indent=1)
    log(f"[7] done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
