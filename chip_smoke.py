#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's single-chip BST read path on one card.

    python3 chip_smoke.py [--json PATH]

Phases, in order; any failure raises and exits non-zero:

1. identify the card (name and power limit from nvidia-smi, versions);
2. build the kernels from ``src/repro_torch/kernels/csrc`` with nvcc;
3. hold each kernel against its plain PyTorch version on the card, bit for
   bit, over a 2^24 - 1 key tree and 65,536 lanes (the paper's equal,
   random and split key sets, absent keys and inactive lanes), plus the
   height-0 and minimal hybrid trees;
4. serve the paper's streams through ``BSTServer`` for each of the seven
   paper configurations over the same tree, check every answer against a
   numpy searchsorted oracle, and check that each kernel of the path was
   launched and that each retired chunk made exactly one device fetch;
   then profile Hrz lookup drains for the device's idle share;
5. at the main path's shapes, hold each kernel configuration against its
   plain version once more, then time the kernel, its plain version and
   ``torch.searchsorted`` (the library yardstick, never called by the port)
   with CUDA events, beside the byte bound of the same work;
6. print the ``{"kernels": [...]}`` line, the card's line, and last the
   ``{"ok": true, ...}`` line.

Needs one CUDA card; exits with code 2 and prints no result without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import invariants, runtime  # noqa: E402
from repro_torch.core import PAPER_CONFIGS, QUERY_OPS  # noqa: E402
from repro_torch.core.tree import (  # noqa: E402
    NO_PRED_KEY,
    NO_SUCC_KEY,
    SENTINEL_KEY,
    SENTINEL_VALUE,
    build_tree,
    rank_to_bfs_indices,
)
from repro_torch.data.keysets import make_key_sets, make_tree_data  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import bst_search as K  # noqa: E402
from repro_torch.serving import BSTServer  # noqa: E402

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
REPLACES = {
    "forest_descend": "src/repro/kernels/bst_search.py:255",
    "hybrid_descend": "src/repro/kernels/bst_search.py:404",
}


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
    the same keys: each drain's wall time and, from torch.profiler on that
    same drain, its device time (kernels and copies, summed by name).  The
    profiler's own host cost is inside the wall time, so the idle share is
    an upper estimate."""
    srv = BSTServer(keys, values, dataclasses.replace(PAPER_CONFIGS["Hrz"], device="cuda"),
                    chunk_size=CHUNK)
    srv.warmup(("lookup",))
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    runs = []
    for _ in range(PROFILE_RUNS):
        with torch.profiler.profile(activities=activities) as prof:
            t0 = time.perf_counter()
            srv.submit(q)
            srv.drain()
            wall = time.perf_counter() - t0
        by_name = {}
        for ev in prof.key_averages():
            # device-side events only (kernels, copies): a host op's row
            # repeats the device time of what it launched
            if ev.device_type == torch.autograd.DeviceType.CUDA and ev.self_device_time_total > 0:
                by_name[ev.key] = by_name.get(ev.key, 0.0) + ev.self_device_time_total
        device_s = sum(by_name.values()) / 1e6
        check(device_s > 0, "the profiler saw no device time")
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        runs.append({"wall_s": wall, "device_s": device_s, "idle_share": 1 - device_s / wall,
                     "top": [(name[:80], us) for name, us in top]})
    return {"chunks": PROFILE_CHUNKS, "runs": runs}


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


def kernel_and_plain(tree, cfg, q, ordered: bool):
    """The kernel call a config's engine makes for a batch ``q``, and the
    same call to its plain version: ``(kernel name, run, plain, agree)``,
    where ``agree(tag)`` holds the two against each other (with the
    overflow mask, for the hybrid kernel)."""
    H = tree.height
    if cfg.strategy == "hyb":
        split = invariants.split_level_for(cfg.n_trees)
        cap = invariants.buffer_capacity(K.HYBRID_BLOCK_Q, cfg.n_trees, cfg.buffer_slack)
        args = (tree.keys, tree.values, q, H, split, cfg.mapping, cap)
        run = functools.partial(K.bst_hybrid_forest_cuda, *args, ordered=ordered)
        plain = functools.partial(ref.bst_hybrid_ref, *args, ordered=ordered)

        def agree(tag):
            k_ovf, r_ovf = torch.full_like(q, -7), torch.full_like(q, -7)
            got = run(overflow_out=k_ovf) + (k_ovf,)
            compare(got, plain(overflow_out=r_ovf) + (r_ovf,), "hybrid_descend", tag)
            return int(k_ovf.sum())

        return "hybrid_descend", run, plain, agree
    T = cfg.n_trees if cfg.strategy == "dup" else 1
    args = (tree.keys[None], tree.values[None], q.reshape(T, -1), H)
    run = functools.partial(K.bst_ordered_forest_cuda, *args, shared_tree=T > 1, ordered=ordered)
    plain = functools.partial(ref.bst_ordered_ref, *args, ordered=ordered)

    def agree(tag):
        compare(run(), plain(), "forest_descend", tag)
        return 0

    return "forest_descend", run, plain, agree


def time_kernels(tree, pool, skewed, timer) -> list:
    """Each kernel configuration of the main path at its serving shape: held
    against its plain version there on the timing keys and on the skewed
    ``equal`` set (which forces the hybrid kernel's stall round), then
    timed on the timing keys."""
    H = tree.height
    sorted_keys = tree.keys[torch.from_numpy(rank_to_bfs_indices(H)).long().cuda()]
    rows = []
    for name, cfg in PAPER_CONFIGS.items():
        for ordered in (False, True):
            lanes = 2 * CHUNK if ordered else CHUNK  # range ops descend lo || hi
            mode = "ordered" if ordered else "membership"
            q = pool[:lanes].contiguous()
            kern, _, _, agree = kernel_and_plain(tree, cfg, skewed[:lanes].contiguous(), ordered)
            replayed = agree(f"{name} {mode} x{lanes} equal keys")
            check(kern == "forest_descend" or replayed > 0,
                  f"{name} {mode}: the equal key set did not overflow")
            kern, run, plain, agree = kernel_and_plain(tree, cfg, q, ordered)
            agree(f"{name} {mode} x{lanes}")
            rows.append({
                "kernel": kern,
                "config": f"{name} {mode}",
                "lanes": lanes,
                "ms": timer(run),
                "plain_ms": timer(plain, reps=5),
                "library_ms": timer(functools.partial(torch.searchsorted, sorted_keys, q)),
                "bound_ms": touched_bytes(tree, q, ordered) / HBM_BYTES_PER_S * 1e3,
            })
            r = rows[-1]
            log(f"  {kern} {r['config']} x{lanes}: 0 mismatches ({replayed} equal-set "
                f"lanes replayed), ms={r['ms']!r} "
                f"plain_ms={r['plain_ms']!r} library_ms={r['library_ms']!r} "
                f"bound_ms={r['bound_ms']!r}")
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", help="also write every measurement to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    log(f"[1] card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")

    built = _build.library()
    log(f"[2] built {os.path.relpath(built.path, ROOT)} in {built.seconds:.3f} s")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"    {line.strip()}")

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
    torch.cuda.synchronize()

    log(f"[4] BSTServer, chunk {CHUNK}, every paper config")
    K.reset_launches()
    served = serve_all_configs(keys, values, make_key_sets(tree, STREAM), smi)
    launches = dict(K.LAUNCHES)
    for kern, n in launches.items():
        check(n > 0, f"{kern} never launched on the main path")
    log(f"    launches on the main path: {launches}")
    busy = profile_drain(keys, values, make_key_sets(tree, PROFILE_CHUNKS * CHUNK)["random"])
    for i, run in enumerate(busy["runs"]):
        log(f"    Hrz lookup drain {i}, {PROFILE_CHUNKS} chunks: wall {run['wall_s']!r} s, "
            f"device busy {run['device_s']!r} s, idle share {run['idle_share']!r}")
        for name, us in run["top"]:
            log(f"      {us!r} us  {name}")

    log("[5] kernels vs plain versions at the main path's shapes; times (CUDA events, L2 flushed, median)")
    serving_sets = make_key_sets(tree, 2 * CHUNK)
    pool = torch.from_numpy(serving_sets["random"]).cuda()
    skewed = torch.from_numpy(serving_sets["equal"]).cuda()
    timings = time_kernels(tree, pool, skewed, ColdTimer())

    # The headline row of each kernel: the lookup chunk of Hrz and of Hyb8q.
    headline = {"forest_descend": "Hrz membership", "hybrid_descend": "Hyb8q membership"}
    kernels = []
    for kern, config in headline.items():
        row = next(r for r in timings if r["config"] == config)
        kernels.append({
            "name": kern,
            "route": "cuda",
            "source": SOURCE,
            "replaces": REPLACES[kern],
            "launches": launches[kern],
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
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"card": smi, "kernels": kernels, "served": served,
                       "hrz_drain_profile": busy,
                       "seconds": time.perf_counter() - t_start}, f, indent=1)
    log(f"[6] done in {time.perf_counter() - t_start:.1f} s")
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
