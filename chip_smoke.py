#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one card: the BST read and write paths, LM and MoE serving.

    python3 chip_smoke.py [--json PATH]

Phases, in order; any failure raises and exits non-zero:

1. identify the card (name and power limit from nvidia-smi, versions);
2. build the kernels from ``src/repro_torch/kernels/csrc`` with nvcc (one
   process per source, all at once), and report ptxas's registers, spills
   and shared memory per kernel, K2's theoretical occupancy at its
   dynamic shared memory (both bodies' delta sample, the hybrid body's
   label table), the hybrid body's queue split limit, both bodies' design
   (levels staged and per round trip, sampled delta lines) against their
   twins in ``kernels/ref.py``, and the HGMMA (wgmma) instructions in each
   K5 body's SASS (``cuobjdump``): the bf16 body must have some;
3. hold each kernel against its plain PyTorch version on the card, bit for
   bit, over a 2^24 - 1 key tree and 65,536 lanes (the paper's equal,
   random and split key sets, absent keys and inactive lanes), plus the
   height-0 and minimal hybrid trees; then the delta configuration (K2)
   of both kernels the same way, against a full 4096-entry write buffer
   (upserts, overwrites, tombstones of stored and absent keys), an empty
   one, a one-entry one, and 20,000- and 140,000-entry ones (sampled
   lines of 32, 64 and 128 slots); an hrz engine with a 140,000-entry
   buffer built, written and read against a dict oracle;
4. serve the paper's streams through ``BSTServer`` for each of the seven
   paper configurations over the same tree, check every answer against a
   numpy searchsorted oracle, and check that each kernel of the path was
   launched and that each retired chunk made exactly one device fetch;
   ``warmup`` captures each op's CUDA graph (captures and capture time per
   config are logged), and the drain captures nothing and runs every chunk
   as one replay (one descent kernel a chunk, no wrapper call); one chunk
   of lookup, predecessor and range_scan is profiled per config through
   the graph and through the engine's eager route (device kernels, host
   launch calls, idle share); then profile Hrz lookup drains for the
   device's idle share;
4w. the live write path: each paper configuration with a 4096-entry delta
   buffer serves one stream of interleaved writes, deletes and reads of
   all five ops over the same tree, every answer held against a numpy
   oracle of the state the read must see; ``warmup`` captures the
   engine's graphs first (five queries, the ingest, the compaction's merge
   and layout), so every read chunk, ingest chunk and compaction step of
   the drain is a replay; the fetch budget (one per read chunk, one per
   compaction), the launch counts (K2 once per read chunk, K1 or K3 once
   per ingest chunk, every one replayed) and the captures (every graph
   once inside the compaction that grows the tree to height 24, none in
   the others) are checked, and so is the snapshot after a final
   compaction; then, on an engine of the same tree, the ingest graph and
   the compaction's graphs against their eager route bit for bit
   (``_ingest_step``, ``delta.compact``: buffer, BFS image, sorted view,
   count) through one compaction that grows the tree and three that keep
   it, both routes timed, and for Hrz one ingest chunk profiled on either
   route (host launch calls); chunk profiles as in phase 4, the Hrz
   write drain's idle share and the phase's peak memory are logged;
4s. sharded serving (``BSTServer(mesh=...)``, ``core/distributed.py``) for
   hrz, dup and hyb (as Hrz, Dup4, Hyb4q) over the same tree: at world 1
   over NCCL in this process, then at 4 ranks spawned on the one card over
   gloo (NCCL puts no two ranks on one card); per strategy the 256K random
   lookups and 2^16 each of predecessor, successor, range_count and
   range_scan, then the first 4 rounds of phase 4w's write stream with a
   4096-entry buffer, every answer against the oracle, the fetch budget
   and the launches the sharded design implies (K4 once a round of a read
   chunk, K1 once a round, no K2) checked on every rank; K4 and K1 held
   bit for bit against their plain versions at the shapes the path gives
   them (K4 at n_dest = ranks over a rank's 2048- and 4096-lane slice,
   K1 over a rank's subtree with the live mask the all_to_all delivers);
   ``memory_nodes_per_device`` (4,194,306 for hrz and hyb at 4 ranks),
   each rank's peak memory, and lanes/s beside the single-chip server's
   at world 1 are logged;
4g. the port gates (``repro_torch.analysis``): the lint, dead-code and
   contracts passes (the contracts on the card's kernels), then the
   serve gate for hrz, dup and hyb on the single-chip server and on the
   sharded server at world 1 over NCCL, at the gate's size (63 keys,
   chunks of 64) and on the phase-4 tree in chunks of CHUNK: a warm
   phase, then two rounds of a small write and 3 chunks each of lookup,
   predecessor and range_scan under the capture and transfer watches
   (no capture, one fetch a read chunk, the planned puts, no compaction,
   no sync that ``set_sync_debug_mode("error")`` raises); two negative
   controls, a planted ``.item()`` and a second batch length, must come
   back as violations; which calls the sync debug mode sees is logged,
   and so are each gate's seconds and kernel runs (K1, K3, K2 and K4
   must each run);
5. measure the card's dependent-load latency with the pointer chase
   (``csrc/pointer_chase.cu``: L_HBM, cold 64 MiB; L_L2, warm 4 MiB); at
   the main path's shapes, hold each kernel configuration against its
   plain version once more, then time the kernel, its plain version and
   ``torch.searchsorted`` (the library yardstick, never called by the port)
   with CUDA events, beside the byte bound of the same work and the latency
   bound, a lane's global round trips x L_HBM; K2 likewise with the full
   buffer, its yardstick searching the merged sorted view;
6. LM serving of qwen3-1.7b at full width and depth (28 layers): kernel K5
   (flash attention) against its plain version in fp32 and bf16 at the JAX
   package's sweep shapes, at Sq > Skv, at the edges of the bf16 body's
   128-row tiles (ragged Sq and Skv, a window edge inside a kv tile, rows
   that see no key, d = 16 and 32) and at both serving shapes (qwen3's and
   mixtral-8x7b's prefill attention); the whole model in fp32 (1 x 512
   prompt), the flash route against the naive route over prefill and 4
   decode steps, and decode against a prefill of the longer prompt; the
   whole model in bf16 (4 x 512 prompts), the flash route (K5's wgmma body)
   and the naive route each against the naive route in fp32: the flash
   route's RMS distance at most 1.25 times the naive one's; then the bf16
   serving run through ``greedy_generate`` (4 prompts x 2048
   tokens + 32 new), which captures the decode step as one CUDA graph, one
   K5 launch per layer, its tokens equal to the eager route's, then one
   request on each route in turns (graph, eager, graph, eager) with no
   capture, every logit finite, with prefill and decode times, peak
   memory and the device idle share, kernels and host launch calls of a
   decode step and of a prefill; then K5 timed at both prefill shapes
   beside its bound, its plain version and ``scaled_dot_product_attention``;
7. MoE serving of mixtral-8x7b at full width (16 of its 32 layers: 32
   layers of bf16 weights, 93.4 GB, do not fit in 80 GB): kernel K4 (queue
   dispatch, all five outputs of the plan) against its plain version, bit
   for bit, at the JAX package's sweep shapes, the MoE prefill and decode
   shapes and the kernel benchmarks' shapes, with skewed and all-inactive
   rows; K4 timed at the prefill, decode and both benchmarks' shapes
   beside its byte and latency bounds, its plain version and its floor (an
   empty kernel of the same launch through the same ctypes path); the
   kernels of one queue dispatch of the MoE layer at the prefill and
   decode shapes, one device kernel, K4, counted with torch.profiler
   before phase 4 (no CUDA graph alive: a live graph makes the profiler
   lose events far more often) and reported here; the model in fp32 at
   2 layers (1 x 512 prompt + 4 decode steps): the K4 route against the plain dispatch route (equal logits),
   and at capacity factor 4 the dispatch route against a dense
   every-token-through-its-experts oracle and decode against a prefill of
   the longer prompt; then the bf16 serving run at 16 layers: the decode
   graph captured, then ``greedy_generate`` (4 prompts x 2048 tokens + 32
   new), one K4 and one K5 launch per layer per prefill, one K4 run per
   layer per decode step (the replays'), its tokens equal to the eager
   route's, then one request on each route in turns (graph, eager, graph,
   eager), K4 counted and the dropped share copied out after every step,
   the two routes' shares equal, no capture, every logit finite, with
   prefill and decode times, peak memory, a decode step's device idle
   share, its device kernels and its host launch calls;
8. print the ``{"kernels": [...]}`` line, the card's line, and last the
   ``{"ok": true, ...}`` line.

Needs one CUDA card; exits with code 2 and prints no result without one.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import json
import os
import pickle
import re
import shutil
import subprocess
import sys
import tempfile
import time
import unittest.mock

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed  # noqa: E402
import torch.multiprocessing  # noqa: E402

from repro_torch import graphs  # noqa: E402
from repro_torch.analysis import invariants, runtime  # noqa: E402
from repro_torch.core import PAPER_CONFIGS, QUERY_OPS, BSTEngine  # noqa: E402
from repro_torch.core import buffers as buf_lib  # noqa: E402
from repro_torch.core import delta as delta_lib  # noqa: E402
from repro_torch.core import distributed as dist_lib  # noqa: E402
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
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import queue_dispatch as QD  # noqa: E402
from repro_torch.models import model as lm  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.analysis import __main__ as analysis_main  # noqa: E402
from repro_torch.analysis import contracts, deadcode, gate, lint, report  # noqa: E402
from repro_torch.serving import bst_server  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    BSTServer,
    decode_graph,
    greedy_generate,
    make_prefill_fn,
    make_serve_step,
)

N_KEYS = (1 << 24) - 1  # H = 23: 2 x 64 MiB of int32 keys and values
CHECK_LANES = 1 << 16
STREAM = 1 << 18  # the paper's 256K key sets
RANGE_STREAM = 1 << 17
CHUNK = 8192  # the server's chunk: the main path's lookup shape
SCAN_K = 8
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
TIMING_REPS = 30
SPIN_CYCLES = 2_000_000  # about 1 ms of the SM clock
CHASE_HBM_INTS = 1 << 24  # 64 MiB: the tree's key array, past the 50 MB L2
CHASE_L2_INTS = 1 << 20  # 4 MiB: held by the L2
CHASE_STEPS = 1 << 15
CHASE_REPS = 5
PROFILE_CHUNKS = 128
PROFILE_RUNS = 3
# Ops whose single chunks are profiled per config (phases 4, 4w), through
# the engine's CUDA graph and through its eager route.
CHUNK_PROFILE_OPS = ("lookup", "predecessor", "range_scan")
CHUNK_PROFILE_CALLS = 16
PROFILE_ATTEMPTS = 3
COUNT_ATTEMPTS = 6  # traces for an exact kernel count (``kernels_per_dispatch``)
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
# buffers past what one CTA could stage whole (~14,000): sampled lines of 32
# slots, and past 131,072 slots lines of 64 (membership) and 128 (ordered)
BIG_CAPACITIES = (20000, 140000)
DELTA_LINE_CAPACITIES = (1, 4096, 20000, 65504, 65536, 131072, 131073, 140000, 1 << 20)
W_ROUNDS = 8
W_WRITES = 4096  # half new odd keys, half overwrites of stored keys
W_DELETES = 2048  # three quarters stored keys, one quarter absent
W_LOOKUPS = 8192  # written, deleted and random keys
W_POINTS = 8192  # predecessor, and as many successor, queries of odd keys
W_RANGES = 4096  # range_count, and as many range_scan, spans near written keys
# The graph-vs-eager check of the write path: the first rounds' writes, one
# compaction each (round 0's grows the tree to height 24, the others keep it)
W_GRAPH_ROUNDS = 4
# The sharded phase (4s): each strategy over a mesh, as the paper config
# below (hrz Hrz, dup Dup4, hyb Hyb4q), at world 1 over NCCL in this process
# and at SHARD_RANKS ranks spawned on the one card over gloo (NCCL puts no
# two ranks on one card).  The reads: the paper's 256K random lookups and
# SHARD_POINTS each of predecessor, successor, range_count, range_scan; the
# writes: the first SHARD_W_ROUNDS rounds of phase 4w's stream.
SHARD_CONFIGS = {"hrz": "Hrz", "dup": "Dup4", "hyb": "Hyb4q"}
# K4 launches a read chunk on the sharded path: hrz one stall-free round,
# hyb its first round, one stall round and the drain round, dup none; K1
# runs once a round (dup: once a chunk).  At one rank hyb's per-batch depth
# is the whole local batch, and it runs one stall-free round
# (``shard_rounds``).
SHARD_ROUNDS = {"hrz": 1, "dup": 0, "hyb": 3}
SHARD_RANKS = 4
SHARD_POINTS = 1 << 16
SHARD_W_ROUNDS = 4
SHARD_TIMEOUT_S = 420
# The gate phase (4g): the serve gate's strategies.
GATE_STRATEGIES = ("hrz", "dup", "hyb")
# The LM phase (6): qwen3-1.7b at its published width and depth.
LM_ARCH = "qwen3-1.7b"
LM_BATCH, LM_PROMPT, LM_NEW = 4, 2048, 32  # the serving run
LM_CHECK_PROMPT, LM_CHECK_STEPS = 512, 4  # the fp32 full-depth check
LM_CHECK_TOL = 1e-3  # fp32 logits after 28 layers: the routes' rounding differs
# The bf16 check: 4 prompts of LM_CHECK_PROMPT tokens; the flash route's
# bf16 logits may be no further (RMS) from the fp32 naive route's than
# this factor times the naive bf16 route's distance from them.
LM_BF16_CHECK_BATCH = 4
LM_BF16_ROUTE_RATIO = 1.25
LM_PROFILE_STEPS = 4
# The timed requests of phases 6 and 7, in turns: (eager route, the profiles
# taken after it); the prefill is the same on both routes.
ROUTE_TURNS = ((False, ("decode", "prefill")), (True, ("decode",)), (False, ()), (True, ()))
BF16_FLOP_PER_S = 989e12  # H100 SXM data sheet, dense bf16 tensor cores
# K5 against its plain version: fp32, the kernel's FMA order and expf
# against torch's matmul and softmax (TF32 off); bf16, the kernel's tensor
# cores take bf16 q, k, v and P (P rounded to bf16 before P V, at most
# about 2^-9 of sum p|v| / l) and sum in fp32, the plain version keeps P in
# fp32, and both round the output to bf16 once: they differ by about one
# bf16 rounding of the output (the JAX sweep's 2e-2).  atol = rtol = the
# value.
FLASH_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# (BH, BHkv, Sq, Skv, d, causal, window): the JAX package's sweep
# (tests/test_kernels.py), a causal Sq > Skv case, the serving shape, the
# mixtral-8x7b prefill shape, and the edges of the bf16 body's tiles (128 q
# rows a CTA, 128 kv rows a tile).
FLASH_SHAPES = [
    (4, 2, 256, 256, 64, True, None),
    (4, 4, 128, 256, 32, True, None),
    (2, 1, 256, 256, 64, True, 128),
    (8, 2, 128, 128, 128, False, None),
    (2, 2, 384, 384, 64, True, 256),
    (4, 2, 512, 256, 128, True, None),
    (LM_BATCH * 16, LM_BATCH * 8, LM_PROMPT, LM_PROMPT, 128, True, None),
    (128, 32, 2048, 2048, 128, True, 4096),  # mixtral-8x7b: 4 x 32 heads, 8 kv heads
    (2, 1, 100, 100, 128, True, None),  # Sq and Skv inside one tile
    (3, 3, 200, 333, 64, True, None),  # Sq and Skv not multiples of 64 or 128
    (2, 1, 257, 190, 128, True, None),  # Sq > Skv: 67 rows see no key
    (2, 2, 300, 300, 128, True, 100),  # a window edge inside a kv tile
    (2, 1, 129, 300, 64, False, None),  # one row past a q block, ragged Skv
    (4, 2, 1, 300, 128, True, None),  # one q row
    (4, 2, 190, 190, 32, True, 50),  # d = 32, window edge inside a tile
    (8, 4, 129, 129, 16, True, 7),  # d = 16, a 7-key window
]
FLASH_TIMED = (6, 7)  # indices into FLASH_SHAPES: the qwen3 and mixtral prefill shapes
# The MoE phase (7): mixtral-8x7b at its published width.  Depth is the one
# cut: 16 of 32 layers (2.90 GB of bf16 weights a layer; 16 take 47.0 GB).
MOE_ARCH = "mixtral-8x7b"
MOE_LAYERS = 16
MOE_BATCH, MOE_PROMPT, MOE_NEW = 4, 2048, 32  # the serving run
MOE_CHECK_LAYERS, MOE_CHECK_PROMPT, MOE_CHECK_STEPS = 2, 512, 4  # the fp32 checks
MOE_AMPLE_CF = 4.0  # n_experts / top_k: no expert can overflow
MOE_CHECK_TOL = 1e-3  # fp32 logits: the oracle sums the experts in another order
QD_SOURCE = "src/repro_torch/kernels/csrc/queue_dispatch.cu"
QD_REPLACES = "src/repro/kernels/queue_dispatch.py:61"
# (G, B, n_dest, capacity, what): K4's shapes.
QD_SHAPES = [
    (1, 16, 2, 2, "JAX sweep"),
    (1, 128, 8, 16, "JAX sweep"),
    (1, 64, 16, 8, "JAX sweep"),
    (1, 33, 4, 1, "JAX sweep, ragged"),
    (1, 40, 4, 3, "JAX overflow test"),
    (32, 512, 8, 80, "mixtral prefill, 4 x 2048 tokens in 32 groups"),
    (1, 8, 8, 1, "mixtral decode, 4 tokens"),
    (1, 4096, 16, 512, "kernel_bench"),
    (1, 8192, 8, 1280, "moe_dispatch_bench, capacity factor 1.25"),
    (2, 1000, 256, 8, "256 destinations"),
    (3, 700, 1024, 2, "the kernel's n_dest limit"),
]
QD_TIMED = (5, 6, 7, 8)  # indices into QD_SHAPES: the prefill, decode and both benchmarks' shapes
QD_ROUND_TRIPS = 1  # a lane's dependent global round trips in K4: its dest, before any barrier
QD_BODIES = ("queue_dispatch_kernel", "queue_dispatch_cluster_kernel", "queue_dispatch_wide_kernel")


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


# Per kernel, over every comparison with its plain version (phases 3, 5 and
# 7): lanes (K4: elements) where any output differed, and the largest
# absolute difference.
AGREEMENT = {kern: {"mismatches": 0, "max_abs_err": 0} for kern in [*REPLACES, "queue_dispatch"]}


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


def kernel_label(mangled: str) -> str:
    """A readable name of a kernel instantiation from its mangled name:
    ``forest_descend_kernel<ORDERED,WITH_DELTA>`` (hybrid's
    ``<ORDERED,MAPPING,WITH_DELTA>``), ``flash_fwd_kernel<float,D>``,
    ``flash_fwd_bf16_kernel<D>``, ``queue_dispatch_kernel`` (and its
    ``_cluster`` and ``_wide`` bodies); any other kernel keeps its mangled
    name, so a renamed or new one still shows."""
    entry = re.search(r"(forest|hybrid)_descend_kernel(I\w*?)EEv", mangled)
    if entry:
        targs = ",".join(re.findall(r"L[bi](\d+)E", entry.group(2) + "E"))
        return f"{entry.group(1)}_descend_kernel<{targs}>"
    flash = re.search(r"flash_fwd_kernelI(f|13__nv_bfloat16)Li(\d+)E", mangled)
    if flash:
        return f"flash_fwd_kernel<{'float' if flash.group(1) == 'f' else 'bf16'},{flash.group(2)}>"
    bf16 = re.search(r"flash_fwd_bf16_kernelILi(\d+)E", mangled)
    if bf16:
        return f"flash_fwd_bf16_kernel<{bf16.group(1)}>"
    qd = re.search(r"queue_dispatch(_wide|_cluster)?_kernel", mangled)
    if qd:
        return qd.group(0)
    return mangled


def ptxas_resources(build_log: str) -> dict:
    """Per kernel instantiation (``kernel_label``), from ptxas's report in
    the build log: ``(registers, static shared memory bytes, spill line)``."""
    out, label, spills = {}, None, ""
    for line in build_log.splitlines():
        entry = "Compiling entry" in line and re.search(r"function '(\w+)'", line)
        if entry:
            label, spills = kernel_label(entry.group(1)), ""
        elif label and "spill" in line:
            spills = line.strip()
        elif label and "registers" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            out[label] = (regs, int(smem.group(1)) if smem else 0, spills)
            label = None
    return out


def sass_instruction_counts(lib_path, opcode: str) -> dict:
    """Per kernel (``kernel_label``) of the built library, the SASS
    instructions whose opcode starts with ``opcode`` (``cuobjdump
    --dump-sass``)."""
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "--dump-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, label = {}, None
    for line in sass.splitlines():
        func = re.search(r"Function : (\S+)", line)
        if func:
            label = kernel_label(func.group(1))
            counts.setdefault(label, 0)
        elif label and re.search(rf"\*/\s+(@!?U?P\w+\s+)?{opcode}", line):
            counts[label] += 1
    return counts


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
        log(f"  K2 {label} (C={buf.capacity}, {int(buf.count)} live): "
            f"forest hrz/dup4/dup8 and hybrid split 2, 3 x queue/direct, membership and ordered: 0 mismatches; "
            f"{int(hit.sum())} active lanes hit the buffer, {int((hit & dead).sum())} of them "
            f"tombstones")


def check_large_buffer_engine(n_keys: int = (1 << 18) - 1, capacity: int = BIG_CAPACITIES[-1]):
    """An hrz engine with a ``capacity``-entry write buffer, built on the card
    (no kernel limit stands in its way), written with 100,000 upserts and
    tombstones in one batch and read back through K2 forest: every lookup
    of the written keys, stored keys and absent neighbours equals a dict
    oracle of the state."""
    keys, values = make_tree_data(n_keys, seed=13)
    rng = np.random.default_rng(13)
    wk = np.unique(rng.integers(1, 4 * n_keys, 100_000).astype(np.int32))
    wv = rng.integers(0, 2**31 - 1, wk.size, dtype=np.int32)
    wd = rng.random(wk.size) < 0.25
    state = dict(zip(keys.tolist(), values.tolist()))
    for k, v, d in zip(wk.tolist(), wv.tolist(), wd.tolist()):
        if d:
            state.pop(k, None)
        else:
            state[k] = v
    eng = BSTEngine(keys, values, dataclasses.replace(PAPER_CONFIGS["Hrz"], delta_capacity=capacity))
    eng.apply_ops(wk, wv, wd)
    check(eng.compactions == 0, "the buffer compacted before the read")
    q = np.concatenate([wk, keys[::7], wk + 1]).astype(np.int32)
    before = graphs.kernel_runs()["forest_descend_delta"]
    val, found = (t.cpu().numpy() for t in eng.lookup(q))
    check(graphs.kernel_runs()["forest_descend_delta"] > before, "K2 forest did not serve the read")
    want_found = np.array([k in state for k in q.tolist()])
    want_val = np.array([state.get(k, SENTINEL_VALUE) for k in q.tolist()], np.int32)
    check(np.array_equal(found, want_found) and np.array_equal(val[found], want_val[found]),
          "the large-buffer engine disagrees with its oracle")
    log(f"  Hrz engine, delta capacity {capacity}: {wk.size} writes ({int(wd.sum())} deletes) "
        f"buffered, {q.size} lookups equal the oracle ({int(found.sum())} found)")


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


def serve_all_configs(keys, values, sets, smi: str, device="cuda") -> tuple:
    """Each paper config's server over the same keys: the lookup key sets,
    predecessor/successor of absent keys, range_count/range_scan of random
    spans, every answer held against the oracle.  ``warmup`` captures each
    op's CUDA graph; the drain then captures nothing and makes no wrapper
    call: every chunk is one replay, which runs one descent kernel.
    Returns the per-config rows and the kernel launches that ran, per
    kernel, summed over the configs' warm-ups and drains (the chunk
    profiles after them not counted)."""
    sk, sv = keys, values  # make_tree_data's keys are sorted and unique
    rng = np.random.default_rng(3)
    absent = (rng.integers(0, keys.size + 1, STREAM) * 2 + 1).astype(np.int32)
    lo = rng.integers(1, 2 * keys.size, RANGE_STREAM).astype(np.int32)
    hi = (lo + rng.integers(-8, 64, RANGE_STREAM)).astype(np.int32)
    rows, launches = [], {kern: 0 for kern in K.LAUNCHES}
    for name, cfg in PAPER_CONFIGS.items():
        cfg = dataclasses.replace(cfg, device=device)
        srv = BSTServer(keys, values, cfg, chunk_size=CHUNK, scan_k=SCAN_K)
        start = graphs.kernel_runs()
        captures, capture_s = graphs.STATS["captures"], graphs.STATS["capture_s"]
        srv.warmup(QUERY_OPS)
        captures = graphs.STATS["captures"] - captures
        capture_s = graphs.STATS["capture_s"] - capture_s
        check(captures == len(QUERY_OPS), f"{name}: warmup captured {captures} graphs")
        before, calls = graphs.kernel_runs(), graphs.launch_counts()
        steady = graphs.STATS["captures"]
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
        launched = graphs.kernel_runs()[kernel] - before[kernel]
        check(launched == srv.stats.chunks, f"{name}: {launched} {kernel} launches for {srv.stats.chunks} chunks")
        check(graphs.STATS["captures"] == steady, f"{name}: the steady-state drain captured a graph")
        check(graphs.launch_counts() == calls, f"{name}: a chunk ran outside its graph")
        for kern, n in graphs.kernel_runs().items():
            if kern in launches:
                launches[kern] += n - start[kern]
        # one trace a phase: every profiler session is a chance for the
        # profiler to lose its device events (see ``profile_calls``)
        chunks = chunk_profiles(srv.engine, absent[:CHUNK], *spans(lo, hi)) if name == "Hrz" else None
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
            "captures": captures, "capture_s": capture_s, "chunk_profiles": chunks,
        }
        rows.append(row)
        log(f"  {name}: lanes_per_sec={st.lanes_per_sec!r} (busy), "
            f"{row['lanes_per_drain_sec']!r} (drain wall) over {st.lanes} lanes, "
            f"{st.chunks} chunks, {n_fetch} fetches, {launched} {kernel} runs, all replayed, "
            f"answers == oracle; warmup captured {captures} graphs in {capture_s!r} s, "
            f"the drain none ({smi})")
        if chunks is not None:
            log_chunk_profiles(chunks)
        del srv
    return rows, launches


def spans(lo, hi) -> tuple:
    """One chunk of range requests (CHUNK ranges, 2 x CHUNK lanes), the
    spans repeated where fewer are given."""
    return np.resize(lo, CHUNK), np.resize(hi, CHUNK)


def chunk_profiles(eng, a, lo, hi) -> dict:
    """Per op of CHUNK_PROFILE_OPS, one chunk through the engine's graph and
    through its eager route, CHUNK_PROFILE_CALLS times each, all in one
    trace (``profile_segments``): device kernels and copies, host launch
    calls, wall time and the idle share of back-to-back chunks.  Each op
    runs once first, so that no graph is captured under the profiler."""
    segments = []
    for op in CHUNK_PROFILE_OPS:
        args = (lo, hi) if op in plans_lib.RANGE_OPS else (a,)
        runtime.block_until_ready(eng.query_static(op, *args, k=SCAN_K))
        for route, eager in (("graph", False), ("eager", True)):
            segments.append(((op, route), functools.partial(
                eng.query_static, op, *args, k=SCAN_K, eager=eager)))
    out = {}
    for (op, route), prof in profile_segments(segments, CHUNK_PROFILE_CALLS).items():
        out.setdefault(op, {})[route] = prof
    return out


def profile_segments(segments, calls: int) -> dict:
    """One torch.profiler trace of several segments, each ``fn()`` ``calls``
    times between synchronisations inside a ``record_function`` range: per
    segment label, the device kernels and copies that started inside its
    range (a graph's replay shows its kernels one by one), their device
    time, the host's CUDA runtime calls with "Launch" in their name, and
    the wall time, each per call.  A trace in which a segment saw no
    device event is taken again, up to PROFILE_ATTEMPTS times, as in
    ``profile_calls``."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        walls = {}
        with torch.profiler.profile(activities=activities) as prof:
            # the first segment's calls once more before the ranges: a trace
            # can miss its first events
            for _ in range(calls):
                segments[0][1]()
            for i, (label, fn) in enumerate(segments):
                torch.cuda.synchronize()
                with torch.profiler.record_function(f"segment {i}"):
                    t0 = time.perf_counter()
                    for _ in range(calls):
                        fn()
                    torch.cuda.synchronize()
                    walls[i] = time.perf_counter() - t0
        events = prof.events()
        spans_us = {int(e.name.split()[1]): (e.time_range.start, e.time_range.end) for e in events
                    if e.name.startswith("segment ") and e.device_type == torch.autograd.DeviceType.CPU}
        counts = {i: [0, 0.0, 0] for i in range(len(segments))}  # device events, us, launch calls
        for e in events:
            if e.name.startswith("segment "):
                continue
            for i, (t0, t1) in spans_us.items():
                if t0 <= e.time_range.start <= t1:
                    if e.device_type == torch.autograd.DeviceType.CUDA:
                        counts[i][0] += 1
                        counts[i][1] += e.time_range.elapsed_us()
                    elif e.name.startswith("cu") and "Launch" in e.name:
                        counts[i][2] += 1
                    break
        if all(n > 0 for n, _, _ in counts.values()):
            break
    out = {}
    for i, (label, _) in enumerate(segments):
        n, us, launches = counts[i]
        check(n > 0, f"the profiler saw no device event of segment {label} in {PROFILE_ATTEMPTS} traces")
        out[label] = {"calls": calls, "wall_s": walls[i], "device_s": us / 1e6,
                      "idle_share": 1 - us / 1e6 / walls[i], "traces": attempt,
                      "device_events_per_call": n / calls, "host_launches_per_call": launches / calls}
    return out


def log_chunk_profiles(profiles: dict) -> None:
    for op, routes in profiles.items():
        log("    " + op + " chunk: " + "; ".join(
            f"{route} {p['device_events_per_call']!r} device kernels and copies, "
            f"{p['host_launches_per_call']!r} host launch calls, "
            f"{p['wall_s'] / p['calls'] * 1e3!r} ms wall, idle share {p['idle_share']!r}"
            for route, p in routes.items()))


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
    srv.warmup(QUERY_OPS + ("write",))
    half = len(rounds) // 2

    def submit(i):
        for rnd in rounds[i * half:(i + 1) * half]:
            srv.submit_write(*rnd["writes"])
            srv.submit_delete(rnd["deletes"])
            for op, a, b, _ in rnd["reads"]:
                srv.submit(a, op=op) if b is None else srv.submit_range(a, b, op=op)

    return profiled_drains(srv, submit, runs=2)


def profile_calls(run, calls: int) -> dict:
    """``run()`` ``calls`` times between synchronisations: the wall time and,
    from torch.profiler over the same calls, the device time of kernels and
    copies by name (a graph's replay shows its kernels one by one), the
    launch calls the host made (CUDA runtime calls with "Launch" in their
    name: kernels and graphs; the ctypes kernels' statically linked runtime
    may not report its own), and host self time by op.  The profiler
    loses device events now and then, far more often while a CUDA graph
    is alive (``graphs.live``), and now and then all of a trace's: an
    empty trace is taken again, up to PROFILE_ATTEMPTS times (``traces``
    says how many it took)."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        with torch.profiler.profile(activities=activities) as prof:
            torch.cuda.synchronize()
            p0 = time.perf_counter()
            for _ in range(calls):
                run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - p0
        by_name, host, device_events, launches = {}, {}, 0, 0
        for ev in prof.key_averages():
            # device-side events (kernels, copies) by their own device time:
            # a host op's row repeats the device time of what it launched
            if ev.device_type == torch.autograd.DeviceType.CUDA and ev.self_device_time_total > 0:
                by_name[ev.key] = by_name.get(ev.key, 0.0) + ev.self_device_time_total
                device_events += ev.count
            elif ev.device_type == torch.autograd.DeviceType.CPU:
                if ev.self_cpu_time_total > 0:
                    host[ev.key] = host.get(ev.key, 0.0) + ev.self_cpu_time_total
                if ev.key.startswith("cu") and "Launch" in ev.key:  # runtime calls: kernels, graphs
                    launches += ev.count
        device_s = sum(by_name.values()) / 1e6
        if device_s > 0:
            break
    check(device_s > 0, f"the profiler saw no device time in {PROFILE_ATTEMPTS} traces")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    top_host = sorted(host.items(), key=lambda kv: -kv[1])[:8]
    return {"calls": calls, "wall_s": wall, "device_s": device_s,
            "idle_share": 1 - device_s / wall,
            "device_events_per_call": device_events / calls,
            "host_launches_per_call": launches / calls, "traces": attempt,
            "top": [(name[:80], us) for name, us in top],
            "top_host_self_us": [(name[:80], us) for name, us in top_host]}


def log_call_profile(label: str, profile: dict) -> None:
    log(f"    {label} profile, {profile['calls']} calls: wall {profile['wall_s']!r} s, device busy "
        f"{profile['device_s']!r} s, idle share {profile['idle_share']!r}, "
        f"{profile['device_events_per_call']!r} device kernels and copies and "
        f"{profile['host_launches_per_call']!r} host launch calls per call "
        f"(trace {profile['traces']} of at most {PROFILE_ATTEMPTS})")
    for name, us in profile["top"]:
        log(f"      {us!r} us  {name}")
    log("      host ops by self CPU time:")
    for name, us in profile["top_host_self_us"]:
        log(f"      {us!r} us  {name}")


def profiled_drains(srv, submit, runs: int = PROFILE_RUNS) -> list:
    """``runs`` drains of ``srv``, each of what ``submit(i)`` queues, each
    profiled on its own (``profile_calls``).  The profiler's own host cost
    is inside the wall time, so the idle share is an upper estimate."""
    return [profile_calls(lambda i=i: (submit(i), srv.drain()), 1) for i in range(runs)]


def log_profile(label: str, runs) -> None:
    for i, run in enumerate(runs):
        log_call_profile(f"{label} {i}", run)


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


def track_compactions(eng) -> list:
    """Record, per compaction of ``eng``, the height before and after and
    the graphs captured inside it: ``eng.compact`` wrapped on the instance
    (``apply_ops`` calls it there)."""
    record = []
    compact = eng.compact

    def tracked():
        h, captures = eng.tree.height, graphs.STATS["captures"]
        out = compact()
        record.append({"height": [h, eng.tree.height],
                       "captures": graphs.STATS["captures"] - captures})
        return out

    eng.compact = tracked
    return record


def serve_write_path(keys, values, rounds, final, tree, smi: str, device="cuda"):
    """Phase 4w: every paper config with a W_CAPACITY delta buffer serves
    the whole stream in one drain, its graphs (the queries', the ingest's
    and the compaction's) captured by ``warmup`` first.  Every read chunk,
    ingest chunk and compaction step is one replay; a compaction that
    keeps the height captures nothing, the one that changes it (23 -> 24)
    captures every graph of the engine once.  Then the ingest and
    compaction graphs against their eager route on the phase's tree
    (``check_write_graphs``).  Returns the per-config rows and the kernel
    launches that ran, per kernel, summed over the configs' drains (each
    counted from 0 just before its drain)."""
    rows, launches = [], {kern: 0 for kern in K.LAUNCHES}
    for name, cfg in PAPER_CONFIGS.items():
        cfg = dataclasses.replace(cfg, device=device, delta_capacity=W_CAPACITY)
        srv = BSTServer(keys, values, cfg, chunk_size=CHUNK, scan_k=SCAN_K)
        srv.warmup(QUERY_OPS + ("write",))
        eng = srv.engine
        held = eng.graph_keys()
        check(len(held) == len(QUERY_OPS) + 3, f"{name}: warmup holds graphs {held}")
        compactions = track_compactions(eng)
        tickets = []
        for rnd in rounds:
            srv.submit_write(*rnd["writes"])
            srv.submit_delete(rnd["deletes"])
            for op, a, b, want in rnd["reads"]:
                t = srv.submit(a, op=op) if b is None else srv.submit_range(a, b, op=op)
                tickets.append((t, op, want))
        fetches = runtime.fetch_count()
        K.reset_launches()
        graphs.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = srv.drain()
        drain_s = time.perf_counter() - t0
        drain_peak = torch.cuda.max_memory_allocated()
        runs = graphs.kernel_runs()
        counts = {kern: runs[kern] for kern in K.LAUNCHES}
        replayed = {kern: graphs.REPLAYED[kern] for kern in K.LAUNCHES}
        captures, capture_s = graphs.STATS["captures"], graphs.STATS["capture_s"]
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
        check(counts[kern + "_delta"] == read_chunks == replayed[kern + "_delta"],
              f"{name}: {counts[kern + '_delta']} K2 launches, {replayed[kern + '_delta']} of them "
              f"replayed, for {read_chunks} read chunks")
        check(counts[kern] == ingest_chunks == replayed[kern],
              f"{name}: {counts[kern]} {kern} launches, {replayed[kern]} of them replayed, for "
              f"{ingest_chunks} ingest chunks")
        check(counts[other] == counts[other + "_delta"] == 0, f"{name}: {other} launched")
        # captures only where the height changed: every graph once, there
        check(len(compactions) == st.compactions, f"{name}: {len(compactions)} compactions tracked")
        for c in compactions:
            want = len(held) if c["height"][0] != c["height"][1] else 0
            check(c["captures"] == want, f"{name}: a compaction {c} captured {c['captures']} "
                  f"graphs, the design {want}")
        changes = [c["height"] for c in compactions if c["height"][0] != c["height"][1]]
        check(captures == len(held) * len(changes) and changes == [[23, 24]],
              f"{name}: {captures} captures in the drain, height changes {changes}")

        rnd = rounds[-1]["reads"]
        chunks = (chunk_profiles(eng, rnd[0][1][:CHUNK], *spans(rnd[3][1], rnd[3][2]))
                  if name == "Hrz" else None)
        eng.compact()
        skd, svd, count = eng.plan.sorted_view()
        n_real = eng.tree.n_real
        check(n_real == final[0].size and count.tolist() == [n_real],
              f"{name}: {n_real} keys after compaction ({count.tolist()} on the card), "
              f"oracle {final[0].size}")
        check(np.array_equal(skd[:n_real].cpu().numpy(), final[0])
              and np.array_equal(svd[:n_real].cpu().numpy(), final[1]),
              f"{name}: the compacted snapshot differs from the oracle")
        final_height = eng.tree.height
        del srv, eng, skd, svd, count, res
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        graph_checks = check_write_graphs(tree, name, rounds, profile=name == "Hrz")
        graph_checks["peak_bytes"] = torch.cuda.max_memory_allocated()

        row = {
            "config": name,
            "lanes": st.lanes,
            "read_chunks": read_chunks,
            "ingest_chunks": ingest_chunks,
            "compactions": st.compactions,
            "compaction_log": compactions,
            "fetches": n_fetch,
            "launches": counts,
            "busy_s": st.busy_s,
            "lanes_per_sec": st.lanes_per_sec,
            "drain_s": drain_s,
            "lanes_per_drain_sec": st.lanes / drain_s,
            "drain_peak_bytes": drain_peak,
            "final_height": final_height,
            "per_op_lanes_per_sec": {op: s.lanes_per_sec for op, s in st.per_op.items()},
            "read_lanes_per_sec": (sum(st.per_op[op].lanes for op in QUERY_OPS)
                                   / sum(st.per_op[op].busy_s for op in QUERY_OPS)),
            "graphs": len(held), "captures": captures, "capture_s": capture_s,
            "chunk_profiles": chunks, "write_graphs": graph_checks,
        }
        rows.append(row)
        same = [c for c in graph_checks["compactions"] if c["height"][0] == c["height"][1]]
        log(f"  {name}: lanes_per_sec={st.lanes_per_sec!r} (busy; reads alone "
            f"{row['read_lanes_per_sec']!r}), {row['lanes_per_drain_sec']!r} (drain wall) over "
            f"{st.lanes} lanes; {read_chunks} read chunks, {ingest_chunks} ingest chunks, "
            f"{st.compactions} compactions, {n_fetch} fetches; every read chunk, ingest chunk and "
            f"compaction step a graph replay; {captures} captures in the drain ({capture_s!r} s), "
            f"all {len(held)} graphs once at the height change 23 -> 24, none at the "
            f"{st.compactions - 1} others; drain peak {drain_peak} bytes; answers and final "
            f"snapshot == oracle ({smi})")
        log(f"    graphs == eager route: {len(graph_checks['ingests'])} ingest chunks, "
            f"{len(graph_checks['compactions'])} compactions; ingest chunk of "
            f"{graph_checks['ingests'][0]['lanes']} lanes graph "
            f"{[i['graph_s'] for i in graph_checks['ingests']]!r} s, eager "
            f"{[i['eager_s'] for i in graph_checks['ingests']]!r} s; same-height compaction graph "
            f"{[c['graph_s'] for c in same]!r} s, eager {[c['eager_s'] for c in same]!r} s; the "
            f"height change's {graph_checks['compactions'][0]['graph_s']!r} s (eager layout and "
            f"{graph_checks['compactions'][0]['captures']} captures), eager "
            f"{graph_checks['compactions'][0]['eager_s']!r} s ({smi})")
        if chunks is not None:
            log_chunk_profiles(chunks)
        if graph_checks["ingest_profile"] is not None:
            log_chunk_profiles(graph_checks["ingest_profile"])
    return rows, launches


def check_write_graphs(tree, name: str, rounds, profile: bool) -> dict:
    """The write path's graphs against its eager route, bit for bit, on the
    phase's own tree: an engine of ``name`` with a W_CAPACITY buffer (its
    high-water mark the capacity, so that a slice of W_CAPACITY - 1 writes
    stays in the buffer), warmed; per round of the first W_GRAPH_ROUNDS,
    that round's writes through the ingest graph (``apply_ops``) against
    ``_ingest_step`` on a copy of the buffer (buffer and kernel operands),
    then a compaction through the merge and layout graphs (``compact``)
    against ``delta.compact`` on copies (BFS image, sorted view, device
    count, height).  Round 0 grows the tree (23 -> 24: the merge's graph,
    then the eager layout and every graph captured again), the others keep
    it.  Each route timed on the host clock around synchronised calls (the
    eager ingest with its packed H2D copy, as ``apply_ops`` did it before
    the graphs); with ``profile``, one ingest chunk on either route
    profiled (``profile_segments``)."""
    cfg = dataclasses.replace(PAPER_CONFIGS[name], device="cuda", delta_capacity=W_CAPACITY,
                              delta_high_water=W_CAPACITY)
    eng = BSTEngine.from_tree(tree, cfg)
    eng.warmup_writes()
    device = eng.device
    ingests, compactions = [], []
    for i, rnd in enumerate(rounds[:W_GRAPH_ROUNDS]):
        wk, wv = (x[: W_CAPACITY - 1] for x in rnd["writes"])
        wd = np.zeros(wk.size, bool)
        before = delta_lib.DeltaBuffer(*(t.clone() for t in eng.delta))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        packed = np.stack([wk, wv, wd, np.ones(wk.size, bool)]).astype(np.int32)
        k, v, d, ok = torch.from_numpy(packed).to(device)
        want = eng._ingest_step(before, k, v, d != 0, ok != 0)
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        eng.apply_ops(wk, wv, wd)
        torch.cuda.synchronize()
        graph_s = time.perf_counter() - t0
        check((eng.compactions, eng.pending_writes()) == (i, wk.size),
              f"{name}: the ingest check compacted")
        check(all(torch.equal(a, b) for a, b in zip(eng.delta, want))
              and all(torch.equal(a, b) for a, b in zip(eng._delta_ops, delta_lib.operands(want))),
              f"{name}: the ingest graph differs from the eager ingest")
        ingests.append({"lanes": int(wk.size), "graph_s": graph_s, "eager_s": eager_s})

        old = tree_lib.TreeData(eng.tree.keys.clone(), eng.tree.values.clone(), eng.tree.height,
                       eng.tree.n_real)
        buffered = delta_lib.DeltaBuffer(*(t.clone() for t in eng.delta))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = delta_lib.compact(old, buffered)
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t0
        h, captures = eng.tree.height, graphs.STATS["captures"]
        t0 = time.perf_counter()
        eng.compact()
        torch.cuda.synchronize()
        graph_s = time.perf_counter() - t0
        got_view, want_view = eng.plan.sorted_view(), tree_lib.sorted_view_of(want)
        check((eng.tree.height, eng.tree.n_real) == (want.height, want.n_real)
              and torch.equal(eng.tree.keys, want.keys) and torch.equal(eng.tree.values, want.values)
              and all(torch.equal(a, b) for a, b in zip(got_view, want_view)),
              f"{name}: the compaction's graphs differ from the eager compaction (round {i})")
        compactions.append({"height": [h, eng.tree.height], "graph_s": graph_s, "eager_s": eager_s,
                            "captures": graphs.STATS["captures"] - captures})
        del old, buffered, want, got_view, want_view
    heights = [c["height"] for c in compactions]
    check(heights == [[23, 24]] + [[24, 24]] * (W_GRAPH_ROUNDS - 1),
          f"{name}: the checked compactions went {heights}")
    check([c["captures"] for c in compactions] == [len(eng.graph_keys())] + [0] * (W_GRAPH_ROUNDS - 1),
          f"{name}: the checked compactions captured {[c['captures'] for c in compactions]}")
    prof = None
    if profile:  # one key a call: the graph pads every slice to the capacity
        one = (wk[:1], wv[:1], wd[:1])
        prof = profile_segments([
            (("ingest", "graph"), lambda: eng.apply_ops(*one)),
            (("ingest", "eager"), lambda: eng._ingest_step(eng.delta, k, v, d != 0, ok != 0)),
        ], CHUNK_PROFILE_CALLS)
        prof = {"ingest": {route: p for (_, route), p in prof.items()}}
    del eng
    return {"ingests": ingests, "compactions": compactions, "ingest_profile": prof}


# --------------------------------------------------- phase 4s: sharded serving
def shard_reads(keys, values, lookups, seed: int = 4) -> list:
    """The sharded phase's reads with the oracle's answers: ``lookups`` (the
    paper's random set), absent keys for predecessor and successor, random
    spans for the range ops."""
    rng = np.random.default_rng(seed)
    absent = (rng.integers(0, keys.size + 1, SHARD_POINTS) * 2 + 1).astype(np.int32)
    lo = rng.integers(1, 2 * keys.size, SHARD_POINTS).astype(np.int32)
    hi = (lo + rng.integers(-8, 64, SHARD_POINTS)).astype(np.int32)
    reads = [("lookup", lookups, None), ("predecessor", absent, None),
             ("successor", absent, None), ("range_count", lo, hi), ("range_scan", lo, hi)]
    return [(op, a, b, oracle(keys, values, op, a, b)) for op, a, b in reads]


def submit_reads(srv, reads) -> list:
    return [(srv.submit(a, op=op) if b is None else srv.submit_range(a, b, op=op), op, want)
            for op, a, b, want in reads]


def check_answers(res, tickets, tag: str) -> None:
    for i, (t, op, want) in enumerate(tickets):
        got = res[t]
        check(len(got) == len(want), f"{tag} {op} #{i}: arity")
        for g, w in zip(got, want):
            check(np.array_equal(g, w), f"{tag} {op} #{i}: answers differ from the oracle")


def shard_rounds(strategy: str, ranks: int) -> int:
    """K4 rounds a read chunk: SHARD_ROUNDS, but one for hyb where its
    per-batch depth is the local batch (one rank), as the host decides."""
    if strategy == "hyb":
        B = CHUNK // ranks
        cap = invariants.capacity_for_trace(B, ranks, PAPER_CONFIGS[SHARD_CONFIGS["hyb"]].buffer_slack)
        if cap >= B:
            return 1
    return SHARD_ROUNDS[strategy]


def check_shard_launches(launches: dict, strategy: str, ranks: int, read_chunks: int,
                         ingest_chunks: int, tag: str) -> None:
    """The launches the sharded design implies: K4 once a round of a read
    chunk (none for dup), K1 once a round (dup: once a chunk), the engine's
    ingest kernel once an ingest chunk (K1 for hrz and dup, K3 for hyb), and
    no K2: the sharded path folds the buffer in plain torch."""
    rounds = shard_rounds(strategy, ranks)
    want = {
        "queue_dispatch": rounds * read_chunks,
        "forest_descend": max(rounds, 1) * read_chunks + (0 if strategy == "hyb" else ingest_chunks),
        "hybrid_descend": ingest_chunks if strategy == "hyb" else 0,
        "forest_descend_delta": 0,
        "hybrid_descend_delta": 0,
    }
    got = {k: launches[k] for k in want}
    check(got == want, f"{tag}: launches {got}, the design implies {want}")


def shard_kernel_checks(srv, mesh, strategy: str, reads) -> dict:
    """K4 and K1 against their plain versions at the shapes the sharded path
    gives them on this rank: K4 over this rank's slice of a point chunk and
    of a range chunk (n_dest = ranks, B = CHUNK / ranks and twice that,
    the capacity of the strategy's first round), and K1 over this rank's
    subtree for the keys the all_to_all delivers, with their live mask.
    Collectives: every rank runs it.  Returns the shapes and agreement."""
    M, rank, group = mesh.size(), mesh.get_local_rank(), mesh.get_group()
    tree = srv.snapshot
    device = tree.device
    point = torch.from_numpy(reads[0][1][:CHUNK]).to(device)
    ranged = torch.from_numpy(np.concatenate([reads[3][1][:CHUNK], reads[3][2][:CHUNK]])).to(device)
    out = []
    for what, batch in (("point", point), ("range", ranged)):
        B = batch.shape[0] // M
        local = batch[rank * B:(rank + 1) * B]
        if strategy == "dup":
            got = kops.bst_ordered_forest(tree.keys[None], tree.values[None], local[None], tree.height)
            want = ref.bst_ordered_ref(tree.keys[None], tree.values[None], local[None], tree.height)
            compare(got, want, "forest_descend", f"4s {strategy} rank {rank} K1 {what}")
            out.append({"what": what, "k1_shape": [1, B], "k1_height": tree.height})
            continue
        sub_k, sub_v, split, sub_h = dist_lib.shard_subtrees(tree, mesh, "model")
        reg_n = (1 << max(split, 1)) - 1
        cap = (invariants.capacity_for_trace(B, M, srv.config.buffer_slack)
               if strategy == "hyb" else B)
        dest, reg = plans_lib.route_phase_ordered(tree.keys[:reg_n], tree.values[:reg_n], local,
                                                  split, tree.height)
        dest = torch.where(reg.found, -1, dest)
        plan = kops.queue_dispatch(dest, M, cap)
        compare_k4(plan, ref.queue_dispatch_ref(dest, M, cap), f"4s {strategy} rank {rank} K4 {what}")
        send_q, send_live = plans_lib.gather_phase(local, buf_lib.DispatchPlan(*plan))
        recv_q, recv_live = torch.empty_like(send_q), torch.empty_like(send_q)
        torch.distributed.all_to_all_single(recv_q, send_q.contiguous(), group=group)
        torch.distributed.all_to_all_single(recv_live, send_live.to(torch.int32), group=group)
        q1, live = recv_q.reshape(1, -1), recv_live.reshape(1, -1) != 0
        got = kops.bst_ordered_forest(sub_k, sub_v, q1, sub_h, active=live)
        want = ref.bst_ordered_ref(sub_k, sub_v, q1, sub_h, live)
        compare(got, want, "forest_descend", f"4s {strategy} rank {rank} K1 {what}")
        out.append({"what": what, "k4_B": B, "k4_n_dest": M, "k4_capacity": cap,
                    "k4_overflow": int(plan[4].sum()), "k1_shape": list(q1.shape),
                    "k1_height": sub_h, "k1_live": int(live.sum())})
    return {"checks": out, "agreement": {k: dict(AGREEMENT[k])
                                         for k in ("forest_descend", "queue_dispatch")}}


def serve_sharded(keys, values, strategy: str, mesh, reads, w_rounds, single: bool = False) -> dict:
    """Phase 4s for one strategy on this rank: the reads through a sharded
    read-only server, then the write stream through a sharded server with a
    W_CAPACITY buffer, every answer against the oracle, the fetch budget and
    the launches (each counted from 0 just before its drain) checked; with
    ``single`` the single-chip server of the same config serves the reads
    too, for its lanes/s beside the sharded one's.  Every rank of ``mesh``
    calls it alike."""
    name = SHARD_CONFIGS[strategy]
    cfg = dataclasses.replace(PAPER_CONFIGS[name], device="cuda")
    tag = f"4s {strategy} x{mesh.size()}"
    row = {"strategy": strategy, "config": name, "ranks": mesh.size()}
    seconds = row["seconds"] = {}  # host clock of each step, for the phase's own time
    t0 = time.perf_counter()

    srv = BSTServer(keys, values, cfg, chunk_size=CHUNK, scan_k=SCAN_K, mesh=mesh)
    srv.warmup(QUERY_OPS)
    seconds["read_server"] = time.perf_counter() - t0
    tickets = submit_reads(srv, reads)
    torch.cuda.synchronize()
    runs = graphs.kernel_runs()
    fetches = runtime.fetch_count()
    t0 = time.perf_counter()
    res = srv.drain()
    drain_s = time.perf_counter() - t0
    launches = {k: n - runs[k] for k, n in graphs.kernel_runs().items()}
    n_fetch = runtime.fetch_count() - fetches
    check_answers(res, tickets, tag)
    st = srv.stats
    check(n_fetch == st.chunks, f"{tag}: {n_fetch} fetches for {st.chunks} chunks")
    check_shard_launches(launches, strategy, mesh.size(), st.chunks, 0, tag)
    row["reads"] = {"lanes": st.lanes, "chunks": st.chunks, "fetches": n_fetch,
                    "launches": launches, "busy_s": st.busy_s,
                    "lanes_per_sec": st.lanes_per_sec, "drain_s": drain_s,
                    "lanes_per_drain_sec": st.lanes / drain_s,
                    "per_op_lanes_per_sec": {op: o.lanes_per_sec for op, o in st.per_op.items()}}
    seconds["reads"] = drain_s
    if single:  # where a chunk's time goes: one lookup chunk a drain, profiled
        one_chunk = reads[0][1][:CHUNK]
        row["chunk_profile"] = profile_calls(lambda: (srv.submit(one_chunk), srv.drain()), 4)
    t0 = time.perf_counter()
    row["memory_nodes_per_device"] = srv.memory_nodes_per_device()
    row["kernels"] = shard_kernel_checks(srv, mesh, strategy, reads)
    seconds["kernel_checks"] = time.perf_counter() - t0
    del srv, res

    if single:
        one = BSTServer(keys, values, cfg, chunk_size=CHUNK, scan_k=SCAN_K)
        one.warmup(QUERY_OPS)
        tickets = submit_reads(one, reads)
        t0 = time.perf_counter()
        res = one.drain()
        drain_s = time.perf_counter() - t0
        check_answers(res, tickets, f"4s {name} single-chip")
        row["single_chip"] = {"lanes_per_sec": one.stats.lanes_per_sec, "drain_s": drain_s,
                              "lanes_per_drain_sec": one.stats.lanes / drain_s}
        del one, res

    t0 = time.perf_counter()
    wsrv = BSTServer(keys, values, dataclasses.replace(cfg, delta_capacity=W_CAPACITY),
                     chunk_size=CHUNK, scan_k=SCAN_K, mesh=mesh)
    wsrv.warmup(QUERY_OPS + ("write",))
    seconds["write_server"] = time.perf_counter() - t0
    tickets = []
    for rnd in w_rounds:
        wsrv.submit_write(*rnd["writes"])
        wsrv.submit_delete(rnd["deletes"])
        tickets += submit_reads(wsrv, rnd["reads"])
    torch.cuda.synchronize()
    runs = graphs.kernel_runs()
    fetches = runtime.fetch_count()
    t0 = time.perf_counter()
    res = wsrv.drain()
    drain_s = time.perf_counter() - t0
    launches = {k: n - runs[k] for k, n in graphs.kernel_runs().items()}
    n_fetch = runtime.fetch_count() - fetches
    check_answers(res, tickets, f"{tag} writes")
    st = wsrv.stats
    read_chunks = sum(st.per_op[op].chunks for op in QUERY_OPS)
    ingest_chunks = st.chunks - read_chunks
    check(st.compactions >= 1, f"{tag}: no compaction in the write stream")
    check(n_fetch == read_chunks + st.compactions,
          f"{tag}: {n_fetch} fetches for {read_chunks} read chunks + {st.compactions} compactions")
    check_shard_launches(launches, strategy, mesh.size(), read_chunks, ingest_chunks,
                         f"{tag} writes")
    row["writes"] = {"lanes": st.lanes, "read_chunks": read_chunks, "ingest_chunks": ingest_chunks,
                     "compactions": st.compactions, "fetches": n_fetch, "launches": launches,
                     "busy_s": st.busy_s, "lanes_per_sec": st.lanes_per_sec, "drain_s": drain_s,
                     "lanes_per_drain_sec": st.lanes / drain_s,
                     "final_height": wsrv.snapshot.height}
    seconds["writes"] = drain_s
    row["memory_nodes_per_device_after_writes"] = wsrv.memory_nodes_per_device()
    del wsrv, res
    return row


def shard_rank(rank: int, world: int, out_dir: str, spawned_at: float) -> None:
    """One of SHARD_RANKS ranks spawned on the one card: gloo over its CUDA
    tensors, every strategy through ``serve_sharded`` over the streams that
    the parent wrote to ``out_dir``; writes its rows, peak memory and clock
    stamps there.  ``spawned_at`` is the parent's wall clock at the
    spawn."""
    started_s = time.time() - spawned_at
    with open(os.path.join(out_dir, "streams.pkl"), "rb") as f:  # written by this script
        reads, w_rounds = pickle.load(f)
    store = os.path.join(out_dir, "store")
    torch.cuda.set_device(0)
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        stamps = {"started": started_s, "group": time.time() - spawned_at}
        keys, values = make_tree_data(N_KEYS)
        torch.cuda.reset_peak_memory_stats()
        rows = []
        for strategy in SHARD_CONFIGS:
            stamps[f"{strategy} begins"] = time.time() - spawned_at
            rows.append(serve_sharded(keys, values, strategy, dist_lib.make_serving_mesh(strategy),
                                      reads, w_rounds))
        stamps["done"] = time.time() - spawned_at
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump({"rank": rank, "rows": rows, "stamps": stamps,
                       "peak_bytes": torch.cuda.max_memory_allocated()}, f)
    finally:
        torch.distributed.destroy_process_group()


def spawn_shard_ranks(reads, w_rounds) -> list:
    """Spawn SHARD_RANKS ranks on the card; fail (killing the rest) when one
    raises or they outlast SHARD_TIMEOUT_S.  Returns each rank's record."""
    out_dir = tempfile.mkdtemp(prefix="phase4s-", dir=os.path.join(ROOT, "build"))
    try:
        # The streams go through a file: arguments of a spawned process
        # pass through a pipe that its child reads only once it has started,
        # so large ones would start the ranks one after another.
        with open(os.path.join(out_dir, "streams.pkl"), "wb") as f:
            pickle.dump((reads, w_rounds), f, protocol=pickle.HIGHEST_PROTOCOL)
        ctx = torch.multiprocessing.start_processes(
            shard_rank, args=(SHARD_RANKS, out_dir, time.time()),
            nprocs=SHARD_RANKS, join=False, start_method="spawn")
        deadline = time.monotonic() + SHARD_TIMEOUT_S
        try:
            while not ctx.join(timeout=5):
                check(time.monotonic() < deadline,
                      f"phase 4s: ranks still running after {SHARD_TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        records = []
        for r in range(SHARD_RANKS):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                records.append(json.load(f))
        return records
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def log_shard_row(row: dict, smi: str) -> None:
    r, w = row["reads"], row["writes"]
    single = row.get("single_chip")
    beside = (f"; single-chip {row['config']} {single['lanes_per_sec']!r} (busy), "
              f"{single['lanes_per_drain_sec']!r} (drain wall)" if single else "")
    log(f"    {row['strategy']} ({row['config']}) x{row['ranks']}: reads lanes_per_sec="
        f"{r['lanes_per_sec']!r} (busy), {r['lanes_per_drain_sec']!r} (drain wall) over "
        f"{r['lanes']} lanes, {r['chunks']} chunks, {r['fetches']} fetches, K4 "
        f"{r['launches']['queue_dispatch']}, K1 {r['launches']['forest_descend']}{beside}; "
        f"writes {w['lanes_per_sec']!r} (busy) over {w['lanes']} lanes, {w['read_chunks']} read "
        f"+ {w['ingest_chunks']} ingest chunks, {w['compactions']} compactions, {w['fetches']} "
        f"fetches, K4 {w['launches']['queue_dispatch']}, K1 {w['launches']['forest_descend']}, "
        f"K3 {w['launches']['hybrid_descend']}; memory_nodes_per_device "
        f"{row['memory_nodes_per_device']}; answers == oracle ({smi})")
    for c in row["kernels"]["checks"]:
        log(f"      {c}: K1, K4 == their plain versions")
    if "chunk_profile" in row:
        log_call_profile(f"{row['strategy']} x{row['ranks']} one lookup chunk's drain",
                         row["chunk_profile"])


def shard_phase(keys, values, lookups, rounds, smi: str) -> dict:
    """Phase 4s: world 1 over NCCL in this process, then SHARD_RANKS ranks
    spawned on the card over gloo.  Returns every row and the K1 and K4
    launches of the sharded paths (reads and writes, every strategy, at
    world 1 and on rank 0 of the spawned run)."""
    reads = shard_reads(keys, values, lookups)
    w_rounds = rounds[:SHARD_W_ROUNDS]
    launches = {"forest_descend": 0, "queue_dispatch": 0}
    torch.distributed.init_process_group("nccl", store=torch.distributed.HashStore(),
                                         rank=0, world_size=1)
    world1 = []
    try:
        t0 = time.perf_counter()
        for strategy in SHARD_CONFIGS:
            row = serve_sharded(keys, values, strategy, dist_lib.make_serving_mesh(strategy),
                                reads, w_rounds, single=True)
            check(row["memory_nodes_per_device"] == N_KEYS + (0 if strategy == "dup" else 1),
                  f"4s {strategy} x1: {row['memory_nodes_per_device']} nodes per device")
            world1.append(row)
            log_shard_row(row, smi)
        log(f"    world 1 over NCCL in {time.perf_counter() - t0!r} s; per strategy (host seconds) "
            f"{[(row['strategy'], row['seconds']) for row in world1]}")
    finally:
        torch.distributed.destroy_process_group()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    records = spawn_shard_ranks(reads, w_rounds)
    spawned_s = time.perf_counter() - t0
    # at 4 ranks: a subtree of height H - 2 (21) and a 3-node register layer
    sub_nodes = (1 << (tree_lib.height_for(N_KEYS) - 1)) - 1 + 3
    for rec in records:
        for row in rec["rows"]:
            want = N_KEYS if row["strategy"] == "dup" else sub_nodes
            check(row["memory_nodes_per_device"] == want,
                  f"4s {row['strategy']} x{SHARD_RANKS} rank {rec['rank']}: "
                  f"{row['memory_nodes_per_device']} nodes per device, want {want}")
            for kern, a in row["kernels"]["agreement"].items():
                AGREEMENT[kern]["max_abs_err"] = max(AGREEMENT[kern]["max_abs_err"], a["max_abs_err"])
                AGREEMENT[kern]["mismatches"] += a["mismatches"]
    for row in records[0]["rows"]:
        log_shard_row(row, smi)
    for row in world1 + records[0]["rows"]:
        for part in ("reads", "writes"):
            for kern in launches:
                launches[kern] += row[part]["launches"][kern]
    for kern, n in launches.items():
        check(n > 0, f"{kern} never launched on the sharded path")
    peaks = [rec["peak_bytes"] for rec in records]
    log(f"    ranks' clocks, seconds after the spawn: {[rec['stamps'] for rec in records]}; "
        f"rank 0 per strategy (host seconds) "
        f"{[(row['strategy'], row['seconds']) for row in records[0]['rows']]}")
    log(f"    {SHARD_RANKS} ranks over gloo on one card in {spawned_s!r} s (spawn included); "
        f"peak device memory per rank {peaks} bytes (torch.cuda.max_memory_allocated; each "
        f"rank's engine keeps the whole snapshot); K1/K4 launches on the sharded paths (world 1 "
        f"and rank 0 of {SHARD_RANKS}) {launches} ({smi})")
    return {"world1": world1, "ranks": records, "spawned_s": spawned_s, "peak_bytes": peaks,
            "launches": launches}


# ------------------------------------------------------ phase 4g: the port gates
class _PlantedPull(BSTServer):
    """Negative control: an implicit device -> host pull (an ``.item()``)
    in every read chunk's retire, which the measured phase runs."""

    def _fill_columns(self, columns, total, sl, res):
        res[0].sum().item()
        return super()._fill_columns(columns, total, sl, res)


class _SecondLength(BSTServer):
    """Negative control: the measured chunks half the length that
    ``warmup`` captured, so the drain captures graphs of a second length."""

    def warmup(self, ops=("lookup",)):
        super().warmup(ops)
        self.chunk_size //= 2


def sync_mode_findings() -> dict:
    """Which calls ``torch.cuda.set_sync_debug_mode("error")`` sees: each
    call planted alone under ``runtime.transfer_watch``; True where it
    raised."""
    x = torch.arange(1024, dtype=torch.int32, device="cuda")
    host = torch.arange(1024, dtype=torch.int32)
    pinned = host.pin_memory()
    dst = torch.empty_like(x)
    event = torch.cuda.Event()
    calls = {
        ".item()": lambda: x.sum().item(),
        ".cpu()": lambda: x.cpu(),
        ".tolist()": lambda: x[:4].tolist(),
        "pageable .to(cuda)": lambda: host.to("cuda"),
        "pageable copy_": lambda: dst.copy_(host),
        "pinned copy_ non_blocking": lambda: dst.copy_(pinned, non_blocking=True),
        "torch.tensor(int, device=cuda)": lambda: torch.tensor(5, device="cuda"),
        "torch.nonzero": lambda: torch.nonzero(x),
        "boolean mask index": lambda: x[x > 5],
        "torch.cuda.synchronize()": torch.cuda.synchronize,
        "Event.synchronize()": lambda: (event.record(), event.synchronize()),
        "Stream.synchronize()": lambda: torch.cuda.current_stream().synchronize(),
        "runtime.device_fetch": lambda: runtime.device_fetch((x,)),
        "runtime.device_put": lambda: runtime.device_put(host, dst),
        "runtime.block_until_ready": lambda: runtime.block_until_ready((x,)),
    }
    raised = {}
    for name, call in calls.items():
        with runtime.transfer_watch():
            try:
                call()
                raised[name] = False
            except RuntimeError as e:
                check("synchroniz" in str(e), f"sync mode: {name} raised another error: {e}")
                raised[name] = True
    torch.cuda.synchronize()
    return raised


def gate_phase(keys, smi: str) -> dict:
    """Phase 4g: the port gates (``repro_torch.analysis``) on the card: the
    lint, dead-code and contracts passes, the serve gate for hrz, dup and
    hyb on the single-chip server and on the sharded server at world 1 over
    NCCL, at the gate's size and at the main path's (the phase-4 tree,
    CHUNK), both negative controls, and the sync debug mode's findings.
    Returns the phase's record; kernel runs are counted per gate run."""
    t_phase = time.perf_counter()
    out = {"sync_mode_raises": sync_mode_findings()}
    expected = {".item()": True, ".cpu()": True, ".tolist()": True, "pageable .to(cuda)": True,
                "pageable copy_": True, "runtime.device_fetch": False,
                "runtime.device_put": False, "runtime.block_until_ready": False}
    for name, want in expected.items():
        check(out["sync_mode_raises"][name] == want,
              f"4g: under transfer_watch {name} {'did not raise' if want else 'raised'}")
    log(f"    sync debug mode 'error' raises on: "
        f"{[k for k, v in out['sync_mode_raises'].items() if v]}; not on: "
        f"{[k for k, v in out['sync_mode_raises'].items() if not v]} ({smi})")

    t0 = time.perf_counter()
    lint_hard, lint_soft = lint.lint_paths([os.path.join(ROOT, p) for p in analysis_main.DEFAULT_PATHS])
    dead_hard, dead = deadcode.report_dead(ROOT)
    check(not lint_hard and not dead_hard, "4g static passes:\n" + report.render_all(lint_hard + dead_hard))
    out["static_s"] = time.perf_counter() - t0
    out["allowlisted"] = len(lint_soft)
    out["quarantined"] = sorted(dead)

    runs = {}
    seconds = {}
    with gate.world1_group("cuda"):
        t0 = time.perf_counter()
        errors = contracts.run_contracts("cuda")
        check(not errors, "4g contracts:\n" + report.render_all(errors))
        out["contracts_s"] = time.perf_counter() - t0
        for size, gate_kw in (("gate", {}), ("main", {"keys": keys, "chunk_size": CHUNK})):
            for sharded in (False, True):
                for strategy in GATE_STRATEGIES:
                    tag = f"{strategy}{'/sharded' if sharded else ''} at the {size} size"
                    torch.cuda.synchronize()
                    before, t0 = graphs.kernel_runs(), time.perf_counter()
                    errors = gate.serve_gate(strategy, sharded=sharded, device="cuda", **gate_kw)
                    seconds[tag] = time.perf_counter() - t0
                    runs[tag] = {k: n - before[k] for k, n in graphs.kernel_runs().items()
                                 if n != before[k]}
                    check(not errors, f"4g serve gate {tag}:\n" + report.render_all(errors))
                    gc.collect()
    out["contracts_and_gates_s"], out["gate_s"], out["gate_kernel_runs"] = (
        time.perf_counter() - t_phase, seconds, runs)

    controls = {}
    for label, planted, needle in (("planted .item()", _PlantedPull, "synchroniz"),
                                   ("second batch length", _SecondLength, "captured")):
        with unittest.mock.patch.object(bst_server, "BSTServer", planted):
            errors = gate.serve_gate("hrz", device="cuda")
        caught = [v.render() for v in errors if needle in v.msg]
        check(caught, f"4g negative control {label!r} not reported: {report.render_all(errors)}")
        controls[label] = [v.render() for v in errors]
        log(f"    negative control {label}: {len(errors)} violation(s), e.g. {caught[0]}")
    out["negative_controls"] = controls

    total = {}
    for r in runs.values():
        for k, n in r.items():
            total[k] = total.get(k, 0) + n
    for kern, names in (("K1", ("forest_descend",)), ("K3", ("hybrid_descend",)),
                        ("K2", ("forest_descend_delta", "hybrid_descend_delta")),
                        ("K4", ("queue_dispatch",))):
        check(sum(total.get(n, 0) for n in names) > 0, f"4g: {kern} never ran in the gates")
    for tag, r in runs.items():
        log(f"    serve gate {tag}: clean in {seconds[tag]!r} s; kernel runs {r}")
    out["kernel_runs_total"] = total
    out["seconds"] = time.perf_counter() - t_phase
    log(f"    phase 4g in {out['seconds']!r} s (static passes {out['static_s']!r} s, "
        f"contracts {out['contracts_s']!r} s); {out['allowlisted']} allowlisted lint hits, "
        f"quarantined {out['quarantined']}; kernel runs over the gates {total} ({smi})")
    return out


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

    def __call__(self, fn, reps: int = TIMING_REPS, cold: bool = True) -> float:
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            if cold:
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


def chase_cycle(n: int, seed: int) -> tuple:
    """A random cycle through ``n`` int32 slots, built on the card: ``(next,
    start)`` with ``next[perm[i]] = perm[i + 1]``."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    perm = torch.randperm(n, generator=g, device="cuda")
    nxt = torch.empty(n, dtype=torch.int32, device="cuda")
    nxt[perm] = torch.roll(perm, -1).to(torch.int32)
    return nxt, int(perm[0])


def pointer_chase_latency(timer) -> dict:
    """The card's dependent-load latency (``csrc/pointer_chase.cu``): one
    thread's walk of CHASE_STEPS links over CHASE_STEPS.  L_HBM from a cold
    64 MiB cycle (the L2 flushed before each run; the size of the tree's
    keys, past the 50 MB L2), L_L2 from a warm 4 MiB one (the timed walk
    repeats the warm-up's path, which the L2 holds and the L1 does not)."""
    lib = _build.library().lib
    out = torch.empty(1, dtype=torch.int32, device="cuda")
    res = {"steps": CHASE_STEPS}
    for name, n, cold in (("l_hbm_ms", CHASE_HBM_INTS, True), ("l_l2_ms", CHASE_L2_INTS, False)):
        nxt, start = chase_cycle(n, seed=n)

        def run():
            rc = lib.pointer_chase(nxt.data_ptr(), start, CHASE_STEPS, out.data_ptr(),
                                   torch.cuda.current_stream().cuda_stream)
            _build.check_launch(rc, "pointer_chase")

        res[name] = timer(run, reps=CHASE_REPS, cold=cold) / CHASE_STEPS
        res[name.replace("_ms", "_buffer_bytes")] = 4 * n
        del nxt
    return res


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


def round_trips(kern: str, H: int, ordered: bool, split: int = 0) -> int:
    """Global round trips on the dependent chain of a lane that walks all
    H + 1 levels, each an HBM round trip when the L2 is cold, from the
    design the library exports: one to stage the top levels (the forest
    body's ``forest_staged_levels``, the hybrid body's
    ``hybrid_staged_levels`` at its split), one per ``levels_per_trip``
    levels below them, one to gather the values, and with the delta buffer
    one for the lane's line of keys (read before the descent).  The same
    in both configurations: the ordered walk keeps node indices too."""
    lib = _build.library().lib
    staged = lib.forest_staged_levels() if kern.startswith("forest") else lib.hybrid_staged_levels(split)
    deep = max(0, H + 1 - staged)
    return 1 + -(-deep // lib.levels_per_trip()) + 1 + (1 if kern.endswith("_delta") else 0)


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


def time_kernels(tree, pool, skewed, timer, l_hbm_ms, delta=None, library_keys=None) -> list:
    """Each kernel configuration of the main path at its serving shape: held
    against its plain version there on the timing keys and on the skewed
    ``equal`` set (which forces the hybrid kernel's stall round), then
    timed on the timing keys, beside the byte bound and the latency bound
    (``round_trips`` x ``l_hbm_ms``).  With ``delta`` (a write buffer) the kernels
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
            trips = round_trips(kern, H, ordered, invariants.split_level_for(cfg.n_trees)
                                if cfg.strategy == "hyb" else 0)
            rows.append({
                "kernel": kern,
                "config": f"{name} {mode}",
                "lanes": lanes,
                "ms": timer(run),
                "plain_ms": timer(plain, reps=5),
                "library_ms": timer(functools.partial(torch.searchsorted, library_keys, q)),
                "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
                "round_trips": trips,
                "latency_bound_ms": trips * l_hbm_ms,
            })
            r = rows[-1]
            log(f"  {kern} {r['config']} x{lanes}: 0 mismatches ({replayed} equal-set "
                f"lanes replayed), ms={r['ms']!r} "
                f"plain_ms={r['plain_ms']!r} library_ms={r['library_ms']!r} "
                f"bound_ms={r['bound_ms']!r} latency_bound_ms={r['latency_bound_ms']!r} "
                f"({trips} round trips)")
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


def check_full_model_bf16(cfg, smi: str) -> dict:
    """qwen3-1.7b in bf16 at full width and depth, LM_BF16_CHECK_BATCH x
    LM_CHECK_PROMPT: the serving route (flash, K5's bf16 wgmma body) and the
    naive route (plain attention) in bf16, each against the naive route of
    the same weights in fp32.  The flash route's RMS distance over all the
    last-position logits may be at most LM_BF16_ROUTE_RATIO times the naive
    bf16 route's: the kernel may add to the model's bf16 rounding, not
    more than that share of it."""
    naive = dataclasses.replace(cfg, attention_impl="naive")
    naive32 = dataclasses.replace(naive, dtype="float32")
    model = lm.init_params(cfg, seed=0, device="cuda")
    model32 = lm.Model(naive32, device="cuda")
    for p32, p in zip(model32.parameters(), model.parameters()):
        p32.copy_(p)
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (LM_BF16_CHECK_BATCH, LM_CHECK_PROMPT))).cuda()
    FA.reset_launches()
    flash, _ = lm.prefill(cfg, model, toks)
    check(FA.LAUNCHES["flash_attention"] == cfg.n_layers,
          f"bf16 prefill: {FA.LAUNCHES['flash_attention']} K5 launches for {cfg.n_layers} layers")
    plain, _ = lm.prefill(naive, model, toks)
    want, _ = lm.prefill(naive32, model32, toks)
    check(FA.LAUNCHES["flash_attention"] == cfg.n_layers, "the naive routes launched K5")
    check(all(bool(torch.isfinite(t).all()) for t in (flash, plain, want)),
          "bf16 check: a logit is not finite")
    dist = {name: (float((got.float() - want).pow(2).mean().sqrt()),
                   float((got.float() - want).abs().max()))
            for name, got in (("flash", flash), ("naive", plain))}
    ratio = dist["flash"][0] / dist["naive"][0]
    row = {"batch": LM_BF16_CHECK_BATCH, "prompt": LM_CHECK_PROMPT,
           "flash_vs_fp32_rms": dist["flash"][0], "flash_vs_fp32_max_abs": dist["flash"][1],
           "naive_vs_fp32_rms": dist["naive"][0], "naive_vs_fp32_max_abs": dist["naive"][1],
           "rms_ratio": ratio, "tol_ratio": LM_BF16_ROUTE_RATIO,
           "logit_scale": float(want.abs().max())}
    log(f"  bf16 {cfg.name}, {cfg.n_layers} layers, {LM_BF16_CHECK_BATCH} x {LM_CHECK_PROMPT}: "
        f"against the fp32 naive route, flash bf16 RMS {dist['flash'][0]!r} (max abs "
        f"{dist['flash'][1]!r}), naive bf16 RMS {dist['naive'][0]!r} (max abs "
        f"{dist['naive'][1]!r}); ratio {ratio!r} (tolerance {LM_BF16_ROUTE_RATIO}; largest "
        f"logit {row['logit_scale']!r}) ({smi})")
    check(ratio <= LM_BF16_ROUTE_RATIO,
          f"bf16 check: the flash route is {ratio!r} times as far from fp32 as the naive route")
    del model, model32, flash, plain, want
    torch.cuda.empty_cache()
    return row


def timed_generate(cfg, model, prompts, n_new: int, eager: bool, per_step=None,
                   profiles=()) -> dict:
    """One request through the serve loop's units on one route (the decode
    graph, or with ``eager`` the ops one by one): the prefill and the
    ``n_new - 1`` decode steps timed by the host clock around synchronised
    work, every step's logits copied out (the graph's are its static
    buffer) and checked finite, ``per_step()`` after the prefill and after
    each step, then the profiles named in ``profiles``: "decode" (further
    decode steps) and "prefill" (one more prefill)."""
    S = prompts.shape[1]
    prefill_fn = make_prefill_fn(cfg, max_len=S + n_new, eager=eager)
    step = make_serve_step(cfg, eager=eager)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, state = prefill_fn(model, prompts)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    if per_step is not None:
        per_step()
    all_logits = [logits]
    tok = logits.argmax(dim=-1, keepdim=True)
    outs = [tok]
    for _ in range(n_new - 1):
        logits, state = step(model, tok, state)
        all_logits.append(logits.clone())
        tok = logits.argmax(dim=-1, keepdim=True)
        outs.append(tok)
        if per_step is not None:
            per_step()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    route = "eager" if eager else "graph"
    check(all(bool(torch.isfinite(lg).all()) for lg in all_logits),
          f"serving ({route}): a logit is not finite")
    n_steps = n_new - 1
    return {
        "route": route, "tokens": torch.cat(outs, dim=1), "prefill_s": t1 - t0,
        "prefill_tok_per_s": prompts.numel() / (t1 - t0), "decode_steps": n_steps,
        "decode_ms_per_step": (t2 - t1) / n_steps * 1e3,
        "decode_tok_per_s": prompts.shape[0] * n_steps / (t2 - t1),
        **({"decode_profile": profile_decode(step, model, tok, state)} if "decode" in profiles else {}),
        **({"prefill_profile": profile_calls(lambda: prefill_fn(model, prompts), 1)}
           if "prefill" in profiles else {}),
    }


def log_route(label: str, r: dict) -> None:
    log(f"    {label} {r['route']}: prefill {r['prefill_s']!r} s ({r['prefill_tok_per_s']!r} tok/s), "
        f"decode {r['decode_ms_per_step']!r} ms/step ({r['decode_tok_per_s']!r} tok/s)")
    for kind in ("decode", "prefill"):
        if f"{kind}_profile" in r:
            log_call_profile(f"{r['route']} {kind}", r[f"{kind}_profile"])


def serve_lm(cfg, smi: str) -> dict:
    """The serving run: qwen3-1.7b in bf16 through ``greedy_generate``, whose
    first call captures the decode graph, with K5's launches counted from
    0; the same through the eager route, tokens equal; then one request
    timed on each route (graph, eager, graph, eager: the host's spread
    shows in each pair) through the serve loop's units, tokens held against
    greedy_generate's, and no capture after the first."""
    model = lm.init_params(cfg, seed=0, device="cuda")
    prompts = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT))).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    FA.reset_launches()
    captures, capture_s = graphs.STATS["captures"], graphs.STATS["capture_s"]
    tokens = greedy_generate(cfg, model, prompts, LM_NEW)
    torch.cuda.synchronize()
    launches = FA.LAUNCHES["flash_attention"]
    peak = torch.cuda.max_memory_allocated()
    check(graphs.STATS["captures"] == captures + 1, "serving: not one decode graph captured")
    capture_s = graphs.STATS["capture_s"] - capture_s
    check(launches == cfg.n_layers, f"serving: {launches} K5 launches for one prefill of "
                                    f"{cfg.n_layers} layers")
    check(tuple(tokens.shape) == (LM_BATCH, LM_NEW), f"greedy_generate gave {tuple(tokens.shape)}")
    eager_tokens = greedy_generate(cfg, model, prompts, LM_NEW, eager=True)
    check(torch.equal(eager_tokens, tokens), "serving: the graph's tokens differ from the eager route's")

    steady = graphs.STATS["captures"]
    routes = [timed_generate(cfg, model, prompts, LM_NEW, eager, profiles=profiles)
              for eager, profiles in ROUTE_TURNS]
    check(graphs.STATS["captures"] == steady, "serving: a steady-state request captured a graph")
    for r in routes:
        check(torch.equal(r.pop("tokens"), tokens),
              f"serving ({r['route']}): the timed steps' tokens differ from greedy_generate's")
    graph, eager = routes[0], routes[1]
    row = {
        "arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads, "head_dim": cfg.resolved_head_dim,
        "vocab": cfg.vocab_size, "dtype": cfg.dtype, "params": cfg.n_params(),
        "batch": LM_BATCH, "prompt": LM_PROMPT, "new_tokens": LM_NEW,
        "flash_launches": launches, "peak_bytes": peak, "capture_s": capture_s,
        **{k: graph[k] for k in ("prefill_s", "prefill_tok_per_s", "decode_steps",
                                 "decode_ms_per_step", "decode_tok_per_s", "decode_profile",
                                 "prefill_profile")},
        "routes": routes, "graph_tokens_equal_eager": True,
        "sample_ids": tokens[0, :16].tolist(),
    }
    log(f"  {cfg.name} bf16, {cfg.n_layers} layers, {LM_BATCH} x {LM_PROMPT} + {LM_NEW}: "
        f"K5 launches {launches}, decode graph captured in {capture_s!r} s, graph tokens == "
        f"eager tokens; graph: prefill {graph['prefill_s']!r} s ({graph['prefill_tok_per_s']!r} "
        f"tok/s), decode {graph['decode_ms_per_step']!r} ms/step; eager: decode "
        f"{eager['decode_ms_per_step']!r} ms/step; peak {peak} bytes, every logit finite ({smi})")
    for r in routes:
        log_route("route", r)
    log(f"    sample ids {row['sample_ids']}")
    del model
    torch.cuda.empty_cache()
    return row


def profile_decode(step, model, tok, state) -> dict:
    """Where LM_PROFILE_STEPS greedy decode steps' time goes (``profile_calls``)."""
    carry = [tok, state]

    def one_step():
        logits, carry[1] = step(model, carry[0], carry[1])
        carry[0] = logits.argmax(dim=-1, keepdim=True)

    return profile_calls(one_step, LM_PROFILE_STEPS)


def time_flash(timer) -> list:
    """K5 in bf16 at both prefill shapes (qwen3's and mixtral's), each beside
    its plain version, scaled_dot_product_attention (the library yardstick,
    never called by the port) and the least time the card could take for
    the same work."""
    rows = []
    for idx, what in zip(FLASH_TIMED, (LM_ARCH, MOE_ARCH)):
        shape = FLASH_SHAPES[idx]
        BH, BHkv, Sq, Skv, d, causal, window = shape
        check(causal and (window is None or window >= Skv),
              f"{shape}: SDPA's is_causal computes this function only without a window cut")
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
            "config": f"{what} prefill attention", "shape": list(shape), "dtype": "bfloat16",
            "ms": timer(functools.partial(FA.flash_attention_cuda, q, k, v, causal=causal,
                                          window=window)),
            "plain_ms": timer(functools.partial(ref.flash_attention_ref, q, k, v, causal=causal,
                                                window=window), reps=5),
            "library_ms": timer(sdpa),
            "flop": flop, "bytes": n_bytes,
            "flop_ms": flop / BF16_FLOP_PER_S * 1e3, "bytes_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
            "max_abs_err": err, "library_max_abs_err": lib_err,
        }
        row["bound_ms"] = max(row["flop_ms"], row["bytes_ms"])
        row["bound_by"] = "operations" if row["flop_ms"] >= row["bytes_ms"] else "bytes"
        row["tflop_per_s"] = flop / row["ms"] * 1e-9
        log(f"  K5 {what} {shape} bf16: ms={row['ms']!r} plain_ms={row['plain_ms']!r} "
            f"library_ms={row['library_ms']!r} bound_ms={row['bound_ms']!r} ({row['bound_by']}: "
            f"{flop} FLOP over {BF16_FLOP_PER_S:.3g}/s = {row['flop_ms']!r} ms, {n_bytes} bytes "
            f"over {HBM_BYTES_PER_S:.3g}/s = {row['bytes_ms']!r} ms; {row['tflop_per_s']!r} "
            f"TFLOP/s); max_abs_err vs plain {err!r}, sdpa vs plain {lib_err!r}")
        rows.append(row)
        del q, k, v, got, want, q4, k4, v4
    return rows


# ------------------------------------------------------------ phase 7: MoE
def queue_dispatch_rows(G: int, B: int, n_dest: int, seed: int) -> torch.Tensor:
    """G rows of B destinations, 1/8 of the lanes inactive (-1), then three
    skewed rows: every lane to one destination, two hot destinations, and
    every lane inactive."""
    rng = np.random.default_rng(seed)
    dest = rng.integers(0, n_dest, (G, B)).astype(np.int32)
    dest[rng.random((G, B)) < 1 / 8] = -1
    skews = np.stack([np.full(B, n_dest - 1), rng.choice([0, n_dest // 2], B), np.full(B, -1)])
    return torch.from_numpy(np.concatenate([dest, skews.astype(np.int32)])).cuda()


def compare_k4(got, want, tag: str) -> int:
    """K4's five outputs (slot, kept, buffers, counts, overflow) against its
    plain version's, element by element; adds to ``AGREEMENT`` and fails on
    any difference."""
    n_bad, worst = 0, 0
    for i, (g, w) in enumerate(zip(got, want)):
        check(g.shape == w.shape and g.dtype == w.dtype, f"{tag}[{i}]: shape/dtype")
        diff = (g.long() - w.long()).abs()
        n_bad += int((diff != 0).sum())
        worst = max(worst, int(diff.max()) if diff.numel() else 0)
    AGREEMENT["queue_dispatch"]["mismatches"] += n_bad
    AGREEMENT["queue_dispatch"]["max_abs_err"] = max(AGREEMENT["queue_dispatch"]["max_abs_err"], worst)
    check(n_bad == 0, f"{tag}: {n_bad} mismatching elements")
    return n_bad


def check_queue_dispatch() -> list:
    """K4 against its plain version at every QD_SHAPES shape, bit for bit on
    all five outputs of the plan; the one-destination row must overflow
    wherever B exceeds the capacity."""
    rows = []
    for i, (G, B, n_dest, capacity, what) in enumerate(QD_SHAPES):
        dest = queue_dispatch_rows(G, B, n_dest, seed=i)
        got = QD.queue_dispatch_cuda(dest, n_dest, capacity)
        want = ref.queue_dispatch_ref(dest, n_dest, capacity)
        check(len(got) == 5, f"K4 {what}: {len(got)} outputs")
        bad = compare_k4(got, want, f"K4 {what}")
        n_over = int(got[4][G].sum())
        check(n_over == max(0, B - capacity), f"K4 {what}: {n_over} lanes of the one-destination row overflowed")
        check(not bool(got[4][G + 2].any()) and int(got[3][G + 2].sum()) == 0,
              f"K4 {what}: the all-inactive row placed a lane")
        rows.append({"G": G, "B": B, "n_dest": n_dest, "capacity": capacity, "what": what,
                     "mismatches": bad, "overflowed": int(got[4].sum())})
        log(f"  K4 {what}: G={G} (+3 skewed rows) B={B} n_dest={n_dest} capacity={capacity}: "
            f"0 mismatches, {rows[-1]['overflowed']} lanes overflowed")
    return rows


def queue_dispatch_bytes(G: int, B: int, n_dest: int, capacity: int) -> int:
    """Bytes K4 must move: dest read once; slot, buffers and counts (int32)
    and kept and overflow (bool) written once."""
    return 4 * G * B + G * (4 * B + 2 * B + 4 * n_dest * capacity + 4 * n_dest)


def empty_launch(grid: int, threads: int, smem_bytes: int, cluster: int = 1) -> None:
    """An empty kernel (``csrc/pointer_chase.cu``) of ``grid`` CTAs of
    ``threads`` threads with ``smem_bytes`` of dynamic shared memory, in
    clusters of ``cluster`` CTAs, through the same ctypes path as the
    kernels."""
    rc = _build.library().lib.empty_launch(grid, threads, smem_bytes, cluster,
                                           torch.cuda.current_stream().cuda_stream)
    _build.check_launch(rc, "empty_launch")


def time_queue_dispatch(timer, l_hbm_ms: float) -> list:
    """K4 at the MoE prefill and decode shapes and at both benchmarks'
    shapes (random rows, 1/8 inactive), its plain version, the byte bound
    and the latency bound (QD_ROUND_TRIPS x L_HBM); beside each, timed the
    same way, its floor: an empty kernel launched with K4's grid, clusters,
    threads and dynamic shared memory (and without the shared memory, which
    says what asking for it costs).  No single PyTorch call builds a FIFO
    buffer image, so there is no library yardstick."""
    lib = _build.library().lib
    rows = []
    for i in QD_TIMED:
        G, B, n_dest, capacity, what = QD_SHAPES[i]
        dest = queue_dispatch_rows(G, B, n_dest, seed=100 + i)[:G].contiguous()
        compare_k4(QD.queue_dispatch_cuda(dest, n_dest, capacity),
                   ref.queue_dispatch_ref(dest, n_dest, capacity), f"K4 timed {what}")
        n_bytes = queue_dispatch_bytes(G, B, n_dest, capacity)
        ctas = lib.queue_dispatch_ctas(B, n_dest)
        threads = lib.queue_dispatch_threads(B, n_dest)
        smem = lib.queue_dispatch_smem_bytes(B, n_dest)
        rows.append({
            "what": what, "G": G, "B": B, "n_dest": n_dest, "capacity": capacity,
            "ctas_per_row": ctas, "threads": threads, "smem_bytes": smem,
            "ms": timer(functools.partial(QD.queue_dispatch_cuda, dest, n_dest, capacity)),
            "plain_ms": timer(functools.partial(ref.queue_dispatch_ref, dest, n_dest, capacity), reps=5),
            "floor_ms": timer(functools.partial(empty_launch, G * ctas, threads, smem, ctas)),
            "floor_no_smem_ms": timer(functools.partial(empty_launch, G * ctas, threads, 0, ctas)),
            "bytes": n_bytes, "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "round_trips": QD_ROUND_TRIPS, "latency_bound_ms": QD_ROUND_TRIPS * l_hbm_ms,
            "library_ms": None,
        })
        r = rows[-1]
        log(f"  K4 {what} (G={G}, B={B}, n_dest={n_dest}, capacity={capacity}; {ctas} CTAs a "
            f"row of {threads} threads, {smem} bytes dynamic shared memory a CTA): ms={r['ms']!r} "
            f"plain_ms={r['plain_ms']!r} floor_ms={r['floor_ms']!r} (an empty kernel of K4's "
            f"launch; {r['floor_no_smem_ms']!r} without the shared memory) "
            f"bound_ms={r['bound_ms']!r} (bytes: {n_bytes} over {HBM_BYTES_PER_S:.3g}/s) "
            f"latency_bound_ms={r['latency_bound_ms']!r} ({QD_ROUND_TRIPS} round trip x L_HBM) "
            f"library_ms=None (no single PyTorch call builds a FIFO buffer image)")
    return rows


def kernels_per_dispatch(G: int, B: int, n_dest: int, capacity: int, calls: int = 10) -> tuple:
    """The device kernels (and copies) of ``calls`` queue dispatches of the
    MoE layer, ``core.buffers.dispatch("queue", ...)``, on the card, by
    name, as torch.profiler sees them: one step of ``calls`` dispatches as
    the profiler's warm-up (a trace can miss its first kernels), then one
    recorded.  One K4 launch per dispatch gives ``calls`` names.  The
    profiler now and then loses some or all of a trace's device events
    (7, and 0, of 10 in two runs on an H100), so a trace with fewer
    events than ``calls`` is taken again, in a new
    session, up to COUNT_ATTEMPTS times; a trace with more, or with any
    other kernel, is returned at once.  Returns the names and the traces
    it took."""
    dest = queue_dispatch_rows(G, B, n_dest, seed=7)[:G].contiguous()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(1, COUNT_ATTEMPTS + 1):
        schedule = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
        with torch.profiler.profile(activities=activities, schedule=schedule) as prof:
            for _ in range(2):
                for _ in range(calls):
                    buf_lib.dispatch("queue", dest, n_dest, capacity)
                torch.cuda.synchronize()
                prof.step()
        names = [ev.name for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA
                 and not ev.name.startswith("ProfilerStep")]  # the step's own annotation
        if len(names) >= calls or any("queue_dispatch" not in n for n in names):
            break
    return names, attempt


@contextlib.contextmanager
def swapped(module, name: str, fn):
    """``module.name`` is ``fn`` inside the block, and what it was after."""
    saved = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, saved)


def dense_moe_ffn(cfg, p, x):
    """The oracle of tests/test_moe.py: every token through its top-k
    experts with no capacity, the experts' outputs summed with the gate
    weights.  Where no expert overflows, the dispatch must give this."""
    B, S, D = x.shape
    xt = x.reshape(-1, D)
    gates, experts = moe_lib.top_k((xt @ p.router).float(), cfg.top_k)
    gates = torch.softmax(gates, dim=-1)
    out = torch.zeros(xt.shape, dtype=torch.float32, device=x.device)
    for e in range(cfg.n_experts):
        g = torch.nn.functional.silu((xt @ p.w_gate[e]).float())
        y = (g * (xt @ p.w_up[e]).float()) @ p.w_down[e].float()
        out += y * (gates * (experts == e)).sum(dim=-1, keepdim=True)
    return out.reshape(B, S, D).to(x.dtype), torch.zeros((), device=x.device)


def check_moe_fp32(cfg, smi: str) -> dict:
    """mixtral-8x7b in fp32 at full width and MOE_CHECK_LAYERS layers, 1 x
    MOE_CHECK_PROMPT + MOE_CHECK_STEPS decode steps: (i) the K4 route
    against the plain dispatch route (``ref.queue_dispatch_ref`` swapped in
    for ``ops.queue_dispatch``), equal logits; at capacity factor 4 (ii) the
    dispatch route against the dense oracle and (iii) decode against a
    prefill of the longer prompt."""
    cfg32 = dataclasses.replace(cfg, n_layers=MOE_CHECK_LAYERS, dtype="float32")
    ample = dataclasses.replace(cfg32, capacity_factor=MOE_AMPLE_CF)
    model = lm.init_params(cfg32, seed=0, device="cuda")
    total = MOE_CHECK_PROMPT + MOE_CHECK_STEPS
    toks = torch.from_numpy(np.random.default_rng(8).integers(0, cfg.vocab_size, (1, total))).cuda()

    def run(c):
        logits, state = lm.prefill(c, model, toks[:, :MOE_CHECK_PROMPT], max_len=total)
        out, dropped = [logits], [[float(lp.moe.dropped) for lp in model.layers]]
        for t in range(MOE_CHECK_PROMPT, total):
            logits, state = lm.decode_step(c, model, toks[:, t:t + 1], state)
            out.append(logits)
            dropped.append([float(lp.moe.dropped) for lp in model.layers])
        check(all(bool(torch.isfinite(lg).all()) for lg in out), "fp32 MoE: a logit is not finite")
        return out, dropped

    QD.reset_launches()
    k4, k4_dropped = run(cfg32)
    check(QD.LAUNCHES["queue_dispatch"] == MOE_CHECK_LAYERS * (1 + MOE_CHECK_STEPS),
          f"fp32 MoE: {QD.LAUNCHES['queue_dispatch']} K4 launches")
    with swapped(kops, "queue_dispatch", ref.queue_dispatch_ref):
        plain, plain_dropped = run(cfg32)
    check(QD.LAUNCHES["queue_dispatch"] == MOE_CHECK_LAYERS * (1 + MOE_CHECK_STEPS),
          "fp32 MoE: the plain dispatch route launched K4")
    route_err = max(float((a - b).abs().max()) for a, b in zip(k4, plain))
    check(all(torch.equal(a, b) for a, b in zip(k4, plain)) and k4_dropped == plain_dropped,
          f"fp32 MoE: the K4 and plain dispatch routes differ (max_abs_err {route_err!r})")

    routed, routed_dropped = run(ample)
    check(all(d == 0.0 for step in routed_dropped for d in step),
          f"fp32 MoE at capacity factor {MOE_AMPLE_CF}: an expert overflowed")
    with swapped(moe_lib, "moe_ffn", dense_moe_ffn):
        oracle, _ = run(ample)
    oracle_err = max(float((a - b).abs().max()) for a, b in zip(routed, oracle))
    for a, b in zip(routed, oracle):
        torch.testing.assert_close(a, b, atol=MOE_CHECK_TOL, rtol=MOE_CHECK_TOL)
    consistency_err = 0.0
    for t, logits in enumerate(routed[1:], start=1):
        want, _ = lm.prefill(ample, model, toks[:, :MOE_CHECK_PROMPT + t])
        consistency_err = max(consistency_err, float((logits - want).abs().max()))
        torch.testing.assert_close(logits, want, atol=MOE_CHECK_TOL, rtol=MOE_CHECK_TOL)
    row = {"layers": MOE_CHECK_LAYERS, "prompt": MOE_CHECK_PROMPT, "decode_steps": MOE_CHECK_STEPS,
           "k4_vs_plain_route_max_abs_err": route_err, "dropped_per_step": k4_dropped,
           "ample_capacity_factor": MOE_AMPLE_CF, "dispatch_vs_dense_oracle_max_abs_err": oracle_err,
           "decode_vs_prefill_max_abs_err": consistency_err, "tol": MOE_CHECK_TOL,
           "logit_scale": float(k4[0].abs().max())}
    log(f"  fp32 {cfg.name}, {MOE_CHECK_LAYERS} layers, 1 x {MOE_CHECK_PROMPT} + {MOE_CHECK_STEPS}: "
        f"K4 route == plain dispatch route (logits equal; dropped share per layer, prefill "
        f"{k4_dropped[0]}, last decode step {k4_dropped[-1]}); at capacity factor {MOE_AMPLE_CF}: "
        f"dispatch vs dense oracle max_abs_err {oracle_err!r}, decode vs longer prefill "
        f"{consistency_err!r} (tolerance {MOE_CHECK_TOL}; largest logit {row['logit_scale']!r}) ({smi})")
    del model, k4, plain, routed, oracle
    torch.cuda.empty_cache()
    return row


def layer_dropped(model) -> torch.Tensor:
    """Each MoE layer's dropped share of its last call, stacked on the card."""
    return torch.stack([lp.moe.dropped for lp in model.layers])


def serve_moe(cfg, smi: str) -> dict:
    """The MoE serving run: mixtral-8x7b in bf16 at MOE_LAYERS layers.  The
    decode graph is captured first; then ``greedy_generate`` with the
    kernels that ran counted from 0 (K4 and K5 eager in the prefill, K4 in
    every replayed step); the eager route's tokens equal; then one request
    timed on each route (graph, eager, graph, eager) through the serve
    loop's units, one K4 run per layer per step counted after each step,
    the dropped share copied out after each step, tokens held against
    greedy_generate's, and no capture after the first."""
    model = lm.init_params(cfg, seed=0, device="cuda")
    prompts = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (MOE_BATCH, MOE_PROMPT))).cuda()
    L = cfg.n_layers
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    decode_graph(cfg, model, MOE_BATCH, MOE_PROMPT + MOE_NEW)
    torch.cuda.synchronize()
    capture_wall_s = time.perf_counter() - t0
    QD.reset_launches()
    FA.reset_launches()
    graphs.reset()
    tokens = greedy_generate(cfg, model, prompts, MOE_NEW)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    runs = graphs.kernel_runs()
    k4_launches, k5_launches = runs["queue_dispatch"], runs["flash_attention"]
    k4_replayed = graphs.REPLAYED["queue_dispatch"]
    check(graphs.STATS["captures"] == 0, "MoE serving: greedy_generate captured a graph")
    check(k5_launches == L, f"MoE serving: {k5_launches} K5 launches for one prefill of {L} layers")
    check(k4_launches == L * MOE_NEW == k4_replayed + L,
          f"MoE serving: {k4_launches} K4 launches ({k4_replayed} replayed) "
          f"for a prefill and {MOE_NEW - 1} decode steps of {L} layers")
    check(tuple(tokens.shape) == (MOE_BATCH, MOE_NEW), f"greedy_generate gave {tuple(tokens.shape)}")
    eager_tokens = greedy_generate(cfg, model, prompts, MOE_NEW, eager=True)
    check(torch.equal(eager_tokens, tokens), "MoE serving: the graph's tokens differ from the eager route's")

    routes, dropped = [], {}
    for eager, profiles in ROUTE_TURNS:
        route = "eager" if eager else "graph"
        shares, k4, k5 = [], [], []

        def per_step():
            shares.append(layer_dropped(model))  # a copy: the next step overwrites the share
            k4.append(graphs.kernel_runs()["queue_dispatch"])
            k5.append(graphs.kernel_runs()["flash_attention"])

        r = timed_generate(cfg, model, prompts, MOE_NEW, eager, per_step, profiles)
        check(torch.equal(r.pop("tokens"), tokens),
              f"MoE serving ({route}): the timed steps' tokens differ from greedy_generate's")
        check(len(k4) == MOE_NEW and all(b - a == L for a, b in zip(k4, k4[1:])),
              f"MoE {route} decode: not one K4 launch per layer per step: {k4}")
        check(len(set(k5)) == 1, f"MoE {route} decode launched K5")
        r["prefill_dropped_share"] = float(shares[0].mean())
        r["decode_dropped_share"] = float(torch.stack(shares[1:]).mean())
        dropped.setdefault(route, torch.stack(shares))
        routes.append(r)
    check(graphs.STATS["captures"] == 0, "MoE serving: a steady-state request captured a graph")
    check(torch.equal(dropped["graph"], dropped["eager"]),
          "MoE serving: the graph's dropped shares differ from the eager route's")
    graph, eager = routes[0], routes[1]
    row = {
        "arch": cfg.name, "layers": L, "published_layers": get_config(MOE_ARCH).n_layers,
        "d_model": cfg.d_model, "d_ff": cfg.d_ff, "experts": cfg.n_experts, "top_k": cfg.top_k,
        "capacity_factor": cfg.capacity_factor, "moe_groups": cfg.moe_groups,
        "dtype": cfg.dtype, "params": cfg.n_params(), "active_params": cfg.n_active_params(),
        "batch": MOE_BATCH, "prompt": MOE_PROMPT, "new_tokens": MOE_NEW,
        "k4_launches": k4_launches, "k4_replayed": k4_replayed, "k5_launches": k5_launches,
        "peak_bytes": peak,
        "capture_wall_s": capture_wall_s,
        **{k: graph[k] for k in ("prefill_s", "prefill_tok_per_s", "decode_steps",
                                 "decode_ms_per_step", "decode_tok_per_s", "decode_profile",
                                 "prefill_profile", "prefill_dropped_share",
                                 "decode_dropped_share")},
        "decode_kernels_per_step": graph["decode_profile"]["device_events_per_call"],
        "routes": routes, "graph_tokens_equal_eager": True,
        "sample_ids": tokens[0, :16].tolist(),
    }
    log(f"  {cfg.name} bf16, {L} of {row['published_layers']} layers, {MOE_BATCH} x {MOE_PROMPT} + "
        f"{MOE_NEW}: decode graph captured in {capture_wall_s!r} s (warm-up step included); K4 "
        f"launches {k4_launches} ({k4_replayed} of them replayed: one per "
        f"layer per prefill and decode step), K5 launches {k5_launches}; graph tokens == eager "
        f"tokens, dropped shares equal; graph: prefill {graph['prefill_s']!r} s "
        f"({graph['prefill_tok_per_s']!r} tok/s), decode {graph['decode_ms_per_step']!r} ms/step; "
        f"eager: decode {eager['decode_ms_per_step']!r} ms/step; dropped share "
        f"{row['prefill_dropped_share']!r} (prefill), {row['decode_dropped_share']!r} (decode), "
        f"peak {peak} bytes, every logit finite ({smi})")
    for r in routes:
        log_route("route", r)
    log(f"    sample ids {row['sample_ids']}")
    del model
    torch.cuda.empty_cache()
    return row


def count_dispatch_kernels() -> dict:
    """The device kernels of 10 queue dispatches of the MoE layer at the
    prefill and decode shapes (``kernels_per_dispatch``): one K4 launch
    each.  The count must be exact, and torch.profiler loses events far
    more often while a CUDA graph is alive, so ``main`` takes it before
    phase 4 captures the first graph, and phase 7 reports it."""
    check(graphs.live() == 0, f"{graphs.live()} CUDA graphs alive before the kernel count")
    out = {}
    for i in QD_TIMED[:2]:  # the prefill and decode shapes
        G, B, n_dest, capacity, what = QD_SHAPES[i]
        calls = 10
        names, traces = kernels_per_dispatch(G, B, n_dest, capacity, calls)
        check(len(names) == calls and all("queue_dispatch" in n for n in names),
              f"{calls} queue dispatches at {what} ran {names} ({traces} traces), not one K4 "
              f"launch each")
        out[f"{what} (G={G}, B={B})"] = names
        log(f"    10 queue dispatches at {what}: {traces} trace(s) to see every device event")
    return out


def moe_phase(resources: dict, timer, smi: str, l_hbm_ms: float, dispatch_kernels: dict) -> dict:
    """Phase 7: K4 checked and timed, the kernels of one queue dispatch
    (counted before phase 4: ``count_dispatch_kernels``) reported, the
    fp32 checks, the bf16 serving run."""
    log(f"[7] MoE serving: {MOE_ARCH}; K4 vs its plain version")
    for kern in QD_BODIES:
        check(kern in resources, f"ptxas reported no resources for {kern}")
        regs, smem, spills = resources[kern]
        log(f"    {kern}: {regs} registers, {smem} bytes static shared memory, {spills}")
    log(f"    n_dest limit {QD.max_dest()}")
    cfg = get_config(MOE_ARCH)
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab_size,
           cfg.n_experts, cfg.top_k, cfg.moe_dispatch, cfg.capacity_factor, cfg.moe_groups,
           cfg.sliding_window, cfg.dtype)
          == (32, 4096, 32, 8, 14336, 32000, 8, 2, "queue", 1.25, 32, 4096, "bfloat16"),
          f"{MOE_ARCH} is not at its published width: {cfg}")
    checks = check_queue_dispatch()
    timing = time_queue_dispatch(timer, l_hbm_ms)
    for what, names in dispatch_kernels.items():
        log(f"  10 queue dispatches at {what}: {len(names)} device kernels {sorted(set(names))} "
            f"(counted before phase 4, with no CUDA graph alive)")
    per_dispatch = {what: len(names) / 10 for what, names in dispatch_kernels.items()}
    fp32 = check_moe_fp32(cfg, smi)
    served = serve_moe(dataclasses.replace(cfg, n_layers=MOE_LAYERS), smi)
    return {"queue_dispatch_checks": checks, "queue_dispatch_timing": timing,
            "kernels_per_queue_dispatch": per_dispatch,
            "ptxas": {k: list(resources[k]) for k in QD_BODIES},
            "moe_full_width_fp32": fp32, "moe_served": served}


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
    hgmma = {k: n for k, n in sass_instruction_counts(built.path, "HGMMA").items()
             if k.startswith("flash")}
    for d in FA.HEAD_DIMS:
        bf16_body = f"flash_fwd_bf16_kernel<{d}>"
        check(hgmma.get(bf16_body, 0) > 0, f"{bf16_body} has no HGMMA in its SASS: {hgmma}")
    flash_smem = {d: FA.bf16_smem_bytes(d) for d in FA.HEAD_DIMS}
    log(f"    K5 HGMMA instructions in SASS: {hgmma}; bf16 body dynamic shared memory "
        f"per CTA by head dim: {flash_smem}")
    occupancy = {}
    for kern, threads in (("forest_descend_kernel", built.lib.forest_block()),
                          ("hybrid_descend_kernel", K.HYBRID_BLOCK_Q)):
        for ordered in (0, 1):
            for mapping in ((0, 1) if kern.startswith("hybrid") else (None,)):
                targs = (ordered, 1) if mapping is None else (ordered, mapping, 1)
                label = f"{kern}<{','.join(map(str, targs))}>"
                check(label in resources, f"ptxas reported no resources for {label}")
                regs, smem, spills = resources[label]
                dyn = (built.lib.forest_smem_bytes(W_CAPACITY, ordered) if mapping is None else
                       built.lib.hybrid_smem_bytes(invariants.split_level_for(8), mapping,
                                                   W_CAPACITY, ordered))
                ctas = ctas_per_sm(threads, regs, smem + dyn)
                tag = (f"{kern.replace('_kernel', '_delta')} {'ordered' if ordered else 'membership'}"
                       + ("" if mapping is None else f" {('queue', 'direct')[mapping]}"))
                occupancy[tag] = {"registers": regs, "spills": spills, "static_smem_bytes": smem,
                                  "dynamic_smem_bytes": dyn, "blocks_per_sm": ctas,
                                  "threads_per_sm": ctas * threads,
                                  "theoretical_occupancy": ctas * threads / SM_THREADS}
                log(f"    {tag} at C={W_CAPACITY}: {regs} registers, {smem} + {dyn} bytes "
                    f"shared memory (static + dynamic), {ctas} CTAs of {threads} threads per SM "
                    f"(theoretical occupancy {ctas * threads / SM_THREADS!r})")
    limits = {"hybrid_descend queue split": K.hybrid_max_queue_split(torch.device("cuda"))}
    check(limits["hybrid_descend queue split"] >= 3, f"the engine's splits do not fit: {limits}")
    design = (built.lib.levels_per_trip(), built.lib.forest_staged_levels(),
              [built.lib.hybrid_staged_levels(s) for s in range(13)],
              [built.lib.delta_line(c, o) for c in DELTA_LINE_CAPACITIES for o in (0, 1)])
    twin = (ref.LEVELS_PER_TRIP, ref.STAGED_LEVELS, [ref.hybrid_staged_levels(s) for s in range(13)],
            [ref.delta_line(c, bool(o)) for c in DELTA_LINE_CAPACITIES for o in (0, 1)])
    check(design == twin, f"the bodies' design {design} is not their twins' {twin} "
          f"in kernels/ref.py")
    log(f"    design: {design[0]} levels per round trip, forest body {design[1]} staged levels "
        f"and {built.lib.forest_block()} lanes a CTA; limits (shared memory of one CTA): "
        f"{limits}; both kernels read the delta buffer in global memory and take any capacity")

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
    # past what one CTA could stage whole: both kernels read the buffer in
    # global memory through its sample
    for seed, C in enumerate(BIG_CAPACITIES, 6):
        big = full_buffer(tree, keys, C, seed=seed)
        b_lanes = lanes.clone()
        b_lanes[-CHECK_LANES // 4:] = torch.from_numpy(
            rng.permutation(big.keys.cpu().numpy())[: CHECK_LANES // 4]).cuda()
        lines = [built.lib.delta_line(C, o) for o in (0, 1)]
        log(f"  sampled lines at C={C}: {lines[0]} slots (membership), {lines[1]} (ordered)")
        check_delta_kernels(tree, b_lanes, active, {"large buffer": big})
        del big
    check_large_buffer_engine()
    torch.cuda.synchronize()

    gc.collect()  # phase 3's engines and their graphs
    dispatch_kernels = count_dispatch_kernels()
    log(f"    K4 kernels per queue dispatch counted: {[len(n) for n in dispatch_kernels.values()]} "
        f"for 10 dispatches at each of {list(dispatch_kernels)}")

    log(f"[4] BSTServer, chunk {CHUNK}, every paper config")
    K.reset_launches()
    graphs.reset()
    lookup_sets = make_key_sets(tree, STREAM)
    served, launches = serve_all_configs(keys, values, lookup_sets, smi)
    for kern, n in launches.items():
        if kern.endswith("_delta"):
            check(n == 0, f"{kern} launched on the read-only path")
        else:
            check(n > 0, f"{kern} never launched on the main path")
    log(f"    launches on the read path that ran (warm-ups and drains): {launches}; over the "
        f"phase, chunk profiles included: wrapper calls {dict(K.LAUNCHES)} (warm-ups, captures, "
        f"eager chunks), replayed {dict(graphs.REPLAYED)}; {graphs.STATS['captures']} graphs "
        f"captured in {graphs.STATS['capture_s']!r} s")
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
    written, w_launches = serve_write_path(keys, values, rounds, final, tree, smi)
    peak = max(max(r["drain_peak_bytes"], r["write_graphs"]["peak_bytes"]) for r in written)
    for kern, n in w_launches.items():
        check(n > 0, f"{kern} never launched on the write path")
    log(f"    launches on the write path: {w_launches}")
    log(f"    peak device memory of the write phase: {peak} bytes (torch.cuda.max_memory_allocated "
        f"over each drain and each graph check, the phase 3 tree and buffers included; the drains' "
        f"{[r['drain_peak_bytes'] for r in written]}, the checks' "
        f"{[r['write_graphs']['peak_bytes'] for r in written]})")
    write_profile = profile_write_drains(keys, values, rounds)
    log_profile(f"Hrz write-path drain of {W_ROUNDS // 2} rounds", write_profile)

    log(f"[4s] sharded serving: hrz, dup, hyb, chunk {CHUNK}, at world 1 over NCCL and at "
        f"{SHARD_RANKS} ranks on this card over gloo; {STREAM} lookups, {SHARD_POINTS} each of "
        f"predecessor, successor, range_count, range_scan; then {SHARD_W_ROUNDS} rounds of the "
        f"write stream with delta capacity {W_CAPACITY}")
    gc.collect()
    sharded = shard_phase(keys, values, lookup_sets["random"], rounds, smi)
    log(f"    [4s] done at {time.perf_counter() - t_start:.1f} s")

    log("[4g] the port gates: lint, dead code, contracts, and the serve gate (hrz, dup, hyb; "
        f"single-chip and sharded at world 1 over NCCL; the gate's 63 keys in chunks of 64, then "
        f"the phase-4 tree in chunks of {CHUNK}); negative controls; the sync debug mode")
    gc.collect()
    gated = gate_phase(keys, smi)
    log(f"    [4g] done at {time.perf_counter() - t_start:.1f} s")

    log("[5] kernels vs plain versions at the main path's shapes; times (CUDA events, L2 flushed, median)")
    serving_sets = make_key_sets(tree, 2 * CHUNK)
    pool = torch.from_numpy(serving_sets["random"]).cuda()
    skewed = torch.from_numpy(serving_sets["equal"]).cuda()
    timer = ColdTimer()
    chase = pointer_chase_latency(timer)
    log(f"    pointer chase ({CHASE_STEPS} dependent loads, median of {CHASE_REPS}): "
        f"L_HBM={chase['l_hbm_ms']!r} ms (cold {CHASE_HBM_INTS * 4} bytes), "
        f"L_L2={chase['l_l2_ms']!r} ms (warm {CHASE_L2_INTS * 4} bytes) ({smi})")
    timings = time_kernels(tree, pool, skewed, timer, chase["l_hbm_ms"])
    # K2 with the full phase-3 buffer; its yardstick searches the merged
    # sorted view (snapshot and buffer), built here outside the timing.
    m_keys, _, m_count = delta_lib.compact_sorted(
        tree.keys, tree.values, tree_lib.rank_to_bfs_on(tree.height, tree.device),
        tree.n_real, full, tree.n_real + full.capacity,
    )
    merged = m_keys[: int(m_count)].contiguous()
    timings += time_kernels(tree, pool, skewed, timer, chase["l_hbm_ms"], delta=full,
                            library_keys=merged)

    log(f"    [5] done at {time.perf_counter() - t_start:.1f} s")

    log(f"[6] LM serving: {LM_ARCH}; K5 vs its plain version (fp32, bf16)")
    for kern in ("flash_fwd_bf16_kernel<128>", "flash_fwd_kernel<float,128>"):
        check(kern in resources, f"ptxas reported no resources for {kern}")
    cfg = get_config(LM_ARCH)
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
           cfg.vocab_size, cfg.dtype) == (28, 2048, 16, 8, 128, 151936, "bfloat16"),
          f"{LM_ARCH} is not at its published width and depth: {cfg}")
    del tree, full, pool, skewed, merged, m_keys
    torch.cuda.empty_cache()
    flash_checks = check_flash_kernel()
    full_model = check_full_model_fp32(cfg, smi)
    full_model_bf16 = check_full_model_bf16(cfg, smi)
    lm_served = serve_lm(cfg, smi)
    flash_timing = time_flash(timer)
    flash_resources = {k: v for k, v in resources.items() if k.startswith("flash")}
    log(f"    [6] done at {time.perf_counter() - t_start:.1f} s")
    moe = moe_phase(resources, timer, smi, chase["l_hbm_ms"], dispatch_kernels)
    qd_timing, moe_served = moe["queue_dispatch_timing"], moe["moe_served"]

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
            **({"sharded_launches": sharded["launches"][kern]} if kern in sharded["launches"] else {}),
            "mismatches": AGREEMENT[kern]["mismatches"],
            "max_abs_err": AGREEMENT[kern]["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": "bytes",
            "library_ms": row["library_ms"],
            "latency_bound_ms": row["latency_bound_ms"],
            "round_trips": row["round_trips"],
            "l_hbm_ms": chase["l_hbm_ms"],
            "l_l2_ms": chase["l_l2_ms"],
            "config": f"{config} x{row['lanes']}",
            "configs": [r for r in timings if r["kernel"] == kern],
            "ptxas": {k: list(v) for k, v in resources.items()
                      if k.startswith(kern.replace("_delta", "") + "_kernel<")
                      and k.endswith(",1>" if kern.endswith("_delta") else ",0>")},
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
        "ms": flash_timing[0]["ms"],
        "plain_ms": flash_timing[0]["plain_ms"],
        "bound_ms": flash_timing[0]["bound_ms"],
        "bound_by": flash_timing[0]["bound_by"],
        "library_ms": flash_timing[0]["library_ms"],
        "config": (f"{flash_timing[0]['config']} {flash_timing[0]['shape']} bf16; launches: one "
                   f"{LM_ARCH} prefill (and {moe_served['k5_launches']} per {MOE_ARCH} prefill "
                   f"at {MOE_LAYERS} layers)"),
        "configs": flash_timing,
        "ptxas": {k: list(v) for k, v in flash_resources.items()},
        "hgmma": hgmma,
        "bf16_smem_bytes": flash_smem,
    })
    kernels.append({
        "name": "queue_dispatch",
        "route": "cuda",
        "source": QD_SOURCE,
        "replaces": QD_REPLACES,
        "launches": moe_served["k4_launches"],
        "sharded_launches": sharded["launches"]["queue_dispatch"],
        "mismatches": AGREEMENT["queue_dispatch"]["mismatches"],
        "max_abs_err": AGREEMENT["queue_dispatch"]["max_abs_err"],
        "ms": qd_timing[0]["ms"],
        "plain_ms": qd_timing[0]["plain_ms"],
        "bound_ms": qd_timing[0]["bound_ms"],
        "bound_by": qd_timing[0]["bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call builds a FIFO buffer image",
        "floor_ms": qd_timing[0]["floor_ms"],
        "latency_bound_ms": qd_timing[0]["latency_bound_ms"],
        "round_trips": QD_ROUND_TRIPS,
        "l_hbm_ms": chase["l_hbm_ms"],
        "kernels_per_queue_dispatch": moe["kernels_per_queue_dispatch"],
        "config": (f"{MOE_ARCH} prefill dispatch, G={qd_timing[0]['G']} B={qd_timing[0]['B']} "
                   f"n_dest={qd_timing[0]['n_dest']} capacity={qd_timing[0]['capacity']}; launches: "
                   f"greedy_generate at {MOE_LAYERS} layers, one prefill and {MOE_NEW - 1} decode steps"),
        "configs": qd_timing,
        "ptxas": moe["ptxas"],
    })
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"card": smi, "kernels": kernels, "served": served,
                       "hrz_drain_profile": busy, "written": written,
                       "write_phase_launches": w_launches, "write_phase_peak_bytes": peak,
                       "hrz_write_drain_profile": write_profile, "sharded": sharded,
                       "gates": gated,
                       "delta_occupancy": occupancy, "kernel_limits": limits,
                       "pointer_chase": chase,
                       "flash_checks": flash_checks, "lm_full_model_fp32": full_model,
                       "lm_full_model_bf16": full_model_bf16,
                       "lm_served": lm_served, "flash_timing": flash_timing,
                       **moe, "seconds": time.perf_counter() - t_start}, f, indent=1)
    log(f"[8] done in {time.perf_counter() - t_start:.1f} s")
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
