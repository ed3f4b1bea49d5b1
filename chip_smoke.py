#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one card: the BST read and write paths, LM serving of every family, training, checkpoints, tensor parallelism, the dry run, the examples.

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
   K5 body's SASS (``cuobjdump``): the bf16 bodies, forward and backward,
   must have some;
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
   at world 1 are logged.  At world 1 the sharded program runs as CUDA
   graphs (``ShardedQuery.compiled``): ``warmup`` captures one graph per
   (op, slot), a read drain none, a compaction that keeps the height none
   and the one that grows the tree to height 24 every held graph again;
   the same server then serves the reads on its eager route, and one
   lookup chunk's drain is profiled on either route (host launch calls,
   device kernels, idle share).  The gloo ranks run eagerly, and say so;
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
   that see no key, d = 16 and 32), at both serving shapes (qwen3's and
   mixtral-8x7b's prefill attention) and at phase 8's (hymba's windowed
   GQA attention with a group of 5, seamless's non-causal encoder, a
   cross-attention over a shorter memory, a small odd-group edge case);
   the whole model in fp32 (1 x 512
   prompt), the flash route against the naive route over prefill and 4
   decode steps, and decode against a prefill of the longer prompt; the
   whole model in bf16 (4 x 512 prompts), the flash route (K5's wgmma body)
   and the naive route each against the naive route in fp32: the flash
   route's RMS distance at most 1.25 times the naive one's; then the bf16
   serving run (4 prompts x 2048 tokens + 32 new): its decode and prefill
   CUDA graphs captured (seconds, each pool's bytes), the prefill graph's
   logits, caches and position equal to the eager route's bit for bit;
   ``greedy_generate`` with every count set to 0 captures nothing, runs one
   K5 a layer (the prefill graph's replay), its tokens equal to the eager
   route's; then one request on each route in turns (graph, eager, graph,
   eager) with no capture, every logit finite, with prefill and decode
   times on both routes, peak memory and the device idle share, kernels
   and host launch calls of a decode step and of a prefill on both
   routes; then K5 timed at both prefill shapes
   beside its bound, its plain version and ``scaled_dot_product_attention``;
6r. K5 past a launch's 65,535 head rows, launched in chunks of whole GQA
   groups: the forward in fp32 and bf16, with and without lse, at group 4
   (2,049 x 32 heads over 8) and group 5 with a window of 50 (2,622 x 25
   heads over 5) and qwen3-1.7b's prefill at 4,096 x 16 tokens (16 heads
   over 8), the backward in bf16 past 65,535 q rows and in fp32 past
   65,535 kv rows (8,193 x 16 heads over 8), each against its plain version
   in slices of rows, one count and the planned launches a call, timed
   beside its bound and ``scaled_dot_product_attention``; qwen3-1.7b in
   bf16 on 4,096 prompts of 16 tokens + 16 new (65,536 head rows a prefill
   attention) through ``greedy_generate`` on both routes, the tokens equal,
   28 K5 runs a prefill replay, the first and last layers' K5 outputs
   against the plain version on their inputs and against one-launch
   slices bit for bit, the tokens equal to those with every K5 call in
   one-launch slices, prefill and decode times and the peak memory; then
   K5 timed again at qwen3's prefill shape and hymba's window, one launch
   each;
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
   and prefill graphs captured, the prefill graph (K4 and K5 inside) equal
   to the eager route bit for bit, then ``greedy_generate`` (4 prompts x
   2048 tokens + 32 new), one K4 and one K5 run per layer per prefill and
   one K4 run per layer per decode step, all of them replays', its tokens
   equal to the eager route's, then one request on each route in turns
   (graph, eager, graph, eager), K4 counted and the dropped share copied
   out after every step, the two routes' shares equal, no capture, every
   logit finite, with prefill and decode times on both routes, peak
   memory, a decode step's device idle share, its device kernels and its
   host launch calls;
8. the other families at their published width and depth, one model
   alive at a time: mamba2-1.3b (ssm), hymba-1.5b (hybrid),
   seamless-m4t-medium (encdec, 2048 frames a prompt) and internvl2-2b
   (vlm, 256 patch embeddings a prompt); each in fp32 (1 x 512 + 4 decode
   steps): the flash route against the naive route (the families with
   attention) and decode against a prefill of the longer prompt (for
   mamba2 the SSD duality at 48 layers), logits within 1e-3; in bf16 (4 x
   512, the families with attention) the flash route's RMS distance from
   the fp32 naive route at most 1.25 times the naive bf16 route's; the
   bf16 serving run as phase 6's (4 x 2048 + 32: the decode and prefill
   graphs captured, the prefill graph equal to the eager route bit for
   bit; ``greedy_generate`` with every kernel count set to 0 first: K5
   runs a prefill hymba 32, seamless 36, internvl2 24, mamba2 0, and no
   other kernel; graph tokens == eager tokens, then one request on each
   route in turns with no capture, every logit finite; prefill tok/s on
   both routes, decode ms/step, peak memory, a decode step's and a
   prefill's profile on both routes); then K5 timed at hymba's and seamless's encoder
   shapes beside its bound, its plain version and SDPA (an explicit mask
   for hymba's window; the backend SDPA chose is named);
9. training: K5's backward (``flash_attention_bwd_cuda``: pre-pass, main
   kernel -- ``flash_bwd_bf16_kernel<D>`` on the tensor cores in bf16,
   ``flash_bwd_kernel<float,D>`` in fp32, both built at every head dim,
   the bf16 one without spills, the old bf16 instantiation gone -- and in
   bf16 the cast of dq) against its plain version at every FLASH_SHAPES
   shape in fp32 (1e-4) and bf16 (2e-2, and 1e-2 in norm), dq, dk, dv and
   the forward's lse; the fp32 gradients of qwen3-1.7b at full depth and of
   mixtral-8x7b (K4 in the forward), hymba-1.5b, seamless-m4t-medium and
   internvl2-2b at their published width and 2 layers, 1 x 512: every
   parameter's gradient on the flash route (K5 and its backward, with
   remat) against the naive route's, at most 1e-3 relative per tensor,
   every parameter with a gradient, the launches counted; qwen3-1.7b's
   gradients at full depth in bf16, 1 x 512, the flash and naive routes
   against the fp32 naive route of the same weights (RMS ratio <= 1.25,
   the worst tensor named); the bf16
   training run of qwen3-1.7b at full depth, 4 x 2048 from TokenPipeline,
   4 steps of ``make_train_step`` on the eager route (every kernel count
   set to 0 first: K5's forward 56 and its backward 28 a step, nothing
   else), losses and gradient norms finite, the first loss within 0.05 of
   the uniform stream's expected loss at init (ln V + 0.02^2 d_model /
   2), the parameters moved, one step profiled (K5's device kernels
   counted in its trace: the forward's body 56, the backward's pre-pass,
   main kernel and cast 28 each, no fp32 backward kernel); then the same
   4 steps from the same init through the step's CUDA graph, the main
   path: step 0 the capture (its warm-up is the step) with the eager
   step's loss bit for bit, the replays running K5 56 and its backward 28
   each (``graphs.kernel_runs()``), later steps held to the eager ones in
   phase 9c; step ms and tok/s on both routes, the pool's bytes, peak
   memory under 80 GB, one replayed step profiled (host launch calls,
   idle share); mixtral-8x7b cut to 2 layers, 3 graphed train steps (K4
   inside) against two eager runs from the same init (every loss, grad
   norm and parameter of the eager runs, and every graphed step's loss and
   grad norm, equal bit for bit); then K5's backward timed at qwen3's and
   hymba's
   training shapes beside its bound (2.5 x the forward's operations), its
   plain version and SDPA's backward (the backend named), with each of its
   three device kernels' share of a launch (each launched alone,
   ``FA.bwd_stage_calls``, and timed with CUDA events) and the main
   kernel's TFLOP/s against the bound;
9c. checkpoints and the data-parallel step (qwen3-1.7b bf16 at full width
   and depth, 4 x 2048 from TokenPipeline): (a) after two steps the state
   (24.09 GB; the depth cut only if the disk under build/ cannot hold it)
   is saved through ``CheckpointManager(save_async=True, keep=1)``, one
   step runs while the write goes on, and the checkpoint is restored into
   a fresh state: every tensor equal to the host snapshot bit for bit, and
   the restored state's step equal to the live state's from the same bits
   (loss, grad norm and every parameter after it, bit for bit); bytes,
   snapshot, write, restore seconds and the step with and without the
   write; (b) the
   launcher's restart as a user runs it, in subprocesses at smoke size: a
   deadline exit (code 42) after its step-0 checkpoint, a ``--resume`` run
   to the end, its final state equal to an uninterrupted run's bit for
   bit; (a)'s step is the graphed one, and the restored state's first step
   captures a graph of its own;
   (c) phase 9's eager steps run again five times, each run equal to phase
   9's in every loss and grad norm and to the first rerun in every
   parameter and master weight, bit for bit; ``make_train_step(mode=
   "dp_shard_map")`` at world 1 over NCCL, a CUDA graph with its
   all-reduces, for compression None, bf16 and int8, 3 steps each from
   the seed-0 state: every kernel count set to 0 first, K5's forward 56
   and its backward 28 a step and nothing else (``kernel_runs()``), one
   capture in step 0, losses finite, None's three steps' losses and grad
   norms equal to phase 9's eager steps' bit for bit, peak memory under
   80 GB, step ms beside the
   plain graphed step's, the all-reduce's bytes and collective calls a
   step (replays counted), the pool's bytes;
9t. the LM's model axis (``make_train_step(mode="pjit")``, the mesh
   ``make_prefill_fn``/``make_serve_step``, ``sharding/tp.py``) on 2 gloo
   ranks sharing the card (NCCL puts no two ranks on one card), mesh (data
   1, model 2), spawned as in phase 4s, the single-card references written
   to a file first: qwen3-1.7b at full width and depth, its fp32 blocks
   over a 1 x 512 prefill and 4 decode steps, the gathered logits within
   1e-3 of the single-card fp32 route's; in bf16 at 4 x 512 phase 6's RMS
   rule against the naive single-card routes; the 4 x 2048 prefill and 31
   decode steps timed; the pjit step's fp32 gradients (``step.gradients``)
   of every parameter within 1e-3 relative of the single-card gradients,
   each rank's block held to its slice; its bf16 gradients, gathered, by
   phase 9's bf16 gradient rule (RMS ratio <= 1.25); 3 bf16 pjit steps of
   phase 9's batches from the seed-0 state, logged beside phase 9's; on
   each rank K5's forward 28 a prefill and 56 a train step at
   B·H 32 and B·Hkv 16, its backward 28 a step; then mixtral-8x7b (K4
   once a layer on each rank) and hymba-1.5b (heads split mid-head) at
   their published width cut to 2 layers, the same serving rules; per
   rank peak memory, step ms, the collectives' calls and bytes (no
   scaling figure: two ranks share one card and gloo crosses the host);
   then at world 1 over NCCL, mesh (1, 1), phase 6's request through the
   mesh prefill and the mesh decode step, a CUDA graph each, its tokens
   bit for bit phase 6's, and 3 steps of the pjit step, a CUDA graph (one
   capture), each loss and grad norm equal to phase 9's graphed steps' bit
   for bit;
10. the dry run (``launch/dryrun.py``, ``dryrun_bst.py``): (a) in two
   subprocesses that see no card, as rank 0 of a fake process group of 256
   under ``FakeTensorMode``, qwen3-1.7b's train_4k, prefill_32k and
   decode_32k cells and mixtral-8x7b's train_4k with ``launch/perf.py``'s
   iteration 5 (32 dispatch groups, ZeRO-1) on the production mesh (data
   16, model 16), and the BST lookup (2^21 - 1 nodes, 65,536 keys a rank):
   every cell ok, neither process imports JAX or the JAX package, each
   cell's peak, FLOPs and collective bytes a rank logged; (b) phase 9's
   bf16 train step of qwen3-1.7b (4 x 2048, full depth) traced at world 1
   (a fake group of 1, one subprocess each) with remat off, "none" and
   "dots", while the card runs the same three steps (``make_train_step(
   mode="pjit", eager=True)`` at world 1 over NCCL, two steps each from
   the seed-0 state: the dry run traces the eager step): each traced peak within DRYRUN_PEAK_TOL of the card's
   ``max_memory_allocated`` (less what was allocated before the state),
   "dots" between "none" and remat off in both, and the traced FLOPs over
   the measured step as TFLOP/s;
10e. the port's four examples (``examples/torch_*.py``) on the card, each
   in a process of its own, all at once, at sizes that take seconds: their
   assertions (every strategy's answers identical, every served key
   found, the fresh writes read back, queue drops <= direct drops at every
   capacity factor) and the training example's checkpoints;
11. print the ``{"kernels": [...]}`` line (with each LM kernel's launches on
   the tensor-parallel path, ``tp_launches``), the card's line, and last the
   ``{"ok": true, ...}`` line.

Needs one CUDA card; exits with code 2 and prints no result without one.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import io
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
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed  # noqa: E402
import torch.multiprocessing  # noqa: E402

from repro_torch import graphs, hardware  # noqa: E402
from repro_torch.analysis import invariants, runtime  # noqa: E402
from repro_torch.core import PAPER_CONFIGS, QUERY_OPS, BSTEngine  # noqa: E402
from repro_torch.core import buffers as buf_lib  # noqa: E402
from repro_torch.core import delta as delta_lib  # noqa: E402
from repro_torch.core import distributed as dist_lib  # noqa: E402
from repro_torch.core import plans as plans_lib  # noqa: E402
from repro_torch.core import tree as tree_lib  # noqa: E402
from repro_torch.core.engine import ingest_ladder  # noqa: E402
from repro_torch.core.tree import (  # noqa: E402
    NO_PRED_KEY,
    NO_SUCC_KEY,
    SENTINEL_KEY,
    SENTINEL_VALUE,
    build_tree,
    rank_to_bfs_indices,
)
from repro_torch.data.keysets import make_key_sets, make_tree_data  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.models.config import ShapeConfig, input_specs  # noqa: E402
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
    greedy_generate,
    make_prefill_fn,
    make_serve_step,
)
from repro_torch.data.pipeline import TokenPipeline  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.checkpoint import store as ckpt_store  # noqa: E402
from repro_torch.checkpoint import elastic  # noqa: E402
from repro_torch.checkpoint.elastic import reshard_state  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models.convert import LayerStack  # noqa: E402
from repro_torch.optim.optimizer import AdamWState  # noqa: E402
from repro_torch.serving import serve_loop  # noqa: E402
from repro_torch.sharding import specs as tspecs  # noqa: E402
from repro_torch.sharding import tp as tp_lib  # noqa: E402
from repro_torch.sharding.specs import mesh_shape  # noqa: E402
from repro_torch.training.train_loop import (  # noqa: E402
    DP_STATS,
    TrainConfig,
    init_train_state,
    make_train_step,
    reset_dp_stats,
)

N_KEYS = (1 << 24) - 1  # H = 23: 2 x 64 MiB of int32 keys and values
CHECK_LANES = 1 << 16
STREAM = 1 << 18  # the paper's 256K key sets
RANGE_STREAM = 1 << 17
CHUNK = 8192  # the server's chunk: the main path's lookup shape
SCAN_K = 8
HBM_BYTES_PER_S = hardware.HBM_BYTES_PER_S  # the data sheet's (repro_torch/hardware.py)
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
# The timed requests of phases 6, 7 and 8, in turns: (eager route, the
# profiles taken after it).
ROUTE_TURNS = ((False, ("decode", "prefill")), (True, ("decode", "prefill")), (False, ()),
               (True, ()))
BF16_FLOP_PER_S = hardware.BF16_FLOP_PER_S  # dense bf16 tensor cores, the data sheet's
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
    (100, 20, 2048, 2048, 64, True, 1024),  # hymba-1.5b: 4 x 25 heads, 5 kv heads, window 1024
    (64, 64, 2048, 2048, 64, False, None),  # seamless-m4t-medium's encoder: non-causal
    (64, 64, 2048, 1536, 64, False, None),  # cross-attention over a memory shorter than the prompt
    (10, 2, 300, 300, 64, True, 100),  # an odd GQA group (5), a window edge inside a kv tile
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
# The families phase (8): the ssm, hybrid, encdec and vlm families at their
# published width and depth, one model alive at a time.  Per arch: the
# published (layers, encoder layers, d_model, heads, kv heads, head dim,
# d_ff, vocab, SSM state, SSM heads, window, frontend length, dtype), and
# K5's launches per prefill (each self-attention; seamless also its 12
# encoder layers' and 12 cross-attentions').
FAMILY_ARCHS = {
    "mamba2-1.3b": ((48, 0, 2048, 0, 0, 0, 0, 50280, 128, 64, None, 0, "bfloat16"), 0),
    "hymba-1.5b": ((32, 0, 1600, 25, 5, 64, 5504, 32001, 16, 25, 1024, 0, "bfloat16"), 32),
    "seamless-m4t-medium": ((12, 12, 1024, 16, 16, 64, 4096, 256206, 0, 0, None, 0, "bfloat16"),
                            36),
    "internvl2-2b": ((24, 0, 2048, 16, 8, 128, 8192, 92553, 0, 0, None, 256, "bfloat16"), 24),
}
# The families' K5 shapes timed: indices into FLASH_SHAPES.
FAMILY_FLASH_TIMED = ((16, "hymba-1.5b prefill attention"),
                      (17, "seamless-m4t-medium encoder attention"))
# Phase 6r: K5 past a launch's 65,535 head rows, launched in chunks of
# whole GQA groups (``FA.head_row_chunks``).  The forward at (B, (BH, BHkv,
# Sq, Skv, d, causal, window)): group 4, B 2,049 x 32 heads over 8 kv heads;
# group 5 with a window, B 2,622 x 25 heads over 5 (hymba's heads); and
# qwen3-1.7b's prefill at ROWS_BATCH x ROWS_PROMPT, 4,096 x 16 heads over 8
# (65,534 q rows, then a 2-row tail of one kv row).  The backward in bf16
# past 65,535 q rows (its kernels are bound by kv rows alone: one launch)
# and in fp32 past 65,535 kv rows (B 8,193 x 16 heads over 8).  The plain
# versions run in slices of ROWS_SLICE kv rows and their q rows; B views
# the rows as (B, H, S, d) for scaled_dot_product_attention.  Then
# qwen3-1.7b serves ROWS_BATCH x ROWS_PROMPT + ROWS_NEW: 65,536 head rows a
# prefill attention.
ROWS_BATCH, ROWS_PROMPT, ROWS_NEW = 4096, 16, 16
ROWS_FWD = ((2049, (2049 * 32, 2049 * 8, 128, 128, 128, True, None)),
            (2622, (2622 * 25, 2622 * 5, 192, 192, 64, True, 50)),
            (ROWS_BATCH, (ROWS_BATCH * 16, ROWS_BATCH * 8, ROWS_PROMPT, ROWS_PROMPT, 128, True,
                          None)))
ROWS_BWD = ((torch.bfloat16, 2049, (2049 * 32, 2049 * 8, 128, 128, 128, True, None)),
            (torch.float32, 8193, (8193 * 16, 8193 * 8, 64, 64, 64, True, None)))
ROWS_SLICE = 2048
ROWS_REPS = 10
FP32_FLOP_PER_S = hardware.FP32_FLOP_PER_S  # the CUDA cores, the data sheet's
# The training phase (9).  K5's backward against its plain version at every
# FLASH_SHAPES shape: fp32, the kernel's FMA order and expf against torch's
# matmuls over the same saved tensors (o, lse), and dq summed kv tile by kv
# tile; bf16, the same fp32 arithmetic on bf16 operands with dq, dk
# and dv rounded to bf16 once, against the plain version's fp32 sums
# rounded once: about one bf16 rounding.  atol = rtol = the value.  And
# per tensor, |got - want|_2 / |want|_2 at most BWD_NORM_TOL: the two
# sides round nearly the same fp32 sums to bf16 and differ only where a
# sum lands near a rounding boundary, while a value of 2e-2 elementwise
# is about half a typical bf16 gradient element at the 2048-long shapes,
# so a wrong scale of a few percent shows only here.
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
BWD_NORM_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
FLASH_BWD_SOURCE = "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"
FLASH_BWD_REPLACES = "src/repro/models/attention.py:55"  # _blockwise_attn, differentiated by XLA
# K5's device kernels a launch in bf16, by a substring of their names:
# the forward's body; the backward's pre-pass, main kernel (the wgmma body)
# and cast of dq.  The profiled train step's trace is held to these times
# the launches, and to nothing of the fp32 backward's.
FWD_BF16_KERNEL = "flash_fwd_bf16_kernel<"
BWD_BF16_KERNELS = ("flash_bwd_pre_bf16_kernel<", "flash_bwd_bf16_kernel<",
                    "flash_bwd_cast_bf16_kernel<")
BWD_FP32_KERNELS = ("flash_bwd_pre_kernel<", "flash_bwd_kernel<")
# The bf16 gradient check: qwen3-1.7b at full width and depth, one sequence
# of TRAIN_CHECK_SEQ tokens, the same weights three ways (flash route in
# bf16, naive route in bf16, naive route in fp32).  The RMS over every
# parameter's gradient of (flash bf16 - naive fp32) may be at most this
# times that of (naive bf16 - naive fp32): phase 6's rule for bf16 logits,
# for gradients.  The bf16 backward rounds P and dS to bf16 before their
# products; the model's gradient may take on that rounding, not more than a
# quarter more error than the model's own bf16 rounding.  Set before the
# first run of the check.
TRAIN_BF16_GRAD_RATIO = 1.25
# The fp32 gradient checks: qwen3-1.7b at full depth and the families with
# attention at their published width and TRAIN_CHECK_LAYERS layers, one
# sequence of TRAIN_CHECK_SEQ tokens; every parameter's gradient on the
# flash route (K5 and its backward) against the naive route's (plain
# attention under autograd): max |flash - naive| / max |naive| per tensor
# at most TRAIN_GRAD_TOL (fp32 sums in other orders through 28 layers and
# their backward; the forward logits differ by about 1e-5 of their scale,
# phase 6), and the losses within TRAIN_GRAD_TOL of each other (relative).
TRAIN_CHECK_SEQ = 512
TRAIN_CHECK_LAYERS = 2
TRAIN_GRAD_TOL = 1e-3
TRAIN_FAMILY_ARCHS = ("mixtral-8x7b", "hymba-1.5b", "seamless-m4t-medium", "internvl2-2b")
# The bf16 training run: qwen3-1.7b at full width and depth, TRAIN_BATCH x
# TRAIN_SEQ tokens from TokenPipeline, TRAIN_STEPS steps of make_train_step,
# then one more step profiled.  Remat (the config's default) runs each
# layer twice, so a step launches K5's forward 2 x 28 times and its
# backward 28 times (each 3 device kernels in bf16: BWD_BF16_KERNELS).
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 4
# The graphed train step with K4 inside (mixtral-8x7b at TRAIN_CHECK_LAYERS
# layers, TRAIN_BATCH x TRAIN_CHECK_SEQ tokens): steps on each route.
MOE_TRAIN_STEPS = 3
TRAIN_PEAK_BYTES = hardware.HBM_BYTES  # the card's memory
# The first loss: the tokens are uniform, and at init the logits are
# <x, e_v> with x the final norm's output (RMS 1, scale 1) and e_v ~
# N(0, INIT_SCALE^2): logits ~ N(0, INIT_SCALE^2 D), so the expected loss
# is ln V + INIT_SCALE^2 D / 2 (ln V + 0.41 at d_model 2048), not ln V.
FIRST_LOSS_TOL = 0.05
# K5's backward timed: indices into FLASH_SHAPES (qwen3's and hymba's
# training attention, 4 x 2048).
BWD_TIMED = ((6, "qwen3-1.7b training attention"), (16, "hymba-1.5b training attention"))
# The backward's device kernels in bf16 by FA.BWD_STAGES' names, each timed
# alone for its share of a launch.
BWD_STAGE_KERNELS = {"pre": "flash_bwd_pre_bf16_kernel", "main": "flash_bwd_bf16_kernel",
                     "cast": "flash_bwd_cast_bf16_kernel"}
# The checkpoint and data-parallel phase (9c), qwen3-1.7b bf16 at full
# width and depth, TRAIN_BATCH x TRAIN_SEQ tokens a step.  The train step is
# a pure function of its state and batch, as the JAX package's is: K5's
# backward adds dQ in a fixed order.  (a) A train state after CKPT_STEPS
# steps is saved through CheckpointManager(save_async=True, keep=1) into
# build/ (the checkout), one step runs while the write goes on, and the
# checkpoint is restored into a fresh state: every tensor bit for bit
# against the host snapshot; then the restored state takes the step that
# the live state took from the same bits during the write: the same loss,
# grad norm and parameters after it, bit for bit.  If the disk cannot hold
# the checkpoint (CKPT_DISK_MARGIN of its bytes free), the phase's depth is
# cut to what fits, never its width.  (b) The launcher's restart at smoke
# size (fp32, K5's fp32 bodies) in subprocesses: a run with --ckpt-every 1
# whose step 1 exceeds --step-deadline-s exits with 42, a --resume run
# (--ckpt-every 2) finishes RESTART_STEPS steps; its final checkpoint equal
# to an uninterrupted run's in this process, every tensor bit for bit (the
# JAX package's tests/test_checkpoint.py, on the card).  (c) Phase 9's
# eager steps run again RERUNS times from the seed-0 state: each step's
# loss and grad norm equal to phase 9's, and every parameter and master
# weight after the last step equal to the first rerun's, bit for bit.  Then
# make_train_step(mode="dp_shard_map") at world 1 over NCCL (this process,
# a HashStore), each compression, DP_STEPS steps from one seed-0 state:
# K5's forward 2 x 28 and its backward 28 a step and nothing else, losses
# finite, peak memory under the card's; None's steps repeat phase 9's eager
# steps, each loss and grad norm equal bit for bit, as phase 9's graphed
# steps equal its eager ones and phase 9t's world-1 pjit graph phase 9's
# graphed steps (``check_graph_steps``).
CKPT_STEPS = 2
CKPT_DISK_MARGIN = 1.1
RERUNS = 5
RESTART_STEPS = 6
RESTART_TIMEOUT_S = 300
DP_MODES = (None, "bf16", "int8")
DP_STEPS = 3
# Phase 9t: the LM's model axis on TP_RANKS gloo ranks sharing the card
# (NCCL puts no two ranks on one card), mesh (data 1, model TP_RANKS):
# qwen3-1.7b at full width and depth, then mixtral-8x7b and hymba-1.5b at
# their published width cut to TP_FAMILY_LAYERS layers (mixtral at 32
# layers does not fit; two layers carry K4 a layer and hymba's mid-head
# splits).  Each rank rounds its row-parallel partial sums to bf16 before
# they are summed, so the bf16 pjit step is held by its gradients
# (``tp_grads_bf16``: ``bf16_grad_rule``, set before its first run), and
# TP_TRAIN_STEPS steps are logged beside phase 9's.
TP_RANKS = 2
TP_FAMILIES = ("mixtral-8x7b", "hymba-1.5b")
TP_FAMILY_LAYERS = 2
TP_TRAIN_STEPS = DP_STEPS
TP_TIMEOUT_S = 600
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
CTA_MAX_SMEM = 232448  # the dynamic shared memory one CTA can opt in to


def kernel_label(mangled: str) -> str:
    """A readable name of a kernel instantiation from its mangled name:
    ``forest_descend_kernel<ORDERED,WITH_DELTA>`` (hybrid's
    ``<ORDERED,MAPPING,WITH_DELTA>``), ``flash_fwd_kernel<float,D>``,
    ``flash_fwd_bf16_kernel<D>`` (``<D,lse>``: the instantiation that also
    stores the rows' log-sum-exp), K5's backward bodies
    ``flash_bwd_bf16_kernel<D>`` and ``flash_bwd_kernel<float,D>`` (with
    ``flash_bwd_pre_bf16_kernel<D>``, ``flash_bwd_pre_kernel<float,D>`` and
    ``flash_bwd_cast_bf16_kernel<D>``),
    ``queue_dispatch_kernel`` (and its
    ``_cluster`` and ``_wide`` bodies); any other kernel keeps its mangled
    name, so a renamed or new one still shows."""
    entry = re.search(r"(forest|hybrid)_descend_kernel(I\w*?)EEv", mangled)
    if entry:
        targs = ",".join(re.findall(r"L[bi](\d+)E", entry.group(2) + "E"))
        return f"{entry.group(1)}_descend_kernel<{targs}>"
    flash = re.search(r"flash_fwd_kernelI(f|13__nv_bfloat16)Li(\d+)E", mangled)
    if flash:
        return f"flash_fwd_kernel<{'float' if flash.group(1) == 'f' else 'bf16'},{flash.group(2)}>"
    bf16 = re.search(r"flash_fwd_bf16_kernelILi(\d+)E(?:Lb([01])E)?", mangled)
    if bf16:
        return f"flash_fwd_bf16_kernel<{bf16.group(1)}{',lse' if bf16.group(2) == '1' else ''}>"
    bwd16 = re.search(r"flash_bwd(_pre|_cast)?_bf16_kernelILi(\d+)E", mangled)
    if bwd16:
        return f"flash_bwd{bwd16.group(1) or ''}_bf16_kernel<{bwd16.group(2)}>"
    bwd = re.search(r"flash_bwd(_pre)?_kernelI(f|13__nv_bfloat16)(?:Li(\d+)E)?E", mangled)
    if bwd:
        targs = "float" if bwd.group(2) == "f" else "bf16"
        targs += "" if bwd.group(3) is None else f",{bwd.group(3)}"
        return f"flash_bwd{bwd.group(1) or ''}_kernel<{targs}>"
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


def profile_calls(run, calls: int, expect: dict | None = None) -> dict:
    """``run()`` ``calls`` times between synchronisations: the wall time and,
    from torch.profiler over the same calls, the device time of kernels and
    copies by name (a graph's replay shows its kernels one by one), the
    launch calls the host made (CUDA runtime calls with "Launch" in their
    name: kernels and graphs; the ctypes kernels' statically linked runtime
    may not report its own), and host self time by op.  The profiler
    loses device events now and then, far more often while a CUDA graph
    is alive (``graphs.live``), and now and then all of a trace's: an
    empty trace is taken again, up to PROFILE_ATTEMPTS times (``traces``
    says how many it took).  ``expect`` maps substrings of kernel names to
    the device events wanted: ``counts`` holds the trace's, and a trace
    whose counts differ is taken again, up to COUNT_ATTEMPTS times (the
    caller checks the last trace's counts)."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(1, (PROFILE_ATTEMPTS if expect is None else COUNT_ATTEMPTS) + 1):
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
        counts = {sub: sum(ev.count for ev in prof.key_averages()
                           if ev.device_type == torch.autograd.DeviceType.CUDA
                           and ev.self_device_time_total > 0 and sub in ev.key)
                  for sub in expect or ()}
        if device_s > 0 and counts == (expect or {}):
            break
    check(device_s > 0, f"the profiler saw no device time in {attempt} traces")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    top_host = sorted(host.items(), key=lambda kv: -kv[1])[:8]
    return {"calls": calls, "wall_s": wall, "device_s": device_s,
            "idle_share": 1 - device_s / wall,
            "device_events_per_call": device_events / calls,
            "host_launches_per_call": launches / calls, "traces": attempt, "counts": counts,
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
        check(len(held) == len(QUERY_OPS) + len(ingest_ladder(W_CAPACITY)) + 2,
              f"{name}: warmup holds graphs {held}")
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
    if profile:  # one key a call: the graph pads it to the ladder's lowest rung
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


def sharded_read_drain(srv, reads, strategy: str, ranks: int, tag: str) -> dict:
    """One drain of the phase's reads through ``srv``, whose read graphs
    ``warmup`` captured (over NCCL): every answer against the oracle, one
    fetch a chunk, no capture, the launches the design implies (counted
    from 0 just before the drain, replays included); lanes/s over the busy
    time and over the drain's wall."""
    srv.reset_stats()
    tickets = submit_reads(srv, reads)
    torch.cuda.synchronize()
    runs, fetches, captures = graphs.kernel_runs(), runtime.fetch_count(), graphs.STATS["captures"]
    t0 = time.perf_counter()
    res = srv.drain()
    drain_s = time.perf_counter() - t0
    launches = {k: n - runs[k] for k, n in graphs.kernel_runs().items()}
    n_fetch = runtime.fetch_count() - fetches
    n_capture = graphs.STATS["captures"] - captures
    check_answers(res, tickets, tag)
    st = srv.stats
    check(n_fetch == st.chunks, f"{tag}: {n_fetch} fetches for {st.chunks} chunks")
    check(n_capture == 0, f"{tag}: the read drain captured {n_capture} graphs")
    check_shard_launches(launches, strategy, ranks, st.chunks, 0, tag)
    return {"lanes": st.lanes, "chunks": st.chunks, "fetches": n_fetch, "captures": n_capture,
            "launches": launches, "busy_s": st.busy_s, "lanes_per_sec": st.lanes_per_sec,
            "drain_s": drain_s, "lanes_per_drain_sec": st.lanes / drain_s,
            "per_op_lanes_per_sec": {op: o.lanes_per_sec for op, o in st.per_op.items()}}


def serve_sharded(keys, values, strategy: str, mesh, reads, w_rounds, single: bool = False) -> dict:
    """Phase 4s for one strategy on this rank: the reads through a sharded
    read-only server, then the write stream through a sharded server with a
    W_CAPACITY buffer, every answer against the oracle, the fetch budget,
    the captures and the launches (each counted from 0 just before its
    drain) checked.  Over NCCL the runner is compiled: ``warmup`` captures
    one graph per (op, slot), a read drain none, a compaction that keeps
    the height none, and the one that grows the tree every held graph
    again; over gloo it is eager.  With ``single`` (world 1) the same
    server serves the reads again on its eager route, one lookup chunk's
    drain is profiled on either route, and the single-chip server of the
    same config serves the reads too, for its lanes/s beside the sharded
    one's.  Every rank of ``mesh`` calls it alike."""
    name = SHARD_CONFIGS[strategy]
    cfg = dataclasses.replace(PAPER_CONFIGS[name], device="cuda")
    tag = f"4s {strategy} x{mesh.size()}"
    row = {"strategy": strategy, "config": name, "ranks": mesh.size()}
    seconds = row["seconds"] = {}  # host clock of each step, for the phase's own time
    t0 = time.perf_counter()

    srv = BSTServer(keys, values, cfg, chunk_size=CHUNK, scan_k=SCAN_K, mesh=mesh)
    run = srv.sharded_query
    row["compiled"] = run.compiled
    row["backend"] = str(torch.distributed.get_backend(run.group))
    captures = graphs.STATS["captures"]
    srv.warmup(QUERY_OPS)
    row["warmup_captures"] = graphs.STATS["captures"] - captures
    want = 2 * len(QUERY_OPS) if run.compiled else 0  # one graph per (op, slot)
    check(row["warmup_captures"] == want,
          f"{tag}: warmup captured {row['warmup_captures']} graphs, want {want}")
    seconds["read_server"] = time.perf_counter() - t0
    row["reads"] = sharded_read_drain(srv, reads, strategy, mesh.size(), tag)
    seconds["reads"] = row["reads"]["drain_s"]
    if single:  # where a chunk's time goes: one lookup chunk a drain, profiled, on either route
        one_chunk = reads[0][1][:CHUNK]
        row["chunk_profile"] = profile_calls(lambda: (srv.submit(one_chunk), srv.drain()), 4)
        srv.eager = True
        row["eager_reads"] = sharded_read_drain(srv, reads, strategy, mesh.size(), f"{tag} eager")
        row["eager_chunk_profile"] = profile_calls(lambda: (srv.submit(one_chunk), srv.drain()), 4)
        srv.eager = False
        seconds["eager_reads"] = row["eager_reads"]["drain_s"]
    t0 = time.perf_counter()
    row["memory_nodes_per_device"] = srv.memory_nodes_per_device()
    row["kernels"] = shard_kernel_checks(srv, mesh, strategy, reads)
    seconds["kernel_checks"] = time.perf_counter() - t0
    del srv, run

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
    captures = graphs.STATS["captures"]
    wsrv.warmup(QUERY_OPS + ("write",))
    row["write_warmup_captures"] = graphs.STATS["captures"] - captures
    seconds["write_server"] = time.perf_counter() - t0
    held = len(wsrv.sharded_query.graph_keys()) + len(wsrv.engine.graph_keys())
    check(row["write_warmup_captures"] == held,
          f"{tag}: the write server's warmup captured {row['write_warmup_captures']}, holds {held}")
    compactions = track_compactions(wsrv.engine)
    tickets = []
    for rnd in w_rounds:
        wsrv.submit_write(*rnd["writes"])
        wsrv.submit_delete(rnd["deletes"])
        tickets += submit_reads(wsrv, rnd["reads"])
    torch.cuda.synchronize()
    runs = graphs.kernel_runs()
    fetches, captures = runtime.fetch_count(), graphs.STATS["captures"]
    t0 = time.perf_counter()
    res = wsrv.drain()
    drain_s = time.perf_counter() - t0
    launches = {k: n - runs[k] for k, n in graphs.kernel_runs().items()}
    n_fetch = runtime.fetch_count() - fetches
    n_capture = graphs.STATS["captures"] - captures
    check_answers(res, tickets, f"{tag} writes")
    st = wsrv.stats
    read_chunks = sum(st.per_op[op].chunks for op in QUERY_OPS)
    ingest_chunks = st.chunks - read_chunks
    check(st.compactions >= 1, f"{tag}: no compaction in the write stream")
    check(n_fetch == read_chunks + st.compactions,
          f"{tag}: {n_fetch} fetches for {read_chunks} read chunks + {st.compactions} compactions")
    check_shard_launches(launches, strategy, mesh.size(), read_chunks, ingest_chunks,
                         f"{tag} writes")
    # captures only where the height changes, there every held graph once
    held = len(wsrv.sharded_query.graph_keys()) + len(wsrv.engine.graph_keys())
    for c in compactions:
        want = 0 if c["height"][0] == c["height"][1] else held
        check(c["captures"] == want, f"{tag}: compaction {c} captured {c['captures']}, want {want}")
    check(n_capture == sum(c["captures"] for c in compactions),
          f"{tag}: the write drain captured {n_capture} graphs outside its compactions too")
    row["writes"] = {"lanes": st.lanes, "read_chunks": read_chunks, "ingest_chunks": ingest_chunks,
                     "compactions": st.compactions, "fetches": n_fetch, "launches": launches,
                     "captures": n_capture, "compaction_captures": compactions,
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
    route = ("graphs (captured, one replay a chunk)" if row["compiled"] else
             f"eager: {row['backend']}'s collectives run on the host and cannot be captured")
    beside = (f"; single-chip {row['config']} {single['lanes_per_sec']!r} (busy), "
              f"{single['lanes_per_drain_sec']!r} (drain wall)" if single else "")
    log(f"    {row['strategy']} ({row['config']}) x{row['ranks']} over {row['backend']}, {route}; "
        f"warmup captured {row['warmup_captures']} graphs (write server "
        f"{row['write_warmup_captures']}); reads lanes_per_sec="
        f"{r['lanes_per_sec']!r} (busy), {r['lanes_per_drain_sec']!r} (drain wall) over "
        f"{r['lanes']} lanes, {r['chunks']} chunks, {r['fetches']} fetches, {r['captures']} "
        f"captures, K4 {r['launches']['queue_dispatch']}, K1 {r['launches']['forest_descend']}"
        f"{beside}; writes {w['lanes_per_sec']!r} (busy) over {w['lanes']} lanes, "
        f"{w['read_chunks']} read + {w['ingest_chunks']} ingest chunks, {w['compactions']} "
        f"compactions (heights and captures {[(c['height'], c['captures']) for c in w['compaction_captures']]}), "
        f"{w['fetches']} fetches, K4 {w['launches']['queue_dispatch']}, K1 "
        f"{w['launches']['forest_descend']}, K3 {w['launches']['hybrid_descend']}; "
        f"memory_nodes_per_device {row['memory_nodes_per_device']}; answers == oracle ({smi})")
    if "eager_reads" in row:
        e = row["eager_reads"]
        log(f"      eager route of the same server: reads lanes_per_sec={e['lanes_per_sec']!r} "
            f"(busy), {e['lanes_per_drain_sec']!r} (drain wall); graph route "
            f"{r['lanes_per_sec'] / e['lanes_per_sec']!r}x (busy), "
            f"{r['lanes_per_drain_sec'] / e['lanes_per_drain_sec']!r}x (drain wall); "
            f"answers == oracle ({smi})")
    for c in row["kernels"]["checks"]:
        log(f"      {c}: K1, K4 == their plain versions")
    for key, route in (("chunk_profile", "graph"), ("eager_chunk_profile", "eager")):
        if key in row:
            log_call_profile(f"{row['strategy']} x{row['ranks']} one lookup chunk's drain, "
                             f"{route} route", row[key])


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
            check(row["compiled"], f"4s {strategy} x1 over NCCL: the sharded runner is not compiled")
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
            check(not row["compiled"], f"4s {row['strategy']} x{SHARD_RANKS} over gloo: compiled")
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


def frontend_embeds(cfg, batch: int, seq: int, seed: int) -> tuple:
    """The stub frontend's embeddings of a (batch, seq) prompt, as
    ``launch/serve.py`` makes them: shaped by ``input_specs`` (seamless a
    frame per position, internvl2 its 256 patches), N(0, 0.02) from numpy,
    in the parameter dtype; () where the config has no frontend."""
    if cfg.frontend is None:
        return ()
    spec = input_specs(cfg, ShapeConfig("serve", seq, batch, "prefill"))["frontend_embeds"]
    draw = np.random.default_rng(seed).standard_normal(tuple(spec.shape), dtype=np.float32) * 0.02
    return (torch.from_numpy(draw).to("cuda", spec.dtype),)


def check_full_model_fp32(cfg, smi: str, k5_per_prefill=None) -> dict:
    """A model (qwen3-1.7b, or a family of phase 8) in fp32 at full width
    and depth, 1 x LM_CHECK_PROMPT with its frontend embeddings: the flash
    route (K5, ``k5_per_prefill`` launches a prefill, by default one a
    layer) against the naive route (plain attention), where the family has
    attention, over prefill and LM_CHECK_STEPS decode steps, then each
    decode step against a prefill of the longer prompt (the same frames or
    patches; for mamba2 the SSD duality at full depth)."""
    k5 = cfg.n_layers if k5_per_prefill is None else k5_per_prefill
    cfg32 = dataclasses.replace(cfg, dtype="float32", attention_impl="flash")
    naive = dataclasses.replace(cfg32, attention_impl="naive")
    model = lm.init_params(cfg32, seed=0, device="cuda")
    total = LM_CHECK_PROMPT + LM_CHECK_STEPS
    toks = torch.from_numpy(np.random.default_rng(7).integers(0, cfg.vocab_size, (1, total))).cuda()
    fe = frontend_embeds(cfg32, 1, LM_CHECK_PROMPT, seed=3)

    def run(c):
        logits, state = lm.prefill(c, model, toks[:, :LM_CHECK_PROMPT], *fe, max_len=total)
        check(bool(torch.isfinite(logits).all()),
              f"{cfg.name} fp32 {c.attention_impl} prefill: a logit is not finite")
        out = [logits]
        for t in range(LM_CHECK_PROMPT, total):
            logits, state = lm.decode_step(c, model, toks[:, t:t + 1], state)
            out.append(logits)
        return out

    FA.reset_launches()
    flash = run(cfg32)
    check(FA.LAUNCHES["flash_attention"] == k5,
          f"{cfg.name} fp32 prefill: {FA.LAUNCHES['flash_attention']} K5 launches, want {k5}")
    route_err = None
    if cfg.has_attention:
        plain = run(naive)
        check(FA.LAUNCHES["flash_attention"] == k5, f"{cfg.name}: the naive route launched K5")
        route_err = max(float((a - b).abs().max()) for a, b in zip(flash, plain))
        for a, b in zip(flash, plain):
            torch.testing.assert_close(a, b, atol=LM_CHECK_TOL, rtol=LM_CHECK_TOL)
        del plain
    consistency_err = 0.0
    for t, logits in enumerate(flash[1:], start=1):
        want, _ = lm.prefill(cfg32, model, toks[:, :LM_CHECK_PROMPT + t], *fe)
        consistency_err = max(consistency_err, float((logits - want).abs().max()))
        torch.testing.assert_close(logits, want, atol=LM_CHECK_TOL, rtol=LM_CHECK_TOL)
    row = {"arch": cfg.name, "prompt": LM_CHECK_PROMPT, "decode_steps": len(flash) - 1,
           "k5_per_prefill": k5, "flash_vs_naive_max_abs_err": route_err,
           "decode_vs_prefill_max_abs_err": consistency_err, "tol": LM_CHECK_TOL,
           "logit_scale": float(flash[0].abs().max())}
    log(f"  fp32 {cfg.name}, {cfg.n_layers} layers, 1 x {LM_CHECK_PROMPT}: K5 launches {k5}; "
        f"flash vs naive route max_abs_err {route_err!r}, decode vs longer prefill "
        f"{consistency_err!r} over {len(flash) - 1} steps (tolerance {LM_CHECK_TOL}; largest "
        f"logit {row['logit_scale']!r}) ({smi})")
    del model, flash
    torch.cuda.empty_cache()
    return row


def check_full_model_bf16(cfg, smi: str, k5_per_prefill=None) -> dict:
    """A model with attention in bf16 at full width and depth,
    LM_BF16_CHECK_BATCH x LM_CHECK_PROMPT with its frontend embeddings: the
    serving route (flash, K5's bf16 wgmma body, ``k5_per_prefill``
    launches, by default one a layer) and the naive route (plain
    attention) in bf16, each against the naive route of the same weights
    in fp32.  The flash route's RMS distance over all the last-position
    logits may be at most LM_BF16_ROUTE_RATIO times the naive bf16
    route's: the kernel may add to the model's bf16 rounding, not more
    than that share of it."""
    k5 = cfg.n_layers if k5_per_prefill is None else k5_per_prefill
    naive = dataclasses.replace(cfg, attention_impl="naive")
    naive32 = dataclasses.replace(naive, dtype="float32")
    model = lm.init_params(cfg, seed=0, device="cuda")
    model32 = lm.Model(naive32, device="cuda")
    for p32, p in zip(model32.parameters(), model.parameters()):
        p32.copy_(p)
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (LM_BF16_CHECK_BATCH, LM_CHECK_PROMPT))).cuda()
    fe = frontend_embeds(cfg, LM_BF16_CHECK_BATCH, LM_CHECK_PROMPT, seed=4)
    FA.reset_launches()
    flash, _ = lm.prefill(cfg, model, toks, *fe)
    check(FA.LAUNCHES["flash_attention"] == k5,
          f"{cfg.name} bf16 prefill: {FA.LAUNCHES['flash_attention']} K5 launches, want {k5}")
    plain, _ = lm.prefill(naive, model, toks, *fe)
    want, _ = lm.prefill(naive32, model32, toks, *fe)  # the prefill casts the bf16 embeddings
    check(FA.LAUNCHES["flash_attention"] == k5, f"{cfg.name}: the naive routes launched K5")
    check(all(bool(torch.isfinite(t).all()) for t in (flash, plain, want)),
          f"{cfg.name} bf16 check: a logit is not finite")
    dist = {name: (float((got.float() - want).pow(2).mean().sqrt()),
                   float((got.float() - want).abs().max()))
            for name, got in (("flash", flash), ("naive", plain))}
    ratio = dist["flash"][0] / dist["naive"][0]
    row = {"arch": cfg.name, "batch": LM_BF16_CHECK_BATCH, "prompt": LM_CHECK_PROMPT,
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
          f"{cfg.name} bf16 check: the flash route is {ratio!r} times as far from fp32 as the "
          f"naive route")
    del model, model32, flash, plain, want
    torch.cuda.empty_cache()
    return row


def timed_generate(cfg, model, prompts, n_new: int, eager: bool, per_step=None,
                   profiles=(), frontend=()) -> dict:
    """One request through the serve loop's units on one route (the decode
    graph, or with ``eager`` the ops one by one): the prefill and the
    ``n_new - 1`` decode steps timed by the host clock around synchronised
    work, every step's logits copied out (the graph's are its static
    buffer) and checked finite, ``per_step()`` after the prefill and after
    each step, then the profiles named in ``profiles``: "decode" (further
    decode steps) and "prefill" (one more prefill).  ``frontend``: the
    prefill's frontend embeddings, where the config has a frontend."""
    S = prompts.shape[1]
    prefill_fn = make_prefill_fn(cfg, max_len=S + n_new, eager=eager)
    step = make_serve_step(cfg, eager=eager)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, state = prefill_fn(model, prompts, *frontend)
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
        **({"prefill_profile": profile_calls(lambda: prefill_fn(model, prompts, *frontend), 1)}
           if "prefill" in profiles else {}),
    }


def log_route(label: str, r: dict) -> None:
    log(f"    {label} {r['route']}: prefill {r['prefill_s']!r} s ({r['prefill_tok_per_s']!r} tok/s), "
        f"decode {r['decode_ms_per_step']!r} ms/step ({r['decode_tok_per_s']!r} tok/s)")
    for kind in ("decode", "prefill"):
        if f"{kind}_profile" in r:
            log_call_profile(f"{r['route']} {kind}", r[f"{kind}_profile"])


def capture_serving_graphs(cfg, model, prompts, fe, max_len: int) -> dict:
    """The serving request's decode and prefill graphs, captured before any
    count is read (a capture runs its step once eagerly, and the prefill's
    once more as a replay): their capture seconds (``graphs.STATS``, the
    warm-ups excluded), the wall time around both, and each pool's bytes."""
    graphs.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pg = serve_loop.prefill_graph(cfg, model, prompts, fe[0] if fe else None, max_len)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(graphs.STATS["captures"] == 2, f"{cfg.name}: {graphs.STATS['captures']} graphs captured "
                                         f"for one request shape, want its decode and prefill graphs")
    return {"captures": graphs.STATS["captures"], "capture_s": graphs.STATS["capture_s"],
            "capture_wall_s": wall, "prefill_pool_bytes": pg.graph.pool_bytes,
            "decode_pool_bytes": pg.decode.graph.pool_bytes}


def check_prefill_routes(cfg, model, prompts, fe, max_len: int) -> dict:
    """The prefill graph against the eager route on the serving request: the
    logits, every cache and the position bit for bit (the graph replays the
    eager route's kernels in its order, and the forward has no atomics)."""
    got, state = make_prefill_fn(cfg, max_len=max_len)(model, prompts, *fe)
    want, eager_state = make_prefill_fn(cfg, max_len=max_len, eager=True)(model, prompts, *fe)
    caches, want_caches = lm.state_tensors(state), lm.state_tensors(eager_state)
    check(torch.equal(got, want), f"{cfg.name}: the prefill graph's logits differ from the eager "
                                  f"route's")
    check(set(caches) == set(want_caches) and all(torch.equal(caches[k], want_caches[k])
                                                  for k in caches)
          and int(state.position) == int(eager_state.position),
          f"{cfg.name}: the prefill graph's caches differ from the eager route's")
    return {"logits_equal": True, "caches_equal": sorted(caches),
            "cache_bytes": sum(t.numel() * t.element_size() for t in caches.values())}


def log_prefill_graph(cfg, captured: dict, routes: list, smi: str) -> None:
    prefill = {r["route"]: [x["prefill_s"] for x in routes if x["route"] == r["route"]]
               for r in routes}
    log(f"    {cfg.name} prefill graph: logits and caches == the eager route's bit for bit; decode "
        f"and prefill graphs captured in {captured['capture_s']!r} s ({captured['capture_wall_s']!r} "
        f"s with the warm-ups and the first replay), pools: prefill "
        f"{captured['prefill_pool_bytes']} bytes, decode {captured['decode_pool_bytes']} bytes; "
        f"prefill s in turns: graph {prefill['graph']}, eager {prefill['eager']} ({smi})")


def serve_lm(cfg, smi: str, k5_per_prefill=None) -> dict:
    """The serving run of a model (qwen3-1.7b, or a family of phase 8) in
    bf16: the decode and prefill graphs of LM_BATCH x LM_PROMPT + LM_NEW
    captured, the prefill graph held to the eager route bit for bit; every
    kernel count set to 0, then ``greedy_generate`` with its frontend
    embeddings, which captures nothing and whose prefill replay runs
    ``k5_per_prefill`` K5 launches (by default one a layer) and no other
    kernel of the port; the same through the eager route, tokens equal;
    then one request timed on each route (graph, eager, graph, eager: the
    host's spread shows in each pair) through the serve loop's units,
    tokens held against greedy_generate's, and no capture."""
    k5 = cfg.n_layers if k5_per_prefill is None else k5_per_prefill
    model = lm.init_params(cfg, seed=0, device="cuda")
    prompts = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT))).cuda()
    fe = frontend_embeds(cfg, LM_BATCH, LM_PROMPT, seed=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    captured = capture_serving_graphs(cfg, model, prompts, fe, LM_PROMPT + LM_NEW)
    prefill_check = check_prefill_routes(cfg, model, prompts, fe, LM_PROMPT + LM_NEW)
    for reset in (K.reset_launches, QD.reset_launches, FA.reset_launches, graphs.reset):
        reset()
    tokens = greedy_generate(cfg, model, prompts, LM_NEW, *fe)
    torch.cuda.synchronize()
    runs = graphs.kernel_runs()
    launches = runs["flash_attention"]
    peak = torch.cuda.max_memory_allocated()
    check(graphs.STATS["captures"] == 0, f"{cfg.name} serving: greedy_generate captured "
                                         f"{graphs.STATS['captures']} graphs")
    check(launches == k5, f"{cfg.name} serving: {launches} K5 launches for one prefill, want {k5}")
    check(all(n == 0 for name, n in runs.items() if name != "flash_attention"),
          f"{cfg.name} serving ran a kernel of another path: {runs}")
    check(tuple(tokens.shape) == (LM_BATCH, LM_NEW), f"greedy_generate gave {tuple(tokens.shape)}")
    eager_tokens = greedy_generate(cfg, model, prompts, LM_NEW, *fe, eager=True)
    check(torch.equal(eager_tokens, tokens),
          f"{cfg.name} serving: the graph's tokens differ from the eager route's")

    routes = [timed_generate(cfg, model, prompts, LM_NEW, eager, profiles=profiles, frontend=fe)
              for eager, profiles in ROUTE_TURNS]
    check(graphs.STATS["captures"] == 0,
          f"{cfg.name} serving: a steady-state request captured a graph")
    for r in routes:
        check(torch.equal(r.pop("tokens"), tokens),
              f"{cfg.name} serving ({r['route']}): the timed steps' tokens differ from "
              f"greedy_generate's")
    graph, eager = routes[0], routes[1]
    row = {
        "arch": cfg.name, "family": cfg.family, "layers": cfg.n_layers,
        "encoder_layers": cfg.encoder_layers, "d_model": cfg.d_model, "heads": cfg.n_heads,
        "kv_heads": cfg.n_kv_heads, "head_dim": cfg.resolved_head_dim, "vocab": cfg.vocab_size,
        "dtype": cfg.dtype, "params": cfg.n_params(),
        "batch": LM_BATCH, "prompt": LM_PROMPT, "new_tokens": LM_NEW,
        "frontend": list(fe[0].shape) if fe else None,
        "flash_launches": launches, "peak_bytes": peak, "capture_s": captured["capture_s"],
        "graphs": captured, "prefill_graph": prefill_check,
        **{k: graph[k] for k in ("prefill_s", "prefill_tok_per_s", "decode_steps",
                                 "decode_ms_per_step", "decode_tok_per_s", "decode_profile",
                                 "prefill_profile")},
        "eager_prefill_s": eager["prefill_s"], "eager_prefill_tok_per_s": eager["prefill_tok_per_s"],
        "eager_prefill_profile": eager["prefill_profile"],
        "routes": routes, "graph_tokens_equal_eager": True,
        "sample_ids": tokens[0, :16].tolist(), "tokens": tokens.tolist(),
    }
    log(f"  {cfg.name} ({cfg.family}) bf16, {cfg.n_layers} layers, {LM_BATCH} x {LM_PROMPT} + "
        f"{LM_NEW}, frontend {row['frontend']}: K5 runs {launches} (the prefill graph's replay), "
        f"graph tokens == eager tokens; graph: prefill {graph['prefill_s']!r} s "
        f"({graph['prefill_tok_per_s']!r} tok/s), decode {graph['decode_ms_per_step']!r} ms/step; "
        f"eager: prefill {eager['prefill_s']!r} s ({eager['prefill_tok_per_s']!r} tok/s), decode "
        f"{eager['decode_ms_per_step']!r} ms/step; peak {peak} bytes, every logit finite ({smi})")
    log_prefill_graph(cfg, captured, routes, smi)
    for r in routes:
        log_route("route", r)
    log(f"    sample ids {row['sample_ids']}")
    del model
    gc.collect()  # the model's graphs go with it
    torch.cuda.empty_cache()
    return row


def profile_decode(step, model, tok, state) -> dict:
    """Where LM_PROFILE_STEPS greedy decode steps' time goes (``profile_calls``)."""
    carry = [tok, state]

    def one_step():
        logits, carry[1] = step(model, carry[0], carry[1])
        carry[0] = logits.argmax(dim=-1, keepdim=True)

    return profile_calls(one_step, LM_PROFILE_STEPS)


def sdpa_backend(call, want: torch.Tensor) -> str:
    """The backend ``scaled_dot_product_attention`` chose for ``call``: the
    ones whose output, each run alone (``sdpa_kernel``), equals the
    unrestricted call's ``want`` bit for bit."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    names = []
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]), warnings.catch_warnings():
                warnings.simplefilter("ignore")  # why each backend that cannot run refuses
                out = call()
        except RuntimeError:
            continue
        if torch.equal(out, want):
            names.append(backend.name)
    return "/".join(names) or "none equal"


def sdpa_mask(Sq: int, Skv: int, causal: bool, window) -> dict:
    """scaled_dot_product_attention's mask arguments for K5's masks:
    ``is_causal`` where no window cuts the causal mask (SDPA aligns it
    top-left, K5 bottom-right: the same where Sq == Skv), else an explicit
    boolean mask of the same function."""
    if window is None or window >= Skv:
        return {"is_causal": causal}
    qpos = torch.arange(Sq, device="cuda")[:, None] + (Skv - Sq)
    kpos = torch.arange(Skv, device="cuda")[None, :]
    return {"attn_mask": (kpos > qpos - window) & ((kpos <= qpos) if causal else True)}


def time_flash(timer, timed=None) -> list:
    """K5 in bf16 at prefill shapes -- both of phase 6 (qwen3's and
    mixtral's), or ``timed``, (index into FLASH_SHAPES, label) pairs --
    each beside its plain version, scaled_dot_product_attention (the
    library yardstick, never called by the port: ``is_causal`` where no
    window cuts the causal mask, else an explicit boolean mask of the same
    function; ``enable_gqa``; the backend it chose named) and the least
    time the card could take for the same work."""
    if timed is None:
        timed = [(i, f"{what} prefill attention") for i, what in zip(FLASH_TIMED, (LM_ARCH, MOE_ARCH))]
    rows = []
    for idx, label in timed:
        shape = FLASH_SHAPES[idx]
        BH, BHkv, Sq, Skv, d, causal, window = shape
        check(Sq == Skv or not causal, f"{shape}: SDPA aligns a causal mask top-left, K5 bottom-right")
        q, k, v = flash_operands(shape, torch.bfloat16, seed=99)
        got = FA.flash_attention_cuda(q, k, v, causal=causal, window=window)
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        err = float((got.float() - want.float()).abs().max())
        B = LM_BATCH
        q4, k4, v4 = (t.view(B, t.shape[0] // B, t.shape[1], d) for t in (q, k, v))
        sdpa = functools.partial(torch.nn.functional.scaled_dot_product_attention, q4, k4, v4,
                                 enable_gqa=True, **sdpa_mask(Sq, Skv, causal, window))
        lib_out = sdpa()
        lib_err = float((lib_out.reshape(BH, Sq, d).float() - want.float()).abs().max())
        backend = sdpa_backend(sdpa, lib_out)
        flop, n_bytes = FA.forward_work(BH, BHkv, Sq, Skv, d, causal, window, q.element_size())
        row = {
            "config": label, "shape": list(shape), "dtype": "bfloat16",
            "ms": timer(functools.partial(FA.flash_attention_cuda, q, k, v, causal=causal,
                                          window=window)),
            "plain_ms": timer(functools.partial(ref.flash_attention_ref, q, k, v, causal=causal,
                                                window=window), reps=5),
            "library_ms": timer(sdpa),
            "flop": flop, "bytes": n_bytes,
            "flop_ms": flop / BF16_FLOP_PER_S * 1e3, "bytes_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
            "max_abs_err": err, "library_max_abs_err": lib_err, "library_backend": backend,
        }
        row["bound_ms"] = max(row["flop_ms"], row["bytes_ms"])
        row["bound_by"] = "operations" if row["flop_ms"] >= row["bytes_ms"] else "bytes"
        row["tflop_per_s"] = flop / row["ms"] * 1e-9
        log(f"  K5 {label} {shape} bf16: ms={row['ms']!r} plain_ms={row['plain_ms']!r} "
            f"library_ms={row['library_ms']!r} (sdpa backend {backend}) bound_ms="
            f"{row['bound_ms']!r} ({row['bound_by']}: "
            f"{flop} FLOP over {BF16_FLOP_PER_S:.3g}/s = {row['flop_ms']!r} ms, {n_bytes} bytes "
            f"over {HBM_BYTES_PER_S:.3g}/s = {row['bytes_ms']!r} ms; {row['tflop_per_s']!r} "
            f"TFLOP/s); max_abs_err vs plain {err!r}, sdpa vs plain {lib_err!r}")
        rows.append(row)
        del q, k, v, got, want, q4, k4, v4, lib_out
    return rows


# ------------------------------------------- phase 6r: K5 past 65,535 rows
def plain_in_slices(fn, q_rows, kv_rows) -> list:
    """``fn(*q_slices, *kv_slices)`` over slices of ROWS_SLICE kv rows and
    their GQA groups' q rows, each output concatenated over the slices: the
    plain version at a shape whose intermediates the card would not hold
    whole."""
    group = q_rows[0].shape[0] // kv_rows[0].shape[0]
    parts = [fn(*(t[i * group:(i + ROWS_SLICE) * group] for t in q_rows),
                *(t[i:i + ROWS_SLICE] for t in kv_rows))
             for i in range(0, kv_rows[0].shape[0], ROWS_SLICE)]
    return [torch.cat(p) for p in zip(*parts)]


def agreement(got, want, tol: float) -> dict:
    """Elements outside atol = rtol = ``tol``, the largest difference, and
    |got - want|_2 / |want|_2."""
    diff = (got.float() - want.float()).abs()
    return {"mismatches": int((diff > tol + tol * want.float().abs()).sum()),
            "max_abs_err": float(diff.max()),
            "rel_norm_err": float(diff.norm()) / float(want.float().norm())}


def rows_work_ms(work, rate: float) -> dict:
    flop, n_bytes = work
    row = {"flop": flop, "bytes": n_bytes, "flop_ms": flop / rate * 1e3,
           "bytes_ms": n_bytes / HBM_BYTES_PER_S * 1e3}
    row["bound_ms"] = max(row["flop_ms"], row["bytes_ms"])
    row["bound_by"] = "operations" if row["flop_ms"] >= row["bytes_ms"] else "bytes"
    return row


def rows_library(timer, B: int, shape, q, k, v, want, dout=None) -> dict:
    """scaled_dot_product_attention (``enable_gqa``, ``sdpa_mask``) on the
    same rows viewed as (B, heads, S, d): the forward, or with ``dout`` its
    backward (autograd through the same call), timed as K5 is beside it,
    the backend it chose and its largest difference from the plain
    version's ``want``.  The library's ms is None, with the reason, where
    it refuses the shape; the port never calls it."""
    BH, BHkv, Sq, Skv, d, causal, window = shape
    q4, k4, v4 = (t.view(B, t.shape[0] // B, t.shape[1], d) for t in (q, k, v))
    if dout is not None:
        q4, k4, v4 = (t.detach().requires_grad_() for t in (q4, k4, v4))
    sdpa = functools.partial(torch.nn.functional.scaled_dot_product_attention, q4, k4, v4,
                             enable_gqa=True, **sdpa_mask(Sq, Skv, causal, window))
    try:
        lib_out = sdpa()
        backend = sdpa_backend(lambda: sdpa().detach(), lib_out.detach())
        if dout is None:
            got, call = [lib_out], sdpa
        else:
            g4 = dout.view(q4.shape)
            call = functools.partial(torch.autograd.grad, lib_out, (q4, k4, v4), g4,
                                     retain_graph=True)
            got = call()
        err = max(float((a.reshape(b.shape).float() - b.float()).abs().max())
                  for a, b in zip(got, want))
        row = {"library_ms": timer(call, reps=ROWS_REPS), "library_backend": backend,
               "library_max_abs_err": err}
    except RuntimeError as e:  # out of memory included
        row = {"library_ms": None, "library_error": f"{type(e).__name__}: {str(e)[:300]}"}
    finally:
        q4 = k4 = v4 = lib_out = got = call = sdpa = None
        torch.cuda.empty_cache()
    return row


def check_head_rows_forward(timer) -> list:
    """K5's forward at ROWS_FWD in fp32 and bf16, with and without lse: one
    count and ``head_row_chunks`` launches a call, the outputs within
    FLASH_TOL of the plain version and the lse within 1e-5; the call timed
    beside its bound and scaled_dot_product_attention (``rows_library``)."""
    rows = []
    for B, shape in ROWS_FWD:
        BH, BHkv, Sq, Skv, d, causal, window = shape
        chunks = len(FA.head_row_chunks(BH, BHkv))
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = flash_operands(shape, dtype, seed=BH % 1000)
            FA.reset_launches()
            out, lse = FA.flash_attention_cuda(q, k, v, causal=causal, window=window, with_lse=True)
            served = FA.flash_attention_cuda(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            counts = {"launches": FA.LAUNCHES["flash_attention"],
                      "chunks": FA.CHUNKS["flash_attention"]}
            check(chunks > 1 and counts == {"launches": 2, "chunks": 2 * chunks},
                  f"K5 {shape}: {counts} for 2 calls of {chunks} chunks")
            want, want_lse = plain_in_slices(functools.partial(
                ref.flash_attention_lse_ref, causal=causal, window=window), (q,), (k, v))
            tol = FLASH_TOL[dtype]
            agree = {"out": agreement(out, want, tol), "served": agreement(served, want, tol),
                     "lse": agreement(lse, want_lse, 1e-5)}
            for name, a in agree.items():
                check(a["mismatches"] == 0, f"K5 {shape} {dtype}: {a['mismatches']} {name} "
                                            f"elements outside the tolerance")
            rate = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
            row = {"shape": list(shape), "dtype": str(dtype).replace("torch.", ""), "tol": tol,
                   "chunks": chunks, **counts, **agree,
                   "ms": timer(functools.partial(FA.flash_attention_cuda, q, k, v, causal=causal,
                                                 window=window), reps=ROWS_REPS),
                   **rows_work_ms(FA.forward_work(BH, BHkv, Sq, Skv, d, causal, window,
                                                  q.element_size()), rate),
                   **rows_library(timer, B, shape, q, k, v, [want])}
            log(f"  K5 {shape} {row['dtype']}: {chunks} chunks a call, counts {counts} for 2 calls; "
                f"out max_abs_err {agree['out']['max_abs_err']!r}, served "
                f"{agree['served']['max_abs_err']!r}, lse {agree['lse']['max_abs_err']!r} "
                f"(tolerance {tol}, lse 1e-5); ms={row['ms']!r} bound_ms={row['bound_ms']!r} "
                f"({row['bound_by']}) library_ms={row['library_ms']!r} (sdpa backend "
                f"{row.get('library_backend', row.get('library_error'))}, max_abs_err vs plain "
                f"{row.get('library_max_abs_err')!r})")
            rows.append(row)
            del q, k, v, out, lse, served, want, want_lse
    return rows


def check_head_rows_backward(timer) -> list:
    """K5's backward at ROWS_BWD: one count and ``head_row_chunks(...,
    whole_groups=True)`` launches a call; dq, dk and dv within BWD_TOL of
    the plain version on the same saved tensors and within BWD_NORM_TOL in
    norm; the call timed beside its bound and the backward of
    scaled_dot_product_attention (``rows_library``)."""
    rows = []
    for dtype, B, shape in ROWS_BWD:
        BH, BHkv, Sq, Skv, d, causal, window = shape
        chunks = len(FA.head_row_chunks(BH, BHkv, whole_groups=True))
        q, k, v, dout = bwd_operands(shape, dtype, seed=BH % 1000)
        out, lse = FA.flash_attention_cuda(q, k, v, causal=causal, window=window, with_lse=True)
        FA.reset_launches()
        got = FA.flash_attention_bwd_cuda(q, k, v, out, dout, lse, causal=causal, window=window)
        torch.cuda.synchronize()
        counts = {"launches": FA.LAUNCHES["flash_attention_bwd"],
                  "chunks": FA.CHUNKS["flash_attention_bwd"]}
        check(counts == {"launches": 1, "chunks": chunks},
              f"K5 backward {shape}: {counts} for one call of {chunks} chunks")

        def plain(qc, oc, doc, lc, kc, vc):
            return ref.flash_attention_bwd_ref(qc, kc, vc, oc, doc, lc, causal=causal,
                                               window=window)

        want = plain_in_slices(plain, (q, out, dout, lse), (k, v))
        tol, norm_tol = BWD_TOL[dtype], BWD_NORM_TOL[dtype]
        agree = {n: agreement(g, w, tol) for n, g, w in zip(("dq", "dk", "dv"), got, want)}
        for name, a in agree.items():
            check(a["mismatches"] == 0 and a["rel_norm_err"] <= norm_tol,
                  f"K5 backward {shape} {dtype}: {name} {a} outside the tolerance")
        rate = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
        row = {"shape": list(shape), "dtype": str(dtype).replace("torch.", ""), "tol": tol,
               "norm_tol": norm_tol, "chunks": chunks, **counts, **agree,
               "ms": timer(functools.partial(FA.flash_attention_bwd_cuda, q, k, v, out, dout, lse,
                                             causal=causal, window=window), reps=ROWS_REPS),
               **rows_work_ms(FA.backward_work(BH, BHkv, Sq, Skv, d, causal, window,
                                               q.element_size()), rate),
               **rows_library(timer, B, shape, q, k, v, want, dout=dout)}
        log(f"  K5 backward {shape} {row['dtype']}: {chunks} chunks, counts {counts}; " + ", ".join(
            f"{n} max_abs_err {a['max_abs_err']!r} rel_norm_err {a['rel_norm_err']!r}"
            for n, a in agree.items()) + f" (tolerance {tol}, in norm {norm_tol}); "
            f"ms={row['ms']!r} bound_ms={row['bound_ms']!r} ({row['bound_by']}) "
            f"library_ms={row['library_ms']!r} (sdpa backward, forward backend "
            f"{row.get('library_backend', row.get('library_error'))}, max_abs_err vs plain "
            f"{row.get('library_max_abs_err')!r})")
        rows.append(row)
        del q, k, v, dout, out, lse, got, want
    return rows


@contextlib.contextmanager
def recorded_flash_calls(keep: dict, calls):
    """Every K5 call through ``kops.flash_attention`` runs as it would;
    the ones whose index (from 0) is in ``calls`` leave clones of their q,
    k, v and output and their keyword arguments in ``keep[index]``."""
    real, seen = kops.flash_attention, [0]

    def recording(q, k, v, *args, **kwargs):
        out = real(q, k, v, *args, **kwargs)
        if seen[0] in calls:
            check(not args, f"K5 call {seen[0]}: positional mask arguments {args}")
            keep[seen[0]] = ((q.clone(), k.clone(), v.clone()), out.clone(), dict(kwargs))
        seen[0] += 1
        return out

    with unittest.mock.patch.object(kops, "flash_attention", recording):
        yield


def one_launch_slices(q, k, v, **kwargs):
    """K5 over slices of ROWS_SLICE kv rows and their q rows, each slice
    one launch (within the limit: the wrapper's call before chunking),
    concatenated."""
    group = q.shape[0] // k.shape[0]
    check(ROWS_SLICE * group <= FA.MAX_HEAD_ROWS, f"a slice of {ROWS_SLICE} kv rows of group "
                                                  f"{group} is more than one launch")
    return torch.cat([FA.flash_attention_cuda(q[i * group:(i + ROWS_SLICE) * group],
                                              k[i:i + ROWS_SLICE], v[i:i + ROWS_SLICE], **kwargs)
                      for i in range(0, k.shape[0], ROWS_SLICE)])


def serve_head_rows(cfg, smi: str) -> dict:
    """qwen3-1.7b in bf16, whole, seed 0, on ROWS_BATCH prompts of
    ROWS_PROMPT tokens + ROWS_NEW: 65,536 head rows a prefill attention.
    The decode and prefill graphs captured first; every count set to 0,
    then ``greedy_generate`` replays one K5 a layer a prefill and no other
    kernel of the port; the eager route's tokens equal the graph's bit for
    bit, its K5 calls launching ``head_row_chunks`` chunks each.  The eager
    route's first and last layers' K5 inputs and outputs are kept: each
    output within FLASH_TOL of the plain version on the same inputs, and
    equal bit for bit to K5 in one-launch slices (``one_launch_slices``).
    The request again on the eager route with every K5 call in one-launch
    slices gives the same tokens bit for bit.  Then one request timed on
    each route, tokens held, no capture; the peak memory."""
    model = lm.init_params(cfg, seed=0, device="cuda")
    prompts = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (ROWS_BATCH, ROWS_PROMPT))).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    captured = capture_serving_graphs(cfg, model, prompts, (), ROWS_PROMPT + ROWS_NEW)
    for reset in (K.reset_launches, QD.reset_launches, FA.reset_launches, graphs.reset):
        reset()
    tokens = greedy_generate(cfg, model, prompts, ROWS_NEW)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()  # the captures and the graph route's request
    runs = graphs.kernel_runs()
    check(graphs.STATS["captures"] == 0 and runs["flash_attention"] == cfg.n_layers
          and all(n == 0 for name, n in runs.items() if name != "flash_attention"),
          f"{cfg.name} at batch {ROWS_BATCH}: kernel runs {runs} for one prefill replay, want "
          f"{cfg.n_layers} K5, {graphs.STATS['captures']} captures")
    FA.reset_launches()
    kept = {}
    with recorded_flash_calls(kept, (0, cfg.n_layers - 1)):
        eager_tokens = greedy_generate(cfg, model, prompts, ROWS_NEW, eager=True)
    chunks = len(FA.head_row_chunks(ROWS_BATCH * cfg.n_heads, ROWS_BATCH * cfg.n_kv_heads))
    eager_counts = {"launches": FA.LAUNCHES["flash_attention"], "chunks": FA.CHUNKS["flash_attention"]}
    check(eager_counts == {"launches": cfg.n_layers, "chunks": cfg.n_layers * chunks},
          f"{cfg.name} at batch {ROWS_BATCH}, eager: K5 {eager_counts}, want {cfg.n_layers} calls "
          f"of {chunks} chunks")
    check(tuple(tokens.shape) == (ROWS_BATCH, ROWS_NEW) and torch.equal(eager_tokens, tokens),
          f"{cfg.name} at batch {ROWS_BATCH}: the graph's tokens differ from the eager route's")
    layers = {}
    for call, ((q, k, v), out, kwargs) in sorted(kept.items()):
        check(q.shape[0] == ROWS_BATCH * cfg.n_heads and k.shape[0] == ROWS_BATCH * cfg.n_kv_heads,
              f"{cfg.name} layer {call}'s K5 call at {tuple(q.shape)}, {tuple(k.shape)}")
        want = plain_in_slices(lambda qc, kc, vc: [ref.flash_attention_ref(qc, kc, vc, **kwargs)],
                               (q,), (k, v))[0]
        agree = agreement(out, want, FLASH_TOL[q.dtype])
        check(agree["mismatches"] == 0, f"{cfg.name} at batch {ROWS_BATCH}, layer {call}'s K5: "
                                        f"{agree} outside {FLASH_TOL[q.dtype]} of the plain version")
        FA.reset_launches()
        sliced = one_launch_slices(q, k, v, **kwargs)
        check(FA.CHUNKS["flash_attention"] == FA.LAUNCHES["flash_attention"]
              and torch.equal(sliced, out), f"{cfg.name} at batch {ROWS_BATCH}, layer {call}'s K5 "
                                            f"differs from its one-launch slices")
        layers[call] = {"shape": [list(q.shape), list(k.shape)], "kwargs": kwargs, **agree,
                        "equals_one_launch_slices": True}
        log(f"  {cfg.name} layer {call}'s K5 at {tuple(q.shape)} over {tuple(k.shape)} ({kwargs}): "
            f"max_abs_err vs plain {agree['max_abs_err']!r} (tolerance {FLASH_TOL[q.dtype]}), "
            f"== its {FA.LAUNCHES['flash_attention']} one-launch slices bit for bit")
        del q, k, v, out, want, sliced
    check(sorted(layers) == [0, cfg.n_layers - 1], f"kept K5 calls {sorted(layers)}")
    del kept
    FA.reset_launches()
    with unittest.mock.patch.object(kops, "flash_attention", one_launch_slices):
        sliced_tokens = greedy_generate(cfg, model, prompts, ROWS_NEW, eager=True)
    sliced_counts = {"launches": FA.LAUNCHES["flash_attention"], "chunks": FA.CHUNKS["flash_attention"]}
    check(sliced_counts["launches"] == sliced_counts["chunks"] > cfg.n_layers
          and torch.equal(sliced_tokens, tokens),
          f"{cfg.name} at batch {ROWS_BATCH}: tokens with K5 in one-launch slices "
          f"({sliced_counts}) differ from the chunked route's")
    log(f"  {cfg.name} at batch {ROWS_BATCH}: tokens with every K5 call in one-launch slices "
        f"({sliced_counts}) == the chunked route's bit for bit")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()  # the checks' copies and slices are not serving's
    routes = [timed_generate(cfg, model, prompts, ROWS_NEW, eager) for eager in (False, True)]
    check(graphs.STATS["captures"] == 0, f"{cfg.name} at batch {ROWS_BATCH}: a timed request "
                                         f"captured a graph")
    for r in routes:
        check(torch.equal(r.pop("tokens"), tokens),
              f"{cfg.name} at batch {ROWS_BATCH} ({r['route']}): the timed tokens differ")
    peak = max(peak, torch.cuda.max_memory_allocated())
    row = {"arch": cfg.name, "batch": ROWS_BATCH, "prompt": ROWS_PROMPT, "new_tokens": ROWS_NEW,
           "head_rows": ROWS_BATCH * cfg.n_heads, "chunks_per_call": chunks,
           "flash_runs_per_prefill": runs["flash_attention"], "eager_counts": eager_counts,
           "graph_tokens_equal_eager": True, "layers_vs_plain": layers,
           "one_launch_slices_counts": sliced_counts, "tokens_equal_one_launch_slices": True,
           "peak_bytes": peak, "graphs": captured,
           "routes": routes, "sample_ids": tokens[0, :16].tolist()}
    log(f"  {cfg.name} bf16, {cfg.n_layers} layers, {ROWS_BATCH} x {ROWS_PROMPT} + {ROWS_NEW}: "
        f"{row['head_rows']} head rows a prefill attention, {chunks} chunks a K5 call; K5 runs "
        f"{runs['flash_attention']} a prefill replay, eager counts {eager_counts}; graph tokens "
        f"== eager tokens; peak {peak} bytes ({smi})")
    for r in routes:
        log_route("route", r)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return row


def head_rows_phase(cfg, timer, smi: str) -> dict:
    """Phase 6r: K5's forward and backward past 65,535 head rows against
    their plain versions, qwen3-1.7b served at batch ROWS_BATCH, and K5
    timed again at qwen3's prefill shape and hymba's window (one chunk
    each) beside phase 6's and phase 8's."""
    t0 = time.perf_counter()
    forward = check_head_rows_forward(timer)
    backward = check_head_rows_backward(timer)
    served = serve_head_rows(cfg, smi)
    timed = time_flash(timer, [(FLASH_TIMED[0], f"{LM_ARCH} prefill attention"),
                               (16, "hymba-1.5b prefill attention")])
    for idx, row in zip((FLASH_TIMED[0], 16), timed):
        shape = FLASH_SHAPES[idx]
        check(len(FA.head_row_chunks(shape[0], shape[1])) == 1, f"{shape} is not one chunk")
    return {"forward": forward, "backward": backward, "served": served, "flash_timing": timed,
            "seconds": time.perf_counter() - t0}


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
        _, n_bytes = QD.work(G, B, n_dest, capacity)
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
    decode and prefill graphs are captured first, the prefill graph held to
    the eager route bit for bit; then ``greedy_generate`` with the kernels
    that ran counted from 0 (K4 and K5 in the prefill's replay, K4 in every
    replayed step); the eager route's tokens equal; then one request timed
    on each route (graph, eager, graph, eager) through the serve loop's
    units, one K4 run per layer per step counted after each step, the
    dropped share copied out after each step, tokens held against
    greedy_generate's, and no capture."""
    model = lm.init_params(cfg, seed=0, device="cuda")
    prompts = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (MOE_BATCH, MOE_PROMPT))).cuda()
    L = cfg.n_layers
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    captured = capture_serving_graphs(cfg, model, prompts, (), MOE_PROMPT + MOE_NEW)
    capture_wall_s = captured["capture_wall_s"]
    prefill_check = check_prefill_routes(cfg, model, prompts, (), MOE_PROMPT + MOE_NEW)
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
    check(k5_launches == L == graphs.REPLAYED["flash_attention"],
          f"MoE serving: {k5_launches} K5 launches for one prefill of {L} layers")
    check(k4_launches == L * MOE_NEW == k4_replayed,
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
        "capture_wall_s": capture_wall_s, "graphs": captured, "prefill_graph": prefill_check,
        "eager_prefill_s": eager["prefill_s"], "eager_prefill_tok_per_s": eager["prefill_tok_per_s"],
        "eager_prefill_profile": eager["prefill_profile"],
        **{k: graph[k] for k in ("prefill_s", "prefill_tok_per_s", "decode_steps",
                                 "decode_ms_per_step", "decode_tok_per_s", "decode_profile",
                                 "prefill_profile", "prefill_dropped_share",
                                 "decode_dropped_share")},
        "decode_kernels_per_step": graph["decode_profile"]["device_events_per_call"],
        "routes": routes, "graph_tokens_equal_eager": True,
        "sample_ids": tokens[0, :16].tolist(),
    }
    log(f"  {cfg.name} bf16, {L} of {row['published_layers']} layers, {MOE_BATCH} x {MOE_PROMPT} + "
        f"{MOE_NEW}: decode and prefill graphs captured in {capture_wall_s!r} s (warm-ups "
        f"included); K4 runs {k4_launches} ({k4_replayed} of them replayed: one per "
        f"layer per prefill and decode step), K5 runs {k5_launches}; graph tokens == eager "
        f"tokens, dropped shares equal; graph: prefill {graph['prefill_s']!r} s "
        f"({graph['prefill_tok_per_s']!r} tok/s), decode {graph['decode_ms_per_step']!r} ms/step; "
        f"eager: prefill {eager['prefill_s']!r} s, decode {eager['decode_ms_per_step']!r} ms/step; "
        f"dropped share {row['prefill_dropped_share']!r} (prefill), "
        f"{row['decode_dropped_share']!r} (decode), peak {peak} bytes, every logit finite ({smi})")
    log_prefill_graph(cfg, captured, routes, smi)
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


# ------------------------------------------------------- phase 8: families
def families_phase(timer, smi: str) -> dict:
    """Phase 8: mamba2, hymba, seamless-m4t and internvl2 at their published
    width and depth, one model alive at a time: the fp32 checks, the bf16
    check (the families with attention), the bf16 serving run; then K5
    timed at hymba's and seamless's encoder shapes."""
    out = {"fp32": [], "bf16": [], "served": []}
    for arch, (published, k5) in FAMILY_ARCHS.items():
        cfg = get_config(arch)
        got = (cfg.n_layers, cfg.encoder_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
               cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size, cfg.ssm_state,
               cfg.ssm_heads if cfg.ssm_state else 0, cfg.sliding_window, cfg.frontend_len,
               cfg.dtype)
        check(got == published, f"{arch} is not at its published width and depth: {got}")
        log(f"  {arch} ({cfg.family}): {cfg.n_params()} parameters, {k5} K5 launches a prefill")
        t0 = time.perf_counter()
        out["fp32"].append(check_full_model_fp32(cfg, smi, k5))
        if cfg.has_attention:
            out["bf16"].append(check_full_model_bf16(cfg, smi, k5))
        out["served"].append(serve_lm(cfg, smi, k5))
        log(f"    {arch} done in {time.perf_counter() - t0!r} s")
    out["flash_timing"] = time_flash(timer, FAMILY_FLASH_TIMED)
    return out


# ------------------------------------------------------------ phase 9: training
def bwd_operands(shape, dtype, seed: int):
    """q, k, v (``flash_operands``) and an output gradient of q's shape."""
    q, k, v = flash_operands(shape, dtype, seed)
    gen = torch.Generator(device="cuda").manual_seed(1000 + seed)
    return q, k, v, torch.randn(q.shape, generator=gen, device="cuda").to(dtype)


def check_flash_bwd() -> list:
    """K5's backward against its plain version at every FLASH_SHAPES shape,
    fp32 and bf16, from the same saved tensors (the kernel forward's output
    and lse): dq, dk and dv within BWD_TOL, each also within BWD_NORM_TOL
    in norm, and the forward's lse against ``flash_attention_lse_ref``'s
    (-inf exactly where a row sees no key).  Fails on any element outside
    the tolerance."""
    rows = []
    for i, shape in enumerate(FLASH_SHAPES):
        _, _, Sq, Skv, d, causal, window = shape
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, dout = bwd_operands(shape, dtype, seed=i)
            out, lse = FA.flash_attention_cuda(q, k, v, causal=causal, window=window, with_lse=True)
            _, lse_want = ref.flash_attention_lse_ref(q, k, v, causal=causal, window=window)
            got = FA.flash_attention_bwd_cuda(q, k, v, out, dout, lse, causal=causal, window=window)
            want = ref.flash_attention_bwd_ref(q, k, v, out, dout, lse, causal=causal, window=window)
            tol = BWD_TOL[dtype]
            row = {"shape": list(shape), "dtype": str(dtype).replace("torch.", ""), "tol": tol}
            empty = ~torch.isfinite(lse_want)
            check(bool((lse[empty] == float("-inf")).all()),
                  f"K5 {shape} {dtype}: a row that sees no key has a finite lse")
            for name, g, w in (("lse", lse[~empty], lse_want[~empty]),
                               *zip(("dq", "dk", "dv"), got, want)):
                diff = (g.float() - w.float()).abs()
                bad = int((diff > tol + tol * w.float().abs()).sum())
                w_norm = float(w.float().norm())
                check(w_norm > 0, f"K5 backward {shape} {dtype}: the plain {name} is all zero")
                row[name] = {"mismatches": bad,
                             "max_abs_err": float(diff.max()) if diff.numel() else 0.0,
                             "rel_norm_err": float(diff.norm()) / w_norm}
            log(f"  K5 backward {shape} {row['dtype']}: " + ", ".join(
                f"{n} mismatches {row[n]['mismatches']} max_abs_err {row[n]['max_abs_err']!r} "
                f"rel_norm_err {row[n]['rel_norm_err']!r}"
                for n in ("dq", "dk", "dv", "lse")) + f" (tolerance atol = rtol = {tol}, "
                f"in norm {BWD_NORM_TOL[dtype]})")
            for n in ("dq", "dk", "dv", "lse"):
                check(row[n]["mismatches"] == 0,
                      f"K5 backward {shape} {dtype}: {row[n]['mismatches']} {n} elements outside "
                      f"the tolerance")
                check(row[n]["rel_norm_err"] <= BWD_NORM_TOL[dtype],
                      f"K5 backward {shape} {dtype}: {n} differs by {row[n]['rel_norm_err']!r} "
                      f"in norm")
            rows.append(row)
            del q, k, v, dout, out, lse, lse_want, got, want
    return rows


def train_check_inputs(cfg, seed: int) -> tuple:
    """One sequence of TRAIN_CHECK_SEQ tokens and its labels (numpy), and
    the stub frontend's embeddings where the config has one."""
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (1, TRAIN_CHECK_SEQ + 1))
    toks = torch.from_numpy(toks).cuda()
    return toks[:, :-1], toks[:, 1:], frontend_embeds(cfg, 1, TRAIN_CHECK_SEQ, seed=seed + 1)


def k5_per_forward(cfg) -> int:
    """K5's launches in one forward: each self-attention, and for encdec the
    encoder's layers and each decoder layer's cross-attention."""
    if not cfg.has_attention:
        return 0
    return cfg.n_layers + (cfg.encoder_layers + cfg.n_layers if cfg.family == "encdec" else 0)


def check_train_grads(cfg, smi: str) -> dict:
    """``forward_train`` in fp32 on one sequence (``train_check_inputs``):
    every parameter's gradient on the flash route (K5 with its lse, then
    K5's backward; with remat the forward runs again in the backward)
    against the naive route's, max |flash - naive| / max |naive| per tensor
    at most TRAIN_GRAD_TOL; every parameter gets a gradient on the flash
    route; the launches: K5's forward 2 a layer's attention (remat), its
    backward 1, K4 2 a MoE layer, none on the naive route but K4's."""
    cfg32 = dataclasses.replace(cfg, dtype="float32", attention_impl="flash")
    naive = dataclasses.replace(cfg32, attention_impl="naive")
    check(cfg32.remat, f"{cfg.name}: the check expects remat")
    model = lm.init_params(cfg32, seed=0, device="cuda", trainable=True)
    tokens, labels, fe = train_check_inputs(cfg32, seed=21)

    def run(c):
        for p in model.parameters():
            p.grad = None
        FA.reset_launches()
        QD.reset_launches()
        loss, metrics = lm.forward_train(c, model, tokens, labels, *fe)
        loss.backward()
        torch.cuda.synchronize()
        missing = [n for n, p in model.named_parameters() if p.grad is None]
        check(not missing, f"{cfg.name} {c.attention_impl} route: no gradient reached {missing}")
        launches = {**FA.LAUNCHES, **QD.LAUNCHES}
        grads = {n: p.grad for n, p in model.named_parameters()}
        return float(loss.detach()), float(metrics["moe_dropped"]), grads, launches

    t0 = time.perf_counter()
    loss_f, dropped_f, g_flash, launches = run(cfg32)
    n_attn = k5_per_forward(cfg32)
    n_moe = cfg32.n_layers if cfg32.family == "moe" else 0
    want = {"flash_attention": 2 * n_attn, "flash_attention_bwd": n_attn, "queue_dispatch": 2 * n_moe}
    check(launches == want, f"{cfg.name} flash route launches {launches}, want {want}")
    loss_n, dropped_n, g_naive, naive_launches = run(naive)
    want_naive = {**want, "flash_attention": 0, "flash_attention_bwd": 0}
    check(naive_launches == want_naive,
          f"{cfg.name} naive route launches {naive_launches}, want {want_naive}")
    rel = {n: float((g_flash[n] - g_naive[n]).abs().max() / g_naive[n].abs().max().clamp_min(1e-30))
           for n in g_naive}
    worst = sorted(rel.items(), key=lambda kv: -kv[1])
    loss_rel = abs(loss_f - loss_n) / abs(loss_n)
    row = {"arch": cfg.name, "layers": cfg.n_layers, "seq": TRAIN_CHECK_SEQ, "loss_flash": loss_f,
           "loss_naive": loss_n, "loss_rel_err": loss_rel, "moe_dropped": dropped_f,
           "launches": launches, "tensors": len(rel), "max_rel_err": worst[0][1],
           "worst": worst[:5], "rel_err": rel, "tol": TRAIN_GRAD_TOL,
           "seconds": time.perf_counter() - t0}
    log(f"  fp32 gradients {cfg.name}, {cfg.n_layers} layers, 1 x {TRAIN_CHECK_SEQ}: loss flash "
        f"{loss_f!r} naive {loss_n!r} (rel {loss_rel!r}), moe_dropped {dropped_f!r} / "
        f"{dropped_n!r}; {len(rel)} tensors, every one with a gradient; largest relative "
        f"error per tensor {worst[0][1]!r} ({worst[0][0]}), then "
        f"{[(n, e) for n, e in worst[1:4]]} (tolerance {TRAIN_GRAD_TOL}); launches {launches} "
        f"in {row['seconds']!r} s ({smi})")
    check(loss_rel <= TRAIN_GRAD_TOL, f"{cfg.name}: the routes' losses differ by {loss_rel!r}")
    check(worst[0][1] <= TRAIN_GRAD_TOL,
          f"{cfg.name}: gradient of {worst[0][0]} differs by {worst[0][1]!r} (relative)")
    del model, g_flash, g_naive
    torch.cuda.empty_cache()
    return row


def bf16_grad_rule(cfg, model, inputs, route) -> dict:
    """The rule of every bf16 route of the gradient, on ``model``'s bf16
    weights (``cfg``: bf16, remat) at ``inputs`` (``train_check_inputs``):
    the naive route in fp32 (the weights copied) and in bf16, and
    ``route()`` -> (loss, name -> gradient), the route under test.  Over
    every parameter's gradient, the RMS of (route - naive fp32) at most
    TRAIN_BF16_GRAD_RATIO times that of (naive bf16 - naive fp32); the
    tensor whose own ratio is largest is reported."""
    naive = dataclasses.replace(cfg, attention_impl="naive")
    naive32 = dataclasses.replace(naive, dtype="float32")

    def grads(c, m) -> tuple:
        loss, _ = lm.forward_train(c, m, *inputs[:2], *inputs[2])
        loss.backward()
        out = {n: p.grad for n, p in m.named_parameters()}
        for p in m.parameters():
            p.grad = None
        return float(loss.detach()), out

    model32 = lm.init_params(naive32, seed=0, device="cuda", trainable=True)
    with torch.no_grad():
        for p32, p in zip(model32.parameters(), model.parameters()):
            p32.copy_(p)
    loss_32, g_32 = grads(naive32, model32)
    del model32
    torch.cuda.empty_cache()

    def sq_dist(g: dict) -> dict:
        missing = sorted(set(g_32) - {n for n, t in g.items() if t is not None})
        check(not missing, f"{cfg.name}: no gradient reached {missing}")
        check(all(bool(torch.isfinite(g[n]).all()) for n in g_32), f"{cfg.name}: a gradient is "
              f"not finite")
        return {n: float((g[n].float() - w).pow(2).sum()) for n, w in g_32.items()}

    loss_n, g = grads(naive, model)
    check(not any(FA.LAUNCHES.values()), f"{cfg.name}: the naive bf16 route launched K5")
    d_naive = sq_dist(g)
    loss_r, g = route()
    d_route = sq_dist(g)
    del g, g_32
    torch.cuda.empty_cache()
    n_elems = sum(p.numel() for p in model.parameters())
    rms = {"route": (sum(d_route.values()) / n_elems) ** 0.5,
           "naive": (sum(d_naive.values()) / n_elems) ** 0.5}
    per_tensor = {n: (d / d_naive[n]) ** 0.5 if d_naive[n] > 0 else (0.0 if d == 0 else float("inf"))
                  for n, d in d_route.items()}
    worst = max(per_tensor.items(), key=lambda kv: kv[1])
    ratio = rms["route"] / rms["naive"]
    check(ratio <= TRAIN_BF16_GRAD_RATIO, f"{cfg.name} bf16 gradients: the route is {ratio!r} times "
          f"as far from fp32 as the naive route (RMS {rms})")
    return {"seq": TRAIN_CHECK_SEQ, "loss_route": loss_r, "loss_naive_bf16": loss_n,
            "loss_naive_fp32": loss_32, "route_vs_fp32_rms": rms["route"],
            "naive_vs_fp32_rms": rms["naive"], "rms_ratio": ratio,
            "tol_ratio": TRAIN_BF16_GRAD_RATIO, "tensors": len(per_tensor),
            "worst_tensor": worst[0], "worst_tensor_ratio": worst[1]}


def check_train_grads_bf16(cfg, smi: str) -> dict:
    """``bf16_grad_rule`` at full width and depth for the flash route in
    bf16 (K5's bf16 forward and ``flash_bwd_bf16_kernel``); the launches:
    K5's forward twice a layer (remat), its backward once, none on the
    naive routes."""
    check(cfg.dtype == "bfloat16" and cfg.remat, f"{cfg.name}: the check expects bf16 and remat")
    flash = dataclasses.replace(cfg, attention_impl="flash")
    model = lm.init_params(flash, seed=0, device="cuda", trainable=True)
    inputs = train_check_inputs(flash, seed=22)
    n_attn = k5_per_forward(cfg)
    launches = {}

    def route() -> tuple:
        FA.reset_launches()
        loss, _ = lm.forward_train(flash, model, *inputs[:2], *inputs[2])
        loss.backward()
        torch.cuda.synchronize()
        launches.update(FA.LAUNCHES)
        g = {n: p.grad for n, p in model.named_parameters()}
        for p in model.parameters():
            p.grad = None
        return float(loss.detach()), g

    t0 = time.perf_counter()
    FA.reset_launches()
    row = {"arch": cfg.name, "layers": cfg.n_layers, **bf16_grad_rule(cfg, model, inputs, route)}
    want = {"flash_attention": 2 * n_attn, "flash_attention_bwd": n_attn}
    check(launches == want, f"{cfg.name} bf16 flash route launches {launches}, want {want}")
    row.update(launches=launches, seconds=time.perf_counter() - t0)
    log(f"  bf16 gradients {cfg.name}, {cfg.n_layers} layers, 1 x {TRAIN_CHECK_SEQ}: against the "
        f"fp32 naive route, flash bf16 RMS {row['route_vs_fp32_rms']!r}, naive bf16 RMS "
        f"{row['naive_vs_fp32_rms']!r}; ratio {row['rms_ratio']!r} (tolerance "
        f"{TRAIN_BF16_GRAD_RATIO}); worst tensor {row['worst_tensor']} at "
        f"{row['worst_tensor_ratio']!r}; losses flash bf16 {row['loss_route']!r}, naive bf16 "
        f"{row['loss_naive_bf16']!r}, naive fp32 {row['loss_naive_fp32']!r}; launches {launches} in "
        f"{row['seconds']!r} s ({smi})")
    del model
    torch.cuda.empty_cache()
    return row


def train_tcfg(compression=None) -> TrainConfig:
    """The TrainConfig of phase 9's bf16 run, which phase 9c (c) repeats."""
    return TrainConfig(warmup_steps=max(10, TRAIN_STEPS // 20), total_steps=TRAIN_STEPS,
                       compression=compression)


def train_steps(step, state, pipe, steps: int, route: str, want: dict) -> tuple:
    """``steps`` steps of ``step`` on the pipeline's batches 0.., each timed
    by the host clock around a synchronised step whose metrics the host
    reads: per step the metrics, ms, tok/s, the kernels that ran
    (``graphs.kernel_runs()``: eager launches and replays' kernels) and the
    graphs captured; the metrics finite and the kernels ``want``.
    Returns (state, rows)."""
    rows = []
    for s in range(steps):
        tokens, labels = batch_on_card(pipe, s)
        runs, captures = graphs.kernel_runs(), graphs.STATS["captures"]
        torch.cuda.synchronize()
        t_step = time.perf_counter()
        state, metrics = step(state, tokens, labels)
        m = {k: float(v) for k, v in metrics.items()}  # the host reads the step's metrics
        ms = (time.perf_counter() - t_step) * 1e3
        got = {k: n - runs[k] for k, n in graphs.kernel_runs().items() if n != runs[k]}
        rows.append({"step": s, **m, "ms": ms,
                     "tok_per_s": tokens.numel() / ms * 1e3, "launches": got,
                     "captures": graphs.STATS["captures"] - captures})
        log(f"    {route} step {s}: loss {m['loss']!r} grad_norm {m['grad_norm']!r} lr {m['lr']!r} "
            f"{ms!r} ms ({rows[-1]['tok_per_s']!r} tok/s); kernels that ran {got}; "
            f"{rows[-1]['captures']} graphs captured")
        check(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]),
              f"{route} train step {s}: loss {m['loss']} grad_norm {m['grad_norm']}")
        check(got == want, f"{route} train step {s}: kernels that ran {got}, want {want}")
    return state, rows


def check_graph_steps(graph: list, ref, label: str) -> dict:
    """A graphed run's steps: one capture, in step 0, whose warm-up is that
    step; with ``ref`` (the same steps from the same init on another route)
    every loss and grad norm equal bit for bit: the train step is a pure
    function, on every route."""
    captures = [r["captures"] for r in graph]
    check(captures == [1] + [0] * (len(graph) - 1),
          f"{label}: captures per step {captures}, want one in step 0")
    if ref is not None:
        check(metrics_of(graph) == metrics_of(ref), f"{label}: (loss, grad norm) a step "
              f"{metrics_of(graph)}, the reference's {metrics_of(ref)}")
        log(f"    {label}: every loss and grad norm equal to the reference's bit for bit")
    return {"captures": captures, "equal_bit_for_bit": ref is not None}


def metrics_of(steps: list) -> list:
    """Each step's (loss, grad norm)."""
    return [(r["loss"], r["grad_norm"]) for r in steps]


def host_copies(tensors) -> list:
    """The tensors' bits on the host, to hold a later run to."""
    return [t.detach().cpu() for t in tensors]


def check_same_bits(label: str, got, want: list) -> int:
    """Every tensor of ``got`` equal to its host copy in ``want``, bit for
    bit; returns how many were compared."""
    got = list(got)
    check(len(got) == len(want), f"{label}: {len(got)} tensors, want {len(want)}")
    differ = [i for i, (g, w) in enumerate(zip(got, want)) if not torch.equal(g.detach().cpu(), w)]
    check(not differ, f"{label}: {len(differ)} of {len(want)} tensors differ, the first at index "
          f"{differ[:1]}")
    return len(want)


def train_lm(cfg, smi: str) -> dict:
    """The bf16 training run, TRAIN_STEPS steps on TokenPipeline's batches
    from the seed-0 state on each route, every kernel count set to 0
    first.  The eager route first: per step the loss and gradient norm
    finite, the launches as the design says; the first loss within
    FIRST_LOSS_TOL of the uniform stream's expected loss at init; the
    parameters changed; one more step profiled (K5's device kernels
    counted exactly: no graph of the phase is alive yet).  Then the graph
    route, the main path (``make_train_step`` on the card): step 0 the
    capture (its warm-up is the step), the others replays, the kernels
    that ran as the eager route's in every step, every loss and grad norm
    the eager route's bit for bit; the pool's bytes, the peak memory under the
    card's; one replayed step profiled (host launch calls, idle share)."""
    tcfg = train_tcfg()
    pipe = TokenPipeline(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH)
    n_attn = k5_per_forward(cfg)
    per_step_want = {"flash_attention": 2 * n_attn, "flash_attention_bwd": n_attn}
    check(cfg.param_dtype == torch.bfloat16, f"the training run is bf16, not {cfg.param_dtype}")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(cfg, tcfg, seed=0, device="cuda")
    init_s = time.perf_counter() - t0
    named = dict(state.params.named_parameters())
    index = {n: i for i, n in enumerate(named)}
    # The matrices' bf16 copies and every watched tensor's fp32 master must
    # move; a norm scale's bf16 copy need not (1 - 1e-4 rounds to 1 in bf16).
    watched = {n: (named[n].detach().clone(), state.opt.master[index[n]].clone())
               for n in ("embed", "layers.0.attn.wq", "layers.27.mlp.w_down", "final_norm")}
    for reset in (FA.reset_launches, QD.reset_launches, K.reset_launches, graphs.reset):
        reset()
    eager_step = make_train_step(cfg, tcfg, eager=True)
    state, eager_steps = train_steps(eager_step, state, pipe, TRAIN_STEPS, "eager", per_step_want)
    expected0 = float(np.log(cfg.vocab_size) + lm.INIT_SCALE ** 2 * cfg.d_model / 2)
    first = eager_steps[0]["loss"]
    check(abs(first - expected0) <= FIRST_LOSS_TOL,
          f"first loss {first!r}, want {expected0!r} +- {FIRST_LOSS_TOL}")
    changed = {n: (float((named[n].detach().float() - w.float()).abs().max()),
                   float((state.opt.master[index[n]] - m).abs().max()))
               for n, (w, m) in watched.items()}
    check(all(m > 0 and (w > 0 or n == "final_norm") for n, (w, m) in changed.items()),
          f"a watched parameter did not move (bf16 copy, fp32 master): {changed}")
    eager_peak = torch.cuda.max_memory_allocated()
    check(eager_peak < TRAIN_PEAK_BYTES, f"training peak memory {eager_peak} bytes")
    tokens, labels = batch_on_card(pipe, TRAIN_STEPS)
    # the device kernels of K5's launches in one step, read from the trace
    expect = {FWD_BF16_KERNEL: per_step_want["flash_attention"],
              **{k: per_step_want["flash_attention_bwd"] for k in BWD_BF16_KERNELS},
              **{k: 0 for k in BWD_FP32_KERNELS}}
    profile = profile_calls(lambda: eager_step(state, tokens, labels), 1, expect=expect)
    log_call_profile("bf16 train step (eager)", profile)
    counts = profile["counts"]
    check(counts == expect, f"the profiled train step's K5 device kernels {counts}, want {expect} "
          f"({profile['traces']} traces)")
    del state, eager_step, named, watched
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(cfg, tcfg, seed=0, device="cuda")
    step = make_train_step(cfg, tcfg)
    for reset in (FA.reset_launches, QD.reset_launches, K.reset_launches, graphs.reset):
        reset()
    state, graph_steps = train_steps(step, state, pipe, TRAIN_STEPS, "graph", per_step_want)
    versus = check_graph_steps(graph_steps, eager_steps, "the graphed train steps vs the eager ones")
    launches = graphs.kernel_runs()
    check(launches["flash_attention"] > 0 and launches["flash_attention_bwd"] > 0,
          f"the training run did not go through K5 and its backward: {launches}")
    check(not any(n for k, n in launches.items() if k not in per_step_want),
          f"the dense training run launched another kernel: {launches}")
    peak = torch.cuda.max_memory_allocated()
    check(peak < TRAIN_PEAK_BYTES, f"training peak memory (graph route) {peak} bytes")
    pool, capture_s = graphs.STATS["pool_bytes"], graphs.STATS["capture_s"]
    graph_profile = profile_calls(lambda: step(state, tokens, labels), 1)
    log_call_profile("bf16 train step (graph replay)", graph_profile)

    def median(rows, key):
        return float(np.median([r[key] for r in rows[1:] or rows]))

    row = {"arch": cfg.name, "layers": cfg.n_layers, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "steps": eager_steps, "graph_steps": graph_steps, "graph_vs_eager": versus,
           "init_s": init_s, "launches": launches, "per_step_launches": per_step_want,
           "first_loss": first, "expected_first_loss": expected0,
           "ln_v": float(np.log(cfg.vocab_size)), "changed": changed,
           "eager_peak_bytes": eager_peak, "peak_bytes": peak, "pool_bytes": pool,
           "capture_s": capture_s, "step_ms": median(graph_steps, "ms"),
           "tok_per_s": median(graph_steps, "tok_per_s"),
           "eager_step_ms": median(eager_steps, "ms"),
           "eager_tok_per_s": median(eager_steps, "tok_per_s"),
           "profile": profile, "graph_profile": graph_profile, "device_kernel_counts": counts,
           "bwd_device_kernels_per_launch": (sum(counts[k] for k in BWD_BF16_KERNELS)
                                             / per_step_want["flash_attention_bwd"])}
    log(f"    first loss {first!r}: expected {expected0!r} (ln V {row['ln_v']!r} + INIT_SCALE^2 "
        f"d_model / 2), |diff| {abs(first - expected0)!r} (tolerance {FIRST_LOSS_TOL}); "
        f"largest change (bf16 copy, fp32 master) {changed}; steady step (median of steps "
        f"1..{TRAIN_STEPS - 1}): graph {row['step_ms']!r} ms ({row['tok_per_s']!r} tok/s), eager "
        f"{row['eager_step_ms']!r} ms ({row['eager_tok_per_s']!r} tok/s); the graph's steps == the "
        f"eager route's; capture {capture_s!r} s, pool {pool} bytes; peak memory: graph "
        f"route {peak} bytes, eager {eager_peak}; kernels that ran on the graph route {launches}; "
        f"a replayed step: {graph_profile['host_launches_per_call']!r} host launch calls, idle "
        f"share {graph_profile['idle_share']!r}; an eager step: "
        f"{profile['host_launches_per_call']!r}, {profile['idle_share']!r} ({smi})")
    log(f"    K5's device kernels in the profiled eager step {counts} (want {expect}): "
        f"{row['bwd_device_kernels_per_launch']!r} a backward launch")
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return row


def train_moe_graph(smi: str) -> dict:
    """The graphed train step with K4 inside: mixtral-8x7b at its published
    width cut to TRAIN_CHECK_LAYERS layers, bf16 with remat, MOE_TRAIN_STEPS
    steps of TRAIN_BATCH x TRAIN_CHECK_SEQ tokens from the seed-0 state
    twice on the eager route and through the graph: the eager runs equal in
    every loss, grad norm and parameter, bit for bit (the step is a pure
    function, the MoE gathers' backward too), and so is the graph's every
    loss and grad norm; each step runs K4 and K5's forward once a layer and
    once more in remat's recompute, K5's backward once a layer."""
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=TRAIN_CHECK_LAYERS)
    tcfg = train_tcfg()
    pipe = TokenPipeline(cfg.vocab_size, TRAIN_CHECK_SEQ, TRAIN_BATCH)
    again = 1 + cfg.remat
    want = {"flash_attention": again * cfg.n_layers, "flash_attention_bwd": cfg.n_layers,
            "queue_dispatch": again * cfg.n_layers}
    t0 = time.perf_counter()
    runs, params = {}, None
    for route in ("eager", "eager again", "graph"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        graphs.reset()
        state = init_train_state(cfg, tcfg, seed=0, device="cuda")
        step = make_train_step(cfg, tcfg, eager=route != "graph")
        state, rows = train_steps(step, state, pipe, MOE_TRAIN_STEPS, f"{cfg.name} {route}", want)
        runs[route] = {"steps": rows, "peak_bytes": torch.cuda.max_memory_allocated(),
                       "pool_bytes": graphs.STATS["pool_bytes"]}
        if route == "eager":
            params = host_copies(state.params.parameters())
        elif route == "eager again":
            check(metrics_of(rows) == metrics_of(runs["eager"]["steps"]),
                  f"{cfg.name}: a second eager run's (loss, grad norm) {metrics_of(rows)}")
            runs[route]["parameters_equal"] = check_same_bits(
                f"{cfg.name}: the second eager run's parameters", state.params.parameters(), params)
        del state, step
    del params
    gc.collect()
    torch.cuda.empty_cache()
    eager, graph = runs["eager"]["steps"], runs["graph"]["steps"]
    versus = check_graph_steps(graph, eager, f"{cfg.name} graphed train steps vs the eager route")
    row = {"arch": cfg.name, "layers": cfg.n_layers, "batch": TRAIN_BATCH, "seq": TRAIN_CHECK_SEQ,
           "runs": runs, "versus_eager": versus, "per_step_launches": want,
           "seconds": time.perf_counter() - t0}
    log(f"    {cfg.name} at {cfg.n_layers} layers, {TRAIN_BATCH} x {TRAIN_CHECK_SEQ}: two eager runs "
        f"equal bit for bit ({runs['eager again']['parameters_equal']} parameters), and the graph's "
        f"steps; kernels a step {want} on both routes; step ms graph "
        f"{[r['ms'] for r in graph]}, eager {[r['ms'] for r in eager]}; pool "
        f"{runs['graph']['pool_bytes']} bytes, peak {runs['graph']['peak_bytes']} bytes; "
        f"{row['seconds']!r} s ({smi})")
    return row


def time_flash_bwd(timer) -> list:
    """K5's backward in bf16 at BWD_TIMED's shapes beside its plain version,
    the backward of scaled_dot_product_attention (``enable_gqa``; an
    explicit mask where a window cuts the causal one; the backend its
    forward chose named) and its bound (``FA.backward_work``): BWD_FLOP_FACTOR
    times the forward's operations over the bf16 tensor-core rate, or the
    bytes (q, k, v, o, dO, lse read; dq, dk, dv written) over the memory
    rate, the larger."""
    rows = []
    for idx, label in BWD_TIMED:
        shape = FLASH_SHAPES[idx]
        BH, BHkv, Sq, Skv, d, causal, window = shape
        q, k, v, dout = bwd_operands(shape, torch.bfloat16, seed=98)
        out, lse = FA.flash_attention_cuda(q, k, v, causal=causal, window=window, with_lse=True)
        run = functools.partial(FA.flash_attention_bwd_cuda, q, k, v, out, dout, lse,
                                causal=causal, window=window)
        plain = functools.partial(ref.flash_attention_bwd_ref, q, k, v, out, dout, lse,
                                  causal=causal, window=window)
        err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(run(), plain()))
        B = LM_BATCH
        q4, k4, v4 = (t.view(B, t.shape[0] // B, t.shape[1], d).detach().requires_grad_()
                      for t in (q, k, v))
        g4 = dout.view(B, BH // B, Sq, d)
        sdpa = functools.partial(torch.nn.functional.scaled_dot_product_attention, q4, k4, v4,
                                 enable_gqa=True, **sdpa_mask(Sq, Skv, causal, window))
        lib_out = sdpa()
        backend = sdpa_backend(lambda: sdpa().detach(), lib_out.detach())
        lib_grads = torch.autograd.grad(lib_out, (q4, k4, v4), g4, retain_graph=True)
        lib_err = max(float((a.reshape(b.shape).float() - b.float()).abs().max())
                      for a, b in zip(lib_grads, plain()))
        flop, n_bytes = FA.backward_work(BH, BHkv, Sq, Skv, d, causal, window, q.element_size())
        row = {
            "config": label, "shape": list(shape), "dtype": "bfloat16",
            "ms": timer(run),
            "plain_ms": timer(plain, reps=5),
            "library_ms": timer(lambda: torch.autograd.grad(lib_out, (q4, k4, v4), g4,
                                                            retain_graph=True)),
            "library_backend": backend,
            "flop": flop, "bytes": n_bytes,
            "flop_ms": flop / BF16_FLOP_PER_S * 1e3, "bytes_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
            "max_abs_err": err, "library_max_abs_err": lib_err,
        }
        row["bound_ms"] = max(row["flop_ms"], row["bytes_ms"])
        row["bound_by"] = "operations" if row["flop_ms"] >= row["bytes_ms"] else "bytes"
        row["tflop_per_s"] = flop / row["ms"] * 1e-9
        # the launch's three device kernels, each launched alone and timed
        # as the launch is (CUDA events), each's share of their sum
        _, stages = FA.bwd_stage_calls(q, k, v, out, dout, lse, causal=causal, window=window)
        row["kernel_ms"] = {BWD_STAGE_KERNELS[name]: timer(fn) for name, fn in stages.items()}
        stages_ms = sum(row["kernel_ms"].values())
        row["kernel_share"] = {name: t / stages_ms for name, t in row["kernel_ms"].items()}
        main_ms = row["kernel_ms"]["flash_bwd_bf16_kernel"]
        row["main_tflop_per_s"] = flop / main_ms * 1e-9
        row["main_over_bound"] = main_ms / row["bound_ms"]
        log(f"  K5 backward {label} {shape} bf16: ms={row['ms']!r} plain_ms={row['plain_ms']!r} "
            f"library_ms={row['library_ms']!r} (sdpa backward, forward backend {backend}) "
            f"bound_ms={row['bound_ms']!r} ({row['bound_by']}: {flop!r} FLOP = "
            f"{FA.BWD_FLOP_FACTOR} x the forward's over {BF16_FLOP_PER_S:.3g}/s = {row['flop_ms']!r} "
            f"ms, {n_bytes} bytes over {HBM_BYTES_PER_S:.3g}/s = {row['bytes_ms']!r} ms; "
            f"{row['tflop_per_s']!r} TFLOP/s); max_abs_err vs plain {err!r}, sdpa vs plain "
            f"{lib_err!r}; each kernel alone, ms {row['kernel_ms']} (sum {stages_ms!r}), shares "
            f"{row['kernel_share']}; the main kernel "
            f"{row['main_tflop_per_s']!r} TFLOP/s, {row['main_over_bound']!r} x the bound")
        rows.append(row)
        del q, k, v, dout, out, lse, q4, k4, v4, g4, lib_out, lib_grads, stages
    return rows


def training_phase(resources: dict, timer, smi: str) -> dict:
    """Phase 9: K5's backward against its plain version; the fp32 gradient
    checks (qwen3-1.7b at full depth, the families with attention at 2
    layers); the bf16 training run of qwen3-1.7b; K5's backward timed."""
    t_phase = time.perf_counter()
    bwd_kernels = {k: v for k, v in resources.items() if k.startswith("flash_bwd")}
    for d in FA.HEAD_DIMS:
        for body in (f"flash_bwd_kernel<float,{d}>", f"flash_bwd_bf16_kernel<{d}>"):
            check(body in bwd_kernels,
                  f"ptxas reported no resources for {body}: {sorted(bwd_kernels)}")
        check(f"flash_bwd_kernel<bf16,{d}>" not in bwd_kernels,
              f"the old bf16 instantiation of flash_bwd_kernel is still built (d {d})")
        spills = bwd_kernels[f"flash_bwd_bf16_kernel<{d}>"][2]
        check(re.search(r"\b0 bytes spill stores, 0 bytes spill loads", spills) is not None,
              f"flash_bwd_bf16_kernel<{d}> spills: {spills!r}")
    smem = {str(dt).replace("torch.", ""): {d: FA.bwd_smem_bytes(d, dt) for d in FA.HEAD_DIMS}
            for dt in (torch.bfloat16, torch.float32)}
    check(all(n <= CTA_MAX_SMEM for body in smem.values() for n in body.values()),
          f"a backward body asks for more shared memory than a CTA can have: {smem}")
    log(f"    K5 backward kernels (registers, static shared memory, spills): {bwd_kernels}; "
        f"main kernels' dynamic shared memory per CTA by head dim: {smem}")
    out = {"bwd_checks": check_flash_bwd(), "bwd_smem_bytes": smem}
    cfg = get_config(LM_ARCH)
    out["grads"] = [check_train_grads(cfg, smi)]
    out["grads_bf16"] = check_train_grads_bf16(cfg, smi)
    for arch in TRAIN_FAMILY_ARCHS:
        fam = get_config(arch)
        out["grads"].append(check_train_grads(dataclasses.replace(
            fam, n_layers=TRAIN_CHECK_LAYERS,
            encoder_layers=TRAIN_CHECK_LAYERS if fam.family == "encdec" else 0), smi))
    log(f"    bf16 training run: {LM_ARCH}, {cfg.n_layers} layers, {TRAIN_BATCH} x {TRAIN_SEQ}, "
        f"{TRAIN_STEPS} steps of make_train_step on the eager route and then through its graph, "
        f"one of each profiled")
    out["trained"] = train_lm(cfg, smi)
    out["moe_graph"] = train_moe_graph(smi)
    out["bwd_timing"] = time_flash_bwd(timer)
    out["seconds"] = time.perf_counter() - t_phase
    return out


# ----------------------------------------- phase 9c: checkpoints, restart, DP
def batch_on_card(pipe, s: int) -> tuple:
    return tuple(torch.from_numpy(a).to("cuda", torch.int64) for a in pipe.batch_at(s))


def timed_step(step, state, batch) -> tuple:
    """One step whose metrics the host reads: (state, metrics as floats, ms)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = step(state, *batch)
    m = {k: float(v) for k, v in metrics.items()}
    return state, m, (time.perf_counter() - t0) * 1e3


def state_bytes(cfg) -> int:
    """A bf16 train state's checkpoint: the parameters in bf16, AdamW's
    master, mu and nu in fp32, the step."""
    return cfg.n_params() * (2 + 3 * 4) + 4


def check_restored(restored, snap) -> dict:
    """Every restored tensor against the host snapshot, bit for bit (bf16
    as uint16), one tensor at a time through the host."""
    t0 = time.perf_counter()
    leaves = ckpt_store.tree_leaves(restored)
    check([p for p, _ in leaves] == snap.paths, "the restored state's paths are not the snapshot's")
    tensors = 0
    for path, leaf in leaves:
        want = snap.arrays[path]
        parts = leaf.parts if isinstance(leaf, LayerStack) else [leaf]
        for i, t in enumerate(parts):
            got = t.detach().cpu()
            got = got.view(torch.int16).numpy().view(np.uint16) if got.dtype == torch.bfloat16 \
                else got.numpy()
            check(np.array_equal(got, want[i] if isinstance(leaf, LayerStack) else want),
                  f"restored {path}[{i}] differs from the snapshot")
            tensors += 1
    return {"tensors": tensors, "seconds": time.perf_counter() - t0}


def checkpoint_restore(cfg, smi: str) -> dict:
    """Phase 9c (a): save, a step during the write, restore, the bits, the
    restored step against the live one, bit for bit."""
    ckdir = tempfile.mkdtemp(prefix="phase9c-", dir=os.path.join(ROOT, "build"))
    try:
        free = shutil.disk_usage(ckdir).free
        full_layers = cfg.n_layers
        while state_bytes(cfg) * CKPT_DISK_MARGIN > free and cfg.n_layers > 1:
            cfg = dataclasses.replace(cfg, n_layers=cfg.n_layers - 1)
        check(state_bytes(cfg) * CKPT_DISK_MARGIN <= free,
              f"the disk under build/ has {free} bytes free: not one layer's checkpoint")
        log(f"    disk under build/: {free} bytes free; the checkpoint takes {state_bytes(cfg)} bytes "
            f"at {cfg.n_layers} layers" + ("" if cfg.n_layers == full_layers else
                                          f" (cut from {full_layers}: the disk holds no more)"))
        tcfg = TrainConfig(warmup_steps=10, total_steps=100)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        pipe = TokenPipeline(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH)
        state = init_train_state(cfg, tcfg, seed=0, device="cuda")
        step = make_train_step(cfg, tcfg)
        for s in range(CKPT_STEPS):
            state, _, _ = timed_step(step, state, batch_on_card(pipe, s))
        mgr = CheckpointManager(ckdir, keep=1, save_async=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        snap = mgr.save(CKPT_STEPS - 1, state, extra={"pipeline_step": CKPT_STEPS - 1})
        t_saved = time.perf_counter()
        snapshot_s = t_saved - t0
        nxt = batch_on_card(pipe, CKPT_STEPS)
        state, live, ms_writing = timed_step(step, state, nxt)
        live_params = host_copies(state.params.parameters())
        mgr.wait()
        write_s = time.perf_counter() - t_saved
        files = {f: os.path.getsize(os.path.join(ckdir, f"step_{CKPT_STEPS - 1:08d}", f))
                 for f in ("arrays.npz", "manifest.json")}
        state, _, ms_quiet = timed_step(step, state, batch_on_card(pipe, CKPT_STEPS + 1))
        del state  # and with its model the step's graph and pool
        gc.collect()
        torch.cuda.empty_cache()
        like = init_train_state(cfg, tcfg, seed=1, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored, ck_step, extra = mgr.restore(like)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        check(ck_step == CKPT_STEPS - 1 and extra == {"pipeline_step": CKPT_STEPS - 1}
              and int(restored.opt.step) == CKPT_STEPS, f"restored step {ck_step}, extra {extra}")
        bits = check_restored(restored, snap)
        snapshot_bytes = snap.nbytes
        del snap
        captures = graphs.STATS["captures"]
        restored, again, _ = timed_step(step, restored, nxt)
        recaptured = graphs.STATS["captures"] - captures
        check(recaptured == 1, f"the restored state's first step captured {recaptured} graphs, want "
                               f"its own")
        check(again == live, f"the restored step's metrics {again}, the live step's {live}")
        params_equal = check_same_bits("the restored step's parameters against the live step's",
                                       restored.params.parameters(), live_params)
        del live_params
        peak = torch.cuda.max_memory_allocated()
        row = {"arch": cfg.name, "layers": cfg.n_layers, "full_layers": full_layers,
               "disk_free_bytes": free, "state_bytes": state_bytes(cfg),
               "snapshot_bytes": snapshot_bytes,
               "files": files, "snapshot_s": snapshot_s, "write_s": write_s,
               "step_ms_writing": ms_writing, "step_ms_quiet": ms_quiet, "restore_s": restore_s,
               "bits": bits, "live": live, "restored": again, "restored_captures": recaptured,
               "parameters_equal": params_equal, "peak_bytes": peak}
        log(f"    checkpoint of {cfg.name} at {cfg.n_layers} layers: {files['arrays.npz']} bytes "
            f"(arrays.npz; the state {state_bytes(cfg)}); host snapshot {snapshot_s!r} s, "
            f"background write {write_s!r} s (save's return to wait's), step {ms_writing!r} ms with "
            f"the write running, {ms_quiet!r} ms without; restore (read, H2D) {restore_s!r} s; "
            f"{bits['tensors']} tensors equal to the snapshot bit for bit; the restored state's "
            f"step captured its own graph; the restored step vs the live step from the same bits: "
            f"loss {again['loss']!r} and {live['loss']!r}, grad norm {again['grad_norm']!r} and "
            f"{live['grad_norm']!r}, {params_equal} parameters after it: equal bit for bit; peak "
            f"memory {peak} bytes ({smi})")
        del restored, like, step
        gc.collect()
        torch.cuda.empty_cache()
        return row
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)


def restart_path(smi: str) -> dict:
    """Phase 9c (b): the launcher's restart as a user runs it, on the card."""
    ckdir = tempfile.mkdtemp(prefix="phase9c-restart-", dir=os.path.join(ROOT, "build"))
    flags = ["--arch", "tinyllama-1.1b", "--smoke", "--device", "cuda", "--steps",
             str(RESTART_STEPS), "--batch", "2", "--seq", "16"]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))

    def run(*extra):
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *flags, *extra],
                             capture_output=True, text=True, timeout=RESTART_TIMEOUT_S, env=env,
                             cwd=ROOT)
        return out, time.perf_counter() - t0

    def tensors(st):
        return ([p.detach() for p in st.params.parameters()] + [st.opt.step] + st.opt.master
                + st.opt.mu + st.opt.nu)

    try:
        first, first_s = run("--ckpt-dir", ckdir, "--ckpt-every", "1", "--step-deadline-s", "1e-9")
        check(first.returncode == launch_train.DEADLINE_EXIT and "step 1 exceeded deadline"
              in first.stdout, f"the deadline run: rc {first.returncode}\n{first.stdout}\n"
              f"{first.stderr[-4000:]}")
        check(ckpt_store.latest_step(ckdir) == 0,
              f"after the deadline exit the latest checkpoint is {ckpt_store.latest_step(ckdir)}")
        second, second_s = run("--ckpt-dir", ckdir, "--ckpt-every", "2", "--resume")
        check(second.returncode == 0 and "resumed from step 0" in second.stdout,
              f"the resumed run: rc {second.returncode}\n{second.stdout}\n{second.stderr[-4000:]}")
        check(ckpt_store.latest_step(ckdir) == RESTART_STEPS - 1,
              f"the resumed run's last checkpoint is {ckpt_store.latest_step(ckdir)}")
        with contextlib.redirect_stdout(io.StringIO()):
            whole = launch_train.main(flags)
        cfg = smoke_config("tinyllama-1.1b")
        resumed, _, _ = ckpt_store.restore_checkpoint(
            ckdir, init_train_state(cfg, TrainConfig(), seed=1, device="cuda"))
        equal = check_same_bits("the resumed run's final state against the uninterrupted run's",
                                tensors(resumed), host_copies(tensors(whole)))
        row = {"first_rc": first.returncode, "first_s": first_s, "second_rc": second.returncode,
               "second_s": second_s, "tensors_equal": equal}
        log(f"    launcher restart (tinyllama smoke, fp32, {RESTART_STEPS} steps, on the card): "
            f"rc {first.returncode} after step 1 ({first_s!r} s), --resume rc {second.returncode} "
            f"({second_s!r} s); final state equal to an uninterrupted run's bit for bit ({equal} "
            f"tensors) ({smi})")
        return row
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)


def plain_reruns(cfg, pipe, plain_steps: list) -> dict:
    """Phase 9's eager steps run again RERUNS times on the eager route from
    the seed-0 state: every step's loss and grad norm equal to phase 9's,
    and after the last step every parameter and AdamW master weight equal
    to the first rerun's, bit for bit: the step is a pure function."""
    step = make_train_step(cfg, train_tcfg(), eager=True)
    first = None
    for run in range(RERUNS):
        gc.collect()
        torch.cuda.empty_cache()
        state = init_train_state(cfg, train_tcfg(), seed=0, device="cuda")
        got = []
        for s in range(len(plain_steps)):
            state, m, _ = timed_step(step, state, batch_on_card(pipe, s))
            got.append(m)
        check(metrics_of(got) == metrics_of(plain_steps),
              f"rerun {run} of phase 9's eager steps: (loss, grad norm) {metrics_of(got)}, phase "
              f"9's {metrics_of(plain_steps)}")
        tensors = [*state.params.parameters(), *state.opt.master]
        if first is None:
            first = host_copies(tensors)
        else:
            check_same_bits(f"rerun {run}'s parameters and master weights", tensors, first)
        del state, tensors
    return {"reruns": RERUNS, "steps": len(plain_steps), "tensors": len(first)}


def dp_steps(cfg, smi: str, plain: dict) -> tuple:
    """Phase 9c (c): phase 9's eager steps rerun (``plain_reruns``), then the
    data-parallel step at world 1 over NCCL, a CUDA graph, each
    compression, DP_STEPS steps from one seed-0 state; None's steps equal
    to phase 9's eager steps (``plain["steps"]``) bit for bit.  Returns
    (the DP rows, the reruns' row)."""
    pipe = TokenPipeline(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH)
    t0 = time.perf_counter()
    reruns = plain_reruns(cfg, pipe, plain["steps"])
    log(f"    phase 9's eager steps 0..{DP_STEPS - 1} run again {RERUNS} times: every loss and grad "
        f"norm equal to phase 9's, every one of {reruns['tensors']} parameters and master weights "
        f"equal across the runs, bit for bit, in {time.perf_counter() - t0!r} s ({smi})")
    torch.distributed.init_process_group("nccl", store=torch.distributed.HashStore(), rank=0,
                                         world_size=1)
    try:
        mesh = make_host_mesh()
        n_attn = k5_per_forward(cfg)
        want = {"flash_attention": 2 * n_attn * DP_STEPS, "flash_attention_bwd": n_attn * DP_STEPS}
        rows = []
        for comp in DP_MODES:
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            tcfg = train_tcfg(comp)
            state = reshard_state(init_train_state(cfg, tcfg, seed=0, device="cuda"), cfg, mesh)
            check(isinstance(state.params, lm.Model), "a world-1 state is not whole")
            step = make_train_step(cfg, tcfg, mesh=mesh, mode="dp_shard_map")
            for reset in (FA.reset_launches, QD.reset_launches, K.reset_launches, graphs.reset,
                          reset_dp_stats):
                reset()
            steps = []
            for s in range(DP_STEPS):
                captures = graphs.STATS["captures"]
                state, m, ms = timed_step(step, state, batch_on_card(pipe, s))
                steps.append({**m, "ms": ms, "captures": graphs.STATS["captures"] - captures})
                check(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]),
                      f"DP step {s} ({comp}): loss {m['loss']} grad_norm {m['grad_norm']}")
            launches = {k: n for k, n in graphs.kernel_runs().items() if n}
            check(launches == want, f"DP run ({comp}): kernels that ran {launches}, want {want} "
                  f"and nothing else")
            versus = check_graph_steps(steps, plain["steps"] if comp is None else None,
                                       f"DP ({comp}) vs phase 9's eager steps")
            pool = graphs.STATS["pool_bytes"]
            stats = dict(DP_STATS)
            peak = torch.cuda.max_memory_allocated()
            check(peak < TRAIN_PEAK_BYTES, f"DP ({comp}) peak memory {peak} bytes")
            row = {"compression": comp, "steps": steps, "launches": launches,
                   "step_ms": float(np.median([r["ms"] for r in steps[1:]])),
                   "plain_step_ms": plain["step_ms"], "versus_plain": versus,
                   "bytes_per_step": stats["bytes"] / DP_STEPS,
                   "calls_per_step": stats["calls"] / DP_STEPS, "peak_bytes": peak,
                   "pool_bytes": pool}
            rows.append(row)
            log(f"    DP step (a graph), compression {comp}: losses {[r['loss'] for r in steps]}, "
                f"step {row['step_ms']!r} ms (median of steps 1..{DP_STEPS - 1}; the plain graphed "
                f"step {plain['step_ms']!r} ms in phase 9), all-reduce {row['bytes_per_step']!r} "
                f"bytes and {row['calls_per_step']!r} collective calls a step, kernels that ran "
                f"{launches}, pool {pool} bytes, peak memory {peak} bytes ({smi})")
            del state, step
        return rows, reruns
    finally:
        torch.distributed.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()


def checkpoint_phase(smi: str, trained: dict) -> dict:
    """Phase 9c: (a) a full-size checkpoint and restore, (b) the launcher's
    restart, (c) the data-parallel step at world 1."""
    t0 = time.perf_counter()
    cfg = get_config(LM_ARCH)
    out = {"checkpoint": checkpoint_restore(cfg, smi), "restart": restart_path(smi)}
    out["dp"], out["reruns"] = dp_steps(
        cfg, smi, {"step_ms": trained["step_ms"], "steps": trained["steps"][:DP_STEPS]})
    out["seconds"] = time.perf_counter() - t0
    return out


# ------------------------------------------- phase 9t: the model axis over gloo
def tp_inputs(cfg) -> dict:
    """The inputs of phase 9t's serving checks: phase 6's (1 x LM_CHECK_PROMPT
    + LM_CHECK_STEPS for fp32, LM_BF16_CHECK_BATCH x LM_CHECK_PROMPT for
    bf16), as ``check_full_model_fp32`` and ``check_full_model_bf16`` draw
    them."""
    total = LM_CHECK_PROMPT + LM_CHECK_STEPS
    return {"fp32": torch.from_numpy(np.random.default_rng(7).integers(0, cfg.vocab_size,
                                                                       (1, total))),
            "bf16": torch.from_numpy(np.random.default_rng(9).integers(
                0, cfg.vocab_size, (LM_BF16_CHECK_BATCH, LM_CHECK_PROMPT)))}


def tp_references(cfg) -> dict:
    """The single-card references of one config for phase 9t, on the host:
    the fp32 flash route's logits over prefill and LM_CHECK_STEPS decode
    steps, the bf16 check's naive fp32 logits and the naive bf16 route's
    RMS distance from them (phase 6's rule's denominator)."""
    inputs = tp_inputs(cfg)
    cfg32 = dataclasses.replace(cfg, dtype="float32", attention_impl="flash")
    model = lm.init_params(cfg32, seed=0, device="cuda")
    toks = inputs["fp32"].cuda()
    logits, state = lm.prefill(cfg32, model, toks[:, :LM_CHECK_PROMPT],
                               max_len=toks.shape[1])
    fp32 = [logits.cpu()]
    for t in range(LM_CHECK_PROMPT, toks.shape[1]):
        logits, state = lm.decode_step(cfg32, model, toks[:, t:t + 1], state)
        fp32.append(logits.cpu())
    del model, state
    naive = dataclasses.replace(cfg, attention_impl="naive")
    naive32 = dataclasses.replace(naive, dtype="float32")
    model = lm.init_params(cfg, seed=0, device="cuda")
    toks = inputs["bf16"].cuda()
    plain, _ = lm.prefill(naive, model, toks)
    model32 = lm.Model(naive32, device="cuda")
    with torch.no_grad():
        for p32, p in zip(model32.parameters(), model.parameters()):
            p32.copy_(p)
    del model
    want, _ = lm.prefill(naive32, model32, toks)
    naive_rms = float((plain.float() - want).pow(2).mean().sqrt())
    del model32, plain
    torch.cuda.empty_cache()
    return {"fp32": fp32, "want": want.cpu(), "naive_rms": naive_rms}


def tp_layers_cfg(arch: str):
    return dataclasses.replace(get_config(arch), n_layers=TP_FAMILY_LAYERS)


@contextlib.contextmanager
def recorded_flash_shapes(out: list):
    """Record (B·H, B·Hkv) of every K5 wrapper call in ``out``."""
    real = kops.flash_attention

    def recording(q, k, v, *args, **kwargs):
        out.append((q.shape[0], k.shape[0]))
        return real(q, k, v, *args, **kwargs)

    with unittest.mock.patch.object(kops, "flash_attention", recording):
        yield


def tp_counts() -> dict:
    return {"flash_attention": FA.LAUNCHES["flash_attention"],
            "flash_attention_bwd": FA.LAUNCHES["flash_attention_bwd"],
            "queue_dispatch": QD.LAUNCHES["queue_dispatch"]}


def tp_reset() -> None:
    FA.reset_launches()
    QD.reset_launches()
    K.reset_launches()
    tp_lib.reset_stats()
    reset_dp_stats()


def tp_collectives() -> dict:
    return {**{k: dict(v) for k, v in tp_lib.STATS.items()}, "dp": dict(DP_STATS)}


def tp_serve_checks(cfg, mesh, ref: dict, moe_layers: int, timed: bool) -> dict:
    """A rank's serving checks of one config on the (1, TP_RANKS) mesh: the
    fp32 model (its blocks) over prefill and decode against the
    single-card fp32 logits (LM_CHECK_TOL), the bf16 check's RMS rule,
    the launches of a prefill and a decode step; with ``timed`` the
    serving run's 4 x 2048 prefill and 31 decode steps timed."""
    inputs = tp_inputs(cfg)
    row = {"arch": cfg.name, "layers": cfg.n_layers}
    k5 = k5_per_forward(cfg)
    cfg32 = dataclasses.replace(cfg, dtype="float32", attention_impl="flash")
    model = lm.init_params(cfg32, seed=0, device="cuda")
    tm = serve_loop.shard_model(cfg32, model, mesh)
    del model
    torch.cuda.empty_cache()
    toks = inputs["fp32"].cuda()
    total = toks.shape[1]
    tp_reset()
    logits, state = serve_loop.make_prefill_fn(cfg32, mesh, 1, total)(tm, toks[:, :LM_CHECK_PROMPT])
    prefill_launches = tp_counts()
    got = [serve_loop.gather_logits(cfg32, mesh, 1, logits).cpu()]
    step = serve_loop.make_serve_step(cfg32, mesh, 1)
    tp_reset()
    for t in range(LM_CHECK_PROMPT, total):
        logits, state = step(tm, toks[:, t:t + 1], state)
        got.append(serve_loop.gather_logits(cfg32, mesh, 1, logits).cpu())
    decode_launches = {k: v / LM_CHECK_STEPS for k, v in tp_counts().items()}
    err = max(float((a - b).abs().max()) for a, b in zip(got, ref["fp32"]))
    for a, b in zip(got, ref["fp32"]):
        torch.testing.assert_close(a, b, atol=LM_CHECK_TOL, rtol=LM_CHECK_TOL)
    want_prefill = {"flash_attention": k5, "flash_attention_bwd": 0, "queue_dispatch": moe_layers}
    check(prefill_launches == want_prefill,
          f"9t {cfg.name} fp32 prefill launches {prefill_launches}, want {want_prefill}")
    want_decode = {"flash_attention": 0, "flash_attention_bwd": 0, "queue_dispatch": moe_layers}
    check(decode_launches == want_decode,
          f"9t {cfg.name} decode launches a step {decode_launches}, want {want_decode}")
    row.update(fp32_max_abs_err=err, fp32_tol=LM_CHECK_TOL, prefill_launches=prefill_launches,
               decode_launches=decode_launches, logit_scale=float(ref["fp32"][0].abs().max()))
    del tm, state, logits
    torch.cuda.empty_cache()
    model = lm.init_params(cfg, seed=0, device="cuda")
    tm = serve_loop.shard_model(cfg, model, mesh)
    del model
    torch.cuda.empty_cache()
    toks = inputs["bf16"].cuda()
    tp_reset()
    logits, _ = serve_loop.make_prefill_fn(cfg, mesh, toks.shape[0])(tm, toks)
    full = serve_loop.gather_logits(cfg, mesh, toks.shape[0], logits).float().cpu()
    check(bool(torch.isfinite(full).all()), f"9t {cfg.name} bf16: a logit is not finite")
    rms = float((full - ref["want"]).pow(2).mean().sqrt())
    ratio = rms / ref["naive_rms"]
    check(ratio <= LM_BF16_ROUTE_RATIO,
          f"9t {cfg.name} bf16: the TP route is {ratio!r} times as far from fp32 as the naive "
          f"single-card route")
    check(tp_counts()["flash_attention"] == k5, f"9t {cfg.name} bf16 prefill: {tp_counts()}")
    row.update(bf16_rms=rms, bf16_naive_rms=ref["naive_rms"], bf16_rms_ratio=ratio,
               bf16_tol_ratio=LM_BF16_ROUTE_RATIO)
    if timed:
        prompts = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (LM_BATCH, LM_PROMPT))).cuda()
        prefill = serve_loop.make_prefill_fn(cfg, mesh, LM_BATCH, LM_PROMPT + LM_NEW)
        step = serve_loop.make_serve_step(cfg, mesh, LM_BATCH)
        shapes = []
        tp_reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with recorded_flash_shapes(shapes):
            logits, state = prefill(tm, prompts)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        prefill_coll = tp_collectives()
        prefill_k5 = tp_counts()["flash_attention"]
        tok = serve_loop.gather_logits(cfg, mesh, LM_BATCH, logits).argmax(dim=-1, keepdim=True)
        outs = [tok]
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for _ in range(LM_NEW - 1):
            tp_reset()
            logits, state = step(tm, tok, state)
            decode_coll = tp_collectives()  # the step's own (the logits' gather aside)
            tok = serve_loop.gather_logits(cfg, mesh, LM_BATCH, logits).argmax(dim=-1, keepdim=True)
            outs.append(tok)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        n = LM_NEW - 1
        check(prefill_k5 == k5 and set(shapes) == {(LM_BATCH * cfg.n_heads // TP_RANKS,
                                                    LM_BATCH * cfg.n_kv_heads // TP_RANKS)},
              f"9t {cfg.name} serving prefill: {prefill_k5} K5 launches at (B*H, B*Hkv) "
              f"{sorted(set(shapes))}")
        row["serving"] = {
            "batch": LM_BATCH, "prompt": LM_PROMPT, "decode_steps": n,
            "prefill_s": t1 - t0, "prefill_tok_per_s": prompts.numel() / (t1 - t0),
            "decode_ms_per_step": (t3 - t2) / n * 1e3, "k5_per_prefill": prefill_k5,
            "k5_shapes": sorted(set(shapes)), "prefill_collectives": prefill_coll,
            "decode_collectives_per_step": decode_coll,
            "tokens": torch.cat(outs, dim=1).tolist()}
    del tm
    gc.collect()
    torch.cuda.empty_cache()
    return row


def tp_grads_bf16(cfg, mesh, shape, coord) -> dict:
    """A rank's ``bf16_grad_rule`` on the (1, TP_RANKS) mesh: the pjit
    step's bf16 gradients (``step.gradients``, after its sums) at the bf16
    gradient check's inputs, gathered whole, against the single-card naive
    routes on the same weights."""
    model = lm.init_params(cfg, seed=0, device="cuda", trainable=True)
    inputs = train_check_inputs(cfg, seed=22)
    sspecs = tspecs.state_specs(cfg, shape)
    empty = AdamWState(torch.zeros((), dtype=torch.int32, device="cuda"), {}, {}, {})
    state = elastic.ShardedState(elastic.reshard_params(model, cfg, mesh), empty, {}, sspecs, coord)
    step = make_train_step(cfg, train_tcfg(), mesh=mesh, mode="pjit")

    def route() -> tuple:
        tp_reset()
        loss, _, blocks = step.gradients(state, *inputs[:2])
        return float(loss), elastic.gather_blocks(blocks, sspecs.params, {
            n: tspecs.Spec(()) for n in blocks}, cfg, mesh, tspecs.all_axes(mesh))

    FA.reset_launches()
    row = bf16_grad_rule(cfg, model, inputs, route)
    row["launches"] = tp_counts()
    del model, state, step
    gc.collect()
    torch.cuda.empty_cache()
    return row


def tp_train_checks(cfg, mesh, phase9: dict) -> dict:
    """A rank's training checks of qwen3-1.7b on the (1, TP_RANKS) mesh:
    the fp32 gradients of the pjit step (``step.gradients``, after its
    sums) against the single-card gradients of the same weights, max
    |tp - single| / max |single| per tensor over every rank's block at
    most TRAIN_GRAD_TOL; the bf16 gradients by ``tp_grads_bf16``'s rule;
    then the bf16 pjit step from the seed-0 state, TP_TRAIN_STEPS steps of
    phase 9's batches (``phase9``: its steps' losses and grad norms, logged
    beside these), launches, collectives and ms a step."""
    shape = mesh_shape(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    cfg32 = dataclasses.replace(cfg, dtype="float32", attention_impl="flash")
    model = lm.init_params(cfg32, seed=0, device="cuda", trainable=True)
    tokens, labels, _ = train_check_inputs(cfg32, seed=21)
    loss_ref, _ = lm.forward_train(cfg32, model, tokens, labels)
    loss_ref.backward()
    loss_ref = loss_ref.detach()
    ref_grads = {n: p.grad for n, p in model.named_parameters()}
    sspecs = tspecs.state_specs(cfg32, shape)
    blocks = elastic.reshard_params(model, cfg32, mesh)
    empty = AdamWState(torch.zeros((), dtype=torch.int32, device="cuda"), {}, {}, {})
    state = elastic.ShardedState(blocks, empty, {}, sspecs, coord)
    step = make_train_step(cfg32, train_tcfg(), mesh=mesh, mode="pjit")
    tp_reset()
    shapes = []
    with recorded_flash_shapes(shapes):
        loss, _, grads = step.gradients(state, tokens, labels)
    launches = tp_counts()
    want = {"flash_attention": 2 * cfg.n_layers, "flash_attention_bwd": cfg.n_layers,
            "queue_dispatch": 0}
    check(launches == want, f"9t fp32 gradients: launches {launches}, want {want}")
    rel = {}
    for n, g in grads.items():
        mine = ref_grads[n][elastic.shard_slices(ref_grads[n].shape, sspecs.params[n], shape,
                                                 coord)]
        rel[n] = float((g - mine).abs().max() / ref_grads[n].abs().max().clamp_min(1e-30))
    names = list(rel)
    worst_all = torch.tensor([rel[n] for n in names], device="cuda")
    torch.distributed.all_reduce(worst_all, op=torch.distributed.ReduceOp.MAX)
    rel = dict(zip(names, worst_all.tolist()))
    worst = sorted(rel.items(), key=lambda kv: -kv[1])
    loss_rel = abs(float(loss) - float(loss_ref)) / abs(float(loss_ref))
    check(worst[0][1] <= TRAIN_GRAD_TOL and loss_rel <= TRAIN_GRAD_TOL,
          f"9t fp32 gradients: {worst[0][0]} differs by {worst[0][1]!r} (relative), the loss by "
          f"{loss_rel!r}")
    row = {"grads_fp32": {"seq": TRAIN_CHECK_SEQ, "loss_tp": float(loss),
                          "loss_single": float(loss_ref), "loss_rel_err": loss_rel,
                          "tensors": len(rel), "max_rel_err": worst[0][1], "worst": worst[:5],
                          "tol": TRAIN_GRAD_TOL, "launches": launches,
                          "k5_shapes": sorted(set(shapes))}}
    del model, ref_grads, blocks, state, grads, loss_ref
    gc.collect()
    torch.cuda.empty_cache()
    row["grads_bf16"] = tp_grads_bf16(cfg, mesh, shape, coord)
    # the bf16 run: the seed-0 state's blocks (init_train_state's, cut)
    model = lm.init_params(cfg, seed=0, device="cuda")
    blocks = elastic.reshard_params(model, cfg, mesh)
    del model
    torch.cuda.empty_cache()
    opt_state = AdamWState(torch.zeros((), dtype=torch.int32, device="cuda"),
                           {n: b.float() for n, b in blocks.items()},
                           {n: torch.zeros(b.shape, device="cuda") for n, b in blocks.items()},
                           {n: torch.zeros(b.shape, device="cuda") for n, b in blocks.items()})
    state = elastic.ShardedState(blocks, opt_state, {}, tspecs.state_specs(cfg, shape), coord)
    step = make_train_step(cfg, train_tcfg(), mesh=mesh, mode="pjit")
    pipe = TokenPipeline(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH)
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for s in range(TP_TRAIN_STEPS):
        tp_reset()
        shapes = []
        with recorded_flash_shapes(shapes):
            state, m, ms = timed_step(step, state, batch_on_card(pipe, s))
        got = tp_counts()
        want = {"flash_attention": 2 * cfg.n_layers, "flash_attention_bwd": cfg.n_layers,
                "queue_dispatch": 0}
        check(got == want, f"9t bf16 train step {s}: launches {got}, want {want}")
        check(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]), f"9t bf16 step {s}: {m}")
        plain = phase9["steps"][s]
        steps.append({"step": s, **m, "ms": ms, "launches": got, "collectives": tp_collectives(),
                      "k5_shapes": sorted(set(shapes)), "phase9_loss": plain["loss"],
                      "phase9_grad_norm": plain["grad_norm"]})
    bh = (TRAIN_BATCH * cfg.n_heads // TP_RANKS, TRAIN_BATCH * cfg.n_kv_heads // TP_RANKS)
    check(all(r["k5_shapes"] == [bh] for r in steps), f"9t bf16 steps: K5 shapes "
          f"{[r['k5_shapes'] for r in steps]}, want {bh}")
    row["train_bf16"] = {"batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": steps,
                         "peak_bytes": torch.cuda.max_memory_allocated(),
                         "step_ms": float(np.median([r["ms"] for r in steps[1:]]))}
    del state, step, blocks, opt_state
    gc.collect()
    torch.cuda.empty_cache()
    return row


def tp_rank(rank: int, world: int, out_dir: str, spawned_at: float) -> None:
    """One of TP_RANKS ranks spawned on the one card: gloo over its CUDA
    tensors, mesh (data 1, model TP_RANKS); the serving and training checks
    of qwen3-1.7b, then the serving checks of mixtral-8x7b and hymba-1.5b
    at TP_FAMILY_LAYERS layers, against the references the parent wrote to
    ``out_dir``; writes its rows, peak memory and clock stamps there."""
    started_s = time.time() - spawned_at
    refs = torch.load(os.path.join(out_dir, "refs.pt"))  # written by this script
    with open(os.path.join(out_dir, "phase9.json")) as f:
        phase9 = json.load(f)
    torch.cuda.set_device(0)
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{os.path.join(out_dir, 'store')}", rank=rank,
        world_size=world)
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        stamps = {"started": started_s, "group": time.time() - spawned_at}
        mesh = make_host_mesh(model=TP_RANKS, device_type="cuda")
        cfg = get_config(LM_ARCH)
        rows = {"serve": [tp_serve_checks(cfg, mesh, refs[LM_ARCH], 0, timed=True)]}
        stamps["serving"] = time.time() - spawned_at
        rows["train"] = tp_train_checks(cfg, mesh, phase9)
        stamps["training"] = time.time() - spawned_at
        for arch in TP_FAMILIES:
            fcfg = tp_layers_cfg(arch)
            moe_layers = fcfg.n_layers if fcfg.family == "moe" else 0
            rows["serve"].append(tp_serve_checks(fcfg, mesh, refs[arch], moe_layers, timed=False))
            stamps[arch] = time.time() - spawned_at
        stamps["done"] = time.time() - spawned_at
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump({"rank": rank, "rows": rows, "stamps": stamps,
                       "peak_bytes": torch.cuda.max_memory_allocated()}, f)
    finally:
        torch.distributed.destroy_process_group()


def spawn_tp_ranks(out_dir: str) -> list:
    """Spawn TP_RANKS ranks on the card; fail (killing the rest) when one
    raises or they outlast TP_TIMEOUT_S.  Returns each rank's record."""
    ctx = torch.multiprocessing.start_processes(
        tp_rank, args=(TP_RANKS, out_dir, time.time()), nprocs=TP_RANKS, join=False,
        start_method="spawn")
    deadline = time.monotonic() + TP_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            check(time.monotonic() < deadline,
                  f"phase 9t: ranks still running after {TP_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    records = []
    for r in range(TP_RANKS):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            records.append(json.load(f))
    return records


def tp_world1_graph(cfg, smi: str, phase6_tokens: list, phase9: dict) -> dict:
    """At world 1 over NCCL, mesh (1, 1): phase 6's serving request
    (LM_BATCH x LM_PROMPT + LM_NEW, greedy) through the mesh prefill and
    the mesh decode step, each one CUDA graph with its collectives, its
    tokens bit for bit phase 6's single-card graphs'; then the pjit step,
    a graph, TP_TRAIN_STEPS steps of phase 9's batches from the seed-0
    state: one capture, in step 0, K5 as phase 9's step, each loss and grad
    norm equal to phase 9's graphed single-card steps' bit for bit."""
    with gate.world1_group("cuda"):
        mesh = make_host_mesh(model=1, device_type="cuda")
        model = lm.init_params(cfg, seed=0, device="cuda")
        tm = serve_loop.shard_model(cfg, model, mesh)
        prompts = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (LM_BATCH, LM_PROMPT))).cuda()
        graphs.reset()
        prefill = serve_loop.make_prefill_fn(cfg, mesh, LM_BATCH, LM_PROMPT + LM_NEW)
        step = serve_loop.make_serve_step(cfg, mesh, LM_BATCH)
        logits, state = prefill(tm, prompts)
        captures = graphs.STATS["captures"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, state = prefill(tm, prompts)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        tok = logits.argmax(dim=-1, keepdim=True)
        outs = [tok]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(LM_NEW - 1):
            logits, state = step(tm, tok, state)
            tok = logits.argmax(dim=-1, keepdim=True)
            outs.append(tok)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / (LM_NEW - 1) * 1e3
        tokens = torch.cat(outs, dim=1).tolist()
        check(captures == graphs.STATS["captures"] == 2,
              f"9t world 1: {graphs.STATS['captures']} graphs captured, want the mesh decode and "
              f"prefill graphs")
        check(tokens == phase6_tokens, "9t world 1: the mesh graphs' tokens differ from phase 6's")
        del tm, model, state, logits, prefill, step
        gc.collect()
        torch.cuda.empty_cache()
        tcfg = train_tcfg()
        state = reshard_state(init_train_state(cfg, tcfg, seed=0, device="cuda"), cfg, mesh)
        step = make_train_step(cfg, tcfg, mesh=mesh, mode="pjit")
        n_attn = k5_per_forward(cfg)
        graphs.reset()
        state, pjit_steps = train_steps(
            step, state, TokenPipeline(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH), TP_TRAIN_STEPS,
            "pjit graph, mesh (1, 1)", {"flash_attention": 2 * n_attn, "flash_attention_bwd": n_attn})
        versus = check_graph_steps(pjit_steps, phase9["graph_steps"][:TP_TRAIN_STEPS],
                                   "9t world 1: the pjit graph vs phase 9's graphed steps")
        pool = graphs.STATS["pool_bytes"]
        del state, step
    gc.collect()
    torch.cuda.empty_cache()
    row = {"batch": LM_BATCH, "prompt": LM_PROMPT, "decode_steps": LM_NEW - 1, "captures": 2,
           "prefill_s": prefill_s, "decode_ms_per_step": ms, "tokens_equal_phase6": True,
           "pjit_steps": pjit_steps, "pjit_pool_bytes": pool, "pjit_vs_phase9_graph": versus,
           "pjit_step_ms": float(np.median([r["ms"] for r in pjit_steps[1:]]))}
    log(f"  world 1 over NCCL, mesh (1, 1): the mesh prefill and decode steps replay one graph each; "
        f"{LM_BATCH} x {LM_PROMPT} + {LM_NEW} tokens equal phase 6's single-card graphs' bit for "
        f"bit; prefill {prefill_s!r} s, decode {ms!r} ms/step; the pjit step a graph (pool {pool} "
        f"bytes), {row['pjit_step_ms']!r} ms a replayed step, held to phase 9's "
        f"graphed steps ({smi})")
    return row


def tp_phase(smi: str, trained: dict, phase6_tokens: list) -> dict:
    """Phase 9t: the LM's tensor-parallel path on TP_RANKS gloo ranks
    sharing the card, then the mesh decode graph at world 1 over NCCL."""
    t0 = time.perf_counter()
    out_dir = tempfile.mkdtemp(prefix="phase9t-", dir=os.path.join(ROOT, "build"))
    try:
        refs = {LM_ARCH: tp_references(get_config(LM_ARCH))}
        for arch in TP_FAMILIES:
            refs[arch] = tp_references(tp_layers_cfg(arch))
        # Large inputs go through a file (spawn arguments pass through a pipe).
        torch.save(refs, os.path.join(out_dir, "refs.pt"))
        with open(os.path.join(out_dir, "phase9.json"), "w") as f:
            json.dump({"steps": [{k: r[k] for k in ("loss", "grad_norm")}
                                 for r in trained["steps"]]}, f)
        del refs
        gc.collect()
        torch.cuda.empty_cache()  # the ranks share the card
        refs_s = time.perf_counter() - t0
        records = spawn_tp_ranks(out_dir)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    ranks_s = time.perf_counter() - t0 - refs_s
    for rec in records:
        r = rec["rank"]
        for row in rec["rows"]["serve"]:
            log(f"  rank {r} {row['arch']} ({row['layers']} layers): fp32 1 x {LM_CHECK_PROMPT} + "
                f"{LM_CHECK_STEPS} max_abs_err {row['fp32_max_abs_err']!r} (tolerance "
                f"{LM_CHECK_TOL}; largest logit {row['logit_scale']!r}); bf16 {LM_BF16_CHECK_BATCH} "
                f"x {LM_CHECK_PROMPT} RMS {row['bf16_rms']!r} vs the naive single-card route's "
                f"{row['bf16_naive_rms']!r}: ratio {row['bf16_rms_ratio']!r} (tolerance "
                f"{LM_BF16_ROUTE_RATIO}); launches a prefill {row['prefill_launches']}, a decode "
                f"step {row['decode_launches']}")
            if "serving" in row:
                sv = row["serving"]
                log(f"    serving {sv['batch']} x {sv['prompt']}: prefill {sv['prefill_s']!r} s "
                    f"({sv['prefill_tok_per_s']!r} tok/s), decode {sv['decode_ms_per_step']!r} "
                    f"ms/step over {sv['decode_steps']} steps; K5 {sv['k5_per_prefill']} a "
                    f"prefill at (B*H, B*Hkv) {sv['k5_shapes']}; collectives a prefill "
                    f"{sv['prefill_collectives']}, a decode step "
                    f"{sv['decode_collectives_per_step']} ({smi})")
        tr = rec["rows"]["train"]
        g = tr["grads_fp32"]
        log(f"  rank {r} {LM_ARCH} fp32 gradients 1 x {g['seq']}: loss {g['loss_tp']!r} vs "
            f"{g['loss_single']!r} single-card; {g['tensors']} tensors, largest relative error "
            f"{g['max_rel_err']!r} ({g['worst'][0][0]}; tolerance {g['tol']}); launches "
            f"{g['launches']} at {g['k5_shapes']}")
        b = tr["grads_bf16"]
        log(f"  rank {r} {LM_ARCH} bf16 gradients 1 x {b['seq']}, against the single-card naive "
            f"fp32 route: TP RMS {b['route_vs_fp32_rms']!r}, single-card naive bf16 RMS "
            f"{b['naive_vs_fp32_rms']!r}; ratio {b['rms_ratio']!r} (tolerance {b['tol_ratio']}); "
            f"losses TP {b['loss_route']!r}, naive bf16 {b['loss_naive_bf16']!r}, naive fp32 "
            f"{b['loss_naive_fp32']!r}; launches {b['launches']}")
        for s in tr["train_bf16"]["steps"]:
            log(f"  rank {r} bf16 pjit step {s['step']}: loss {s['loss']!r} (phase 9's plain step "
                f"{s['phase9_loss']!r}, |diff| {abs(s['loss'] - s['phase9_loss'])!r}), grad_norm "
                f"{s['grad_norm']!r} ({s['phase9_grad_norm']!r}, |diff| "
                f"{abs(s['grad_norm'] - s['phase9_grad_norm'])!r}), {s['ms']!r} ms, launches "
                f"{s['launches']} at {s['k5_shapes']}, collectives {s['collectives']}")
        log(f"  rank {r}: peak memory {rec['peak_bytes']} bytes (bf16 training "
            f"{tr['train_bf16']['peak_bytes']}), step {tr['train_bf16']['step_ms']!r} ms; stamps "
            f"{rec['stamps']} ({smi})")
    serve_rows = [rec["rows"]["serve"][0]["serving"] for rec in records]
    check(all(sv["tokens"] == serve_rows[0]["tokens"] for sv in serve_rows),
          "9t: the ranks' greedy tokens differ")
    world1 = tp_world1_graph(get_config(LM_ARCH), smi, phase6_tokens, trained)
    return {"ranks": records, "world1": world1, "refs_s": refs_s, "ranks_s": ranks_s,
            "seconds": time.perf_counter() - t0,
            "launches": {"flash_attention": records[0]["rows"]["serve"][0]["prefill_launches"][
                "flash_attention"],
                "flash_attention_bwd": records[0]["rows"]["train"]["train_bf16"]["steps"][0][
                    "launches"]["flash_attention_bwd"],
                "queue_dispatch": records[0]["rows"]["serve"][1]["prefill_launches"][
                    "queue_dispatch"]}}


# ----------------------------------------------------- phase 10: the dry run
# (a) cells of the production mesh (256 fake ranks), in two subprocesses that
# run beside the rest of the phase: (arch, shape, launch/perf.py's iteration
# whose variant it takes, or None); the first also traces the BST lookup.
DRYRUN_CELLS = (
    ((LM_ARCH, "train_4k", None), (LM_ARCH, "prefill_32k", None), (LM_ARCH, "decode_32k", None)),
    ((MOE_ARCH, "train_4k", "5"),),
)
# (b) the traced peak of phase 9's step (qwen3 bf16, full depth, TRAIN_BATCH x
# TRAIN_SEQ) at world 1 against the card's max_memory_allocated, for each
# remat setting: |predicted - measured| <= DRYRUN_PEAK_TOL x measured (set
# before the final run; the first card run was within 0.0012).
REMAT_VARIANTS = {"off": {"remat": False}, "none": {"remat": True, "remat_policy": "none"},
                  "dots": {"remat": True, "remat_policy": "dots"}}
DRYRUN_PEAK_TOL = 0.02
DRYRUN_TIMEOUT_S = 400
# 10e: the port's examples, each in a process of its own at a size that
# takes seconds (its own assertions raise; exit 0 is the check).
EXAMPLES = {
    "torch_quickstart.py": ["--stream", "4096"],
    "torch_serve_bst.py": ["--requests", "65536", "--chunk", "8192", "--tree-keys", "65535"],
    "torch_moe_dispatch.py": [],
    "torch_train_lm.py": ["--steps", "6", "--batch", "4", "--seq", "64", "--ckpt-every", "3"],
}
EXAMPLE_TIMEOUT_S = 300

_DRYRUN_WORKER = """
import json, sys
from repro_torch.launch import dryrun as DR, dryrun_bst, perf
cells, bst, out_path = json.loads(sys.argv[1]), sys.argv[2] == "1", sys.argv[3]
out = {"cells": []}
with DR.fake_group(DR.world_of("single")):
    for arch, shape, it in cells:
        variant, tag = (perf.ITERATIONS[it][2], perf.ITERATIONS[it][3]) if it else (None, "")
        out["cells"].append(DR.run_cell(arch, shape, "single", save=False, variant=variant,
                                        tag=tag))
    if bst:
        out["bst"] = dryrun_bst.lookup_record(DR.production_mesh("single"), "single",
                                              (1 << 21) - 1, 65536, 1.0)
out["imported"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro"))
with open(out_path, "w") as f:
    json.dump(out, f)
"""

_TRACE_WORKER = """
import json, sys
from repro_torch.configs import get_config
from repro_torch.launch import dryrun as DR
from repro_torch.models.config import ShapeConfig
arch, batch, seq, variant, out_path = sys.argv[1:]
shape = ShapeConfig("train", int(seq), int(batch), "train")
rec = DR.trace_cell(get_config(arch), shape, {"data": 1, "model": 1}, json.loads(variant))
with open(out_path, "w") as f:
    json.dump(rec, f)
"""


def start_worker(argv: list, card: bool = False) -> subprocess.Popen:
    """A Python process of ``argv`` started from the repo root; without
    ``card`` it sees no CUDA device (the dry run needs none)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    if not card:
        env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.Popen([sys.executable, *argv], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def finish_worker(proc: subprocess.Popen, what: str, timeout: float) -> str:
    """Wait for ``proc`` (killed past ``timeout``); its output, checked exit 0."""
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
        check(False, f"{what} ran past {timeout} s:\n{out[-3000:]}")
    check(proc.returncode == 0, f"{what} exited {proc.returncode}:\n{out[-3000:]}")
    return out


def log_dryrun_cell(rec: dict) -> None:
    ma, ca, co = rec["memory_analysis"], rec["cost_analysis"], rec["collectives"]
    log(f"    {rec['arch']} x {rec['shape']}{' [' + rec['tag'] + ']' if rec.get('tag') else ''} "
        f"x {rec['mesh']} (256 ranks): {rec['status']}; a rank: peak "
        f"{ma['peak_per_device_bytes']} B, arguments {ma['argument_size_in_bytes']} B, "
        f"{ca['flops']!r} FLOP ({ca['matmul_flops']!r} in matrix products, "
        f"{ca['kernel_flops']!r} in the kernels), collectives {co['total_bytes']} B in "
        f"{co['total_count']} calls; traced in {rec['lower_s']:.1f} s")


def remat_steps(cfg, smi: str) -> dict:
    """Phase 10 (b) on the card: phase 9's step (``make_train_step(mode=
    "pjit")`` at world 1 over NCCL, mesh (1, 1), the state whole) for each
    of REMAT_VARIANTS, two steps from the seed-0 state: the peak
    (``max_memory_allocated`` over both, less what was allocated before the
    state) and the second step's time."""
    out = {}
    pipe = TokenPipeline(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH)
    with gate.world1_group("cuda"):
        mesh = make_host_mesh(model=1, device_type="cuda")
        for name, variant in REMAT_VARIANTS.items():
            c = dataclasses.replace(cfg, **variant)
            gc.collect()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            state = reshard_state(init_train_state(c, train_tcfg(), seed=0, device="cuda"), c, mesh)
            step = make_train_step(c, train_tcfg(), mesh=mesh, mode="pjit", eager=True)
            batch = batch_on_card(pipe, 0)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            state, first, _ = timed_step(step, state, batch)
            state, second, ms = timed_step(step, state, batch)
            peak = torch.cuda.max_memory_allocated() - base
            check(all(np.isfinite(m["loss"]) for m in (first, second)),
                  f"10b {name}: losses {first['loss']}, {second['loss']}")
            out[name] = {"peak_bytes": peak, "step_ms": ms, "losses": [first["loss"],
                                                                        second["loss"]]}
            log(f"    {name}: measured peak {peak} B, step {ms!r} ms, losses "
                f"{out[name]['losses']} ({smi})")
            del state, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def dryrun_phase(smi: str) -> dict:
    """Phase 10: (a) ``launch/dryrun.py``'s cells and ``dryrun_bst`` on the
    production mesh over a fake group of 256, in subprocesses that see no
    card: every cell ok, none imports JAX or the JAX package, and each
    one's peak, FLOPs and collective bytes a rank logged; (b) the traced
    peak of phase 9's step at world 1 (a fake group of 1, qwen3 bf16 at
    full depth) for each remat setting, each trace in a subprocess,
    against the card's: every predicted peak within DRYRUN_PEAK_TOL of the
    measured one, "dots" between "none" and remat off on the card as in
    the trace, and the traced FLOPs over the measured step as TFLOP/s.
    The subprocesses run while the card runs (b)'s steps; phase 10e runs
    after them."""
    t0 = time.perf_counter()
    cfg = get_config(LM_ARCH)
    tmp = tempfile.mkdtemp(prefix="repro-torch-dryrun-", dir=os.path.join(ROOT, "build"))
    workers = []
    for i, cells in enumerate(DRYRUN_CELLS):
        path = os.path.join(tmp, f"cells{i}.json")
        workers.append((path, start_worker(["-c", _DRYRUN_WORKER, json.dumps(cells),
                                            str(int(i == 0)), path])))
    traces = {}
    for name, variant in REMAT_VARIANTS.items():
        path = os.path.join(tmp, f"trace_{name}.json")
        traces[name] = (path, start_worker(["-c", _TRACE_WORKER, LM_ARCH, str(TRAIN_BATCH),
                                            str(TRAIN_SEQ), json.dumps(variant), path]))
    measured = remat_steps(cfg, smi)
    cells, bst = [], None
    for path, proc in workers:
        finish_worker(proc, "the dry run's cells", DRYRUN_TIMEOUT_S)
        with open(path) as f:
            got = json.load(f)
        check(not got["imported"], f"the dry run imported {got['imported']}")
        cells += got["cells"]
        bst = got.get("bst", bst)
    log("  (a) the production mesh, single (data 16, model 16), as rank 0 of 256 fake ranks:")
    for rec in cells:
        check(rec["status"] == "ok", f"dry run {rec['arch']} x {rec['shape']}: {rec['status']} "
              f"{rec.get('error')}\n{rec.get('traceback', '')}")
        log_dryrun_cell(rec)
    log(f"    BST lookup, {bst['tree_nodes']} nodes, {bst['keys_per_device']} keys a rank: "
        f"all-to-all {bst['collectives']['all-to-all']} a rank, peak "
        f"{bst['peak_per_device_bytes']} B; terms (s) compute {bst['t_compute_s']!r}, memory "
        f"{bst['t_memory_s']!r}, collective {bst['t_collective_s']!r}: {bst['dominant']}-bound, "
        f"{bst['keys_per_sec_bound']!r} keys/s at most ({bst['card']})")
    log(f"  (b) {LM_ARCH} bf16, {TRAIN_BATCH} x {TRAIN_SEQ}, world 1: traced peak vs the card's "
        f"(tolerance {DRYRUN_PEAK_TOL}):")
    rows = {}
    for name, (path, proc) in traces.items():
        finish_worker(proc, f"the {name} trace", DRYRUN_TIMEOUT_S)
        with open(path) as f:
            rec = json.load(f)
        pred = rec["memory_analysis"]["peak_per_device_bytes"]
        meas = measured[name]["peak_bytes"]
        flops = rec["cost_analysis"]["flops"]
        rows[name] = {"predicted_peak_bytes": pred, "measured_peak_bytes": meas,
                      "rel_err": (pred - meas) / meas, "flops": flops,
                      "step_ms": measured[name]["step_ms"],
                      "tflop_per_s": flops / measured[name]["step_ms"] * 1e-9,
                      "argument_size_in_bytes": rec["memory_analysis"]["argument_size_in_bytes"],
                      "lower_s": rec["lower_s"], "losses": measured[name]["losses"]}
        r = rows[name]
        log(f"    remat {name}: predicted peak {pred} B, measured {meas} B "
            f"({r['rel_err']!r} relative); {flops!r} FLOP traced over {r['step_ms']!r} ms = "
            f"{r['tflop_per_s']!r} TFLOP/s ({smi})")
    for name, r in rows.items():
        check(abs(r["rel_err"]) <= DRYRUN_PEAK_TOL,
              f"10b {name}: predicted peak {r['predicted_peak_bytes']} vs measured "
              f"{r['measured_peak_bytes']}")
    for key in ("predicted_peak_bytes", "measured_peak_bytes"):
        order = [rows[n][key] for n in ("none", "dots", "off")]
        check(order[0] < order[1] < order[2], f"10b: {key} none < dots < off fails: {order}")
    shutil.rmtree(tmp, ignore_errors=True)
    seconds = time.perf_counter() - t0
    return {"cells": cells, "bst": bst, "remat": rows, "seconds": seconds}


def examples_phase(smi: str) -> dict:
    """Phase 10e: the four ``examples/torch_*.py`` on the card, each in a
    process of its own at EXAMPLES' sizes, all at once; each must exit 0
    (their assertions: every strategy's answers identical, every served
    key found, queue drops <= direct drops at every capacity factor) and
    the training example must leave its checkpoints."""
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="repro-torch-examples-", dir=os.path.join(ROOT, "build"))
    procs = {}
    for script, args in EXAMPLES.items():
        extra = ["--ckpt-dir", os.path.join(tmp, "ckpt")] if script == "torch_train_lm.py" else []
        procs[script] = start_worker([os.path.join(ROOT, "examples", script), *args, *extra],
                                     card=True)
    rows = {}
    for script, proc in procs.items():
        out = finish_worker(proc, f"examples/{script}", EXAMPLE_TIMEOUT_S)
        rows[script] = {"tail": out.strip().splitlines()[-3:]}
        log(f"    examples/{script} {' '.join(EXAMPLES[script])}: exit 0; "
            f"{' | '.join(rows[script]['tail'])}")
    ckpts = sorted(os.listdir(os.path.join(tmp, "ckpt")))
    check(ckpts == ["step_00000002", "step_00000005"], f"torch_train_lm checkpoints: {ckpts}")
    shutil.rmtree(tmp, ignore_errors=True)
    return {"examples": rows, "seconds": time.perf_counter() - t0, "card": smi}


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
        for bf16_body in (f"flash_fwd_bf16_kernel<{d}>", f"flash_fwd_bf16_kernel<{d},lse>",
                          f"flash_bwd_bf16_kernel<{d}>"):
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
    log(f"[6r] K5 past {FA.MAX_HEAD_ROWS} head rows: the forward at {[s for _, s in ROWS_FWD]}, "
        f"the backward at {[s for _, _, s in ROWS_BWD]}; {LM_ARCH} served at {ROWS_BATCH} x "
        f"{ROWS_PROMPT} + {ROWS_NEW}; K5 timed at {LM_ARCH}'s and hymba-1.5b's prefill shapes")
    gc.collect()
    torch.cuda.empty_cache()
    head_rows = head_rows_phase(cfg, timer, smi)
    log(f"    [6r] done at {time.perf_counter() - t_start:.1f} s (the phase "
        f"{head_rows['seconds']!r} s)")
    moe = moe_phase(resources, timer, smi, chase["l_hbm_ms"], dispatch_kernels)
    qd_timing, moe_served = moe["queue_dispatch_timing"], moe["moe_served"]
    log(f"    [7] done at {time.perf_counter() - t_start:.1f} s")
    log(f"[8] families: {', '.join(FAMILY_ARCHS)} at their published width and depth")
    gc.collect()
    families = families_phase(timer, smi)
    family_k5 = {r["arch"]: r["flash_launches"] for r in families["served"]}
    log(f"    [8] done at {time.perf_counter() - t_start:.1f} s; K5 launches a prefill {family_k5}")
    log(f"[9] training: K5's backward vs its plain version; fp32 gradients of {LM_ARCH} and of "
        f"{', '.join(TRAIN_FAMILY_ARCHS)} at {TRAIN_CHECK_LAYERS} layers, flash vs naive route; "
        f"the bf16 training run; K5's backward timed")
    gc.collect()
    training = training_phase(resources, timer, smi)
    trained, bwd_timing = training["trained"], training["bwd_timing"]
    log(f"    [9] done at {time.perf_counter() - t_start:.1f} s (the phase {training['seconds']!r} s)")
    log(f"[9c] checkpoints and the data-parallel step: {LM_ARCH} bf16, {TRAIN_BATCH} x {TRAIN_SEQ}; "
        f"(a) save through CheckpointManager(save_async=True, keep=1), a step during the write, "
        f"restore, the restored step vs the live one; (b) the launcher's restart at smoke size; "
        f"(c) make_train_step(mode='dp_shard_map') at world 1 over NCCL, {DP_MODES}")
    gc.collect()
    checkpointed = checkpoint_phase(smi, trained)
    log(f"    [9c] done at {time.perf_counter() - t_start:.1f} s (the phase "
        f"{checkpointed['seconds']!r} s)")

    log(f"[9t] the model axis: {LM_ARCH} at full width and depth, then "
        f"{', '.join(TP_FAMILIES)} at {TP_FAMILY_LAYERS} layers, on {TP_RANKS} gloo ranks sharing "
        f"this card, mesh (data 1, model {TP_RANKS}); then the mesh decode graph at world 1 over "
        f"NCCL")
    gc.collect()
    torch.cuda.empty_cache()
    tensor_parallel = tp_phase(smi, trained, lm_served["tokens"])
    log(f"    [9t] done at {time.perf_counter() - t_start:.1f} s (the phase "
        f"{tensor_parallel['seconds']!r} s: references {tensor_parallel['refs_s']!r} s, ranks "
        f"{tensor_parallel['ranks_s']!r} s)")

    log(f"[10] the dry run: {', '.join(f'{a} x {sh}' for group in DRYRUN_CELLS for a, sh, _ in group)} "
        f"and the BST lookup on the production mesh over 256 fake ranks; {LM_ARCH}'s train step "
        f"traced at world 1 for remat {list(REMAT_VARIANTS)} against the card")
    gc.collect()
    torch.cuda.empty_cache()
    dryrun = dryrun_phase(smi)
    log(f"    [10] done at {time.perf_counter() - t_start:.1f} s (the phase {dryrun['seconds']!r} s)")
    log(f"[10e] the port's examples on the card: {', '.join(EXAMPLES)}")
    examples = examples_phase(smi)
    log(f"    [10e] done at {time.perf_counter() - t_start:.1f} s (the phase "
        f"{examples['seconds']!r} s)")

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
        "tp_launches": tensor_parallel["launches"]["flash_attention"],
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
                   f"at {MOE_LAYERS} layers; per family prefill: {family_k5})"),
        "family_launches": family_k5,
        "configs": flash_timing + families["flash_timing"] + head_rows["flash_timing"],
        "past_head_rows": head_rows["forward"],
        "served_past_head_rows": {k: head_rows["served"][k] for k in (
            "batch", "head_rows", "chunks_per_call", "flash_runs_per_prefill", "layers_vs_plain",
            "tokens_equal_one_launch_slices", "peak_bytes")},
        "ptxas": {k: list(v) for k, v in flash_resources.items()},
        "hgmma": hgmma,
        "bf16_smem_bytes": flash_smem,
    })
    bwd_checks = training["bwd_checks"]
    kernels.append({
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": FLASH_BWD_SOURCE,
        "replaces": FLASH_BWD_REPLACES,
        "replaces_note": "no TPU kernel: the JAX package differentiates _blockwise_attn with XLA",
        "launches": trained["launches"]["flash_attention_bwd"],
        "tp_launches": tensor_parallel["launches"]["flash_attention_bwd"],
        "device_kernels_per_launch": trained["bwd_device_kernels_per_launch"],
        "device_kernel_counts": trained["device_kernel_counts"],
        "mismatches": sum(r[n]["mismatches"] for r in bwd_checks for n in ("dq", "dk", "dv")),
        "max_abs_err": max(r[n]["max_abs_err"] for r in bwd_checks for n in ("dq", "dk", "dv")),
        "tolerance": {str(k).replace("torch.", ""): v for k, v in BWD_TOL.items()},
        "ms": bwd_timing[0]["ms"],
        "plain_ms": bwd_timing[0]["plain_ms"],
        "bound_ms": bwd_timing[0]["bound_ms"],
        "bound_by": bwd_timing[0]["bound_by"],
        "library_ms": bwd_timing[0]["library_ms"],
        "library_backend": bwd_timing[0]["library_backend"],
        "config": (f"{bwd_timing[0]['config']} {bwd_timing[0]['shape']} bf16; launches: the bf16 "
                   f"training run of {LM_ARCH}, {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ}"),
        "configs": bwd_timing,
        "past_head_rows": head_rows["backward"],
        "grads_bf16": training["grads_bf16"],
        "ptxas": {k: list(v) for k, v in resources.items() if k.startswith("flash_bwd")},
        "smem_bytes": training["bwd_smem_bytes"],
    })
    kernels.append({
        "name": "queue_dispatch",
        "route": "cuda",
        "source": QD_SOURCE,
        "replaces": QD_REPLACES,
        "launches": moe_served["k4_launches"],
        "sharded_launches": sharded["launches"]["queue_dispatch"],
        "tp_launches": tensor_parallel["launches"]["queue_dispatch"],
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
                       "head_rows": head_rows,
                       **moe, "families": families, "training": training,
                       "checkpoints": checkpointed, "tensor_parallel": tensor_parallel,
                       "dryrun": dryrun, "examples": examples,
                       "seconds": time.perf_counter() - t_start}, f, indent=1)
    log(f"[11] done in {time.perf_counter() - t_start:.1f} s")
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
