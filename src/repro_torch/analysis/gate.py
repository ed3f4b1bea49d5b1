"""The serve gate: a steady-state drain captures nothing and moves nothing
it did not plan to move (the JAX package's ``repro.analysis.gate``).

``serve_gate(strategy)`` drives a real ``BSTServer`` -- on the card the
engine's CUDA graphs and the kernels behind them; with ``sharded`` the
strategy's serving mesh over the process group that exists -- through a
WARM phase (``warmup`` of the read ops and the write path, then one write
drain: every graph the measured phase replays is captured here) and then a
MEASURED phase under ``runtime.capture_watch()`` and
``runtime.transfer_watch()``:

  * two rounds, each a small write drain and then ``n_chunks`` fixed-shape
    chunks of every op in ``ops``, so the delta buffer's CONTENT changes
    while every shape stays constant -- the situation in which a
    content-dependent shape would capture a new graph;
  * zero captures: every step replayed a graph it already had;
  * fetches and puts exactly the design's (``runtime.device_fetch`` and
    ``runtime.device_put``): one fetch per read chunk
    (``BSTServer._fill_columns``); single-chip, one put per row of a read
    chunk (two for a range op: lows and highs) and one per ingest slice;
    sharded, one put per read chunk (the staged rows) and one per ingest
    slice;
  * zero compactions: the delta capacity is 64 and the high-water mark is
    equal to it, and the gate writes far fewer entries, so the measured
    phase never pays the allowlisted fetch of a compaction;
  * no sync raised by the watch on the card: any implicit transfer or sync
    inside the measured phase raises there and comes back as a violation
    (on the CPU the lint enforces that rule statically).

Each failure is a ``GAT001`` violation; nothing is swallowed, and the CLI
exits 1 on any.  ``world1_group`` makes the one-rank process group the
sharded route needs where none exists.  Serving is imported lazily, so
``repro_torch.analysis`` stays import-light.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.analysis import runtime
from repro_torch.analysis.report import Violation

# Ops exercised by the gate: both point shapes and a range op (the lo || hi
# doubled-lane descent); each is its own graph.
GATE_OPS: Tuple[str, ...] = ("lookup", "predecessor", "range_scan")

_N_KEYS = 63
_DELTA_CAP = 64
_SCAN_K = 4
_SEED = 19120156


def _violation(tag: str, msg: str) -> Violation:
    return Violation("GAT001", f"serve-gate:{tag}", 0, msg)


@contextlib.contextmanager
def world1_group(device: str) -> Iterator[None]:
    """A one-rank default process group for the block (gloo on the CPU,
    NCCL on the card, a ``file://`` store in a temporary directory),
    destroyed in ``finally``; a no-op where a group exists already."""
    if dist.is_initialized():
        yield
        return
    with tempfile.TemporaryDirectory(prefix="repro-torch-gate-") as tmp:
        dist.init_process_group(
            "nccl" if torch.device(device).type == "cuda" else "gloo",
            init_method=f"file://{os.path.join(tmp, 'store')}",
            rank=0,
            world_size=1,
        )
        try:
            yield
        finally:
            dist.destroy_process_group()


def gate_keys() -> np.ndarray:
    """The gate's default tree: 63 keys, multiples of 3."""
    return np.arange(1, _N_KEYS + 1, dtype=np.int32) * 3


def warm(srv, keys: np.ndarray, ops: Sequence[str]) -> None:
    """The warm phase: every read op's graph, the write path's graphs, and
    one write drain."""
    srv.warmup(tuple(ops) + ("write",))
    srv.submit_write(np.int32([keys[1], keys[3]]), np.int32([1, 3]))
    srv.drain()


def measured_drain(srv, keys: np.ndarray, ops: Sequence[str], n_chunks: int, chunk_size: int):
    """The measured phase's requests on ``srv`` (a port or a JAX
    ``BSTServer``: the calls are the same).  Returns every drain's results
    in order, the read chunks and the write slices it planned."""
    rng = np.random.default_rng(_SEED)
    results: List[dict] = []
    read_chunks: List[Tuple[str, int]] = []
    write_slices = 0
    for round_no in range(2):
        # the buffer's CONTENT changes between rounds; every shape holds
        srv.submit_write(
            np.int32([keys[5 + round_no], keys[9 + round_no]]),
            np.int32([round_no, round_no + 1]),
        )
        results.append(srv.drain())
        write_slices += 1  # two writes: one slice of at most the capacity
        for op in ops:
            q = rng.integers(0, keys[-1] + 2, size=n_chunks * chunk_size).astype(np.int32)
            if op in ("range_count", "range_scan"):
                srv.submit_range(q, q + 17, op=op)
            else:
                srv.submit(q, op=op)
            results.append(srv.drain())
            read_chunks.append((op, n_chunks))
    return results, read_chunks, write_slices


def serve_gate(
    strategy: str,
    *,
    n_chunks: int = 3,
    ops: Sequence[str] = GATE_OPS,
    n_trees: int = 4,
    sharded: bool = False,
    keys: Optional[np.ndarray] = None,
    chunk_size: int = 64,
    device: str = "cuda",
) -> List[Violation]:
    """Gate one strategy's steady-state drain on ``device``; returns the
    violations (empty = pass).  ``sharded`` serves the reads through
    ``BSTServer(mesh=make_serving_mesh(strategy))`` over the process group
    that exists; ``keys`` (default ``gate_keys()``) and ``chunk_size`` size
    the tree and the chunks."""
    from repro_torch.core import distributed as dist_lib
    from repro_torch.core.engine import EngineConfig
    from repro_torch.serving import bst_server

    tag = f"{strategy}{'/sharded' if sharded else ''}"
    keys = gate_keys() if keys is None else np.asarray(keys, np.int32)
    cfg = EngineConfig(
        strategy=strategy,
        n_trees=1 if strategy == "hrz" else n_trees,
        device=device,
        # High water == capacity and the measured writes stay far below it:
        # no compaction (and no compaction fetch) in the gate.
        delta_capacity=_DELTA_CAP,
        delta_high_water=_DELTA_CAP,
    )
    mesh = dist_lib.make_serving_mesh(strategy, torch.device(device).type) if sharded else None
    srv = bst_server.BSTServer(keys, keys * 7, cfg, chunk_size=chunk_size, scan_k=_SCAN_K, mesh=mesh)
    warm(srv, keys, ops)

    errors: List[Violation] = []
    compactions_before = srv.stats.compactions
    with runtime.capture_watch() as cw, runtime.transfer_watch() as tw:
        try:
            _, read_chunks, write_slices = measured_drain(srv, keys, ops, n_chunks, chunk_size)
        except RuntimeError as e:  # a sync the watch raised, or any failure of the drain
            errors.append(_violation(tag, f"the measured drain raised: {e}"))
            read_chunks, write_slices = None, 0
    if cw.count:
        errors.append(
            _violation(
                tag,
                f"steady-state drain captured {cw.count} CUDA graph(s): "
                f"{cw.keys[:4]} -- a step met a shape (or a snapshot) its "
                "warm-up did not",
            )
        )
    if read_chunks is not None:
        fetches = sum(n for _, n in read_chunks)
        rows = sum(n * (2 if op in ("range_count", "range_scan") else 1) for op, n in read_chunks)
        puts = (fetches if sharded else rows) + write_slices
        if tw.fetches != fetches:
            errors.append(
                _violation(
                    tag,
                    f"{tw.fetches} counted device fetches, budget is {fetches} "
                    "(one per read chunk) -- an unplanned device->host sync "
                    "crept onto the hot path",
                )
            )
        if tw.puts != puts:
            errors.append(
                _violation(
                    tag,
                    f"{tw.puts} counted device puts, budget is {puts} ("
                    + ("one per read chunk" if sharded else "one per row of a read chunk")
                    + " and one per ingest slice)",
                )
            )
    swept = srv.stats.compactions - compactions_before
    if swept:
        errors.append(
            _violation(
                tag,
                f"{swept} compaction(s) fired in the measured phase -- the "
                "gate's write volume must stay below the high-water mark",
            )
        )
    return errors


def run_serve_gates(
    strategies: Sequence[str] = ("hrz", "dup", "hyb"),
    *,
    n_chunks: int = 3,
    device: str = "cuda",
) -> List[Violation]:
    """Every strategy on the single-chip server, and, where a process group
    exists, on the sharded server too."""
    errors: List[Violation] = []
    for sharded in (False, True) if dist.is_initialized() else (False,):
        for strategy in strategies:
            errors.extend(serve_gate(strategy, n_chunks=n_chunks, sharded=sharded, device=device))
    return errors
