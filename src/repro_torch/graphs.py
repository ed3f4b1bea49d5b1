"""CUDA graphs of the compiled steps: the port's counterpart of ``jax.jit``.

The JAX package runs each step as one compiled program: the LM prefill and
decode steps (``serving/serve_loop.py``), the train step
(``training/train_loop.py``) and the BST engine's bound query callables
(``core/engine.py``).  The port runs the same torch ops, and on a CUDA
device it captures each step once into a ``torch.cuda.CUDAGraph`` and
replays it, so a step costs one host launch instead of one per op.

``Graph`` captures a callable that reads and writes only tensors at fixed
addresses (its caller's static buffers); what the callable returns is the
graph's static output, rewritten by every replay, and what its warm-up
returned is ``warm``.  A failed capture or replay raises: nothing falls
back to running the ops eagerly.

The kernels' ``LAUNCHES`` counters count wrapper calls, and a wrapper call
made while a graph is captured records the kernel without running it.  So
each graph keeps the wrapper calls its capture made (``held``); they are
added to ``CAPTURED`` once, and to ``REPLAYED`` at every replay.
``kernel_runs()`` is what ran on the card: ``LAUNCHES - CAPTURED +
REPLAYED`` per kernel.  The collectives (``sharding/tp.py``'s ``STATS``,
the train loop's ``DP_STATS``: the tables given to ``count_at_replay``)
count what ran in the same way: a capture takes its calls and bytes back
out (nothing ran), and every replay adds them.
"""

from __future__ import annotations

import gc
import time
import weakref
from typing import Callable, Dict, List

import torch
import torch.distributed as dist

from repro_torch.kernels import bst_search, flash_attention, queue_dispatch
from repro_torch.sharding import tp

_COUNTERS = (bst_search.LAUNCHES, queue_dispatch.LAUNCHES, flash_attention.LAUNCHES)

# Since the last ``reset()``: per kernel, the wrapper calls recorded into
# graphs and the launches their replays made; graphs captured, the seconds
# their captures took (warm-up excluded, instantiation included) and the
# bytes they reserved for their pools (``Graph.pool_bytes``).
CAPTURED: Dict[str, int] = {name: 0 for c in _COUNTERS for name in c}
REPLAYED: Dict[str, int] = {name: 0 for c in _COUNTERS for name in c}
STATS: Dict[str, float] = {"captures": 0, "capture_s": 0.0, "pool_bytes": 0}
# The lists of the open ``analysis.runtime.capture_watch`` blocks: every
# capture appends its graph's label to each.
WATCHERS: List[List[object]] = []

# Counter tables of the work a step does besides the kernels (calls and
# bytes, flat or by op), counted at every replay: ``count_at_replay``.
_TABLES: List[dict] = [tp.STATS]

_side_streams: Dict[torch.device, torch.cuda.Stream] = {}
_live: "weakref.WeakSet[Graph]" = weakref.WeakSet()


def reset() -> None:
    for counts in (CAPTURED, REPLAYED):
        for name in counts:
            counts[name] = 0
    STATS.update(captures=0, capture_s=0.0, pool_bytes=0)


def launch_counts() -> Dict[str, int]:
    """Every kernel's wrapper calls (``LAUNCHES`` of the three wrappers)."""
    return {name: n for c in _COUNTERS for name, n in c.items()}


def kernel_runs() -> Dict[str, int]:
    """Per kernel, the launches that ran on the card: eager wrapper calls
    and the kernels of every replay."""
    return {name: n - CAPTURED[name] + REPLAYED[name] for name, n in launch_counts().items()}


def eager_route(eager: bool, tensor: torch.Tensor, collectives: bool = False) -> bool:
    """Whether a compiled step on ``tensor``'s device runs its ops eagerly:
    when asked to (``eager``), off a CUDA device, and for a step with
    ``collectives`` over a backend other than NCCL (gloo's collectives run
    on the host and cannot be captured).  Otherwise the step is a graph."""
    if eager or tensor.device.type != "cuda":
        return True
    return collectives and dist.get_backend() != dist.Backend.NCCL


def live() -> int:
    """Graphs alive in this process.  While one is, torch.profiler loses
    device events far more often, so a count that must be exact is taken
    when none is."""
    return len(_live)


def count_at_replay(table: dict) -> None:
    """Count ``table`` (numbers by name, or rows of them by op) as
    ``tp.STATS`` is: what a capture adds to it is taken back out, and every
    replay adds it."""
    if not any(t is table for t in _TABLES):
        _TABLES.append(table)


def _table_counts() -> Dict[tuple, int]:
    out = {}
    for i, table in enumerate(_TABLES):
        for key, v in table.items():
            for field, n in (v.items() if isinstance(v, dict) else ((None, v),)):
                out[(i, key, field)] = n
    return out


def _add_counts(counts: Dict[tuple, int], sign: int) -> None:
    for (i, key, field), n in counts.items():
        if field is None:
            _TABLES[i][key] += sign * n
        else:
            _TABLES[i][key][field] += sign * n


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """One stream per device for every warm-up and capture, so that
    per-stream state (cuBLAS workspaces) is set up once, by a warm-up."""
    if device not in _side_streams:
        _side_streams[device] = torch.cuda.Stream(device)
    return _side_streams[device]


class Graph:
    """``fn()`` captured as one CUDA graph on ``device`` (the current CUDA
    device by default).

    With ``warmup`` the ops run once eagerly first, on the capture stream:
    first launches load kernels and set their attributes, and allocate
    per-stream workspaces, none of which may happen under capture.  The
    warm-up is a real run of ``fn``: what it returned is ``warm`` (a step
    that may not run twice, the train step, hands it to its first caller
    instead of replaying).  A re-capture of ops that already ran in this
    process may skip it.  ``release`` synchronises and empties the caching
    allocator between the warm-up and the capture, so that the warm-up's
    cached temporaries are freed before the capture draws the graph's own
    pool (a train step's take tens of GB).  ``pool``, a
    ``torch.cuda.graph_pool_handle()``, lets graphs share one memory pool:
    safe when each replay's outputs are consumed before another graph of
    the pool replays.  ``pool_bytes`` is the device memory the capture
    reserved (with a shared pool, what it added to it).  ``label`` names the
    step for a ``capture_watch`` (an engine passes its step key).
    ``collectives`` captures in the thread-local error mode, for steps that
    hold NCCL collectives: the process group's watchdog thread queries
    CUDA events while the capture is open, which the global mode forbids
    (the capture is then invalid).  ``out`` is ``fn``'s result, the static
    output."""

    def __init__(
        self,
        fn: Callable,
        *,
        warmup: bool = True,
        release: bool = False,
        pool=None,
        label: object = None,
        collectives: bool = False,
        device=None,
    ):
        device = torch.device("cuda", torch.cuda.current_device()) if device is None \
            else torch.device(device)
        with torch.cuda.device(device):
            stream = _side_stream(device)
            stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(stream):
                self.warm = fn() if warmup else None
                if release:
                    torch.cuda.synchronize(device)
                    torch.cuda.empty_cache()
                before = launch_counts()
                tables_before = _table_counts()
                reserved = torch.cuda.memory_reserved(device)
                t0 = time.perf_counter()
                self._graph = torch.cuda.CUDAGraph()
                # No collection inside the capture: a collected graph's teardown
                # (a dead engine's, in a reference cycle) would invalidate it.
                collecting = gc.isenabled()
                gc.disable()
                try:
                    self._graph.capture_begin(
                        pool=pool, capture_error_mode="thread_local" if collectives else "global"
                    )
                    try:
                        self.out = fn()
                    except BaseException:
                        try:
                            self._graph.capture_end()
                        except RuntimeError:
                            pass  # the capture is already invalid: report fn's error
                        raise
                    self._graph.capture_end()
                finally:
                    if collecting:
                        gc.enable()
                seconds = time.perf_counter() - t0
                self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
            torch.cuda.current_stream(device).wait_stream(stream)
        after = launch_counts()
        self.held = {name: after[name] - before[name] for name in after if after[name] != before[name]}
        for name, n in self.held.items():
            CAPTURED[name] += n
        # the collectives recorded, not run: counted at replay
        self.collectives = {key: n - tables_before.get(key, 0)
                            for key, n in _table_counts().items()
                            if n != tables_before.get(key, 0)}
        _add_counts(self.collectives, -1)
        STATS["captures"] += 1
        STATS["capture_s"] += seconds
        STATS["pool_bytes"] += self.pool_bytes
        for watch in WATCHERS:
            watch.append(label)
        _live.add(self)

    def replay(self):
        """Run the captured work on the current stream; returns ``out``."""
        self._graph.replay()
        for name, n in self.held.items():
            REPLAYED[name] += n
        _add_counts(self.collectives, 1)
        return self.out
