"""CUDA graphs of the serving steps: the port's counterpart of ``jax.jit``.

The JAX package runs each serving step as one compiled program: the LM
decode step (``serving/serve_loop.py``) and the BST engine's bound query
callables (``core/engine.py``).  The port runs the same torch ops, and on a
CUDA device it captures each step once into a ``torch.cuda.CUDAGraph`` and
replays it, so a step costs one host launch instead of one per op.

``Graph`` captures a callable that reads and writes only tensors at fixed
addresses (its caller's static buffers); what the callable returns is the
graph's static output, rewritten by every replay.  A failed capture or
replay raises: nothing falls back to running the ops eagerly.

The kernels' ``LAUNCHES`` counters count wrapper calls, and a wrapper call
made while a graph is captured records the kernel without running it.  So
each graph keeps the wrapper calls its capture made (``held``); they are
added to ``CAPTURED`` once, and to ``REPLAYED`` at every replay.
``kernel_runs()`` is what ran on the card: ``LAUNCHES - CAPTURED +
REPLAYED`` per kernel.  The model axis's collectives (``sharding/tp.py``'s
``STATS``) count what ran in the same way: a capture takes its calls and
bytes back out (nothing ran), and every replay adds them.
"""

from __future__ import annotations

import gc
import time
import weakref
from typing import Callable, Dict, List

import torch

from repro_torch.kernels import bst_search, flash_attention, queue_dispatch
from repro_torch.sharding import tp

_COUNTERS = (bst_search.LAUNCHES, queue_dispatch.LAUNCHES, flash_attention.LAUNCHES)

# Since the last ``reset()``: per kernel, the wrapper calls recorded into
# graphs and the launches their replays made; graphs captured and the
# seconds their captures took (warm-up excluded, instantiation included).
CAPTURED: Dict[str, int] = {name: 0 for c in _COUNTERS for name in c}
REPLAYED: Dict[str, int] = {name: 0 for c in _COUNTERS for name in c}
STATS: Dict[str, float] = {"captures": 0, "capture_s": 0.0}
# The lists of the open ``analysis.runtime.capture_watch`` blocks: every
# capture appends its graph's label to each.
WATCHERS: List[List[object]] = []

_side_streams: Dict[torch.device, torch.cuda.Stream] = {}
_live: "weakref.WeakSet[Graph]" = weakref.WeakSet()


def reset() -> None:
    for counts in (CAPTURED, REPLAYED):
        for name in counts:
            counts[name] = 0
    STATS.update(captures=0, capture_s=0.0)


def launch_counts() -> Dict[str, int]:
    """Every kernel's wrapper calls (``LAUNCHES`` of the three wrappers)."""
    return {name: n for c in _COUNTERS for name, n in c.items()}


def kernel_runs() -> Dict[str, int]:
    """Per kernel, the launches that ran on the card: eager wrapper calls
    and the kernels of every replay."""
    return {name: n - CAPTURED[name] + REPLAYED[name] for name, n in launch_counts().items()}


def live() -> int:
    """Graphs alive in this process.  While one is, torch.profiler loses
    device events far more often, so a count that must be exact is taken
    when none is."""
    return len(_live)


def _collective_counts() -> Dict[tuple, int]:
    return {(op, field): n for op, row in tp.STATS.items() for field, n in row.items()}


def _add_collectives(counts: Dict[tuple, int], sign: int) -> None:
    for (op, field), n in counts.items():
        tp.STATS[op][field] += sign * n


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """One stream per device for every warm-up and capture, so that
    per-stream state (cuBLAS workspaces) is set up once, by a warm-up."""
    if device not in _side_streams:
        _side_streams[device] = torch.cuda.Stream(device)
    return _side_streams[device]


class Graph:
    """``fn()`` captured as one CUDA graph on the current device.

    With ``warmup`` the ops run once eagerly first, on the capture stream:
    first launches load kernels and set their attributes, and allocate
    per-stream workspaces, none of which may happen under capture.  A
    re-capture of ops that already ran in this process may skip it.
    ``pool``, a ``torch.cuda.graph_pool_handle()``, lets graphs share one
    memory pool: safe when each replay's outputs are consumed before
    another graph of the pool replays.  ``label`` names the step for a
    ``capture_watch`` (an engine passes its step key).  ``collectives``
    captures in the thread-local error mode, for steps that hold NCCL
    collectives: the process group's watchdog thread queries CUDA events
    while the capture is open, which the global mode forbids (the capture
    is then invalid).  ``out`` is ``fn``'s result, the static output."""

    def __init__(
        self,
        fn: Callable,
        *,
        warmup: bool = True,
        pool=None,
        label: object = None,
        collectives: bool = False,
    ):
        device = torch.device("cuda", torch.cuda.current_device())
        stream = _side_stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            if warmup:
                fn()
            before = launch_counts()
            collectives_before = _collective_counts()
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
        torch.cuda.current_stream(device).wait_stream(stream)
        after = launch_counts()
        self.held = {name: after[name] - before[name] for name in after if after[name] != before[name]}
        for name, n in self.held.items():
            CAPTURED[name] += n
        # the model axis's collectives recorded, not run: counted at replay
        self.collectives = {key: n - collectives_before[key]
                            for key, n in _collective_counts().items()}
        _add_collectives(self.collectives, -1)
        STATS["captures"] += 1
        STATS["capture_s"] += seconds
        for watch in WATCHERS:
            watch.append(label)
        _live.add(self)

    def replay(self):
        """Run the captured work on the current stream; returns ``out``."""
        self._graph.replay()
        for name, n in self.held.items():
            REPLAYED[name] += n
        _add_collectives(self.collectives, 1)
        return self.out
