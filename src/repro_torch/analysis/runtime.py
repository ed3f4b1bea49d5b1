"""The serving path's sanctioned transfers and the watches that hold a drain
to them: the port's counterpart of the JAX package's
``repro.analysis.runtime``.

Three spellings are sanctioned on the hot path, and lint rule ANA006 asks
each call site for an allowlist line that names its budget:

  * ``device_fetch``: device -> host, counted (``fetch_count``).  A read
    chunk's results leave the device in exactly one place,
    ``BSTServer._fill_columns``; a compaction adds one fetch, its key count.
    ``device_fetch_into`` is one fetch into a given host tensor (a copy even
    on the CPU): a checkpoint's snapshot, one a tensor a save.
  * ``device_put``: host -> device into a given tensor, counted
    (``put_count``): the counterpart of an explicit ``jax.device_put``,
    which stays legal under the JAX transfer guard.  The copy is what the
    caller asks for: pageable and blocking by default, or non-blocking from
    pinned memory (the sharded loop's staging slots).
  * ``block_until_ready``: a wait for the device, no copy.

Two watches hold a steady-state drain to that plan (``analysis.gate``):

  * ``capture_watch()``, the counterpart of ``compile_watch``: every CUDA
    graph captured inside the block, with its key (``graphs.Graph``'s
    label, such as ``("lookup", None, 64)`` or ``("ingest",)``).  On the
    CPU the engine runs eagerly and captures nothing, so the count is 0 by
    construction there.
  * ``transfer_watch()``, the counterpart of the transfer guard: on the
    card it sets ``torch.cuda.set_sync_debug_mode("error")`` for the block
    (the mode is global to the process, so the previous one comes back in
    ``finally``), ``device_fetch`` and ``device_put`` lift it for their own
    copy only (the mode lets ``block_until_ready``'s explicit wait pass);
    it reports the counted fetches and puts.  On the CPU the
    mode does nothing, as JAX's device -> host guard does nothing on its
    CPU: there lint rules ANA001, ANA002 and ANA005 enforce the rule
    statically.

Which calls the mode sees (torch 2.11+cu128 on an H100 80GB HBM3 at
700 W, each planted alone under the watch: ``chip_smoke.py`` phase 4g's
``sync_mode_findings`` and
``tests/test_torch_cuda.py::test_transfer_watch_raises_on_planted_syncs``).
It raises on ``.item()``, ``.cpu()``, ``.tolist()``, a pageable
``.to("cuda")`` or ``copy_``, ``torch.tensor(int, device="cuda")`` (all
``memcpy_and_sync``), ``torch.nonzero`` and a boolean-mask index (a size
read back), and ``torch.cuda.current_stream().synchronize()``
(``stream_synchronize``).  It does not raise on a non-blocking copy from
pinned memory, nor on ``torch.cuda.synchronize()`` or
``torch.cuda.Event.synchronize()``: those are explicit waits, which ANA006
budgets.  torch warns that the mode "does not yet detect all
synchronizing operations": it is a net under the lint, not a proof.

This module imports torch, numpy and the stdlib only (``graphs`` lazily),
so ``core`` and ``serving`` import it without a cycle.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable, Iterator, List, Sequence, Tuple, TypeVar

import numpy as np
import torch

_counts_lock = threading.Lock()
_counts = {"fetch": 0, "put": 0}
# The sync debug mode a transfer_watch set (0: none is active).
_watch_mode = 0

T = TypeVar("T")


def _count(kind: str) -> None:
    with _counts_lock:
        _counts[kind] += 1


def _lifted(fn: Callable[[], T]) -> T:
    """``fn()`` with the sync debug mode of a transfer_watch lifted."""
    torch.cuda.set_sync_debug_mode(0)
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(_watch_mode)


def device_fetch(values: Sequence[torch.Tensor]) -> Tuple[np.ndarray, ...]:
    """Copy a tuple of tensors to host numpy arrays, counted as one fetch."""
    _count("fetch")
    if _watch_mode:
        return _lifted(lambda: _to_host(values))
    return _to_host(values)


def _to_host(values: Sequence[torch.Tensor]) -> Tuple[np.ndarray, ...]:
    return tuple(v.cpu().numpy() for v in values)


def device_fetch_into(value: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Copy ``value`` into the host tensor ``out`` (a copy even of a CPU
    tensor), counted as one fetch; returns ``out``."""
    if not out.is_cpu:
        raise ValueError(f"device_fetch_into copies into a host tensor, got one on {out.device}")
    _count("fetch")
    if _watch_mode:
        return _lifted(lambda: out.copy_(value))
    return out.copy_(value)


def device_put(host: torch.Tensor, out: torch.Tensor, *, non_blocking: bool = False) -> torch.Tensor:
    """Copy the host tensor ``host`` into ``out`` (on the device), counted
    as one put; returns ``out``.  ``non_blocking`` is only asynchronous
    from pinned memory."""
    if not host.is_cpu:
        raise ValueError(f"device_put copies a host tensor, got one on {host.device}")
    _count("put")
    if _watch_mode:
        return _lifted(lambda: out.copy_(host, non_blocking=non_blocking))
    return out.copy_(host, non_blocking=non_blocking)


def fetch_count() -> int:
    """Total ``device_fetch`` calls this process (monotonic counter)."""
    return _counts["fetch"]


def put_count() -> int:
    """Total ``device_put`` calls this process (monotonic counter)."""
    return _counts["put"]


def block_until_ready(values: Sequence[torch.Tensor]) -> None:
    """Wait for the device work behind ``values`` (no copy, no fetch)."""
    devices = {v.device for v in values if v.device.type == "cuda"}
    for device in devices:
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class CaptureWatch:
    """The keys of the CUDA graphs captured inside a ``capture_watch``."""

    keys: List[object] = dataclasses.field(default_factory=list)

    @property
    def count(self) -> int:
        return len(self.keys)


@contextlib.contextmanager
def capture_watch() -> Iterator[CaptureWatch]:
    """Record every CUDA graph captured inside the block.

    None over a region means that every step the region ran replayed a
    graph it already had: the steady-state contract, the port's "zero
    recompiles".  On the CPU nothing is captured."""
    from repro_torch import graphs

    watch = CaptureWatch()
    graphs.WATCHERS.append(watch.keys)
    try:
        yield watch
    finally:
        graphs.WATCHERS.remove(watch.keys)


@dataclasses.dataclass
class TransferWatch:
    """Fetches and puts counted inside a ``transfer_watch``."""

    fetches_before: int = 0
    puts_before: int = 0

    @property
    def fetches(self) -> int:
        return fetch_count() - self.fetches_before

    @property
    def puts(self) -> int:
        return put_count() - self.puts_before


@contextlib.contextmanager
def transfer_watch() -> Iterator[TransferWatch]:
    """Forbid unplanned synchronising transfers; count the planned ones.

    On the card an implicit transfer or sync (an ``.item()``, a pageable
    copy outside ``device_put``) raises ``RuntimeError`` at once; the
    counted spellings stay legal: the contract bans unplanned movement,
    not movement."""
    global _watch_mode
    watch = TransferWatch(fetch_count(), put_count())
    if not torch.cuda.is_available():
        yield watch
        return
    prev, prev_watch = torch.cuda.get_sync_debug_mode(), _watch_mode
    torch.cuda.set_sync_debug_mode("error")
    _watch_mode = torch.cuda.get_sync_debug_mode()
    try:
        yield watch
    finally:
        torch.cuda.set_sync_debug_mode(prev)
        _watch_mode = prev_watch
