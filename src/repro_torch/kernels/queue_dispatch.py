"""Wrapper of kernel K4 in ``csrc/queue_dispatch.cu``: queue-mapped dispatch.

``queue_dispatch_cuda`` checks its operands (device, dtype, rank,
contiguity, ``n_dest`` and ``capacity``; ``check_operands`` holds the part
of that contract the plain version shares), allocates the five outputs of
the dispatch plan with ``torch.empty``, launches the kernel on the current
stream, raises if the launch was refused, and adds one to
``LAUNCHES["queue_dispatch"]``.  It takes CUDA tensors only;
``kernels.ops.queue_dispatch`` sends CPU tensors to the plain version
(``ref.queue_dispatch_ref``) instead.  ``work`` is the bytes a call must
move, from its shapes: ``chip_smoke.py``'s bound and the dry run's count.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build

# Launches since the last ``reset_launches()``.
LAUNCHES: Dict[str, int] = {"queue_dispatch": 0}

_INT32_MAX = 2**31 - 1


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def check_operands(dest: torch.Tensor, n_dest: int, capacity: int) -> Tuple[int, int]:
    """The dispatch contract on either device: ``dest`` int32, (B,) or
    (G, B), contiguous; ``n_dest`` and ``capacity`` at least 1, with
    ``n_dest * capacity`` slots within int32.  Returns ``(G, B)``, G = 1 for
    a single row."""
    if dest.dtype != torch.int32:
        raise ValueError(f"dest must be int32, got {dest.dtype}")
    if dest.ndim not in (1, 2):
        raise ValueError(f"dest must be (B,) or (G, B), got shape {tuple(dest.shape)}")
    if not dest.is_contiguous():
        raise ValueError("dest must be contiguous")
    if n_dest < 1 or capacity < 1:
        raise ValueError(f"n_dest and capacity must be >= 1, got {n_dest} and {capacity}")
    if n_dest * capacity > _INT32_MAX:
        raise ValueError(f"n_dest * capacity = {n_dest * capacity} slots exceed int32")
    G, B = (1, dest.shape[0]) if dest.ndim == 1 else tuple(dest.shape)
    if B > _INT32_MAX or G > _INT32_MAX:
        raise ValueError(f"dest shape {tuple(dest.shape)} out of the kernel's range")
    return G, B


def work(G: int, B: int, n_dest: int, capacity: int) -> Tuple[int, int]:
    """``(operations, bytes)`` of one call: dest read once; slot, buffers
    and counts (int32) and kept and overflow (bool) written once.  Its
    operations are integer compares and prefix sums, counted as none: the
    bytes bound it."""
    return 0, 4 * G * B + G * (4 * B + 2 * B + 4 * n_dest * capacity + 4 * n_dest)


def max_dest() -> int:
    """The largest ``n_dest`` K4 takes: above 32 destinations its per-warp
    count table lives in shared memory."""
    return _build.library().lib.queue_dispatch_max_dest()


def check_n_dest(n_dest: int) -> None:
    """Raise if ``n_dest`` is above K4's limit (``max_dest``)."""
    limit = max_dest()
    if n_dest > limit:
        raise ValueError(
            f"n_dest {n_dest} is above K4's limit of {limit} destinations "
            f"(its per-warp count table in shared memory)"
        )


def outputs(dest: torch.Tensor, n_dest: int, capacity: int
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plan's five tensors for ``dest``, allocated with ``torch.empty``."""
    lead = tuple(dest.shape[:-1])
    slot = torch.empty_like(dest)
    kept = torch.empty(dest.shape, dtype=torch.bool, device=dest.device)
    buffers = torch.empty(lead + (n_dest, capacity), dtype=torch.int32, device=dest.device)
    counts = torch.empty(lead + (n_dest,), dtype=torch.int32, device=dest.device)
    overflow = torch.empty(dest.shape, dtype=torch.bool, device=dest.device)
    return slot, kept, buffers, counts, overflow


def queue_dispatch_cuda(
    dest: torch.Tensor, n_dest: int, capacity: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel K4: the queue dispatch plan ``(slot (…, B) int32, kept (…, B)
    bool, buffers (…, n_dest, capacity) int32, counts (…, n_dest) int32,
    overflow (…, B) bool)`` for ``dest`` (B,) or (G, B), each group row on
    one CTA (a cluster of CTAs past 512 lanes), all five written by the
    one launch.  A negative dest marks an inactive lane; a dest >= n_dest
    counts as n_dest - 1, as the Pallas kernel clips it (the JAX package's
    plain version lets such a lane fall into its sink instead: the two
    disagree, so such input has no defined answer)."""
    if dest.device.type != "cuda":
        raise ValueError(f"queue_dispatch_cuda takes CUDA tensors, got {dest.device}")
    G, B = check_operands(dest, n_dest, capacity)
    check_n_dest(n_dest)
    slot, kept, buffers, counts, overflow = outputs(dest, n_dest, capacity)
    if G > 0:
        built = _build.library()
        with torch.cuda.device(dest.device):
            stream = torch.cuda.current_stream(dest.device).cuda_stream
            LAUNCHES["queue_dispatch"] += 1
            rc = built.lib.queue_dispatch(
                dest.data_ptr(), G, B, n_dest, capacity, slot.data_ptr(), kept.data_ptr(),
                buffers.data_ptr(), counts.data_ptr(), overflow.data_ptr(), stream,
            )
        _build.check_launch(rc, "queue_dispatch")
    return slot, kept, buffers, counts, overflow
