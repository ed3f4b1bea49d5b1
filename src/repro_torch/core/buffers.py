"""Direct- and queue-mapped dispatch buffers (paper §II.C.3), in torch ops.

The port of the JAX package's ``core/buffers.py``.  The paper routes keys
leaving the register layer into per-subtree buffers:

* **Direct mapping** -- the item at chunk index ``i`` may only occupy slot
  ``i % capacity`` of its destination buffer.  Cheap routing; spurious
  stalls when that slot is busy while other slots are free.
* **Queue mapping** -- same-destination items are *labeled* 0, 1, 2, ...
  within the chunk (a segmented prefix count) and stored at
  ``write_ptr + label``.  Dense packing, FIFO order, fewer stalls, at the
  cost of the labeling network.

The same primitives place a MoE layer's tokens into expert buffers
(``models/moe.py``).  The dispatch functions take one chunk (B,) or G
chunks at once (G, B), where the JAX package vmaps over groups, so that one
call serves all of a MoE layer's dispatch groups; ``gather_from_buffers``
and ``combine_to_chunk`` take one chunk, as in the JAX package.  Everything
stays int32; only scatter and gather indices are int64, as torch indexing
wants.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import ops as kops


class DispatchPlan(NamedTuple):
    """Result of mapping a chunk of items onto (n_dest, capacity) buffers
    (each field with a leading G axis for (G, B) chunks).

    slot:     (B,) int32 -- assigned slot within the destination buffer, or -1
              when the item overflowed (it must retry in a later round: the
              software analogue of the paper's frontend stall).
    kept:     (B,) bool  -- item landed in a buffer this round.
    buffers:  (n_dest, capacity) int32 -- chunk indices, -1 for empty slots.
    counts:   (n_dest,) int32 -- occupied slots per destination.
    overflow: (B,) bool  -- ~kept for active items.
    """

    slot: torch.Tensor
    kept: torch.Tensor
    buffers: torch.Tensor
    counts: torch.Tensor
    overflow: torch.Tensor


def _count(dest: torch.Tensor, n_dest: int) -> torch.Tensor:
    """Items per destination over the last axis; negative dests count nowhere."""
    iota = torch.arange(n_dest, dtype=dest.dtype, device=dest.device)
    return (dest[..., None] == iota).sum(dim=-2, dtype=torch.int32)


def _scatter_buffers(
    dest: torch.Tensor, slot: torch.Tensor, kept: torch.Tensor, n_dest: int, capacity: int
) -> torch.Tensor:
    """Scatter chunk indices into the (n_dest, capacity) buffer image.  The
    items not kept go to a sink slot past the image, which is dropped; a
    position past the image drops too, as JAX's ``mode="drop"`` does."""
    B = dest.shape[-1]
    sink = n_dest * capacity
    lin = torch.where(kept, dest * capacity + slot, sink).clamp(max=sink)
    lin = lin.reshape(-1, B).long()
    flat = torch.full((lin.shape[0], sink + 1), -1, dtype=torch.int32, device=dest.device)
    flat.scatter_(1, lin, torch.arange(B, dtype=torch.int32, device=dest.device).expand_as(lin))
    return flat[:, :sink].reshape(dest.shape[:-1] + (n_dest, capacity))


def queue_dispatch(
    dest: torch.Tensor,
    n_dest: int,
    capacity: int,
    active: Optional[torch.Tensor] = None,
    base: Optional[torch.Tensor] = None,
) -> DispatchPlan:
    """Queue mapping: slot = write_ptr(dest) + |earlier same-dest items|.

    Without ``base`` the plan is ``kernels.ops.queue_dispatch``: kernel K4
    on the card, which writes all five fields in one launch (with
    ``active``, one ``torch.where`` first folds the mask into ``dest``), its
    plain version on the CPU.  ``base`` optionally carries the per-destination
    write pointers (occupancy) from previous rounds, (n_dest,) or (G,
    n_dest); K4 has no such operand, so with ``base`` the plan is computed
    in torch ops on either device (no caller in the repository passes it
    today)."""
    if active is not None:
        dest = torch.where(active, dest, -1)
    if base is None:
        return DispatchPlan(*kops.queue_dispatch(dest, n_dest, capacity))
    active = dest >= 0
    # Segmented prefix count: label[i] = #{j < i : dest[j] == dest[i]}.
    iota = torch.arange(n_dest, dtype=dest.dtype, device=dest.device)
    onehot = (dest[..., None] == iota).to(torch.int32)  # (…, B, n_dest)
    label = torch.cumsum(onehot, dim=-2, dtype=torch.int32) - onehot  # exclusive
    d_safe = dest.clamp(0, n_dest - 1).long()
    label = label.gather(-1, d_safe[..., None])[..., 0]
    label = label + base.expand(dest.shape[:-1] + (n_dest,)).gather(-1, d_safe)
    slot = torch.where(active, label, -1)
    kept = active & (slot >= 0) & (slot < capacity)
    slot = torch.where(kept, slot, -1)
    counts = _count(torch.where(kept, dest, -1), n_dest)
    buffers = _scatter_buffers(dest, slot, kept, n_dest, capacity)
    return DispatchPlan(slot, kept, buffers, counts, active & ~kept)


def direct_dispatch(
    dest: torch.Tensor,
    n_dest: int,
    capacity: int,
    active: Optional[torch.Tensor] = None,
    occupied: Optional[torch.Tensor] = None,
) -> DispatchPlan:
    """Direct mapping: item at chunk index ``i`` may only use slot ``i % capacity``.

    ``occupied`` optionally carries per-(dest, slot) occupancy from previous
    rounds (the cycle simulator's buffer image), (n_dest, capacity) or
    (G, n_dest, capacity); a set bit blocks placement even when other slots
    are free -- the paper's spurious-stall case.  Within a single chunk two
    items can also collide on (dest, slot) when B > capacity; the earlier
    item wins, as in hardware.  The JAX package finds the clashes with a
    (B, n_dest * capacity) one-hot and its cumulative sum; here the first
    item of each (dest, slot) pair comes from one ``scatter_reduce`` (amin):
    the same answers in O(B + n_dest * capacity) memory."""
    active = (dest >= 0) if active is None else (active & (dest >= 0))
    dest = torch.where(active, dest, -1)
    B = dest.shape[-1]
    idx = torch.arange(B, dtype=torch.int32, device=dest.device).expand_as(dest)
    slot = idx % capacity

    blocked = torch.zeros_like(active)
    if occupied is not None:
        pos = (dest.clamp(0, n_dest - 1) * capacity + slot).long()
        occ = occupied.reshape(occupied.shape[:-2] + (-1,))
        blocked = occ.expand(dest.shape[:-1] + occ.shape[-1:]).gather(-1, pos) & active

    # Intra-chunk collision: same (dest, slot) pair claimed by an earlier item.
    size = n_dest * capacity
    pair = dest * capacity + slot
    key = torch.where(active & (pair < size), pair, size).long()  # the rest: a sink
    first = torch.full(dest.shape[:-1] + (size + 1,), B, dtype=torch.int32, device=dest.device)
    first.scatter_reduce_(-1, key, idx, "amin")
    clash = first.gather(-1, key) < idx
    kept = active & ~blocked & ~clash
    slot = torch.where(kept, slot, -1)
    counts = _count(torch.where(kept, dest, -1), n_dest)
    buffers = _scatter_buffers(dest, slot, kept, n_dest, capacity)
    return DispatchPlan(slot, kept, buffers, counts, active & ~kept)


def dispatch(
    mapping: str,
    dest: torch.Tensor,
    n_dest: int,
    capacity: int,
    active: Optional[torch.Tensor] = None,
) -> DispatchPlan:
    if mapping == "queue":
        return queue_dispatch(dest, n_dest, capacity, active)
    if mapping == "direct":
        return direct_dispatch(dest, n_dest, capacity, active)
    raise ValueError(f"unknown mapping {mapping!r} (want 'direct' or 'queue')")


def gather_from_buffers(
    items: torch.Tensor, buffers: torch.Tensor, fill_value=0
) -> torch.Tensor:
    """Materialize buffered items: (B, ...) -> (n_dest, capacity, ...)."""
    safe = buffers.clamp(0, items.shape[0] - 1).long()
    out = items[safe]
    mask = (buffers >= 0).reshape(buffers.shape + (1,) * (items.ndim - 1))
    return torch.where(mask, out, fill_value)


def combine_to_chunk(
    per_dest: torch.Tensor, buffers: torch.Tensor, chunk_size: int, fill_value=0
) -> torch.Tensor:
    """Inverse of gather_from_buffers: (n_dest, capacity, ...) -> (B, ...).
    Empty slots, and positions past the chunk, go to a sink row that is
    dropped (JAX's ``mode="drop"``)."""
    flat_idx = buffers.reshape(-1)
    flat_val = per_dest.reshape((-1,) + tuple(per_dest.shape[2:]))
    out = torch.full((chunk_size + 1,) + tuple(per_dest.shape[2:]), fill_value,
                     dtype=per_dest.dtype, device=per_dest.device)
    sink = torch.where((flat_idx >= 0) & (flat_idx < chunk_size), flat_idx, chunk_size)
    out[sink.long()] = flat_val
    return out[:-1]
