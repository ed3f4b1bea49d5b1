"""Mixture-of-experts FFN with the paper's buffer-mapped dispatch.

The port of the JAX package's ``models/moe.py``.  The hybrid-partitioning
router of the paper and a top-k MoE router solve the same problem: a chunk
of items must be placed into fixed-capacity buffers keyed by a
data-dependent destination, and collisions beyond the port budget cost
throughput.  Both of the paper's mappings are exposed (``core/buffers.py``):

  * ``queue`` (the paper's contribution, the default): slot = write_ptr +
    label, the label being the count of earlier same-expert items -- dense,
    FIFO packing.  On the card the placement is kernel K4.  Overflow is the
    paper's frontend stall; in serving it is a dropped expert contribution
    for the token.
  * ``direct``: slot = the item's position modulo capacity; a token can be
    dropped while its expert's buffer still has free slots.

Dispatch and combine are gathers on (E, C) buffers.  The dispatch groups
set the capacity and so the drops.  Under tensor parallelism
(``sharding/tp.py``) the router stays replicated, so K4 plans the same
dispatch on every rank of the model axis; ``w_gate``/``w_up``/``w_down``
are F blocks of every expert, whose products give partial sums that
``reduce_out`` completes.  Where the batch rows are split over the data
axes, a rank's rows form whole dispatch groups when the group count
splits over them (the JAX package pins the groups to its DP axes); else a
group spans the ranks, and each rank gathers the batch's rows, dispatches
the whole groups and keeps its rows' outputs, as GSPMD replicates a group
dim it cannot split.  The expert products run as one batched matrix product per weight
(``torch.bmm`` over the experts), as the JAX package leaves its einsums to
XLA.  Two details differ from a literal copy and give the JAX package's
answers: the top-k choice is a stable descending sort (``top_k``), and the
expert rows are laid out expert-major, (E, G, C), so each expert's rows of
every group form one matrix.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import buffers as buf
from repro_torch.kernels import queue_dispatch as QD
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import tp


def moe_params_shape(cfg: ModelConfig):
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": (D, E),
        "w_gate": (E, D, Fd),
        "w_up": (E, D, Fd),
        "w_down": (E, Fd, D),
    }


class MoE(nn.Module):
    """One MoE FFN's parameters (``moe_params_shape``), allocated
    uninitialised on ``device``; ``models.model.init_params`` or
    ``models.convert.params_from_jax`` fills them.  ``dropped`` holds the
    dropped share of the layer's last call (0 before the first), a 0-d
    fp32 tensor on ``device`` that every call overwrites in place, so it is
    also the static output of a captured decode step, rewritten at every
    replay: a caller that keeps a step's share copies it before the next
    step."""

    def __init__(self, cfg: ModelConfig, device, dtype: torch.dtype):
        super().__init__()
        if cfg.moe_dispatch == "queue" and torch.device(device).type == "cuda":
            QD.check_n_dest(cfg.n_experts)  # K4's limit, before any allocation
        for name, shape in moe_params_shape(cfg).items():
            setattr(self, name, nn.Parameter(torch.empty(shape, device=device, dtype=dtype)))
        self.register_buffer(
            "dropped", torch.zeros((), dtype=torch.float32, device=device), persistent=False
        )


def expert_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    fair = n_tokens * cfg.top_k / cfg.n_experts
    return max(1, int(fair * cfg.capacity_factor))


def top_k(logits: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``'s rule: the k largest along the last axis, largest
    first, and among equal values the lower index first.  ``torch.topk``
    promises no order among ties (and bf16 router logits tie often); a
    stable descending sort keeps the index order."""
    values, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def moe_ffn(cfg: ModelConfig, params: MoE, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, dropped fraction, a 0-d device tensor).

    Tokens are split into ``cfg.moe_groups`` independent dispatch groups
    along the flattened (B·S) token axis where it divides, else one group:
    a prefill of 4 x 2048 tokens makes 32 groups of 256, a decode step of 4
    tokens one group of 4.  (The JAX package tests ``B % G`` first, then
    ``B·S % G``; both give this reshape.)"""
    B, S, D = x.shape
    G = cfg.moe_groups or 1
    shard = getattr(params, "tp", None)
    dp = shard.owner.dp if shard is not None and shard.owner.rows_split else tp.SINGLE
    if dp.size > 1:  # the batch's rows are split over the data axes
        if G > 1 and (B * dp.size * S) % G == 0 and G % dp.size == 0:
            G //= dp.size  # this rank's rows are G / n of the groups, whole
        else:  # a group spans the ranks: dispatch the whole batch, keep these rows
            out, dropped = moe_ffn_rows(cfg, params, tp.gather_rows(x, dp), G)
            return dp.block(out, 0), dropped
    return moe_ffn_rows(cfg, params, x, G)


def moe_ffn_rows(cfg: ModelConfig, params: MoE, x: torch.Tensor, G: int):
    """``moe_ffn`` of the rows ``x`` (B, S, D) in ``G`` dispatch groups
    (one where G does not divide B·S)."""
    B, S, D = x.shape
    if G > 1 and (B * S) % G == 0:
        xg = x.reshape(G, (B * S) // G, D)
    else:
        xg = x.reshape(1, B * S, D)
    out, dropped = _moe_grouped(cfg, params, xg)
    return out.reshape(B, S, D).to(x.dtype), dropped


def _moe_grouped(cfg: ModelConfig, p: MoE, xg: torch.Tensor):
    G, Tg, D = xg.shape
    E, K = cfg.n_experts, cfg.top_k
    shard = tp.get(p)
    if shard is not None:
        xg = tp.copy_in(xg, shard.axis)
    logits = (xg @ p.router).float()
    gates, experts = top_k(logits, K)  # (G, Tg, K)
    gates = torch.softmax(gates, dim=-1)

    C = expert_capacity(cfg, Tg)
    # K*Tg items per group, k-major so primary choices claim slots first.
    dest = experts.transpose(1, 2).reshape(G, K * Tg).to(torch.int32)
    plan = buf.dispatch(cfg.moe_dispatch, dest, E, C)  # one call for all groups

    # Gather each expert's tokens, expert-major: row (e, g, c) of x_e is
    # token buffers[g, e, c] % Tg of group g, zero where the slot is empty.
    group = torch.arange(G, device=xg.device)[:, None, None]
    rows = (group * Tg + plan.buffers % Tg).transpose(0, 1).reshape(-1)  # (E*G*C,)
    live = (plan.buffers >= 0).transpose(0, 1).reshape(-1, 1)
    xe = xg.reshape(G * Tg, D).index_select(0, rows).masked_fill_(~live, 0)
    xe = xe.reshape(E, G * C, D)

    g = torch.bmm(xe, p.w_gate)
    u = torch.bmm(xe, p.w_up)
    h = F.silu(g.float()).to(xg.dtype) * u
    ye = torch.bmm(h, p.w_down).reshape(E * G * C, D)

    # combine: a pure gather -- each (dest, slot) holds at most one item, so
    # a token reads its k-th expert output at (dest, slot).
    slot = plan.slot.reshape(G, K, Tg)  # -1 when dropped
    dest_k = dest.reshape(G, K, Tg)
    lin = (dest_k.clamp(0, E - 1) * G + group) * C + slot.clamp(0, C - 1)
    picked = ye.index_select(0, lin.reshape(-1)).reshape(G, K, Tg, D)
    w = gates.transpose(1, 2)  # (G, K, Tg), fp32
    w = torch.where(slot >= 0, w, 0.0)
    out = (picked.float() * w[..., None]).sum(dim=1)  # (G, Tg, D)
    if shard is not None:  # each rank's F block gave a partial sum
        out = tp.reduce_out(out, shard.axis)
    dropped = 1.0 - plan.kept.sum() / max(dest.numel(), 1)
    return out, dropped
