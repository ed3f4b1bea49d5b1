"""AdamW with fp32 master weights over bf16 compute parameters.

The port of the JAX package's ``optim/optimizer.py``: plain functions on
lists of tensors, in the order of the model's ``named_parameters`` (the
JAX package maps over its parameter tree).  The state keeps fp32 master
copies, so bf16 training does not lose small updates, and the update
returns the masters cast to the compute dtype.  The step counter and the
learning rate are device tensors: nothing here reads a value on the host.
Where the JAX package returns new arrays, ``adamw_update`` updates the
masters, the moments and the step counter in place (the JAX train step
donates its state), which saves a second copy of all three and lets a
train step captured as a CUDA graph replay over the same tensors.  Under tensor parallelism the lists hold
a rank's blocks (``clip_by_global_norm`` sums the split ones' squares over
the model axis), and under ZeRO-1 ``adamw_update`` is given the slices of
the masters, moments and gradients this rank keeps
(``training/train_loop.py`` gathers the parameters after it).
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor  # () int32, on the parameters' device
    master: List[torch.Tensor]  # fp32 copies of the parameters
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


def adamw_init(params: Sequence[torch.Tensor]) -> AdamWState:
    """Step 0, fp32 masters copied from ``params``, zero moments."""
    device = params[0].device if params else "cpu"
    with torch.no_grad():
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=device),
            master=[p.detach().to(torch.float32, copy=True) for p in params],
            mu=[torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in params],
            nu=[torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in params],
        )


def cosine_schedule(
    step: torch.Tensor, peak_lr: float, warmup: int, total: int, floor: float = 0.1
) -> torch.Tensor:
    """Linear warmup from (step + 1) / warmup (step 0 moves), then a cosine
    decay to ``floor`` * peak over the remaining steps: a 0-d fp32 tensor."""
    s = step.to(torch.float32)
    warm = (s + 1) / max(warmup, 1)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
    return peak_lr * torch.where(s < warmup, warm, cos)


def clip_by_global_norm(
    grads: Sequence[torch.Tensor], max_norm: float, split: Optional[Sequence[bool]] = None,
    axis=None,
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """The gradients in fp32 scaled to a global norm of at most
    ``max_norm``, and that norm before clipping (a 0-d device tensor).

    Over blocks (tensor parallelism): ``split[i]`` says that ``grads[i]``
    is this rank's block of a tensor split over ``axis``
    (``sharding/tp.Axis``); the split tensors' squares are summed over the
    axis (one all-reduce) and a replicated tensor's counted once."""
    if split is None or axis is None or axis.size == 1:
        gn = torch.sqrt(sum(g.float().square().sum() for g in grads))
    else:
        zero = torch.zeros((), dtype=torch.float32, device=grads[0].device)
        parts = sum((g.float().square().sum() for g, s in zip(grads, split) if s), zero)
        whole = sum((g.float().square().sum() for g, s in zip(grads, split) if not s), zero)
        gn = torch.sqrt(axis.all_reduce(parts) + whole)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return [g.float() * scale for g in grads], gn


@torch.no_grad()
def adamw_update(
    grads: Sequence[torch.Tensor],
    state: AdamWState,
    lr: torch.Tensor,
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> Tuple[List[torch.Tensor], AdamWState]:
    """One AdamW step with decoupled weight decay on the fp32 masters:
    ``(params in compute_dtype, state)``.  The masters, the moments and the
    step counter of ``state`` are updated in place (a graphed train step
    reads and writes them at fixed addresses); the returned state holds
    them.  For fp32 the returned parameters are the masters themselves."""
    step = state.step.add_(1)
    t = step.to(torch.float32)
    c1 = 1 - torch.pow(b1, t)
    c2 = 1 - torch.pow(b2, t)
    for g, m, v, p in zip(grads, state.mu, state.nu, state.master):
        g = g.float()
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        update = (m / c1) / (torch.sqrt(v / c2) + eps) + weight_decay * p
        p.sub_(lr * update)
    params = [p.to(compute_dtype) for p in state.master]
    return params, AdamWState(step=step, master=state.master, mu=state.mu, nu=state.nu)
