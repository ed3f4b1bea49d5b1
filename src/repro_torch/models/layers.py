"""Shared layers: RMS norm, rope, SwiGLU MLP, embeddings, chunked CE.

Conventions, as in the JAX package: activations (B, S, D); weights in
the config's parameter dtype (bf16 on the serving path); the math that
needs it (norms, rope, the SiLU gate, the cross-entropy) in fp32.  Weight
matrices keep the JAX layout, (in, out), so ``x @ w``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.sharding import tp


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float,
             axis: Optional[tp.Axis] = None) -> torch.Tensor:
    """RMS norm over the last dim; with ``axis``, that dim is split over
    its ranks (``x`` and ``scale`` this rank's block) and the mean of
    squares spans them."""
    dt = x.dtype
    xf = x.float()
    if axis is None or axis.size == 1:
        var = (xf * xf).mean(dim=-1, keepdim=True)
    else:
        var = tp.sum_over((xf * xf).sum(dim=-1, keepdim=True), axis) / (x.shape[-1] * axis.size)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(dt)


def rope_angles(
    positions: torch.Tensor, head_dim: int, theta: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of shape (..., head_dim // 2), fp32."""
    half = head_dim // 2
    exponent = -torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freq = torch.pow(float(theta), exponent)  # a host scalar base: no copy to the device
    ang = positions.float()[..., None] * freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, hd); cos/sin: (..., S, 1, hd/2) or broadcastable.  The
    two halves of the head dim rotate together (not interleaved pairs)."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(
    x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor
) -> torch.Tensor:
    g = x @ w_gate
    u = x @ w_up
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ w_down


def embed(tokens: torch.Tensor, table: torch.Tensor,
          axis: Optional[tp.Axis] = None) -> torch.Tensor:
    """``table[tokens]``; with ``axis``, ``table`` is this rank's vocab block."""
    if axis is None or axis.size == 1:
        return table[tokens]
    return tp.embed(tokens, table, axis)


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """x (..., D) @ (V, D)^T -> (..., V)."""
    return x @ table.t()


def _xent_chunk(xc: torch.Tensor, head: torch.Tensor, lc: torch.Tensor,
                mc: Optional[torch.Tensor], axis: Optional[tp.Axis] = None) -> torch.Tensor:
    """The summed (masked) NLL of one chunk: (B, c, D) states, (B, c)
    labels; with ``axis``, ``head`` is this rank's vocab block."""
    if axis is None:
        logits = (xc @ head.t()).float()  # (B, c, V), the product in the parameter dtype
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, lc[..., None].long())[..., 0]
    else:  # (B, c, V / m) here; the statistics summed over the ranks
        logz, gold = tp.xent_terms((tp.copy_in(xc, axis) @ head.t()).float(), lc, axis)
    nll = logz - gold
    if mc is not None:
        nll = nll * mc.float()
    return nll.sum()


def chunked_softmax_xent(
    x: torch.Tensor,  # (B, S, D) final hidden states
    head: torch.Tensor,  # (V, D) output embedding
    labels: torch.Tensor,  # (B, S) integer
    chunk: int,
    mask: Optional[torch.Tensor] = None,  # (B, S) bool
    axis: Optional[tp.Axis] = None,  # the model axis of a vocab-split head
) -> torch.Tensor:
    """Mean next-token CE with sequence-chunked logits, a 0-d fp32 tensor.

    Never materializes (B, S, V): each chunk runs under
    ``torch.utils.checkpoint``, so the forward keeps only its summed NLL and
    the backward computes that chunk's logits again; the peak of live
    logits is (B, chunk, V) fp32 (and their gradient), the JAX package's
    promise.  A sequence that ``chunk`` does not divide is one chunk, as
    there.  With ``axis`` the head is a vocab block and each chunk's
    logits are (B, chunk, V / m)."""
    B, S, _ = x.shape
    if axis is not None and axis.size == 1:
        axis = None
    if S % chunk:
        chunk = S  # degenerate/smoke shapes
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, S, chunk):
        cols = slice(c0, c0 + chunk)
        mc = None if mask is None else mask[:, cols]
        tot = tot + checkpoint(_xent_chunk, x[:, cols], head, labels[:, cols], mc, axis,
                               use_reentrant=False, preserve_rng_state=False)
    if mask is None:
        return tot / max(B * S, 1)
    return tot / mask.sum().clamp(min=1).float()
