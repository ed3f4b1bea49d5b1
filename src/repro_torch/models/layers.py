"""Shared layers: RMS norm, rope, SwiGLU MLP, embeddings.

Conventions, as in the JAX package: activations (B, S, D); weights in
the config's parameter dtype (bf16 on the serving path); the math that
needs it (norms, rope, the SiLU gate) in fp32.  Weight matrices keep the
JAX layout, (in, out), so ``x @ w``.  The chunked cross-entropy of the JAX
package's layers waits for the training slice.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
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


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """x (..., D) @ (V, D)^T -> (..., V)."""
    return x @ table.t()
