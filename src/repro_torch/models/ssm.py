"""Mamba2 (SSD, state-space duality) mixer: chunked-parallel and decode paths.

The port of the JAX package's ``models/ssm.py``.  Recurrence (per head h,
head-dim p, state n):

    a_t = exp(dt_t * A)             (A < 0, per head)
    h_t = a_t * h_{t-1} + dt_t * B_t (x) x_t
    y_t = C_t . h_t + D * x_t

Prefill runs the chunked parallel form: within a chunk of Q steps the
quadratic intra term is a decay-masked (C B^T) matrix, and one (H, P, N)
state carries across chunks, so peak memory is (B, Q, Q, H) rather than
(B, S, S, H).  The JAX package scans the chunks with ``lax.scan``; here it
is a Python loop.  Decode is the O(1) recurrent update.  A depthwise causal
conv (width 4) precedes the SSM on x, B and C; its tail is part of the
serving cache.

The mixer is plain torch ops (the JAX package's is plain jnp, no Pallas
kernel).  It keeps the JAX package's fp32 casts and clips: the decays are
clipped to [-60, 0], the inter-chunk factor exp(cum) to [-60, +inf), and a
ragged tail is padded with dt = 0 (a = 1 and no input: identity on the
state).  ``ssd_decode`` updates the cache's conv tail and state in place,
so that a CUDA graph of the decode step owns them.

Under tensor parallelism (``sharding/tp.py``) a mixer whose ``wo`` rows
are split is active: ``wx``, ``wz``, ``norm`` and ``wo`` are split over
``d_inner``, ``wdt``, ``dt_bias``, ``A_log`` and ``Dskip`` over the SSM
heads where those divide, and ``wB``, ``wC`` and ``conv_w`` are
replicated.  A rank convolves its ``d_inner`` columns and the 2N B/C
columns, scans its heads, normalises over the whole ``d_inner`` (the
mean of squares spans the ranks) and gives ``wo``'s partial sums to
``reduce_out``.  Where ``d_inner`` divides but the heads do not (hymba-1.5b
at m = 2: 25 heads of 64), the split weights are gathered whole and the
rank computes every head, then keeps its columns of the normed output
for ``wo``'s rows.  The conv tail of the serving cache is replicated (its
spec), so each rank gathers the new ``d_inner`` columns to write it whole.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import tp

CONV_K = 4


@dataclasses.dataclass
class SSMCache:
    conv: torch.Tensor  # (B, CONV_K-1, d_inner + 2N) last conv inputs, or (L, ...) stacked
    state: torch.Tensor  # (B, H, P, N) fp32, or (L, ...) stacked
    # Tokens consumed so far, a 0-d int32 device tensor: in a decode state
    # the one position every cache shares (``models.model.DecodeState``).
    length: torch.Tensor


def ssm_params_shape(cfg: ModelConfig):
    D, di, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    return {
        "wx": (D, di),
        "wz": (D, di),
        "wB": (D, N),
        "wC": (D, N),
        "wdt": (D, H),
        "dt_bias": (H,),
        "A_log": (H,),
        "Dskip": (H,),
        "conv_w": (CONV_K, di + 2 * N),
        "norm": (di,),
        "wo": (di, D),
    }


class SSM(nn.Module):
    """One SSD mixer's parameters (``ssm_params_shape``), allocated
    uninitialised on ``device``; ``models.model.init_params`` or
    ``models.convert.params_from_jax`` fills them."""

    def __init__(self, cfg: ModelConfig, device, dtype: torch.dtype):
        super().__init__()
        for name, shape in ssm_params_shape(cfg).items():
            setattr(self, name, nn.Parameter(torch.empty(shape, device=device, dtype=dtype)))


class _Local(NamedTuple):
    """The mixer's weights as this rank computes with them: ``shard`` (None
    unless active), ``whole`` (the rank computes its own heads), the inner
    width ``di`` and heads ``H`` it computes, and the weights to use."""

    shard: Optional[tp.ModuleShard]
    whole: bool
    di: int
    H: int
    wx: torch.Tensor
    wz: torch.Tensor
    wdt: torch.Tensor
    dt_bias: torch.Tensor
    A_log: torch.Tensor
    Dskip: torch.Tensor
    norm: torch.Tensor

    def conv_cols(self, cfg: ModelConfig, t: torch.Tensor) -> torch.Tensor:
        """The columns of a (..., d_inner + 2N) tensor this rank convolves."""
        if not self.whole or self.shard is None:
            return t
        di = cfg.d_inner
        return torch.cat([self.shard.axis.block(t[..., :di], -1), t[..., di:]], dim=-1)


def _local(cfg: ModelConfig, p: SSM) -> _Local:
    t = tp.get(p)
    names = ("wx", "wz", "wdt", "dt_bias", "A_log", "Dskip", "norm")
    if t is None:
        return _Local(None, False, cfg.d_inner, cfg.ssm_heads, *(getattr(p, n) for n in names))
    whole = t.divides(cfg.ssm_heads)
    m = t.axis.size if whole else 1
    return _Local(t, whole, cfg.d_inner // m, cfg.ssm_heads // m,
                  *(t.weight(p, n, whole) for n in names))


def _out(cfg: ModelConfig, p: SSM, loc: _Local, y: torch.Tensor) -> torch.Tensor:
    """The gated-normed output (B, S, di) through ``wo``: on an active
    mixer its row block, summed over the model axis."""
    if loc.shard is None:
        return y @ p.wo
    if not loc.whole:
        y = loc.shard.axis.block(y, -1)
    return tp.reduce_out(y @ p.wo, loc.shard.axis)


def _norm_axis(loc: _Local) -> Optional[tp.Axis]:
    return loc.shard.axis if loc.shard is not None and loc.whole else None


def _causal_conv(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, width CONV_K.  u: (B, S, C), w: (K, C)."""
    out = u * w[CONV_K - 1]
    for k in range(1, CONV_K):
        shifted = F.pad(u, (0, 0, k, 0))[:, : u.shape[1], :]
        out = out + shifted * w[CONV_K - 1 - k]
    return out


def _project(cfg: ModelConfig, p: SSM, x: torch.Tensor, loc: _Local):
    """x (B, S, D) -> xin (B, S, H, P), z, B_, C_, dt (after conv and
    activations) and the pre-conv inputs ``raw`` (the cache's tail), of
    the heads this rank computes (``loc``)."""
    di, N, H, P = loc.di, cfg.ssm_state, loc.H, cfg.ssm_head_dim
    if loc.shard is not None:
        x = tp.copy_in(x, loc.shard.axis)
    xin = x @ loc.wx  # (B, S, di)
    z = x @ loc.wz
    B_ = x @ p.wB  # (B, S, N)
    C_ = x @ p.wC
    dt = x @ loc.wdt  # (B, S, H)
    raw = torch.cat([xin, B_, C_], dim=-1)
    u = _causal_conv(raw, loc.conv_cols(cfg, p.conv_w))
    u = F.silu(u.float()).to(x.dtype)
    xin, B_, C_ = u[..., :di], u[..., di: di + N], u[..., di + N:]
    dt = F.softplus(dt.float() + loc.dt_bias.float())
    Bsz, S = x.shape[0], x.shape[1]
    return xin.reshape(Bsz, S, H, P), z, B_, C_, dt, raw


def _ssd_scan(
    cfg: ModelConfig, p: SSM, x: torch.Tensor, projected, h0: Optional[torch.Tensor],
    loc: _Local,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD scan of ``_project``'s outputs: (y (B, S, D), final
    state (B, H, P, N) fp32)."""
    Bsz, S, _ = x.shape
    H, P = loc.H, cfg.ssm_head_dim
    Q = min(cfg.ssm_chunk, S)
    xin, z, B_, C_, dt, _ = projected
    A = -torch.exp(loc.A_log.float())  # (H,)
    # Ragged tails: pad to a chunk multiple with dt = 0 -> a = 1 and zero
    # input, so padded steps are identity on the state and ignored in y.
    pad = (-S) % Q
    S_orig = S
    if pad:
        xin = F.pad(xin, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B_ = F.pad(B_, (0, 0, 0, pad))
        C_ = F.pad(C_, (0, 0, 0, pad))
        S = S + pad
    la = dt * A  # (B, S, H) log a_t
    dtx = xin.float() * dt[..., None]  # (B, S, H, P)
    Bf, Cf = B_.float(), C_.float()
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()  # j <= i

    h = h0 if h0 is not None else torch.zeros(
        (Bsz, H, P, cfg.ssm_state), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(S // Q):
        chunk = slice(c * Q, (c + 1) * Q)
        la_k, dtx_k, B_k, C_k = la[:, chunk], dtx[:, chunk], Bf[:, chunk], Cf[:, chunk]
        cum = torch.cumsum(la_k, dim=1)  # inclusive (B, Q, H)
        # intra-chunk: scores[b, i, j, h] = (C_i . B_j) exp(cum_i - cum_j), j <= i
        CB = torch.einsum("bin,bjn->bij", C_k, B_k)
        decay = torch.exp(torch.clamp(cum[:, :, None, :] - cum[:, None, :, :], -60.0, 0.0))
        scores = CB[..., None] * decay * tri[None, :, :, None]
        y_intra = torch.einsum("bijh,bjhp->bihp", scores, dtx_k)
        # inter-chunk: y_inter[i] = exp(cum_i) * C_i . h_in
        Ch = torch.einsum("bin,bhpn->bihp", C_k, h)
        y_inter = Ch * torch.exp(torch.clamp(cum, min=-60.0))[..., None]
        # state update: h_out = exp(cum_Q) h + sum_j exp(cum_Q - cum_j) dtx_j B_j
        tot = cum[:, -1:, :]  # (B, 1, H)
        w = torch.exp(torch.clamp(tot - cum, -60.0, 0.0))  # (B, Q, H)
        contrib = torch.einsum("bjh,bjhp,bjn->bhpn", w, dtx_k, B_k)
        h = h * torch.exp(torch.clamp(tot[:, 0, :], -60.0, 0.0))[:, :, None, None] + contrib
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1)  # (B, S, H, P)
    y = y + xin.float() * loc.Dskip.float()[:, None]
    y = y.reshape(Bsz, S, loc.di)[:, :S_orig]
    # gated RMSNorm (over the whole d_inner), then the output projection
    y = layers.rms_norm((y * F.silu(z.float())).to(x.dtype), loc.norm, cfg.norm_eps,
                        _norm_axis(loc))
    return _out(cfg, p, loc, y), h


def ssd_parallel(
    cfg: ModelConfig, p: SSM, x: torch.Tensor, h0: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan of x (B, S, D) from state ``h0`` (default zeros):
    (y (B, S, D), final state (B, H, P, N) fp32)."""
    loc = _local(cfg, p)
    return _ssd_scan(cfg, p, x, _project(cfg, p, x, loc), h0, loc)


def ssd_prefill(cfg: ModelConfig, p: SSM, x: torch.Tensor) -> Tuple[torch.Tensor, SSMCache]:
    """Parallel pass that also returns the serving cache (conv tail, state,
    length S); on an active mixer the tail holds this rank's ``d_inner``
    columns (``whole_tail`` widens it to the cache's layout).  The JAX package projects once for the tail and again inside
    ``ssd_parallel``; here once for both (the same ops on the same inputs,
    so the same numbers)."""
    S = x.shape[1]
    loc = _local(cfg, p)
    projected = _project(cfg, p, x, loc)
    y, h_final = _ssd_scan(cfg, p, x, projected, None, loc)
    raw = projected[-1]
    tail = raw[:, -(CONV_K - 1):, :].to(cfg.param_dtype)
    pad = CONV_K - 1 - tail.shape[1]
    if pad > 0:
        tail = F.pad(tail, (0, 0, pad, 0))
    length = torch.full((), S, dtype=torch.int32, device=x.device)
    return y, SSMCache(conv=tail, state=h_final, length=length)


def whole_tail(cfg: ModelConfig, p: SSM, tail: torch.Tensor) -> torch.Tensor:
    """A prefill's conv tail (``ssd_prefill``) in the cache's layout: every
    rank's ``d_inner`` columns."""
    return _whole_cols(cfg, _local(cfg, p), tail)


def _whole_cols(cfg: ModelConfig, loc: _Local, u: torch.Tensor) -> torch.Tensor:
    """(..., di + 2N) conv inputs with every rank's ``d_inner`` columns: the
    replicated conv tail's layout."""
    if loc.shard is None or not loc.whole:
        return u
    di = loc.di
    xin = loc.shard.axis.all_gather(u[..., :di], dim=-1)
    return torch.cat([xin, u[..., di:]], dim=-1)


def init_ssm_cache(cfg: ModelConfig, batch: int, device) -> SSMCache:
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    return SSMCache(
        conv=torch.zeros((batch, CONV_K - 1, di + 2 * N), dtype=cfg.param_dtype, device=device),
        state=torch.zeros((batch, H, P, N), dtype=torch.float32, device=device),
        length=torch.zeros((), dtype=torch.int32, device=device),
    )


def ssd_decode(cfg: ModelConfig, p: SSM, x: torch.Tensor, cache: SSMCache) -> torch.Tensor:
    """O(1) recurrent step of x (B, 1, D): the mixer's (B, 1, D) output.
    The cache's conv tail and state are updated in place; the caller
    advances the length (one position for every cache:
    ``models.model.decode_step``).  Nothing here reads a device value on
    the host."""
    Bsz = x.shape[0]
    loc = _local(cfg, p)
    di, N, H, P = loc.di, cfg.ssm_state, loc.H, cfg.ssm_head_dim
    xt = x[:, 0, :]
    xin = xt @ loc.wx
    z = xt @ loc.wz
    B_ = xt @ p.wB
    C_ = xt @ p.wC
    dt = xt @ loc.wdt
    u_new = _whole_cols(cfg, loc, torch.cat([xin, B_, C_], dim=-1))  # (B, d_inner + 2N)
    win = torch.cat([cache.conv, u_new[:, None, :]], dim=1)  # (B, K, ch): a fresh tensor
    u = torch.einsum("bkc,kc->bc", loc.conv_cols(cfg, win), loc.conv_cols(cfg, p.conv_w))
    u = F.silu(u.float()).to(x.dtype)
    xin, B_, C_ = u[:, :di], u[:, di: di + N], u[:, di + N:]
    dt = F.softplus(dt.float() + loc.dt_bias.float())  # (B, H)
    A = -torch.exp(loc.A_log.float())
    a = torch.exp(dt * A)  # (B, H)
    xh = xin.reshape(Bsz, H, P).float()
    h = cache.state * a[:, :, None, None] + torch.einsum("bh,bhp,bn->bhpn", dt, xh, B_.float())
    y = torch.einsum("bn,bhpn->bhp", C_.float(), h)
    y = y + xh * loc.Dskip.float()[:, None]
    y = y.reshape(Bsz, 1, di)
    y = layers.rms_norm(
        (y * F.silu(z.float())[:, None, :]).to(x.dtype), loc.norm, cfg.norm_eps, _norm_axis(loc))
    # ``win`` is a new tensor, so its last K-1 steps do not overlap the
    # tail they replace (a copy from ``cache.conv[:, 1:]`` into itself
    # would smear the tail in a graph's replay).
    cache.conv.copy_(win[:, 1:, :])
    cache.state.copy_(h)
    return _out(cfg, p, loc, y)
