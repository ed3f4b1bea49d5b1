"""GQA attention: prefill (flash kernel K5 or naive) and decode.

Two implementations behind one interface (``cfg.attention_impl``):

  * ``"flash"`` -- ``kernels.ops.flash_attention``: kernel K5 on the card,
    its plain version on the CPU.  The counterpart of the JAX package's
    ``"flash_pallas"``; the JAX package's ``"blockwise"`` scan is an
    XLA-level schedule that eager PyTorch has no use for.
  * ``"naive"`` -- materialized scores, for tiny tests only.

Prefill attention is ``project_qkv`` then ``attend``: the JAX package's
``multi_head_attention`` in two steps, so that prefill projects K/V once for
both the attention and the decode cache.  Decode attends one new token
against a KV cache; sliding-window archs use a ring buffer of ``window``
slots.  The cache is updated in place, where the JAX package donates it to
the jitted step.  Layouts follow the JAX package:
activations (B, S, H, hd), caches (B, C, KV, hd), weights (in, out).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.kernels import ops as kops
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig

_NEG_INF = -1e30  # the JAX package's mask value for decode scores


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor  # (B, C, KV, hd), or (L, B, C, KV, hd) stacked per layer
    v: torch.Tensor
    # Tokens written so far (absolute), one for the whole batch.  A host int:
    # the ring slot and the rope position come from it without a device sync.
    length: int


def attn_params_shape(cfg: ModelConfig):
    D, hd = cfg.d_model, cfg.resolved_head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    shapes = {
        "wq": (D, H * hd),
        "wk": (D, KV * hd),
        "wv": (D, KV * hd),
        "wo": (H * hd, D),
    }
    if cfg.qk_norm:
        shapes["q_norm"] = (hd,)
        shapes["k_norm"] = (hd,)
    return shapes


class Attention(nn.Module):
    """One attention block's parameters (``attn_params_shape``), allocated
    uninitialised on ``device``; ``models.model.init_params`` or
    ``models.convert.params_from_jax`` fills them."""

    def __init__(self, cfg: ModelConfig, device, dtype: torch.dtype):
        super().__init__()
        for name, shape in attn_params_shape(cfg).items():
            setattr(self, name, nn.Parameter(torch.empty(shape, device=device, dtype=dtype)))


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    B, S, _ = x.shape
    return x.reshape(B, S, n, hd)


def _naive_attn(q, k, v, causal, window, scale):
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    group = H // KV
    qg = (q.float() * scale).reshape(B, Sq, KV, group, hd)
    s = torch.einsum("bqkgd,bpkd->bqkgp", qg, k.float())
    qpos = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
    kpos = torch.arange(Skv, device=q.device)[None, :]
    msk = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        msk &= kpos <= qpos
    if window is not None:
        msk &= kpos > qpos - window
    s = torch.where(msk[None, :, None, None, :], s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqkgp,bpkd->bqkgd", p, v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def _flash_attn(q, k, v, causal, window, scale):
    """(B, S, H, hd) -> contiguous (B*H, S, hd) rows in (batch, head) order,
    so q row b reads kv row b // group: the kernel's GQA mapping."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    qf = q.transpose(1, 2).reshape(B * H, Sq, hd).contiguous()
    kf = k.transpose(1, 2).reshape(B * KV, Skv, hd).contiguous()
    vf = v.transpose(1, 2).reshape(B * KV, Skv, hd).contiguous()
    out = kops.flash_attention(qf, kf, vf, causal=causal, window=window, scale=scale)
    return out.reshape(B, H, Sq, hd).transpose(1, 2)


def project_qkv(
    cfg: ModelConfig, p: Attention, x: torch.Tensor, positions: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q (B, S, H, hd), k and v (B, S, KV, hd) of the full sequence ``x``
    (B, S, D) at ``positions`` (B, S): q and k normed (qk_norm) and roped."""
    hd = cfg.resolved_head_dim
    q = _split_heads(x @ p.wq, cfg.n_heads, hd)
    k = _split_heads(x @ p.wk, cfg.n_kv_heads, hd)
    v = _split_heads(x @ p.wv, cfg.n_kv_heads, hd)
    cos, sin = layers.rope_angles(positions, hd, cfg.rope_theta)
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    if cfg.qk_norm:
        q = layers.rms_norm(q, p.q_norm, cfg.norm_eps)
        k = layers.rms_norm(k, p.k_norm, cfg.norm_eps)
    return layers.apply_rope(q, cos, sin), layers.apply_rope(k, cos, sin), v


def attend(
    cfg: ModelConfig,
    p: Attention,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Full-sequence attention of projected q/k/v, then the output
    projection: (B, Sq, D)."""
    B, Sq, H, hd = q.shape
    scale = hd**-0.5
    if cfg.attention_impl == "naive":
        out = _naive_attn(q, k, v, causal, window, scale)
    else:
        out = _flash_attn(q, k, v, causal, window, scale)
    return out.reshape(B, Sq, H * hd) @ p.wo


# --------------------------------------------------------------------- decode
def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> KVCache:
    """Ring buffer of ``window`` slots for SWA archs, else full ``max_len``."""
    C = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    shape = (batch, C, cfg.n_kv_heads, cfg.resolved_head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=cfg.param_dtype, device=device),
        v=torch.zeros(shape, dtype=cfg.param_dtype, device=device),
        length=0,
    )


def decode_attention(
    cfg: ModelConfig,
    p: Attention,
    x: torch.Tensor,  # (B, 1, D)
    cache: KVCache,
) -> torch.Tensor:
    """One decode step: write the new token's K/V into the (ring) cache in
    place and attend over the cache.  The caller advances the length (one
    for all layers: ``models.model.decode_step``)."""
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    group = H // KV
    pos = cache.length  # absolute position of the new token

    q = _split_heads(x @ p.wq, H, hd)
    k_new = _split_heads(x @ p.wk, KV, hd)
    v_new = _split_heads(x @ p.wv, KV, hd)
    positions = torch.full((1, 1), pos, dtype=torch.int64, device=x.device)
    cos, sin = layers.rope_angles(positions, hd, cfg.rope_theta)
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    if cfg.qk_norm:
        q = layers.rms_norm(q, p.q_norm, cfg.norm_eps)
        k_new = layers.rms_norm(k_new, p.k_norm, cfg.norm_eps)
    q = layers.apply_rope(q, cos, sin)
    k_new = layers.apply_rope(k_new, cos, sin)
    C = cache.k.shape[1]
    slot = pos % C  # ring for SWA, linear when C == max_len
    cache.k[:, slot] = k_new[:, 0]
    cache.v[:, slot] = v_new[:, 0]
    # slot i holds absolute position: ring unwrap
    slots = torch.arange(C, device=x.device)
    if pos + 1 > C:
        abs_pos = torch.where(slots <= slot, pos - slot + slots, pos - slot - C + slots)
    else:
        abs_pos = slots
    valid = abs_pos <= pos
    if cfg.sliding_window:
        valid &= abs_pos > pos - cfg.sliding_window

    qg = (q.float() * hd**-0.5).reshape(B, 1, KV, group, hd)
    s = torch.einsum("bqkgd,bpkd->bqkgp", qg, cache.k.float())
    s = torch.where(valid[None, None, None, None, :], s, torch.full_like(s, _NEG_INF))
    probs = torch.softmax(s, dim=-1)
    out = torch.einsum("bqkgp,bpkd->bqkgd", probs, cache.v.float())
    out = out.reshape(B, 1, H * hd).to(x.dtype)
    return out @ p.wo
