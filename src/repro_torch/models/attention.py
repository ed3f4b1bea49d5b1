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
the jitted step, and the position is read on the device, so that one CUDA
graph of the decode step serves every position.  Layouts follow the JAX
package:
activations (B, S, H, hd), caches (B, C, KV, hd), weights (in, out).

Under tensor parallelism (``sharding/tp.py``) a block whose ``wo`` rows
are split is *active*: its input enters through ``copy_in``, each rank
computes its heads, and ``wo``'s row block gives partial sums that
``reduce_out`` completes.  ``param_specs`` splits the product H·hd, not H,
so a block can cut a head in two (hymba-1.5b at m = 2: 25 heads of 64,
12.5 a rank).  The stored blocks stay as the spec says (checkpoints and
``elastic`` depend on them); such a weight is gathered whole before use
and the rank computes every head, then keeps its columns of the output
for ``wo``'s rows.  (GSPMD instead reshards the activations as its cost
model picks; the function is the same.)  Rank r's q heads attend to the
kv heads they map to: its own when H and KV both divide, else selected
from the whole set (``_kv_for``).  The decode cache is head-split when KV
divides, or sequence-split (``KVCache.seq_axis``): each rank holds 1/m of
the slots, writes the new token's K/V where it owns the slot, attends
every head's q over its slots, and the ranks combine the partial softmax
(max, sum, weighted V).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch.kernels import ops as kops
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import tp

_NEG_INF = -1e30  # the JAX package's mask value for decode scores


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor  # (B, C, KV, hd), or (L, B, C, KV, hd) stacked per layer
    v: torch.Tensor
    # Tokens written so far (absolute), one for the whole batch: a 0-d int32
    # tensor on the caches' device, as in the JAX package.  The rope
    # position, the ring slot and the unwrap are computed from it on the
    # device, so a captured decode step reads the position of each replay.
    length: torch.Tensor
    # Set when the slots are split over the model axis (a sequence-sharded
    # cache): k and v hold this rank's C / m slots of the ring.
    seq_axis: Optional[tp.Axis] = None


def attn_params_shape(cfg: ModelConfig, cross: bool = False):
    """The block's weights; a cross-attention block (``cross``) has no
    q/k norms, as its q and memory keys are neither normed nor roped."""
    D, hd = cfg.d_model, cfg.resolved_head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    shapes = {
        "wq": (D, H * hd),
        "wk": (D, KV * hd),
        "wv": (D, KV * hd),
        "wo": (H * hd, D),
    }
    if cfg.qk_norm and not cross:
        shapes["q_norm"] = (hd,)
        shapes["k_norm"] = (hd,)
    return shapes


class Attention(nn.Module):
    """One attention block's parameters (``attn_params_shape``), allocated
    uninitialised on ``device``; ``models.model.init_params`` or
    ``models.convert.params_from_jax`` fills them."""

    def __init__(self, cfg: ModelConfig, device, dtype: torch.dtype, cross: bool = False):
        super().__init__()
        for name, shape in attn_params_shape(cfg, cross).items():
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


class _Heads(NamedTuple):
    """The heads an active block computes on this rank: q heads
    [q0, q0 + nq) and kv heads [k0, k0 + nk) of the full sets."""

    shard: tp.ModuleShard
    q0: int
    nq: int
    k0: int
    nk: int


def _heads(cfg: ModelConfig, p: Attention) -> Optional[_Heads]:
    t = tp.get(p)
    if t is None:
        return None
    q0, nq = t.units("wq", cfg.n_heads, t.divides(cfg.n_heads))
    k0, nk = t.units("wk", cfg.n_kv_heads, t.divides(cfg.n_kv_heads))
    return _Heads(t, q0, nq, k0, nk)


def _weights(cfg: ModelConfig, p: Attention, h: Optional[_Heads], *names: str):
    if h is None:
        return [getattr(p, n) for n in names]
    whole = {"wq": h.shard.divides(cfg.n_heads), "wk": h.shard.divides(cfg.n_kv_heads),
             "wv": h.shard.divides(cfg.n_kv_heads)}
    return [h.shard.weight(p, n, whole[n]) for n in names]


def _kv_for(cfg: ModelConfig, h: Optional[_Heads], k: torch.Tensor, v: torch.Tensor):
    """The kv heads (dim 2) that q heads [q0, q0 + nq) read, in the GQA
    layout (q head j reads kv head j // (nq / nk)): a slice when the q
    block holds whole groups, else one kv head a q head."""
    if h is None:
        return k, v
    group = cfg.n_heads // cfg.n_kv_heads
    if h.q0 % group == 0 and h.nq % group == 0:
        a, n = h.q0 // group - h.k0, h.nq // group
        if a == 0 and n == k.shape[2]:
            return k, v
        return k[:, :, a:a + n], v[:, :, a:a + n]
    idx = torch.arange(h.q0, h.q0 + h.nq, device=k.device) // group - h.k0
    return k.index_select(2, idx), v.index_select(2, idx)


def _out_proj(cfg: ModelConfig, p: Attention, h: Optional[_Heads], out: torch.Tensor):
    """(B, S, nq·hd) attention output -> (B, S, D): ``wo``, or on an
    active block its row block on this rank's columns, summed over the
    model axis."""
    if h is None:
        return out @ p.wo
    if h.nq == cfg.n_heads:  # every head computed here: keep this rank's columns
        out = h.shard.axis.block(out, -1)
    return tp.reduce_out(out @ p.wo, h.shard.axis)


def project_qkv(
    cfg: ModelConfig, p: Attention, x: torch.Tensor, positions: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q (B, S, H, hd), k and v (B, S, KV, hd) of the full sequence ``x``
    (B, S, D) at ``positions`` (B, S): q and k normed (qk_norm) and roped.
    On an active block, this rank's heads (``_heads``)."""
    hd = cfg.resolved_head_dim
    h = _heads(cfg, p)
    if h is not None:
        x = tp.copy_in(x, h.shard.axis)
    wq, wk, wv = _weights(cfg, p, h, "wq", "wk", "wv")
    q = _split_heads(x @ wq, wq.shape[1] // hd, hd)
    k = _split_heads(x @ wk, wk.shape[1] // hd, hd)
    v = _split_heads(x @ wv, wv.shape[1] // hd, hd)
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
    h = _heads(cfg, p)
    k, v = _kv_for(cfg, h, k, v)
    if cfg.attention_impl == "naive":
        out = _naive_attn(q, k, v, causal, window, scale)
    else:
        out = _flash_attn(q, k, v, causal, window, scale)
    return _out_proj(cfg, p, h, out.reshape(B, Sq, H * hd))


def project_cross_kv(
    cfg: ModelConfig, p: Attention, memory: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention K and V (B, Smem, KV, hd) of the encoder memory
    (B, Smem, D): projected once, neither normed nor roped."""
    hd = cfg.resolved_head_dim
    h = _heads(cfg, p)
    if h is not None:
        memory = tp.copy_in(memory, h.shard.axis)
    wk, wv = _weights(cfg, p, h, "wk", "wv")
    k = _split_heads(memory @ wk, wk.shape[1] // hd, hd)
    v = _split_heads(memory @ wv, wv.shape[1] // hd, hd)
    return k, v


def cross_attention(
    cfg: ModelConfig, p: Attention, x: torch.Tensor, memory_kv: Tuple[torch.Tensor, torch.Tensor]
) -> torch.Tensor:
    """Full-sequence cross-attention of x (B, S, D) over the projected
    memory (``project_cross_kv``), non-causal: (B, S, D).  q is neither
    normed nor roped (the JAX package's ``kv_override`` path)."""
    hd = cfg.resolved_head_dim
    h = _heads(cfg, p)
    if h is not None:
        x = tp.copy_in(x, h.shard.axis)
    (wq,) = _weights(cfg, p, h, "wq")
    q = _split_heads(x @ wq, wq.shape[1] // hd, hd)
    return attend(cfg, p, q, *memory_kv, causal=False, window=None)


# --------------------------------------------------------------------- decode
def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> KVCache:
    """Ring buffer of ``window`` slots for SWA archs, else full ``max_len``."""
    C = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    shape = (batch, C, cfg.n_kv_heads, cfg.resolved_head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=cfg.param_dtype, device=device),
        v=torch.zeros(shape, dtype=cfg.param_dtype, device=device),
        length=torch.zeros((), dtype=torch.int32, device=device),
    )


def all_heads(cfg: ModelConfig, p: Attention, t: torch.Tensor, kv: bool) -> torch.Tensor:
    """Every head of (B, S, n, hd) ``t`` (q heads, or kv heads with
    ``kv``): gathered over the model axis when this rank holds its block."""
    h = _heads(cfg, p)
    total = cfg.n_kv_heads if kv else cfg.n_heads
    if h is None or t.shape[2] == total:
        return t
    return h.shard.axis.all_gather(t, dim=2)


def decode_attention(
    cfg: ModelConfig,
    p: Attention,
    x: torch.Tensor,  # (B, 1, D)
    cache: Optional[KVCache],
    kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """One decode step: write the new token's K/V into the (ring) cache in
    place and attend over the cache.  The caller advances the length (one
    for all layers: ``models.model.decode_step``).  With ``kv_override``,
    cross-attention: q (neither normed nor roped) attends over every slot
    of the given memory K/V (B, Smem, KV, hd), and no cache is read or
    written.  A cache with a ``seq_axis`` holds this rank's slots
    (``_decode_seq``).  Nothing here reads a device value on the host."""
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    h = _heads(cfg, p)
    (wq,) = _weights(cfg, p, h, "wq")
    q = _split_heads(x @ wq, wq.shape[1] // hd, hd)
    if kv_override is not None:
        k_all, v_all = kv_override
        valid = None
    elif cache.seq_axis is not None:
        return _decode_seq(cfg, p, h, x, q, cache)
    else:
        q, k_all, v_all, valid = _write_self_kv(cfg, p, h, x, q, cache)
    k_all, v_all = _kv_for(cfg, h, k_all, v_all)
    nq, nk = q.shape[2], k_all.shape[2]
    group = nq // nk
    qg = (q.float() * hd**-0.5).reshape(B, 1, nk, group, hd)
    s = torch.einsum("bqkgd,bpkd->bqkgp", qg, k_all.float())
    if valid is not None:
        s = torch.where(valid[None, None, None, None, :], s, torch.full_like(s, _NEG_INF))
    probs = torch.softmax(s, dim=-1)
    out = torch.einsum("bqkgp,bpkd->bqkgd", probs, v_all.float())
    out = out.reshape(B, 1, nq * hd).to(x.dtype)
    return _out_proj(cfg, p, h, out)


def _new_kv(cfg: ModelConfig, p: Attention, h: Optional[_Heads], x: torch.Tensor,
            q: torch.Tensor, pos: torch.Tensor):
    """The new token's q and K normed (qk_norm) and roped at ``pos``, and
    its V: (q, k_new, v_new)."""
    hd = cfg.resolved_head_dim
    wk, wv = _weights(cfg, p, h, "wk", "wv")
    k_new = _split_heads(x @ wk, wk.shape[1] // hd, hd)
    v_new = _split_heads(x @ wv, wv.shape[1] // hd, hd)
    cos, sin = layers.rope_angles(pos.view(1, 1), hd, cfg.rope_theta)
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    if cfg.qk_norm:
        q = layers.rms_norm(q, p.q_norm, cfg.norm_eps)
        k_new = layers.rms_norm(k_new, p.k_norm, cfg.norm_eps)
    return layers.apply_rope(q, cos, sin), layers.apply_rope(k_new, cos, sin), v_new


def _valid_slots(cfg: ModelConfig, pos: torch.Tensor, slot: torch.Tensor, C: int,
                 slots: torch.Tensor) -> torch.Tensor:
    """Which ring ``slots`` (absolute slot indices of a ring of ``C``)
    hold a token the new one at ``pos`` (in slot ``slot``) attends to:
    the ring unwrapped, branch-free."""
    abs_pos = torch.where(
        pos + 1 > C,
        torch.where(slots <= slot, pos - slot + slots, pos - slot - C + slots),
        slots,
    )
    valid = abs_pos <= pos
    if cfg.sliding_window:
        valid &= abs_pos > pos - cfg.sliding_window
    return valid


def _write_self_kv(cfg: ModelConfig, p: Attention, h: Optional[_Heads], x: torch.Tensor,
                   q: torch.Tensor, cache: KVCache):
    """Self-attention's part of a decode step: q and the new K normed
    (qk_norm) and roped at the cache's position, K/V written into the
    (ring) cache in place.  Returns (q, cache K, cache V, valid slots)."""
    pos = cache.length  # absolute position of the new token, () int32
    q, k_new, v_new = _new_kv(cfg, p, h, x, q, pos)
    C = cache.k.shape[1]
    slot = pos % C  # ring for SWA, linear when C == max_len
    index = slot.view(1).long()
    cache.k.index_copy_(1, index, k_new)
    cache.v.index_copy_(1, index, v_new)
    slots = torch.arange(C, dtype=torch.int32, device=x.device)
    return q, cache.k, cache.v, _valid_slots(cfg, pos, slot, C, slots)


def _decode_seq(cfg: ModelConfig, p: Attention, h: Optional[_Heads], x: torch.Tensor,
                q: torch.Tensor, cache: KVCache) -> torch.Tensor:
    """A decode step on a sequence-sharded cache: this rank holds slots
    [first, first + C / m) of every kv head.  Every head's q and the new
    token's whole K/V are gathered; the owner of the new token's slot
    writes it (a select, so every rank runs the same ops); each rank
    attends over its slots and the ranks combine the partial softmax:
    the max over the axis, then the rescaled sums and weighted V summed."""
    axis = cache.seq_axis
    B, hd = x.shape[0], cfg.resolved_head_dim
    pos = cache.length
    q, k_new, v_new = _new_kv(cfg, p, h, x, q, pos)
    q = all_heads(cfg, p, q, kv=False)
    k_new, v_new = all_heads(cfg, p, k_new, kv=True), all_heads(cfg, p, v_new, kv=True)
    Cl = cache.k.shape[1]
    C, first = Cl * axis.size, axis.index * Cl
    slot = pos % C
    local = slot - first
    own = (local >= 0) & (local < Cl)
    index = local.clamp(0, Cl - 1).view(1).long()
    cache.k.index_copy_(1, index, torch.where(own, k_new, cache.k.index_select(1, index)))
    cache.v.index_copy_(1, index, torch.where(own, v_new, cache.v.index_select(1, index)))
    slots = first + torch.arange(Cl, dtype=torch.int32, device=x.device)
    valid = _valid_slots(cfg, pos, slot, C, slots)
    H, KV = cfg.n_heads, cfg.n_kv_heads
    qg = (q.float() * hd**-0.5).reshape(B, 1, KV, H // KV, hd)
    s = torch.einsum("bqkgd,bpkd->bqkgp", qg, cache.k.float())
    s = torch.where(valid[None, None, None, None, :], s, torch.full_like(s, _NEG_INF))
    top = axis.all_reduce(s.amax(dim=-1, keepdim=True), tp.dist.ReduceOp.MAX)
    e = torch.exp(s - top)
    part = torch.cat([torch.einsum("bqkgp,bpkd->bqkgd", e, cache.v.float()),
                      e.sum(dim=-1, keepdim=True)], dim=-1)
    part = axis.all_reduce(part)
    out = (part[..., :hd] / part[..., hd:]).reshape(B, 1, H * hd).to(x.dtype)
    if h is None:
        return out @ p.wo
    return _out_proj(cfg, p, h._replace(q0=0, nq=H), out)
