"""The dense decoder LM: parameters, prefill and decode.

The port of the JAX package's ``models/model.py`` for the dense family
(internlm2, granite-3, tinyllama, qwen3).  Parameters are ``nn.Module``s:
``Model`` holds the embedding, the final norm, the untied head where there
is one, and an ``nn.ModuleList`` of ``DecoderLayer``s, where the JAX package
stacks (L, ...) leaves for its layer scan; the scan becomes a Python loop.
Serving runs under ``torch.no_grad``.  The decode caches are stacked
(L, B, C, KV, hd) as in the JAX package and are updated in place.

The other families (moe, ssm, hybrid, encdec, vlm) raise
``NotImplementedError``: they are still to port (ROADMAP.md Queue 1 item
13b).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig

INIT_SCALE = 0.02


def check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet "
            f"(ROADMAP.md Queue 1 item 13b); the port runs the dense family"
        )


def _param(shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype))


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        D, F = cfg.d_model, cfg.d_ff
        self.w_gate = _param((D, F), device, dtype)
        self.w_up = _param((D, F), device, dtype)
        self.w_down = _param((F, D), device, dtype)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        self.ln1 = _param((cfg.d_model,), device, dtype)
        self.attn = attn.Attention(cfg, device, dtype)
        self.ln2 = _param((cfg.d_model,), device, dtype)
        self.mlp = MLP(cfg, device, dtype)


class Model(nn.Module):
    """The dense LM's parameters, allocated uninitialised on ``device`` in
    the config's parameter dtype (``init_params`` fills them from a seed,
    ``models.convert.params_from_jax`` from the JAX package's tree)."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        check_family(cfg)
        dt = cfg.param_dtype
        self.embed = _param((cfg.vocab_size, cfg.d_model), device, dt)
        self.final_norm = _param((cfg.d_model,), device, dt)
        if not cfg.tie_embeddings:
            self.head = _param((cfg.vocab_size, cfg.d_model), device, dt)
        self.layers = nn.ModuleList(DecoderLayer(cfg, device, dt) for _ in range(cfg.n_layers))
        for p in self.parameters():
            p.requires_grad_(False)

    def head_table(self) -> torch.Tensor:
        return getattr(self, "head", self.embed)


# ------------------------------------------------------------------ param init
def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Model:
    """A ``Model`` on ``device`` from ``seed``: every matrix N(0, 0.02),
    drawn in fp32 by a ``torch.Generator`` on ``device`` and cast to the
    parameter dtype; every norm scale 1.  (The JAX package draws its layer
    norms' scales from N(0, 0.02) too and sets only the final norm to 1;
    its numbers come from ``jax.random`` and cannot be matched by a torch
    generator, so the tests carry the JAX weights across with
    ``params_from_jax`` instead.)"""
    model = Model(cfg, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for name, p in model.named_parameters():
        if p.ndim == 1:
            p.fill_(1.0)
        else:
            draw = torch.randn(p.shape, generator=gen, device=device, dtype=torch.float32)
            p.copy_(draw.mul_(INIT_SCALE))
    return model


# ---------------------------------------------------------------- layer bodies
def _mlp(lp: DecoderLayer, h: torch.Tensor) -> torch.Tensor:
    return layers.swiglu(h, lp.mlp.w_gate, lp.mlp.w_up, lp.mlp.w_down)


def _decoder_layer_full(
    cfg: ModelConfig, lp: DecoderLayer, x: torch.Tensor, positions: torch.Tensor, causal: bool
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence layer: ``(x, k, v)``, with the layer's roped K and its V
    (B, S, KV, hd) for the decode cache.  The JAX package's prefill projects
    K/V once for the cache and again inside its attention; here they are
    projected once (the same ops on the same inputs, so the same numbers)."""
    h = layers.rms_norm(x, lp.ln1, cfg.norm_eps)
    q, k, v = attn.project_qkv(cfg, lp.attn, h, positions)
    x = x + attn.attend(cfg, lp.attn, q, k, v, causal=causal, window=cfg.sliding_window)
    h = layers.rms_norm(x, lp.ln2, cfg.norm_eps)
    return x + _mlp(lp, h), k, v


# --------------------------------------------------------------------- decode
class DecodeState(NamedTuple):
    """The per-layer KV caches, stacked (L, B, C, KV, hd)."""

    kv: attn.KVCache


def make_decode_state(cfg: ModelConfig, batch: int, max_len: int, device="cuda") -> DecodeState:
    """Zeroed caches: a ring of ``sliding_window`` slots for SWA archs, else
    ``max_len`` slots."""
    check_family(cfg)
    one = attn.init_kv_cache(cfg, batch, max_len, device)
    L = cfg.n_layers
    return DecodeState(kv=attn.KVCache(
        k=one.k.new_zeros((L,) + tuple(one.k.shape)),
        v=one.v.new_zeros((L,) + tuple(one.v.shape)),
        length=0,
    ))


def _decoder_layer_decode(
    cfg: ModelConfig, lp: DecoderLayer, x: torch.Tensor, cache: attn.KVCache
) -> torch.Tensor:
    """One-token layer step; the layer's cache is updated in place."""
    h = layers.rms_norm(x, lp.ln1, cfg.norm_eps)
    x = x + attn.decode_attention(cfg, lp.attn, h, cache)
    h = layers.rms_norm(x, lp.ln2, cfg.norm_eps)
    return x + _mlp(lp, h)


@torch.no_grad()
def decode_step(
    cfg: ModelConfig, model: Model, tokens: torch.Tensor, state: DecodeState
) -> Tuple[torch.Tensor, DecodeState]:
    """One serving step: (B, 1) tokens -> (B, V) logits and the advanced
    state.  The caches in ``state`` are written in place (the JAX package
    donates them); the returned state shares their storage."""
    check_family(cfg)
    x = layers.embed(tokens, model.embed)
    kv = state.kv
    for i, lp in enumerate(model.layers):
        x = _decoder_layer_decode(cfg, lp, x, attn.KVCache(kv.k[i], kv.v[i], kv.length))
    x = layers.rms_norm(x, model.final_norm, cfg.norm_eps)
    logits = layers.unembed(x, model.head_table())
    return logits[:, 0, :], DecodeState(attn.KVCache(kv.k, kv.v, kv.length + 1))


@torch.no_grad()
def prefill(
    cfg: ModelConfig, model: Model, tokens: torch.Tensor, max_len: Optional[int] = None
) -> Tuple[torch.Tensor, DecodeState]:
    """Full-sequence pass that also builds the decode caches: (B, S) tokens
    -> (last-position logits (B, V), DecodeState), with room for
    ``max_len`` (default S) tokens.  With ``attention_impl="flash"`` each
    layer launches kernel K5 once on the card."""
    check_family(cfg)
    B, S = tokens.shape
    C = max_len or S
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    x = layers.embed(tokens, model.embed)
    state = make_decode_state(cfg, B, C, tokens.device)
    for i, lp in enumerate(model.layers):
        x, k, v = _decoder_layer_full(cfg, lp, x, positions, causal=True)
        packed = _ring_pack(cfg, k, v, C, S)
        state.kv.k[i].copy_(packed.k)
        state.kv.v[i].copy_(packed.v)
    x = layers.rms_norm(x[:, -1, :], model.final_norm, cfg.norm_eps)
    logits = layers.unembed(x, model.head_table())
    return logits, DecodeState(attn.KVCache(state.kv.k, state.kv.v, S))


def _ring_pack(cfg: ModelConfig, k: torch.Tensor, v: torch.Tensor, C: int, S: int) -> attn.KVCache:
    """Pack prefill K/V (B, S, KV, hd) into the decode cache layout (a ring
    of ``W = min(C, window)`` slots for SWA)."""
    W = min(C, cfg.sliding_window) if cfg.sliding_window else C
    if S >= W:
        # keep the last W tokens, placed at slots (pos % W): for pos in
        # [S-W, S), slot = pos % W -- a roll of the last-W slice.
        shift = (S - W) % W
        ck = torch.roll(k[:, S - W:], shift, dims=1)
        cv = torch.roll(v[:, S - W:], shift, dims=1)
    else:
        pad = (0, 0, 0, 0, 0, W - S)  # zeros after the S tokens, along dim 1
        ck = torch.nn.functional.pad(k, pad)
        cv = torch.nn.functional.pad(v, pad)
    return attn.KVCache(k=ck, v=cv, length=S)
