"""The LM of every family: parameters, training forward, prefill and decode.

The port of the JAX package's ``models/model.py`` for all six families:
dense (internlm2, granite-3, tinyllama, qwen3), moe (mixtral: a
mixture-of-experts FFN, ``models/moe.py``, in place of the MLP), ssm
(mamba2: each layer a norm and the SSD mixer, ``models/ssm.py``), hybrid
(hymba: attention and SSD heads side by side, their outputs averaged), encdec
(seamless-m4t: a non-causal encoder over the frontend's frames, and decoder
layers that also attend to its output) and vlm (internvl2: the frontend's
patch embeddings replace the first decoder positions).  The frontends are
stubs, as in the JAX package: precomputed embeddings.  Parameters are
``nn.Module``s: ``Model`` holds the embedding, the final norm, the untied
head where there is one, an ``nn.ModuleList`` of ``DecoderLayer``s and, for
encdec, the encoder's layers and norm, where the JAX package stacks
(L, ...) leaves for its layer scan; the scan becomes a Python loop.
``forward_train`` is the JAX package's training forward: the mean
next-token cross-entropy (``layers.chunked_softmax_xent``) and the MoE
dropped share, each layer under ``torch.utils.checkpoint`` with
``cfg.remat`` (the counterpart of its ``jax.checkpoint`` around the layer
scan's body), keeping what ``cfg.remat_policy`` says.  A model is frozen
unless built ``trainable``.
Serving runs under ``torch.no_grad``.  The decode caches are stacked (L, ...)
as in the JAX package and are updated in place, and the decode position is
one device scalar that every cache shares and the step advances in place,
so the step reads nothing on the host and one CUDA graph of it serves every
position (``serving/serve_loop.py``).

A tensor-parallel model (``serving/serve_loop.py``'s and
``training/train_loop.py``'s mesh steps build one from a placed state) is a
``Model`` whose tensors are this rank's blocks, with ``sharding/tp.py``'s
context attached (``tp.attach``): each module finds its split weights and
collectives through it, the embedding and the head are vocab blocks where
the vocab divides, and the logits of ``prefill`` and ``decode_step`` are
this rank's vocab block.  Its decode state is cut the same way, by
``decode_state_specs`` (``serving/serve_loop.py`` makes it).
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.models import attention as attn
from repro_torch.models import layers, moe, ssm
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import tp

INIT_SCALE = 0.02
PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")
# The parameters that are norm scales (``init_params`` sets them to 1): the
# layers' norms, the q/k norms, the final norms and the SSD mixer's gated
# norm (``ssm.norm``).
NORM_SCALES = frozenset(
    ("ln1", "ln2", "ln_cross", "q_norm", "k_norm", "final_norm", "enc_final_norm", "norm"))


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
    """One layer's parameters, as the JAX package's ``_layer_param_shapes``:
    ssm: ``ln1`` and ``ssm``; else ``ln1``, ``attn``, ``ssm`` (hybrid),
    ``ln_cross`` and ``cross`` (an encdec decoder layer, ``role``
    "decoder"), ``ln2`` and ``moe`` or ``mlp``.  An encoder layer
    (``role`` "encoder") has no cross-attention."""

    def __init__(self, cfg: ModelConfig, device, dtype, role: str = "decoder"):
        super().__init__()
        self.ln1 = _param((cfg.d_model,), device, dtype)
        if cfg.family == "ssm":
            self.ssm = ssm.SSM(cfg, device, dtype)
            return
        self.attn = attn.Attention(cfg, device, dtype)
        if cfg.family == "hybrid":
            self.ssm = ssm.SSM(cfg, device, dtype)
        if role == "decoder" and cfg.family == "encdec":
            self.ln_cross = _param((cfg.d_model,), device, dtype)
            self.cross = attn.Attention(cfg, device, dtype, cross=True)
        self.ln2 = _param((cfg.d_model,), device, dtype)
        if cfg.family == "moe":
            self.moe = moe.MoE(cfg, device, dtype)
        else:
            self.mlp = MLP(cfg, device, dtype)


class Model(nn.Module):
    """The LM's parameters, allocated uninitialised on ``device`` in
    the config's parameter dtype (``init_params`` fills them from a seed,
    ``models.convert.params_from_jax`` from the JAX package's tree).  On
    the ``meta`` device it allocates nothing: a count of its parameters
    is ``cfg.n_params()``.  Its parameters require a gradient only if it
    is ``trainable`` (a serving model is frozen)."""

    def __init__(self, cfg: ModelConfig, device="cuda", trainable: bool = False):
        super().__init__()
        dt = cfg.param_dtype
        self.embed = _param((cfg.vocab_size, cfg.d_model), device, dt)
        self.final_norm = _param((cfg.d_model,), device, dt)
        if not cfg.tie_embeddings:
            self.head = _param((cfg.vocab_size, cfg.d_model), device, dt)
        self.layers = nn.ModuleList(DecoderLayer(cfg, device, dt) for _ in range(cfg.n_layers))
        if cfg.family == "encdec":
            self.enc_layers = nn.ModuleList(
                DecoderLayer(cfg, device, dt, role="encoder") for _ in range(cfg.encoder_layers))
            self.enc_final_norm = _param((cfg.d_model,), device, dt)
        self.requires_grad_(trainable)

    def head_table(self) -> torch.Tensor:
        return getattr(self, "head", self.embed)

    def vocab_axis(self) -> Optional[tp.Axis]:
        """The model axis when the embedding and head are vocab blocks."""
        shard = getattr(self, "tp", None)
        return shard.axis if shard is not None and shard.vocab_split() else None


# ------------------------------------------------------------------ param init
def init_params(cfg: ModelConfig, seed: int = 0, device="cuda", trainable: bool = False) -> Model:
    """A ``Model`` on ``device`` from ``seed``: every norm scale
    (``NORM_SCALES``) 1, every other parameter N(0, 0.02) -- the matrices,
    the MoE router and the (E, in, out) expert stacks, and the SSD mixer's
    ``A_log``, ``dt_bias`` and ``Dskip``, as the JAX package draws them --
    drawn in fp32 by a ``torch.Generator`` on ``device`` in the order of
    ``named_parameters`` and cast to the parameter dtype.  (The JAX package
    draws its layer norms' scales from N(0, 0.02) too and sets only the
    final norms to 1; its numbers come from ``jax.random`` and cannot be
    matched by a torch generator, so the tests carry the JAX weights
    across with ``params_from_jax`` instead.  The dense and moe families
    have no 1-D parameter but norm scales, so their draws are those of
    the rule that set every 1-D parameter to 1.)"""
    model = Model(cfg, device, trainable)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.rsplit(".", 1)[-1] in NORM_SCALES:
                p.fill_(1.0)
            else:
                draw = torch.randn(p.shape, generator=gen, device=device, dtype=torch.float32)
                p.copy_(draw.mul_(INIT_SCALE))
    return model


# ---------------------------------------------------------------- layer bodies
def _mix_ffn(cfg: ModelConfig, lp: DecoderLayer, h: torch.Tensor):
    """The layer's FFN: ``(out, dropped)``.  For the moe family ``dropped``
    is the share of expert assignments its dispatch dropped, a device
    tensor, also copied (detached) into ``lp.moe.dropped`` (prefill and
    decode discard it, as the JAX package does; ``forward_train`` reports
    it); the dense MLP drops nothing."""
    if cfg.family == "moe":
        out, dropped = moe.moe_ffn(cfg, lp.moe, h)
        lp.moe.dropped.copy_(dropped.detach())
        return out, dropped
    shard = tp.get(lp.mlp)  # F blocks: a column block, then a row block's partial sums
    if shard is not None:
        h = tp.copy_in(h, shard.axis)
    out = layers.swiglu(h, lp.mlp.w_gate, lp.mlp.w_up, lp.mlp.w_down)
    return (out if shard is None else tp.reduce_out(out, shard.axis)), 0.0


def _decoder_layer_full(
    cfg: ModelConfig,
    lp: DecoderLayer,
    x: torch.Tensor,
    positions: torch.Tensor,
    causal: bool,
    memory_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
):
    """Full-sequence layer (training, prefill, encoder): ``(x, kv,
    ssm_cache, dropped)``, with the layer's roped K and its V (B, S, KV, hd)
    for the decode cache (None for the ssm family), its SSM cache (ssm and
    hybrid; else None) and its FFN's dropped share (``_mix_ffn``).  The
    JAX package's prefill projects K/V once for the cache and again inside
    its attention; here they are projected once (the same ops on the same
    inputs, so the same numbers).  ``memory_kv``, the encoder memory's
    projected K/V, adds the cross-attention of an encdec decoder layer."""
    h = layers.rms_norm(x, lp.ln1, cfg.norm_eps)
    if cfg.family == "ssm":
        mixed, sc = ssm.ssd_prefill(cfg, lp.ssm, h)
        return x + mixed, None, sc, 0.0
    q, k, v = attn.project_qkv(cfg, lp.attn, h, positions)
    a = attn.attend(cfg, lp.attn, q, k, v, causal=causal, window=cfg.sliding_window)
    sc = None
    if cfg.family == "hybrid":
        s, sc = ssm.ssd_prefill(cfg, lp.ssm, h)
        a = (a + s) * 0.5  # parallel attention + SSM heads (hymba)
    x = x + a
    if memory_kv is not None:
        h = layers.rms_norm(x, lp.ln_cross, cfg.norm_eps)
        x = x + attn.cross_attention(cfg, lp.cross, h, memory_kv)
    h = layers.rms_norm(x, lp.ln2, cfg.norm_eps)
    f, dropped = _mix_ffn(cfg, lp, h)
    return x + f, (k, v), sc, dropped


LayerFn = Callable[[DecoderLayer, torch.Tensor], Tuple[torch.Tensor, object]]


# The matrix products without batch dims: ``x @ w`` of a 2-D weight (a 3-D
# ``x`` is flattened into one ``mm``), with or without a bias.  Batched
# products (``bmm``: the experts, the naive attention's and the SSD scan's
# einsums) and K5 are not among them.
_DOTS = frozenset((torch.ops.aten.mm.default, torch.ops.aten.addmm.default))


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """The "dots" policy: keep the outputs of ``_DOTS``, recompute the rest
    (``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``)."""
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg: ModelConfig) -> Optional[str]:
    """The layers' remat policy in ``forward_train``: None without remat."""
    return cfg.remat_policy if cfg.remat else None


def _run_layers(layer_list: nn.ModuleList, x: torch.Tensor, fn: LayerFn,
                remat: Optional[str]):
    """``fn(lp, x) -> (x, dropped)`` over the layers: ``(x, the summed
    dropped share)``, a 0-d fp32 tensor.  With ``remat`` each layer runs
    under ``torch.utils.checkpoint`` and the backward runs the layer again
    (the JAX package's ``jax.checkpoint`` around its scan body): "none"
    keeps only the layer's input through the forward, "dots" also the
    outputs of its ``_DOTS``, which the backward's rerun reads instead of
    recomputing them (a selective checkpoint)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in layer_list:
        if remat is None:
            x, dropped = fn(lp, x)
        elif remat == "none":
            x, dropped = checkpoint(fn, lp, x, use_reentrant=False, preserve_rng_state=False)
        else:
            x, dropped = checkpoint(
                fn, lp, x, use_reentrant=False, preserve_rng_state=False,
                context_fn=functools.partial(create_selective_checkpoint_contexts, _save_dots))
        aux = aux + dropped
    return x, aux


# ------------------------------------------------------------------- embedding
def _embed_inputs(cfg: ModelConfig, model: Model, tokens: torch.Tensor,
                  frontend_embeds: Optional[torch.Tensor]) -> torch.Tensor:
    """The decoder's input (B, S, D): the tokens' embeddings, the first
    ``flen`` positions replaced by the vlm frontend's patch embeddings."""
    x = layers.embed(tokens, model.embed, model.vocab_axis())
    if cfg.family == "vlm" and frontend_embeds is not None:
        flen = frontend_embeds.shape[1]
        if flen > tokens.shape[1]:
            raise ValueError(f"{flen} patch embeddings do not fit a prompt of {tokens.shape[1]}")
        x = torch.cat([frontend_embeds.to(x.dtype), x[:, flen:, :]], dim=1)
    return x


def _run_encoder(cfg: ModelConfig, model: Model, frontend_embeds: torch.Tensor,
                 remat: Optional[str] = None) -> torch.Tensor:
    """The encdec encoder over the frontend's frames (B, Smem, D), non-causal,
    then its final norm: the memory (B, Smem, D)."""
    B, S, _ = frontend_embeds.shape
    positions = torch.arange(S, device=frontend_embeds.device).expand(B, S)

    def layer(lp, h):
        h, _, _, dropped = _decoder_layer_full(cfg, lp, h, positions, causal=False)
        return h, dropped

    x, _ = _run_layers(model.enc_layers, frontend_embeds.to(cfg.param_dtype), layer, remat)
    return layers.rms_norm(x, model.enc_final_norm, cfg.norm_eps)


# ------------------------------------------------------------------ training
def forward_train(
    cfg: ModelConfig,
    model: Model,
    tokens: torch.Tensor,
    labels: torch.Tensor,
    frontend_embeds: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The mean next-token cross-entropy of (B, S) ``tokens`` against
    ``labels`` and the metrics ``{"loss", "moe_dropped"}`` (the layers'
    dropped shares summed over n_layers, as the JAX package reports them; 0
    without MoE), all device tensors.  encdec: the encoder consumes
    ``frontend_embeds`` (its frames, which it needs) and every decoder layer
    projects its cross K/V from the memory; vlm: the patch embeddings
    replace the first positions, which the loss leaves out (the mask
    ``positions >= flen``).  With ``cfg.remat`` every layer, the encoder's
    too, runs under ``torch.utils.checkpoint`` with ``cfg.remat_policy``."""
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    enc_out = None
    if cfg.family == "encdec":
        if frontend_embeds is None:
            raise ValueError(f"{cfg.name}: the encdec forward needs frontend_embeds, the "
                             f"encoder's frames")
        enc_out = _run_encoder(cfg, model, frontend_embeds, remat=_remat(cfg))
        x = layers.embed(tokens, model.embed, model.vocab_axis())
    else:
        x = _embed_inputs(cfg, model, tokens, frontend_embeds)

    def layer(lp, h):
        mem = None if enc_out is None else attn.project_cross_kv(cfg, lp.cross, enc_out)
        h, _, _, dropped = _decoder_layer_full(cfg, lp, h, positions, causal=True, memory_kv=mem)
        return h, dropped

    x, aux = _run_layers(model.layers, x, layer, _remat(cfg))
    x = layers.rms_norm(x, model.final_norm, cfg.norm_eps)
    mask = None
    if cfg.family == "vlm" and frontend_embeds is not None:
        mask = positions >= frontend_embeds.shape[1]
    loss = layers.chunked_softmax_xent(x, model.head_table(), labels, cfg.logit_chunk, mask,
                                       model.vocab_axis())
    return loss, {"loss": loss, "moe_dropped": aux / max(cfg.n_layers, 1)}


# --------------------------------------------------------------------- decode
class DecodeState(NamedTuple):
    """The per-layer caches, stacked (L, ...), and the decode position.

    ``kv``: the attention families' KV caches (L, B, C, KV, hd); ``ssm``:
    the ssm and hybrid families' conv tails (L, B, CONV_K - 1, d_inner +
    2N) and states (L, B, H, P, N) fp32; ``cross_kv``: the encdec
    decoder's cross-attention memory K and V (L, B, Smem, KV, hd), Smem the
    encoder's length (never padded: decode attends to every slot);
    ``position``: a 0-d int32 device tensor, the tokens consumed so far,
    which ``kv.length`` and ``ssm.length`` are too.  Absent caches are
    None."""

    kv: Optional[attn.KVCache]
    ssm: Optional[ssm.SSMCache]
    cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]]
    position: torch.Tensor


def make_decode_state(
    cfg: ModelConfig, batch: int, max_len: int, device="cuda", memory_len: Optional[int] = None
) -> DecodeState:
    """Zeroed caches at position 0: a ring of ``sliding_window`` slots for
    SWA archs, else ``max_len`` slots; for encdec a cross memory of
    ``memory_len`` slots, the encoder's length, which it needs."""
    L = cfg.n_layers

    def stacked(one: torch.Tensor) -> torch.Tensor:  # one layer's cache (a meta tensor), L times
        return torch.zeros((L,) + tuple(one.shape), dtype=one.dtype, device=device)

    position = torch.zeros((), dtype=torch.int32, device=device)
    kv = sm = cross = None
    if cfg.has_attention:
        one = attn.init_kv_cache(cfg, batch, max_len, "meta")
        kv = attn.KVCache(k=stacked(one.k), v=stacked(one.v), length=position)
    if cfg.family in ("ssm", "hybrid"):
        one = ssm.init_ssm_cache(cfg, batch, "meta")
        sm = ssm.SSMCache(conv=stacked(one.conv), state=stacked(one.state), length=position)
    if cfg.family == "encdec":
        if memory_len is None:
            raise ValueError(f"{cfg.name}: an encdec decode state needs memory_len, the "
                             f"encoder's length (the cross memory is never padded)")
        shape = (L, batch, memory_len, cfg.n_kv_heads, cfg.resolved_head_dim)
        cross = (torch.zeros(shape, dtype=cfg.param_dtype, device=device),
                 torch.zeros(shape, dtype=cfg.param_dtype, device=device))
    return DecodeState(kv=kv, ssm=sm, cross_kv=cross, position=position)


def state_tensors(state: DecodeState) -> Dict[str, torch.Tensor]:
    """The state's cache tensors by name (the position aside)."""
    out: Dict[str, torch.Tensor] = {}
    if state.kv is not None:
        out.update({"kv.k": state.kv.k, "kv.v": state.kv.v})
    if state.ssm is not None:
        out.update({"ssm.conv": state.ssm.conv, "ssm.state": state.ssm.state})
    if state.cross_kv is not None:
        out.update({"cross_kv.k": state.cross_kv[0], "cross_kv.v": state.cross_kv[1]})
    return out


def _decoder_layer_decode(
    cfg: ModelConfig,
    lp: DecoderLayer,
    x: torch.Tensor,
    cache_kv: Optional[attn.KVCache],
    cache_ssm: Optional[ssm.SSMCache],
    cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]],
) -> torch.Tensor:
    """One-token layer step; the layer's caches are updated in place."""
    h = layers.rms_norm(x, lp.ln1, cfg.norm_eps)
    if cfg.family == "ssm":
        return x + ssm.ssd_decode(cfg, lp.ssm, h, cache_ssm)
    a = attn.decode_attention(cfg, lp.attn, h, cache_kv)
    if cfg.family == "hybrid":
        a = (a + ssm.ssd_decode(cfg, lp.ssm, h, cache_ssm)) * 0.5
    x = x + a
    if cross_kv is not None:
        h = layers.rms_norm(x, lp.ln_cross, cfg.norm_eps)
        x = x + attn.decode_attention(cfg, lp.cross, h, None, kv_override=cross_kv)
    h = layers.rms_norm(x, lp.ln2, cfg.norm_eps)
    f, _ = _mix_ffn(cfg, lp, h)
    return x + f


@torch.no_grad()
def decode_step(
    cfg: ModelConfig, model: Model, tokens: torch.Tensor, state: DecodeState
) -> Tuple[torch.Tensor, DecodeState]:
    """One serving step: (B, 1) tokens -> (B, V) logits and the advanced
    state.  The caches and the position in ``state`` are advanced in place
    (the JAX package donates them), so the returned state is ``state``."""
    x = layers.embed(tokens, model.embed, model.vocab_axis())
    pos, kv, sm, cross = state.position, state.kv, state.ssm, state.cross_kv
    for i, lp in enumerate(model.layers):
        x = _decoder_layer_decode(
            cfg, lp, x,
            None if kv is None else attn.KVCache(kv.k[i], kv.v[i], pos, kv.seq_axis),
            None if sm is None else ssm.SSMCache(sm.conv[i], sm.state[i], pos),
            None if cross is None else (cross[0][i], cross[1][i]),
        )
    x = layers.rms_norm(x, model.final_norm, cfg.norm_eps)
    logits = layers.unembed(x, model.head_table())
    pos.add_(1)
    return logits[:, 0, :], state


@torch.no_grad()
def prefill(
    cfg: ModelConfig,
    model: Model,
    tokens: torch.Tensor,
    frontend_embeds: Optional[torch.Tensor] = None,
    max_len: Optional[int] = None,
    out: Optional[DecodeState] = None,
) -> Tuple[torch.Tensor, DecodeState]:
    """Full-sequence pass that also builds the decode caches: (B, S) tokens
    -> (last-position logits (B, V), DecodeState), with room for
    ``max_len`` (default S) tokens.  ``frontend_embeds``: the encdec
    encoder's frames (B, Smem, D), which it needs, or the vlm's patch
    embeddings (B, flen, D); other families ignore them, as the JAX
    package does.  With ``out``, a state of that shape
    (``make_decode_state``), the caches and the position are written into
    it and it is returned: a graphed decode step reads fixed addresses.
    With ``attention_impl="flash"`` each attention launches kernel K5 once
    on the card: a layer's self-attention, and an encdec encoder layer's
    and decoder layer's cross-attention."""
    B, S = tokens.shape
    C = max_len or S
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    enc_out = memory_len = None
    if cfg.family == "encdec":
        if frontend_embeds is None:
            raise ValueError(f"{cfg.name}: the encdec prefill needs frontend_embeds, the "
                             f"encoder's frames")
        enc_out = _run_encoder(cfg, model, frontend_embeds)
        memory_len = enc_out.shape[1]
        x = layers.embed(tokens, model.embed, model.vocab_axis())
    else:
        x = _embed_inputs(cfg, model, tokens, frontend_embeds)
    state = make_decode_state(cfg, B, C, tokens.device, memory_len) if out is None else out
    # (a tensor-parallel model's state holds its rank's blocks, cut by its serve loop)
    if out is not None and getattr(model, "tp", None) is None:
        want = {k: tuple(t.shape) for k, t in
                state_tensors(make_decode_state(cfg, B, C, "meta", memory_len)).items()}
        got = {k: tuple(t.shape) for k, t in state_tensors(state).items()}
        if got != want:
            raise ValueError(f"out state caches are {got}, want {want}")
    W = min(C, cfg.sliding_window) if cfg.sliding_window else C
    for i, lp in enumerate(model.layers):
        mem = None if enc_out is None else attn.project_cross_kv(cfg, lp.cross, enc_out)
        x, kv, sc, _ = _decoder_layer_full(cfg, lp, x, positions, causal=True, memory_kv=mem)
        if kv is not None:
            seq = state.kv.seq_axis
            if seq is not None:  # every kv head of this rank's slots
                kv = tuple(attn.all_heads(cfg, lp.attn, t, kv=True) for t in kv)
            ck, cv = _ring_pack(*kv, W, S)
            if seq is not None:
                ck, cv = seq.block(ck, 1), seq.block(cv, 1)
            state.kv.k[i].copy_(ck)
            state.kv.v[i].copy_(cv)
        if sc is not None:
            state.ssm.conv[i].copy_(ssm.whole_tail(cfg, lp.ssm, sc.conv))
            state.ssm.state[i].copy_(sc.state)
        if mem is not None:
            state.cross_kv[0][i].copy_(mem[0])
            state.cross_kv[1][i].copy_(mem[1])
    state.position.fill_(S)
    x = layers.rms_norm(x[:, -1, :], model.final_norm, cfg.norm_eps)
    logits = layers.unembed(x, model.head_table())
    return logits, state


def _ring_pack(k: torch.Tensor, v: torch.Tensor, W: int, S: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack prefill K/V (B, S, KV, hd) into the decode cache layout of
    ``W`` slots (a ring of ``W = min(C, window)`` slots for SWA): the
    caches' (k, v)."""
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
    return ck, cv
