"""Model configuration: one frozen dataclass describes all ten architectures.

The port's own copy of the JAX package's ``ModelConfig``: the same fields
for the model's shapes and families, and the same derived properties.
Families:

  dense   -- GQA decoder LM (internlm2, granite-3, tinyllama, qwen3)
  moe     -- dense + mixture-of-experts FFN (mixtral)
  ssm     -- attention-free mamba2 (SSD)
  hybrid  -- hymba: parallel attention + SSM heads per layer
  encdec  -- seamless-m4t: encoder + causal decoder with cross-attention
  vlm     -- internvl2: decoder LM consuming stub patch embeddings

The port serves and trains all six families (``models.model``).
``ShapeConfig`` and ``input_specs`` describe a request's inputs, the
frontend's stub embeddings among them, as ``meta`` tensors (no data);
``SHAPES`` are the dry run's four cell shapes and ``cell_is_runnable``
says which (arch, shape) cells run, as in the JAX package.  The training
switches are kept: ``remat`` (each layer under ``torch.utils.checkpoint``),
``remat_policy`` (what a layer keeps under it: "none", nothing but its
input; "dots", also the outputs of its matrix products without batch
dims, the JAX package's ``dots_with_no_batch_dims_saveable``) and
``logit_chunk`` (the cross-entropy's sequence chunk).  So are the sharding
switches that ``sharding/specs.py`` reads: ``sharding_strategy`` ("tp", or
"dp_only": parameters replicated, the batch split over every mesh axis)
and ``zero1`` (the optimizer state split over the data axis).  The JAX
package's XLA and TPU switches (``scan_layers``,
``attn_block_q``/``attn_block_k``) have no meaning in eager PyTorch and are
left out.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")
# "flash": kernel K5 on the card (its plain version on the CPU); "naive":
# materialized scores, for tiny tests only.
ATTENTION_IMPLS = ("flash", "naive")
REMAT_POLICIES = ("none", "dots")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # one of FAMILIES
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    qk_norm: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    rope_theta: float = 1e6
    # --- MoE
    n_experts: int = 0
    top_k: int = 0
    moe_dispatch: str = "queue"  # "queue" (the paper's best) | "direct"
    capacity_factor: float = 1.25
    moe_groups: Optional[int] = None  # dispatch groups along the batch dim
    # --- attention extras
    sliding_window: Optional[int] = None
    # --- SSM (mamba2 SSD / hymba heads)
    ssm_state: int = 0
    ssm_expand: int = 1
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    # --- encoder-decoder
    encoder_layers: int = 0
    # --- modality frontend stub
    frontend: Optional[str] = None  # "audio" | "vision"
    frontend_len: int = 0  # frames/patches prepended
    # --- numerics / implementation
    dtype: str = "bfloat16"
    sharding_strategy: str = "tp"  # "tp" | "dp_only"
    zero1: bool = False  # ZeRO-1: AdamW's state split over the data axis
    attention_impl: str = "flash"  # one of ATTENTION_IMPLS
    # --- training
    remat: bool = True  # each layer under torch.utils.checkpoint in forward_train
    remat_policy: str = "none"  # one of REMAT_POLICIES
    logit_chunk: int = 512  # sequence chunk of the cross-entropy's logits

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r} (want one of {FAMILIES})")
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(
                f"unknown attention_impl {self.attention_impl!r} (want one of "
                f"{ATTENTION_IMPLS})"
            )
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(
                f"unknown remat_policy {self.remat_policy!r} (want one of {REMAT_POLICIES})"
            )

    # ------------------------------------------------------------------ props
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def has_attention(self) -> bool:
        return self.family != "ssm"

    @property
    def supports_long_decode(self) -> bool:
        """Sub-quadratic decode: SSM state and/or sliding-window KV."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window is not None

    @property
    def param_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def n_params(self) -> int:
        """Total parameter count."""
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        H, KV = self.n_heads, self.n_kv_heads
        per_layer = 0
        if self.has_attention:
            per_layer += D * H * hd + 2 * D * KV * hd + H * hd * D  # q k v o
            per_layer += 2 * D  # norms
            if self.qk_norm:
                per_layer += 2 * hd
        if self.family == "moe":
            per_layer += D * self.n_experts  # router
            per_layer += self.n_experts * 3 * D * F
        elif F > 0:
            per_layer += 3 * D * F  # swiglu
        if self.family in ("ssm", "hybrid"):
            di, N, Hs = self.d_inner, self.ssm_state, self.ssm_heads
            per_layer += 2 * D * di + 2 * D * N + D * Hs + di * D  # x z B C dt o
            per_layer += 3 * Hs + di  # A, D, dt_bias, gated-norm scale
            per_layer += 4 * (di + 2 * N)  # depthwise conv (width 4)
            if self.family == "ssm":
                per_layer += D  # ln1 (attention branch adds norms otherwise)
        n = self.n_layers * per_layer
        if self.family == "encdec":
            n += self.encoder_layers * (
                D * H * hd + 2 * D * KV * hd + H * hd * D + 3 * D * F + 2 * D
            )
            # decoder cross-attention
            n += self.n_layers * (D * H * hd + 2 * D * KV * hd + H * hd * D + D)
            n += D  # the encoder's final norm (the JAX package's formula leaves it out)
        n += V * D  # embedding
        if not self.tie_embeddings:
            n += V * D  # output head
        n += D  # final norm
        return n

    def n_active_params(self) -> int:
        """Active-per-token params (MoE: top_k of n_experts)."""
        if self.family != "moe":
            return self.n_params()
        D, F = self.d_model, self.d_ff
        inactive = self.n_layers * (self.n_experts - self.top_k) * 3 * D * F
        return self.n_params() - inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def cell_is_runnable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """(runnable, reason).  long_500k needs sub-quadratic decode."""
    if shape.name == "long_500k" and not cfg.supports_long_decode:
        return False, (
            "pure full-attention arch: 524k dense-KV decode is the quadratic "
            "case long_500k excludes (DESIGN.md §4)"
        )
    return True, ""


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """Every model input of ``shape`` as a ``meta`` tensor: its shape and
    dtype, no data.

    train:   tokens/labels (B, S)
    prefill: tokens (B, S)
    decode:  tokens (B, 1); the decode state is ``models.model.make_decode_state``.
    Frontends contribute precomputed embeddings (stubs), in the parameter
    dtype: encdec (audio) a frame per position, (B, S, d_model), which the
    encoder consumes; vlm (vision) a fixed budget of ``frontend_len`` patch
    embeddings, (B, frontend_len, d_model), which replace the first decoder
    positions (the sequence stays S long).  Tokens are int64, the port's
    token dtype (numpy's integers, ``argmax``), where the JAX package's are
    int32.
    """
    B, S = shape.global_batch, shape.seq_len

    def spec(dims, dtype):
        return torch.empty(dims, dtype=dtype, device="meta")

    specs: Dict[str, torch.Tensor] = {}
    if shape.kind == "train":
        specs["tokens"] = spec((B, S), torch.int64)
        specs["labels"] = spec((B, S), torch.int64)
    elif shape.kind == "prefill":
        specs["tokens"] = spec((B, S), torch.int64)
    else:  # decode: one new token against a seq_len-deep cache
        specs["tokens"] = spec((B, 1), torch.int64)
    if cfg.frontend is not None and shape.kind != "decode":
        flen = S if cfg.family == "encdec" else cfg.frontend_len
        specs["frontend_embeds"] = spec((B, flen, cfg.d_model), cfg.param_dtype)
    return specs
