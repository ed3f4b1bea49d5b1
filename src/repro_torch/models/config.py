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

The port runs the dense family (``models.model``); the others are
configured here and raise ``NotImplementedError`` there.  The JAX
package's XLA and TPU switches (``sharding_strategy``, ``zero1``, ``remat``,
``remat_policy``, ``scan_layers``, ``attn_block_q``/``attn_block_k``) and its
training switch ``logit_chunk`` have no meaning in eager PyTorch on one card
and are left out.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")
# "flash": kernel K5 on the card (its plain version on the CPU); "naive":
# materialized scores, for tiny tests only.
ATTENTION_IMPLS = ("flash", "naive")


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
    attention_impl: str = "flash"  # one of ATTENTION_IMPLS

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r} (want one of {FAMILIES})")
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(
                f"unknown attention_impl {self.attention_impl!r} (want one of "
                f"{ATTENTION_IMPLS})"
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
