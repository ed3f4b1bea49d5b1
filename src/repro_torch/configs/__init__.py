"""Architecture registry: one module per assigned architecture.

``get_config(name)`` returns the full published config (``all_configs()``
every one, by architecture id); ``smoke_config(name)``
returns a reduced same-family config for CPU smoke tests (2 layers, narrow,
tiny vocab, fp32), as the JAX package's registry does.  One difference: the
JAX smoke config selects naive attention because the Pallas kernel runs
slowly in interpret mode; the port keeps its default ``"flash"`` (K5 on the
card, its plain version on the CPU).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

ARCH_IDS: List[str] = [
    "seamless_m4t_medium",
    "hymba_1p5b",
    "internlm2_1p8b",
    "granite_3_8b",
    "tinyllama_1p1b",
    "qwen3_1p7b",
    "mixtral_8x7b",
    "mixtral_8x22b",
    "mamba2_1p3b",
    "internvl2_2b",
]

# CLI aliases (--arch) matching the assignment spelling.
ALIASES: Dict[str, str] = {
    "seamless-m4t-medium": "seamless_m4t_medium",
    "hymba-1.5b": "hymba_1p5b",
    "internlm2-1.8b": "internlm2_1p8b",
    "granite-3-8b": "granite_3_8b",
    "tinyllama-1.1b": "tinyllama_1p1b",
    "qwen3-1.7b": "qwen3_1p7b",
    "mixtral-8x7b": "mixtral_8x7b",
    "mixtral-8x22b": "mixtral_8x22b",
    "mamba2-1.3b": "mamba2_1p3b",
    "internvl2-2b": "internvl2_2b",
}


def canonical(name: str) -> str:
    return ALIASES.get(name, name.replace("-", "_").replace(".", "p"))


def get_config(name: str) -> ModelConfig:
    arch = canonical(name)
    if arch not in ARCH_IDS:
        raise ValueError(f"unknown architecture {name!r} (want one of {ARCH_IDS})")
    return importlib.import_module(f"repro_torch.configs.{arch}").CONFIG


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config: 2 layers, narrow, tiny vocab, fp32."""
    cfg = get_config(name)
    heads = min(cfg.n_heads, 4)
    kv = min(cfg.n_kv_heads, heads)
    while kv > 1 and heads % kv:
        kv -= 1
    return dataclasses.replace(
        cfg,
        n_layers=2,
        encoder_layers=2 if cfg.family == "encdec" else 0,
        d_model=64,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=503,
        n_experts=4 if cfg.n_experts else 0,
        moe_groups=None,  # smoke batches are tiny: one dispatch group
        zero1=False,
        ssm_head_dim=16 if cfg.ssm_state else 64,
        ssm_chunk=8,
        sliding_window=16 if cfg.sliding_window else None,
        frontend_len=8 if cfg.frontend == "vision" else 0,
        dtype="float32",
        remat=False,
        logit_chunk=8,
    )


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
