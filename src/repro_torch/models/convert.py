"""Weights carried across from the JAX package.

``params_from_jax`` fills a ``Model`` from the tree that the JAX package's
``init_params`` returns, as numpy arrays (``jax.tree.map(np.asarray,
params)``): the embedding, the final norm, the head where it is untied, and
each layer's slice of the stacked (L, ...) layer leaves.  The layouts agree
(weights (in, out) on both sides), so every tensor is a plain copy; bf16
arrays pass through float32, which holds them exactly.  This module imports
no JAX: it reads the arrays only.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model


def _copy(dst: torch.Tensor, src: Any, name: str) -> None:
    arr = np.array(src, dtype=np.float32)  # a writable copy
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: JAX shape {arr.shape}, port shape {tuple(dst.shape)}")
    dst.copy_(torch.from_numpy(arr))


def params_from_jax(cfg: ModelConfig, params_np: Mapping[str, Any], device="cuda") -> Model:
    """A ``Model`` on ``device`` holding the JAX package's parameters."""
    model = Model(cfg, device)
    _copy(model.embed, params_np["embed"], "embed")
    _copy(model.final_norm, params_np["final_norm"], "final_norm")
    if not cfg.tie_embeddings:
        _copy(model.head, params_np["head"], "head")
    stacked = params_np["layers"]
    for i, lp in enumerate(model.layers):
        _copy(lp.ln1, stacked["ln1"][i], f"layers.{i}.ln1")
        _copy(lp.ln2, stacked["ln2"][i], f"layers.{i}.ln2")
        for name, p in lp.attn.named_parameters():
            _copy(p, stacked["attn"][name][i], f"layers.{i}.attn.{name}")
        for name, p in lp.mlp.named_parameters():
            _copy(p, stacked["mlp"][name][i], f"layers.{i}.mlp.{name}")
    return model
