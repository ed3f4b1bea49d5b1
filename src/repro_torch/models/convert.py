"""Weights carried across from the JAX package.

``params_from_jax`` fills a ``Model`` from the tree that the JAX package's
``init_params`` returns, as numpy arrays (``jax.tree.map(np.asarray,
params)``): the embedding, the final norm, the head where it is untied, and
each layer's slice of the stacked (L, ...) layer leaves -- ``ln1``, and
where the family has them ``ln2``, ``attn.*``, the SSD mixer's ``ssm.*``
(ssm, hybrid), the cross-attention's ``ln_cross`` and ``cross.*`` (encdec),
the MLP's ``mlp.*`` or, for the moe family, the router and the expert
stacks ``moe.*`` (``layers.moe.w_gate`` (L, E, D, F) and so on); for encdec
also the encoder's ``enc_layers.*`` the same way and ``enc_final_norm``.
Every leaf of the port's model is filled, and the names agree with the JAX
tree's.  The layouts agree (weights (in, out) on both sides), so every
tensor is a plain copy; bf16 arrays pass through float32, which holds them
exactly.  This module imports no JAX: it reads the arrays only.
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


def _copy_stack(module: torch.nn.Module, stacked: Mapping[str, Any], prefix: str) -> None:
    """Fill each of ``module``'s layers from its slice of the stacked
    (L, ...) leaves, by the parameter's dotted name (``attn.wq`` is
    ``stacked["attn"]["wq"]``)."""
    for i, layer in enumerate(module):
        for name, p in layer.named_parameters():
            leaf: Any = stacked
            for part in name.split("."):
                leaf = leaf[part]
            _copy(p, leaf[i], f"{prefix}.{i}.{name}")


def params_from_jax(cfg: ModelConfig, params_np: Mapping[str, Any], device="cuda") -> Model:
    """A ``Model`` on ``device`` holding the JAX package's parameters."""
    model = Model(cfg, device)
    _copy(model.embed, params_np["embed"], "embed")
    _copy(model.final_norm, params_np["final_norm"], "final_norm")
    if not cfg.tie_embeddings:
        _copy(model.head, params_np["head"], "head")
    _copy_stack(model.layers, params_np["layers"], "layers")
    if cfg.family == "encdec":
        _copy_stack(model.enc_layers, params_np["enc_layers"], "enc_layers")
        _copy(model.enc_final_norm, params_np["enc_final_norm"], "enc_final_norm")
    return model
