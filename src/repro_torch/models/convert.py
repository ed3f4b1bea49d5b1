"""Weights and optimizer state carried across from the JAX package.

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
tree's: the port's ``layers.3.attn.wq`` is ``tree["layers"]["attn"]["wq"][3]``.
``adamw_state_from_jax`` carries the JAX package's ``AdamWState`` (its step
and its master, mu and nu trees, as numpy arrays) into the port's, whose
lists follow the model's ``named_parameters``.  The layouts agree (weights
(in, out) on both sides), so every tensor is a plain copy; bf16 arrays pass
through float32, which holds them exactly.  This module imports no JAX: it
reads the arrays only.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model
from repro_torch.optim.optimizer import AdamWState


def _copy(dst: torch.Tensor, src: Any, name: str) -> None:
    arr = np.array(src, dtype=np.float32)  # a writable copy
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: JAX shape {arr.shape}, port shape {tuple(dst.shape)}")
    dst.copy_(torch.from_numpy(arr))


def jax_leaf(tree: Mapping[str, Any], name: str) -> Any:
    """The JAX tree's array of the port's parameter ``name``: a stacked
    layer leaf's slice for ``layers.<i>.*`` and ``enc_layers.<i>.*``."""
    parts = name.split(".")
    if parts[0] in ("layers", "enc_layers"):
        leaf: Any = tree[parts[0]]
        for part in parts[2:]:
            leaf = leaf[part]
        return leaf[int(parts[1])]
    return tree[name]


def params_from_jax(cfg: ModelConfig, params_np: Mapping[str, Any], device="cuda",
                    trainable: bool = False) -> Model:
    """A ``Model`` on ``device`` holding the JAX package's parameters."""
    model = Model(cfg, device, trainable)
    with torch.no_grad():
        for name, p in model.named_parameters():
            _copy(p, jax_leaf(params_np, name), name)
    return model


def adamw_state_from_jax(model: Model, state_np: Any) -> AdamWState:
    """The port's ``AdamWState`` for ``model`` from the JAX package's
    (``step``, ``master``, ``mu``, ``nu``; numpy arrays), on the model's
    device: the step a 0-d int32 tensor, the trees' leaves as fp32 lists in
    ``named_parameters`` order."""
    names = [name for name, _ in model.named_parameters()]
    device = model.embed.device

    def leaves(tree) -> list:
        return [torch.from_numpy(np.array(jax_leaf(tree, n), dtype=np.float32)).to(device)
                for n in names]

    return AdamWState(
        step=torch.tensor(int(np.asarray(state_np.step)), dtype=torch.int32, device=device),
        master=leaves(state_np.master), mu=leaves(state_np.mu), nu=leaves(state_np.nu),
    )
