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

The inverse map, port name -> JAX path, is ``jax_key``; ``jax_tree``
builds the JAX package's nested dict of any per-parameter list of the
port's (parameters, AdamW's master, mu and nu, the int8 error feedback),
each layer leaf a ``LayerStack`` of the L per-layer tensors, and
``train_state_tree`` does so for a whole ``TrainState``.  The checkpoint
store (``checkpoint/store.py``) flattens these trees in the JAX package's
order, so either package restores a checkpoint the other writes.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

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


LAYER_LISTS = ("layers", "enc_layers")


def jax_key(name: str) -> Tuple[Tuple[str, ...], Optional[int]]:
    """The JAX tree's dict keys of the port's parameter ``name`` and, for a
    layer's parameter, its index in the stacked (L, ...) leaf:
    ``layers.3.attn.wq`` -> ``(("layers", "attn", "wq"), 3)``,
    ``embed`` -> ``(("embed",), None)``."""
    parts = name.split(".")
    if parts[0] in LAYER_LISTS:
        return (parts[0], *parts[2:]), int(parts[1])
    return tuple(parts), None


def jax_leaf(tree: Mapping[str, Any], name: str) -> Any:
    """The JAX tree's array of the port's parameter ``name``: a stacked
    layer leaf's slice for ``layers.<i>.*`` and ``enc_layers.<i>.*``."""
    keys, layer = jax_key(name)
    leaf: Any = tree
    for key in keys:
        leaf = leaf[key]
    return leaf if layer is None else leaf[layer]


class LayerStack:
    """One stacked (L, ...) leaf of the JAX tree held as the port's L
    per-layer tensors, in layer order."""

    __slots__ = ("parts",)

    def __init__(self, parts: Optional[List[Any]] = None):
        self.parts = [] if parts is None else parts

    @property
    def shape(self) -> Tuple[int, ...]:
        return (len(self.parts), *self.parts[0].shape)


def jax_tree(names: Sequence[str], values: Sequence[Any]) -> Dict[str, Any]:
    """The JAX package's nested dict of ``values``, one a port parameter
    name in ``names`` (``named_parameters`` order): a layer's leaves
    gathered into ``LayerStack``s, in layer order."""
    tree: Dict[str, Any] = {}
    for name, value in zip(names, values, strict=True):
        keys, layer = jax_key(name)
        node = tree
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        if layer is None:
            node[keys[-1]] = value
            continue
        stack = node.setdefault(keys[-1], LayerStack())
        if layer != len(stack.parts):
            raise ValueError(f"{name}: layer {layer} out of order ({len(stack.parts)} before it)")
        stack.parts.append(value)
    return tree


def train_state_tree(state: Any) -> Any:
    """A ``TrainState`` (the port's: a ``Model``, an ``AdamWState`` of
    lists, an error-feedback list) as the JAX package's ``TrainState``
    tree: the same NamedTuple types holding ``jax_tree`` dicts, so that
    the fields flatten as ``.params``, ``.opt/.step``, ``.opt/.master``,
    ..., ``.error_feedback`` (empty without int8 compression)."""
    names = [name for name, _ in state.params.named_parameters()]
    params = [p for _, p in state.params.named_parameters()]
    opt = state.opt
    return type(state)(
        params=jax_tree(names, params),
        opt=type(opt)(step=opt.step, master=jax_tree(names, opt.master),
                      mu=jax_tree(names, opt.mu), nu=jax_tree(names, opt.nu)),
        error_feedback=jax_tree(names, state.error_feedback) if state.error_feedback else (),
    )


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
