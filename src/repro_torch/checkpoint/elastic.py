"""Elastic scaling: place a restored (whole) state on another mesh.

The port of the JAX package's ``checkpoint/elastic.py``.  Checkpoints hold
every tensor whole (``store.py``) and specs are pure functions of (config,
mesh shape) (``sharding/specs.py``), so a restart on a smaller or larger
mesh needs no format migration: each rank keeps the block of every tensor
that the JAX device at the same mesh coordinate holds after
``jax.device_put(leaf, NamedSharding(mesh, spec))``.

``shard_slices`` is that block as one pure function of (shape, spec, mesh
shape, coordinate), which the tests hold to ``NamedSharding``'s
``devices_indices_map``.  ``reshard_state`` places a ``TrainState`` on a
``DeviceMesh``.  Where every spec replicates every tensor (data
parallelism without ZeRO-1, a model axis of 1), it returns the same
``TrainState`` with its tensors on the mesh's device: what the
data-parallel step (``make_train_step(mesh=, mode="dp_shard_map")``)
takes.  Otherwise it returns a ``ShardedState`` of this rank's blocks
(``None`` for a layer that a ZeRO-1 split gives to other ranks), which no
ported step takes yet: the tensor-parallel step is not ported (ROADMAP.md
Queue 1 item 9), and the data-parallel step raises on it where the JAX
package would gather.  The data pipeline is stateless in the step, so a
restored run continues at the checkpoint's step with the new layout.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.models import convert
from repro_torch.models.config import ModelConfig
from repro_torch.optim.optimizer import AdamWState
from repro_torch.sharding import specs as specs_lib
from repro_torch.sharding.specs import Spec, mesh_shape


def shard_slices(shape: Sequence[int], spec: Sequence[Any], mesh: Mapping[str, int],
                 coord: Mapping[str, int]) -> Tuple[slice, ...]:
    """The block of a tensor of ``shape`` held at mesh coordinate
    ``coord`` (axis -> index) under ``spec``: one slice a dim.  A dim
    split over several axes is split major to minor in the entry's order;
    it must divide by their product (the specs shard only such dims)."""
    out = []
    for i, n in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        if entry is None:
            out.append(slice(0, n))
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        count = math.prod(mesh[a] for a in axes)
        if n % count:
            raise ValueError(f"dim {i} of {tuple(shape)} does not split {count} ways ({entry})")
        index = 0
        for a in axes:
            index = index * mesh[a] + coord[a]
        size = n // count
        out.append(slice(index * size, (index + 1) * size))
    return tuple(out)


def holds_layer(spec: Spec, layer: int, n_layers: int, mesh: Mapping[str, int],
                coord: Mapping[str, int]) -> bool:
    """Whether the rank at ``coord`` holds layer ``layer`` of a stacked
    leaf of ``n_layers`` under ``spec`` (all of them unless ZeRO-1 split
    the layer dim: then layer i is held by coordinate i // (L / size))."""
    (rows,) = shard_slices((n_layers,), (spec.layer,), mesh, coord)
    return rows.start <= layer < rows.stop


def is_whole(spec: Spec) -> bool:
    return spec.layer is None and all(entry is None for entry in spec)


class ShardedState(NamedTuple):
    """A ``TrainState``'s blocks on one rank: name -> this rank's block of
    each tensor (``None`` for a layer it does not hold), the step, and the
    specs and coordinate they were cut by."""

    params: Dict[str, Optional[torch.Tensor]]
    opt: AdamWState  # master, mu and nu are name -> block dicts
    error_feedback: Dict[str, Optional[torch.Tensor]]
    specs: Any
    coord: Dict[str, int]


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _coord(mesh) -> Dict[str, int]:
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    return dict(zip(mesh.mesh_dim_names, coord))


def _blocks(names, tensors, specs, cfg: ModelConfig, shape, coord, device):
    counts = {"layers": cfg.n_layers, "enc_layers": cfg.encoder_layers}
    out: Dict[str, Optional[torch.Tensor]] = {}
    for name, t in zip(names, tensors, strict=True):
        spec = specs[name]
        keys, layer = convert.jax_key(name)
        if layer is not None and not holds_layer(spec, layer, counts[keys[0]], shape, coord):
            out[name] = None
            continue
        out[name] = t[shard_slices(t.shape, spec, shape, coord)].to(device)
    return out


def reshard_params(params, cfg: ModelConfig, mesh) -> Dict[str, Optional[torch.Tensor]]:
    """A ``Model``'s parameters placed on ``mesh`` per ``param_specs``:
    name -> this rank's block, on the mesh's device."""
    shape, coord = mesh_shape(mesh), _coord(mesh)
    named = list(params.named_parameters())
    return _blocks([n for n, _ in named], [p.detach() for _, p in named],
                   specs_lib.param_specs(cfg, shape), cfg, shape, coord, _mesh_device(mesh))


def reshard_state(state, cfg: ModelConfig, mesh):
    """A (host or device) ``TrainState`` placed on ``mesh`` per
    ``state_specs``: the same ``TrainState`` on the mesh's device when
    every tensor stays whole on every rank, else this rank's
    ``ShardedState``."""
    shape, coord, device = mesh_shape(mesh), _coord(mesh), _mesh_device(mesh)
    specs = specs_lib.state_specs(cfg, shape)
    if all(is_whole(s) for tree in (specs.params, specs.opt.master) for s in tree.values()):
        model = state.params.to(device)
        opt = state.opt
        moved = AdamWState(step=opt.step.to(device), master=[t.to(device) for t in opt.master],
                           mu=[t.to(device) for t in opt.mu], nu=[t.to(device) for t in opt.nu])
        return type(state)(model, moved, [t.to(device) for t in state.error_feedback])
    names = [n for n, _ in state.params.named_parameters()]
    params = [p.detach() for p in state.params.parameters()]

    def cut(tensors, tree):
        return _blocks(names, tensors, tree, cfg, shape, coord, device)

    opt = state.opt
    return ShardedState(
        params=cut(params, specs.params),
        opt=AdamWState(step=opt.step.to(device), master=cut(opt.master, specs.opt.master),
                       mu=cut(opt.mu, specs.opt.mu), nu=cut(opt.nu, specs.opt.nu)),
        # the error feedback is a gradient's residual: replicated as the parameters
        error_feedback=cut(state.error_feedback, specs.params) if state.error_feedback else {},
        specs=specs,
        coord=coord,
    )
