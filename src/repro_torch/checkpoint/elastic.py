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
(``None`` for a layer that a ZeRO-1 split gives to other ranks): what the
tensor-parallel step (``mode="pjit"``) takes, and what the data-parallel
step gathers whole first (``gather_state``), as the JAX package's
``in_specs=P()`` does.  ``sharded_model`` builds the ``Model`` whose
tensors are a rank's parameter blocks, with ``sharding/tp.py``'s context
attached; ``gather_blocks`` puts blocks back together over some mesh
axes (all-gathers only, which gloo has).  The data pipeline is stateless
in the step, so a restored run continues at the checkpoint's step with
the new layout.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from repro_torch.models import convert
from repro_torch.models.config import ModelConfig
from repro_torch.optim.optimizer import AdamWState
from repro_torch.sharding import specs as specs_lib
from repro_torch.sharding import tp
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


def mesh_device(mesh) -> torch.device:
    """The device this rank's tensors of ``mesh`` live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _coord(mesh) -> Dict[str, int]:
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    return dict(zip(mesh.mesh_dim_names, coord))


def _blocks(names, tensors, specs, cfg: ModelConfig, shape, coord, device):
    out: Dict[str, Optional[torch.Tensor]] = {}
    for name, t in zip(names, tensors, strict=True):
        spec = specs[name]
        if not holds(name, spec, cfg, shape, coord):
            out[name] = None
            continue
        # storage of its own, a whole tensor's too: a step that updates the
        # blocks in place leaves the placed state untouched, as
        # ``jax.device_put`` (whose arrays never change) does
        out[name] = t[shard_slices(t.shape, spec, shape, coord)].to(device, copy=True)
    return out


def reshard_params(params, cfg: ModelConfig, mesh) -> Dict[str, Optional[torch.Tensor]]:
    """A ``Model``'s parameters placed on ``mesh`` per ``param_specs``:
    name -> a copy of this rank's block, on the mesh's device."""
    shape, coord = mesh_shape(mesh), _coord(mesh)
    named = list(params.named_parameters())
    return _blocks([n for n, _ in named], [p.detach() for _, p in named],
                   specs_lib.param_specs(cfg, shape), cfg, shape, coord, mesh_device(mesh))


def reshard_state(state, cfg: ModelConfig, mesh):
    """A (host or device) ``TrainState`` placed on ``mesh`` per
    ``state_specs``: the same ``TrainState`` on the mesh's device when
    every tensor stays whole on every rank (the data-parallel step updates
    it in place, as it does any state it is given), else this rank's
    ``ShardedState``, every block a copy: stepping it leaves ``state`` as
    it was."""
    shape, coord, device = mesh_shape(mesh), _coord(mesh), mesh_device(mesh)
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
        opt=AdamWState(step=opt.step.to(device, copy=True),
                       master=cut(opt.master, specs.opt.master),
                       mu=cut(opt.mu, specs.opt.mu), nu=cut(opt.nu, specs.opt.nu)),
        # the error feedback is a gradient's residual: replicated as the parameters
        error_feedback=cut(state.error_feedback, specs.params) if state.error_feedback else {},
        specs=specs,
        coord=coord,
    )


# ------------------------------------------------------------ blocks, whole
@functools.lru_cache(maxsize=None)
def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """Parameter name -> whole shape (the configs are frozen: one meta model each)."""
    from repro_torch.models.model import Model

    return {n: tuple(p.shape) for n, p in Model(cfg, device="meta").named_parameters()}


def holds(name: str, spec: Spec, cfg: ModelConfig, shape, coord) -> bool:
    """Whether the rank at ``coord`` holds the tensor ``name`` under ``spec``
    (every one but a layer that a ZeRO-1 split gives to other ranks)."""
    counts = {"layers": cfg.n_layers, "enc_layers": cfg.encoder_layers}
    keys, layer = convert.jax_key(name)
    return layer is None or holds_layer(spec, layer, counts[keys[0]], shape, coord)


def axes_coords(mesh, axes) -> List[Dict[str, int]]:
    """The mesh coordinates of the ranks that share this rank's coordinates
    off ``axes``, in the order of ``tp.mesh_axis(mesh, axes)``'s index."""
    shape, coord = mesh_shape(mesh), _coord(mesh)
    axes = [a for a in shape if a in axes]
    out = []
    for i in range(math.prod(shape[a] for a in axes)):
        c = dict(coord)
        for a in reversed(axes):
            c[a] = i % shape[a]
            i //= shape[a]
        out.append(c)
    return out


def gather_blocks(blocks: Mapping[str, Optional[torch.Tensor]], have: Mapping[str, Spec],
                  want: Mapping[str, Spec], cfg: ModelConfig, mesh, axes,
                  out: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """This rank's blocks under ``want`` of the tensors whose blocks under
    ``have`` the ranks along ``axes`` hold (``blocks``: name -> this
    rank's, None for a layer it does not hold): one flat all-gather over
    ``axes`` (every rank along them holds as many elements), each rank's
    blocks copied into place.  ``want`` must be ``have`` without ``axes``
    (each ``have`` block inside a ``want`` block).  With ``out`` the blocks
    are written into its tensors in place; names that no rank along
    ``axes`` splits are left out of the gather and copied from ``blocks``."""
    shape, coord = mesh_shape(mesh), _coord(mesh)
    axis = tp.mesh_axis(mesh, axes)
    full = param_shapes(cfg)
    members = axes_coords(mesh, axis.axes)
    names = [n for n in blocks if any(
        shard_slices(full[n], have[n], shape, c) != shard_slices(full[n], have[n], shape, coord)
        or holds(n, have[n], cfg, shape, c) != holds(n, have[n], cfg, shape, coord)
        for c in members)]
    result = {} if out is None else out
    for n, t in blocks.items():
        if n in names:
            continue
        if out is None:
            result[n] = t
        elif t is not None and result[n] is not t:
            result[n].copy_(t)
    if not names:
        return result
    mine = [blocks[n].reshape(-1) for n in names if blocks[n] is not None]
    dtypes = {t.dtype for t in mine}
    if len(dtypes) > 1:
        raise ValueError(f"gather_blocks takes one dtype at a time, got {dtypes}")
    device = mine[0].device if mine else next(t for t in blocks.values() if t is not None).device
    dtype = mine[0].dtype if mine else torch.float32
    flat = axis.all_gather(torch.cat(mine) if mine else torch.zeros(0, dtype=dtype,
                                                                     device=device))
    parts = flat.split(flat.numel() // axis.size)
    for n in names:
        if out is None:
            rows = shard_slices(full[n], want[n], shape, coord)
            result[n] = torch.empty([s.stop - s.start for s in rows], dtype=dtype, device=device)
    for c, part in zip(members, parts):
        offset = 0
        for n in names:
            if not holds(n, have[n], cfg, shape, c):
                continue
            src = shard_slices(full[n], have[n], shape, c)
            dst = shard_slices(full[n], want[n], shape, coord)
            size = math.prod(s.stop - s.start for s in src)
            if holds(n, want[n], cfg, shape, coord):
                rel = tuple(slice(a.start - b.start, a.stop - b.start) for a, b in zip(src, dst))
                result[n][rel] = part[offset:offset + size].view(
                    [s.stop - s.start for s in src])
            offset += size
    return result


def gather_state(state: ShardedState, cfg: ModelConfig, mesh):
    """The whole ``TrainState`` of a ``ShardedState``, on every rank (the
    JAX package's ``P()``): every block gathered over every mesh axis, the
    parameters into a ``Model`` on the mesh's device."""
    from repro_torch.models.model import Model
    from repro_torch.training.train_loop import TrainState

    axes = specs_lib.all_axes(mesh)
    whole = {n: Spec(()) for n in state.params}
    params = gather_blocks(state.params, state.specs.params, whole, cfg, mesh, axes)
    model = Model(cfg, device="meta")
    for name, t in params.items():
        _set_param(model, name, t, True)
    _real_buffers(model, mesh_device(mesh))
    names = list(state.params)

    def listed(tree, specs):
        got = gather_blocks(tree, specs, whole, cfg, mesh, axes)
        return [got[n] for n in names]

    opt = state.opt
    moved = AdamWState(step=opt.step, master=listed(opt.master, state.specs.opt.master),
                       mu=listed(opt.mu, state.specs.opt.mu), nu=listed(opt.nu, state.specs.opt.nu))
    ef = listed(state.error_feedback, state.specs.params) if state.error_feedback else []
    return TrainState(model, moved, ef)


def _set_param(model, name: str, t: torch.Tensor, trainable: bool) -> None:
    path, leaf = name.rsplit(".", 1) if "." in name else ("", name)
    module = model.get_submodule(path) if path else model
    setattr(module, leaf, nn.Parameter(t.detach(), requires_grad=trainable))


def _real_buffers(model, device) -> None:
    for module in model.modules():
        for name, b in list(module.named_buffers(recurse=False)):
            if b.is_meta:
                module.register_buffer(name, torch.zeros(b.shape, dtype=b.dtype, device=device),
                                       persistent=False)


def shard_axes(cfg: ModelConfig, mesh) -> Tuple["tp.Axis", "tp.Axis"]:
    """(the model axis of the tensor-parallel compute, the data-parallel
    axis of the batch): ``model`` and the DP axes, or for ``dp_only`` one
    rank and every axis."""
    if cfg.sharding_strategy == "dp_only":
        return tp.SINGLE, tp.mesh_axis(mesh, specs_lib.all_axes(mesh))
    return tp.mesh_axis(mesh, ("model",)), tp.mesh_axis(mesh, specs_lib.dp_axes(mesh))


def sharded_model(cfg: ModelConfig, blocks: Mapping[str, torch.Tensor], mesh,
                  trainable: bool = False):
    """A ``Model`` whose parameters are ``blocks`` (this rank's, from
    ``reshard_params`` or a ``ShardedState``; the tensors themselves, so an
    update of the model's parameters in place updates them), with
    ``sharding/tp.py``'s context for ``mesh`` attached."""
    from repro_torch.models.model import Model

    model = Model(cfg, device="meta")
    for name, t in blocks.items():
        _set_param(model, name, t, trainable)
    _real_buffers(model, mesh_device(mesh))
    model_axis, dp = shard_axes(cfg, mesh)
    tp.attach(model, model_axis, dp, specs_lib.param_specs(cfg, mesh))
    return model
