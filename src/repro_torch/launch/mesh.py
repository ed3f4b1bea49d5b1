"""Meshes over the current process group.

The port of the JAX package's ``launch/mesh.py``.  Axis roles: ``pod`` and
``data`` are data parallelism (and BST tree duplication), ``model``
tensor, expert and vertical-subtree parallelism.  Each function returns a
``torch.distributed.device_mesh.DeviceMesh`` over every rank of the
default process group (rank r at the r-th place of the mesh, row-major),
which must exist: one process a device, started by the caller (NCCL on
the card, gloo on the CPU).  They are functions, so importing this module
touches no device and starts nothing.
"""

from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

PRODUCTION_SHAPE = (16, 16)
MULTI_POD_SHAPE = (2, 16, 16)


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs a process group: call "
                           "torch.distributed.init_process_group first")
    return dist.get_world_size()


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """(data 16, model 16) over 256 ranks, or (pod 2, data 16, model 16)
    over 512."""
    shape = MULTI_POD_SHAPE if multi_pod else PRODUCTION_SHAPE
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    world = _world()
    if world != need:
        raise ValueError(f"the {'multi-pod ' if multi_pod else ''}production mesh {shape} needs "
                         f"{need} ranks, the process group has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(model: int = 1, device_type: str = "cuda") -> DeviceMesh:
    """(data n / model, model) over the n ranks there are (tests,
    examples); ``model`` is capped at n and must divide it."""
    n = _world()
    model = min(model, n)
    if n % model:
        raise ValueError(f"a model axis of {model} does not divide {n} ranks")
    return init_device_mesh(device_type, (n // model, model), mesh_dim_names=("data", "model"))
