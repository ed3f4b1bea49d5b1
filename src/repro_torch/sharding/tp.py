"""Tensor parallelism over the mesh's model axis, written out by hand.

The JAX package's ``pjit`` step and sharded serving steps take each tensor
placed by ``sharding/specs.py`` and leave the collectives to GSPMD.  The
port runs one process a device and places the collectives itself; this
module holds what GSPMD inserts:

* ``Axis``: the ranks along some mesh axes as this rank sees them (its
  group, size and index), with counted ``all_reduce`` and ``all_gather``
  on CUDA and CPU tensors alike (gloo has no ``reduce_scatter``, so only
  these two are used; a size-1 axis makes no call).
* Megatron's conjugate pair as ``torch.autograd.Function``s: ``copy_in``
  (identity forward, all-reduce backward) where a replicated activation
  enters a split module, ``reduce_out`` (all-reduce forward, identity
  backward) where the module's partial sums leave it; ``sum_over`` (both
  directions all-reduce) for a statistic that split activations consume,
  as the mean of squares of an RMS norm over a split dim; ``gather``
  (all-gather forward, all-reduce then this rank's block backward) for a
  weight whose block cuts a head in two; ``gather_rows`` (all-gather
  forward, this rank's rows backward) for activations that a computation
  replicated over the data axes needs whole.
* The vocab-parallel pieces: ``embed`` (masked rows, then an all-reduce)
  and ``xent_terms`` (the log-sum-exp and the gold logit of a vocab block).
* ``ModuleShard``/``ModelShard``: which of a module's weights are split
  here, driven by the specs.  A module is *active* when its output
  projection is split; it then takes its input through ``copy_in`` and
  gives its output through ``reduce_out``, and every one of its
  replicated weights gets a partial gradient on each rank
  (``partial_grad_names``: the train step sums them over the model axis).
  Where ``_maybe`` fell back to replication, or the axis has one rank,
  nothing is active and every helper is the identity and makes no call.

Every rank of the model axis runs the same ops in the same order, so the
collectives pair up; the data-parallel sums of the train step and the
ZeRO-1 gathers go through ``Axis`` too.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.sharding import specs as specs_lib
from repro_torch.sharding.specs import Spec

# Collectives since the last ``reset_stats()``, per op: calls and the bytes
# of the tensors each rank puts in (all_reduce) or contributes (all_gather).
# What ran: a CUDA graph's are counted at each replay (``repro_torch.graphs``).
STATS: Dict[str, Dict[str, int]] = {"all_reduce": {"calls": 0, "bytes": 0},
                                    "all_gather": {"calls": 0, "bytes": 0}}


def reset_stats() -> None:
    for row in STATS.values():
        row.update(calls=0, bytes=0)


def _count(op: str, t: torch.Tensor) -> None:
    STATS[op]["calls"] += 1
    STATS[op]["bytes"] += t.numel() * t.element_size()


class Axis:
    """The ranks along ``axes`` of a mesh that share this rank's other
    coordinates: ``group`` (None for one rank), ``size`` and ``index``,
    this rank's place along the axes (major to minor, the order in which
    ``elastic.shard_slices`` splits a dim over them)."""

    def __init__(self, axes: Tuple[str, ...], group, size: int, index: int):
        self.axes, self.group, self.size, self.index = axes, group, size, index

    def __repr__(self):
        return f"Axis({self.axes}, size={self.size}, index={self.index})"

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``t`` summed (or ``op``) over the axis, in place where ``t`` is
        contiguous; returns the result."""
        if self.size == 1:
            return t
        t = t.contiguous()
        _count("all_reduce", t)
        dist.all_reduce(t, op=op, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim`` in axis order."""
        if self.size == 1:
            return t
        t = t.contiguous()
        _count("all_gather", t)
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts, dim=dim)

    def block(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block of ``t`` along ``dim`` (split ``size`` ways)."""
        if self.size == 1:
            return t
        n = t.shape[dim] // self.size
        return t.narrow(dim, self.index * n, n)


SINGLE = Axis((), None, 1, 0)

# Groups by (the mesh's rank layout, axes): every rank creates every
# subgroup of an axis set once, in the same order.
_GROUPS: Dict[Tuple, Dict[int, object]] = {}


def forget_groups() -> None:
    """Drop the subgroups made so far: after the default process group is
    destroyed they are dead, and a new one makes its own."""
    _GROUPS.clear()


def mesh_axis(mesh, axes: Sequence[str]) -> Axis:
    """The ``Axis`` of ``axes`` (names of ``mesh``, a ``DeviceMesh`` over
    the whole default process group) for this rank."""
    names = tuple(mesh.mesh_dim_names)
    axes = tuple(a for a in names if a in axes)
    shape = specs_lib.mesh_shape(mesh)
    size = math.prod(shape[a] for a in axes)
    coord = dict(zip(names, mesh.get_coordinate()))
    index = 0
    for a in axes:
        index = index * shape[a] + coord[a]
    if size == 1:
        return Axis(axes, None, 1, 0)
    if len(axes) == 1:
        return Axis(axes, mesh.get_group(axes[0]), size, index)
    layout = np.array(specs_lib.mesh_ranks(mesh))
    key = (tuple(layout.flatten().tolist()), tuple(layout.shape), names, axes)
    if key not in _GROUPS:
        keep = [i for i, a in enumerate(names) if a in axes]
        other = [i for i, a in enumerate(names) if a not in axes]
        moved = layout.transpose(other + keep).reshape(-1, size)
        groups = {}
        for row in moved.tolist():  # every rank creates every group, in order
            g = dist.new_group(sorted(row))
            for r in row:
                groups[r] = g
        _GROUPS[key] = groups
    return Axis(axes, _GROUPS[key][dist.get_rank()], size, index)


# ------------------------------------------------------------ autograd pairs
class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_reduce(g.clone()), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return axis.all_reduce(x.clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return axis.all_reduce(x.clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_reduce(g.clone()), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, reduce_grad):
        ctx.axis, ctx.dim, ctx.reduce_grad = axis, dim, reduce_grad
        return axis.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce_grad:
            g = ctx.axis.all_reduce(g.clone())
        return ctx.axis.block(g, ctx.dim).contiguous(), None, None, None


def copy_in(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Identity forward; the gradient summed over ``axis`` backward."""
    return x if axis.size == 1 else _CopyIn.apply(x, axis)


def reduce_out(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The partial sums of ``x`` summed over ``axis``; identity backward."""
    return x if axis.size == 1 else _ReduceOut.apply(x, axis)


def sum_over(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``x`` summed over ``axis`` where each rank's split activations
    consume the sum: the gradient is summed too."""
    return x if axis.size == 1 else _SumOver.apply(x, axis)


def gather(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """Every rank's block of ``x`` along ``dim``, whole, inside an active
    module (its gradient is a partial sum: summed, then cut)."""
    return x if axis.size == 1 else _Gather.apply(x, axis, dim, True)


def gather_rows(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Every rank's rows of ``x`` (dim 0), whole, for a computation that
    each rank repeats on the whole batch and then keeps its rows of: the
    gradient of the other ranks' rows is zero here, so backward cuts."""
    return x if axis.size == 1 else _Gather.apply(x, axis, 0, False)


# -------------------------------------------------------------- vocab blocks
def embed(tokens: torch.Tensor, table: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``table[tokens]`` over a vocab block (V / m rows on each rank): each
    rank looks up the tokens in its rows, zeros elsewhere, and the ranks
    sum (each token has exactly one owner, so the sum is exact)."""
    n = table.shape[0]
    local = tokens - axis.index * n
    own = (local >= 0) & (local < n)
    x = table[local.clamp(0, n - 1)] * own[..., None].to(table.dtype)
    return reduce_out(x, axis)


def xent_terms(logits: torch.Tensor, labels: torch.Tensor, axis: Axis
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(log-sum-exp, gold logit) over the whole vocab of fp32 ``logits``
    (..., V / m), this rank's vocab block: the max over the ranks (no
    gradient: the shift cancels), the shifted exponentials' sum and the
    gold logit (from the one rank that owns the label) each summed."""
    n = logits.shape[-1]
    with torch.no_grad():
        top = axis.all_reduce(logits.amax(dim=-1), dist.ReduceOp.MAX)
    sumexp = reduce_out(torch.exp(logits - top[..., None]).sum(dim=-1), axis)
    local = labels.long() - axis.index * n
    own = (local >= 0) & (local < n)
    gold = logits.gather(-1, local.clamp(0, n - 1)[..., None])[..., 0] * own
    return top + torch.log(sumexp), reduce_out(gold, axis)


# ----------------------------------------------------------------- the plan
def is_split(spec: Spec) -> bool:
    """Whether a dim of ``spec`` is split over the model axis."""
    for entry in spec:
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        if "model" in axes:
            return True
    return False


def split_dim(spec: Spec) -> Optional[int]:
    for i, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        if "model" in axes:
            return i
    return None


class ModuleShard:
    """One module's weights on this rank: ``split`` names the weights cut
    over ``axis`` (by their dim), ``active`` whether its output projection
    is (the module then runs between ``copy_in`` and ``reduce_out``)."""

    def __init__(self, axis: Axis, specs: Mapping[str, Spec], out: str,
                 owner: "ModelShard"):
        self.axis, self.owner = axis, owner
        self.split = {n: split_dim(s) for n, s in specs.items() if is_split(s)}
        self.active = out in self.split and axis.size > 1

    def weight(self, module, name: str, whole_units: bool) -> torch.Tensor:
        """``module.name``: this rank's block when it holds whole units
        (heads, columns of a unit each) or is not split, else gathered
        whole (a block that cuts a head in two)."""
        w = getattr(module, name)
        if name in self.split and not whole_units:
            return gather(w, self.axis, self.split[name])
        return w

    def units(self, name: str, count: int, whole_units: bool) -> Tuple[int, int]:
        """(first, count) of the ``count`` units (heads) this rank computes
        for weight ``name``: its block's when split in whole units, else all."""
        if name in self.split and whole_units:
            n = count // self.axis.size
            return self.axis.index * n, n
        return 0, count

    def divides(self, count: int) -> bool:
        return count % self.axis.size == 0


class ModelShard:
    """A model's tensor-parallel context: the model axis, the data-parallel
    axis of its batch (``dp``), the parameter specs, and whether the
    current call's batch rows are split over ``dp`` (``rows_split``, set by
    the entry points through ``batch_rows``)."""

    def __init__(self, model_axis: Axis, dp: Axis, specs: Mapping[str, Spec]):
        self.axis, self.dp, self.specs = model_axis, dp, dict(specs)
        self.rows_split = False

    @contextlib.contextmanager
    def batch_rows(self, split: bool) -> Iterator[None]:
        before, self.rows_split = self.rows_split, split
        try:
            yield
        finally:
            self.rows_split = before

    def vocab_split(self) -> bool:
        return is_split(self.specs["embed"]) and self.axis.size > 1


MODULES = ("attn", "cross", "ssm", "moe", "mlp")
OUT_WEIGHT = {"attn": "wo", "cross": "wo", "ssm": "wo", "moe": "w_down", "mlp": "w_down"}


def attach(model, model_axis: Axis, dp: Axis, specs: Mapping[str, Spec]) -> ModelShard:
    """Give ``model`` (its tensors this rank's blocks) and each of its
    modules their ``tp`` context; returns the model's."""
    shard = ModelShard(model_axis, dp, specs)
    model.tp = shard
    by_module: Dict[str, Dict[str, Spec]] = {}
    for name, spec in specs.items():
        prefix, leaf = name.rsplit(".", 1) if "." in name else ("", name)
        by_module.setdefault(prefix, {})[leaf] = spec
    for prefix, module in model.named_modules():
        kind = prefix.rsplit(".", 1)[-1]
        if kind in MODULES:
            module.tp = ModuleShard(model_axis, by_module[prefix], OUT_WEIGHT[kind], shard)
    return shard


def partial_grad_names(specs: Mapping[str, Spec], m: int) -> List[str]:
    """The replicated parameters of the active modules: each rank's
    gradient of one is a partial sum over the model axis."""
    if m == 1:
        return []
    active = set()
    for name, spec in specs.items():
        if "." not in name:
            continue
        prefix, leaf = name.rsplit(".", 1)
        kind = prefix.rsplit(".", 1)[-1]
        if kind in MODULES and leaf == OUT_WEIGHT[kind] and is_split(spec):
            active.add(prefix)
    return [n for n, s in specs.items()
            if "." in n and n.rsplit(".", 1)[0] in active and not is_split(s)]


def get(module) -> Optional[ModuleShard]:
    """A module's ``ModuleShard`` when it is active, else None."""
    t = getattr(module, "tp", None)
    return t if t is not None and t.active else None
