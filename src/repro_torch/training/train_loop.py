"""Training step and loop: microbatch accumulation, AdamW, the compressed
data-parallel all-reduce, the host loop.

The port of the JAX package's ``training/train_loop.py``.  The step runs
``forward_train``, autograd's backward, the global-norm clip, the cosine
schedule and AdamW on fp32 masters, and writes the updated parameters back
into the model in its compute dtype.  The same metrics as the JAX step:
``loss``, ``moe_dropped``, ``grad_norm`` and ``lr``, each a device tensor
(the step reads nothing on the host).  Microbatches split the batch along
its first dimension: the fp32 gradients are summed divided by the count,
the loss averaged, and the metrics are the last microbatch's.

Where the JAX step returns a new state (and donates the old one), this one
updates the model's parameters, the optimizer state (the step counter too)
and the error feedback in place and returns the state it was given.

The JAX package jits each step into one program.  On a CUDA device
(unless ``eager=True``) each of the port's steps is a CUDA graph
(``repro_torch.graphs``), one per batch shape over one state's tensors
(``_StepGraphs``): the first call on a state runs the step once eagerly,
its warm-up, which is that call's step (a step cannot run twice), captures
it and returns the warm-up's metrics; every later call copies the batch
into the graph's static inputs and replays it.  The metrics are then the
graph's static outputs, valid until the next step, as decode logits are.
A state whose tensors are not the captured ones (a restore into another
state, ``reshard_state``) is captured anew.  The data-parallel and pjit
steps are graphs over NCCL, eager over gloo, whose collectives run on the
host; ``step.gradients`` stays eager.

``make_train_step(mesh=None)`` is the one-device step; it ignores gradient
compression, as the JAX package's ``step_plain`` does (for "int8" the
state still holds the error-feedback zeros).  ``mode="dp_shard_map"`` is
the JAX package's ``step_dp`` written SPMD over ``torch.distributed``, one
process a device: every rank is given the same global batch and takes its
rows (rank r of n the rows [r B / n, (r + 1) B / n), as ``shard_map``'s
``P(axes)`` splits them), accumulates its gradients, sums them over the
ranks through ``_compress_grads`` ("bf16" or "int8" with error feedback),
divides by n, averages the loss and metrics, and takes the plain step's
update; a ``ShardedState`` (ZeRO-1, or split parameters) is gathered whole
first, as the JAX package's ``in_specs=P()`` gathers it.

``mode="pjit"`` is the JAX package's ``pjit`` step written SPMD: each rank
holds its blocks of the state as ``sharding/specs.py`` places it
(``elastic.reshard_state``), takes its rows of the global batch over the
DP axes (of every microbatch, so that the ranks' rows of microbatch i are
the JAX step's microbatch i), and runs the tensor-parallel model
(``elastic.sharded_model``, ``sharding/tp.py``'s collectives over the
model axis).  After the backward it sums over the model axis the
gradients of the replicated parameters of the split modules (each rank's
is partial: ``tp.partial_grad_names``), sums every gradient over the DP
axes and divides by their size, clips by the norm of the blocks, and
updates: with ZeRO-1 each data rank updates the masters and moments it
holds and all-gathers the parameters over ``data``.  It ignores gradient
compression, as the JAX package's pjit step does.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import weakref
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import graphs
from repro_torch.analysis import runtime
from repro_torch.checkpoint import elastic
from repro_torch.models import convert
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.optim import optimizer as opt
from repro_torch.sharding import specs, tp


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    microbatches: int = 1  # grad accumulation factor
    compression: Optional[str] = None  # None | "bf16" | "int8"
    b1: float = 0.9
    b2: float = 0.95


class TrainState(NamedTuple):
    params: M.Model  # trainable, in the config's compute dtype
    opt: opt.AdamWState
    error_feedback: List[torch.Tensor]  # int8 compression residuals (or empty)


def init_train_state(cfg: ModelConfig, tcfg: TrainConfig, seed: int = 0,
                     device="cuda") -> TrainState:
    """A trainable model from ``seed`` (``init_params``), its AdamW state,
    and for int8 compression the error-feedback zeros."""
    model = M.init_params(cfg, seed=seed, device=device, trainable=True)
    params = list(model.parameters())
    ef = []
    if tcfg.compression == "int8":
        ef = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in params]
    return TrainState(params=model, opt=opt.adamw_init(params), error_feedback=ef)


StepFn = Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]
MODES = ("pjit", "dp_shard_map")
# The data-parallel collectives (both steps' sums over the DP ranks) since
# the last reset: calls and the bytes of the tensors they reduce (what each
# rank puts on the wire).  The model axis's are ``sharding.tp.STATS``.
DP_STATS = {"calls": 0, "bytes": 0}
graphs.count_at_replay(DP_STATS)  # a graphed step's all-reduces count as they run


def reset_dp_stats() -> None:
    DP_STATS.update(calls=0, bytes=0)


def _all_reduce(t: torch.Tensor, op=dist.ReduceOp.SUM, group=None) -> torch.Tensor:
    DP_STATS["calls"] += 1
    DP_STATS["bytes"] += t.numel() * t.element_size()
    dist.all_reduce(t, op=op, group=group)
    return t


def _sum_flat(tensors: List[torch.Tensor], wire: Optional[torch.dtype] = None, group=None
              ) -> List[torch.Tensor]:
    """``psum`` of every tensor, cast to ``wire`` first if given: one
    all-reduce a dtype over their concatenation (a sum and a cast are
    elementwise, so the function is the same)."""
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        idx = [i for i, t in enumerate(tensors) if t.dtype == dtype]
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        flat = _all_reduce(flat if wire is None else flat.to(wire), group=group)
        for i, part in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            out[i] = part.view(tensors[i].shape)
    return out


def _leaf_groups(names: List[str]) -> List[List[int]]:
    """The indices of the port's tensors that make one leaf of the JAX
    tree (a layer leaf: one tensor a layer), in first-seen order."""
    groups: Dict[Tuple[str, ...], List[int]] = {}
    for i, name in enumerate(names):
        groups.setdefault(convert.jax_key(name)[0], []).append(i)
    return list(groups.values())


def _compress_grads(grads: List[torch.Tensor], error_feedback: List[torch.Tensor],
                    kind: Optional[str], groups: List[List[int]]):
    """The JAX package's ``_compress_grads`` (quantize, ``psum`` over the
    ranks, dequantize, error feedback) over the default process group:
    ``(summed gradients, new error feedback)``.

    None sums the gradients in their dtype; "bf16" sums them cast to bf16
    and casts the sum to fp32; "int8" adds the error feedback, quantizes
    with this rank's absmax / 127 scale per JAX leaf (``groups``: a layer
    leaf's scale is its max over every layer), sums the int8 values as
    int32 and multiplies by the max of the ranks' scales, and keeps the
    residual as this rank's new error feedback (updated in place).  Each
    rank keeps its own residual, as each JAX device does under
    ``out_specs=P()`` with ``check=False``; a checkpoint holds rank 0's,
    as ``jax.device_get`` of that array does.  The int32 sum puts 4 bytes
    a parameter on the wire, as fp32 does."""
    if kind is None:
        return _sum_flat(grads), error_feedback
    if kind == "bf16":
        return [g.float() for g in _sum_flat(grads, wire=torch.bfloat16)], error_feedback
    if kind != "int8":
        raise ValueError(f"unknown compression {kind!r} (want None, 'bf16' or 'int8')")
    g32 = [g.float() + e for g, e in zip(grads, error_feedback, strict=True)]
    scales = torch.stack([
        torch.clamp(torch.stack([g32[i].abs().max() for i in idx]).max(), min=1e-12) / 127.0
        for idx in groups])
    q = [None] * len(g32)
    for k, idx in enumerate(groups):
        for i in idx:
            q[i] = torch.clamp(torch.round(g32[i] / scales[k]), -127, 127).to(torch.int8)
            error_feedback[i].copy_(g32[i] - q[i].float() * scales[k])
    del g32
    summed = _sum_flat(q, wire=torch.int32)
    del q
    scales = _all_reduce(scales, dist.ReduceOp.MAX)
    out = [None] * len(grads)
    for k, idx in enumerate(groups):
        for i in idx:
            out[i] = summed[i].float() * scales[k]
    return out, error_feedback


def _dp_rows(mesh, batch: int) -> Tuple[slice, int]:
    """(this rank's rows of a global batch of ``batch`` split over every
    mesh axis, the mesh's size): the block that ``elastic.shard_slices``
    cuts for the spec ``P(all_axes)``, as ``shard_map`` splits the batch."""
    if not dist.is_initialized():
        raise RuntimeError("the data-parallel step needs a process group: call "
                           "torch.distributed.init_process_group first")
    shape = specs.mesh_shape(mesh)
    n = math.prod(shape.values())
    if n != dist.get_world_size():
        raise ValueError(f"the data-parallel step's mesh {tuple(shape.values())} must span every "
                         f"one of the {dist.get_world_size()} ranks of the process group")
    if batch % n:
        raise ValueError(f"a global batch of {batch} does not split over {n} ranks")
    coord = dict(zip(shape, mesh.get_coordinate()))
    (rows,) = elastic.shard_slices((batch,), (specs.all_axes(shape),), shape, coord)
    return rows, n


def _grads_of(cfg: ModelConfig, model: M.Model, tokens, labels, frontend):
    """One forward and backward: (loss, metrics, the parameters' grads)."""
    params = list(model.parameters())
    for p in params:
        p.grad = None
    loss, metrics = M.forward_train(cfg, model, tokens, labels, frontend)
    loss.backward()
    missing = [name for name, p in model.named_parameters() if p.grad is None]
    if missing:
        raise RuntimeError(f"no gradient reached {missing}")
    return loss.detach(), metrics, [p.grad for p in params]


def _state_addresses(state) -> Tuple[int, ...]:
    """The addresses of every tensor of a ``TrainState`` or a
    ``ShardedState`` that a step reads or updates in place: the
    parameters, the step counter, the masters, the moments and the error
    feedback (a ZeRO-1 block this rank does not hold is None)."""
    def flat(x):
        if isinstance(x, torch.Tensor):
            return [x]
        if isinstance(x, torch.nn.Module):
            return list(itertools.chain(x.parameters(), x.buffers()))
        return [t for item in (x.values() if isinstance(x, dict) else x) if item is not None
                for t in flat(item)]

    o = state.opt
    return tuple(t.data_ptr() for t in flat([state.params, o.step, o.master, o.mu, o.nu,
                                             state.error_feedback]))


class _StepGraph:
    """One train step of one batch shape over one state's tensors as a CUDA
    graph: its static tokens, labels and frontend buffer, and the state's
    ``addresses`` at the capture.  The capture's warm-up is a real step
    (``release``: its cached temporaries are freed before the capture
    draws the graph's pool), whose metrics ``graph.warm`` holds for the
    first caller."""

    def __init__(self, run: Callable, tokens, labels, frontend, addresses, collectives: bool):
        self.addresses = addresses
        self.tokens, self.labels = tokens.clone(), labels.clone()
        self.frontend = None if frontend is None else frontend.clone()
        self.graph = graphs.Graph(lambda: run(self.tokens, self.labels, self.frontend),
                                  release=True, label=("train", *tokens.shape),
                                  collectives=collectives, device=tokens.device)

    def replay(self, tokens, labels, frontend) -> Dict[str, torch.Tensor]:
        self.tokens.copy_(tokens)
        self.labels.copy_(labels)
        if self.frontend is not None:
            self.frontend.copy_(frontend)
        return self.graph.replay()


class _StepGraphs:
    """A step function's graphs, per owner and batch shape.  The owner is
    the model the step trains (the caller's, or the pjit step's
    tensor-parallel model), held weakly: a dropped state's graphs and
    their memory pools go with it.  A graph holds no reference to the
    state, only its tensors' addresses, and one whose state is not at
    those addresses any more is captured anew."""

    def __init__(self, collectives: bool):
        self.collectives = collectives
        self._graphs: "weakref.WeakKeyDictionary[Any, Dict[tuple, _StepGraph]]" = (
            weakref.WeakKeyDictionary())

    def __call__(self, owner, state, run: Callable, tokens, labels, frontend
                 ) -> Dict[str, torch.Tensor]:
        """The metrics of ``run(tokens, labels, frontend)`` (one step on
        ``state``) as a replay of its graph, or, where the graph is to be
        captured, of the capture's warm-up step."""
        key = (tuple(tokens.shape), tuple(labels.shape),
               None if frontend is None else (tuple(frontend.shape), frontend.dtype))
        per_owner = self._graphs.setdefault(owner, {})
        g = per_owner.get(key)
        addresses = _state_addresses(state)
        if g is not None and g.addresses == addresses:
            return g.replay(tokens, labels, frontend)
        per_owner.pop(key, None)  # a stale graph's pool goes before the capture
        per_owner[key] = g = _StepGraph(run, tokens, labels, frontend, addresses,
                                        self.collectives)
        return g.graph.warm


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, mesh: Any = None,
                    mode: str = "pjit", *, eager: bool = False) -> StepFn:
    """``step(state, tokens, labels, frontend=None) -> (state, metrics)`` on
    the state's device; tokens and labels (B, S) integer tensors, frontend
    the stub embeddings ``forward_train`` takes (encdec, vlm).

    * ``mesh=None``: the one-device step.
    * ``mode="dp_shard_map"``: data parallelism over every axis of
      ``mesh`` (a ``DeviceMesh`` over the whole process group), the
      parameters whole on every rank (a ``ShardedState`` is gathered
      whole first); every rank is given the same global batch (and
      frontend), which must split evenly over the ranks.
    * ``mode="pjit"``: tensor and data parallelism (``_make_pjit_step``)
      on the state ``elastic.reshard_state`` placed on ``mesh`` (a
      ``ShardedState``, or a whole ``TrainState`` where every spec keeps
      every tensor whole); every rank is given the same global batch.
      The step returns the state it was given, its blocks updated in
      place; ``step.gradients(state, tokens, labels[, frontend])`` gives
      ``(loss, metrics, gradients)``, the gradients of this rank's blocks
      by name after the step's sums and before the clip.

    On a CUDA device, unless ``eager``, every step but the first on a state
    replays the step's CUDA graph (the module docstring says how); the
    mesh steps only over NCCL."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r} (want one of {MODES})")
    step_graphs = _StepGraphs(collectives=mesh is not None)
    if mesh is not None and mode == "pjit":
        return _make_pjit_step(cfg, tcfg, mesh, eager, step_graphs)

    def accumulate(model: M.Model, tokens, labels, frontend):
        mb = tcfg.microbatches
        if mb == 1:
            return _grads_of(cfg, model, tokens, labels, frontend)
        Bl = tokens.shape[0]
        if Bl % mb:
            raise ValueError(f"a batch of {Bl} does not split into {mb} microbatches")
        n = Bl // mb
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in model.parameters()]
        acc_loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
        metrics: Dict[str, torch.Tensor] = {}
        for i in range(mb):
            rows = slice(i * n, (i + 1) * n)
            loss, metrics, grads = _grads_of(cfg, model, tokens[rows], labels[rows],
                                             None if frontend is None else frontend[rows])
            for a, g in zip(acc, grads):
                a.add_(g.float() / mb)
            acc_loss = acc_loss + loss / mb
        return acc_loss, metrics, acc

    def finish(state: TrainState, loss, dropped, grads, ef):
        model = state.params
        grads, gnorm = opt.clip_by_global_norm(grads, tcfg.clip_norm)
        for p in model.parameters():  # the raw grads go before the update's temporaries
            p.grad = None
        lr = opt.cosine_schedule(state.opt.step, tcfg.peak_lr, tcfg.warmup_steps,
                                 tcfg.total_steps)
        params, opt_state = opt.adamw_update(
            grads, state.opt, lr, b1=tcfg.b1, b2=tcfg.b2, weight_decay=tcfg.weight_decay,
            compute_dtype=cfg.param_dtype,
        )
        del grads
        with torch.no_grad():
            for p, new in zip(model.parameters(), params):
                p.copy_(new)
        metrics = {"moe_dropped": dropped, "loss": loss, "grad_norm": gnorm, "lr": lr}
        return TrainState(model, opt_state, ef), metrics

    def run_plain(state: TrainState, tokens, labels, frontend):
        loss, metrics, grads = accumulate(state.params, tokens, labels, frontend)
        return finish(state, loss, metrics["moe_dropped"].detach(), grads, state.error_feedback)

    def step(state: TrainState, tokens: torch.Tensor, labels: torch.Tensor,
             frontend: Optional[torch.Tensor] = None):
        if graphs.eager_route(eager, tokens):
            return run_plain(state, tokens, labels, frontend)
        return state, step_graphs(state.params, state,
                                  lambda t, y, f: run_plain(state, t, y, f)[1],
                                  tokens, labels, frontend)

    if mesh is None:
        return step

    _dp_rows(mesh, 0)  # the process group and the mesh, checked once here
    groups: List[List[int]] = []

    def run_dp(state: TrainState, tokens, labels, frontend):
        rows, n = _dp_rows(mesh, tokens.shape[0])
        loss, metrics, grads = accumulate(state.params, tokens[rows], labels[rows],
                                          None if frontend is None else frontend[rows])
        if not groups:
            groups.extend(_leaf_groups([name for name, _ in state.params.named_parameters()]))
        grads, ef = _compress_grads(grads, state.error_feedback, tcfg.compression, groups)
        grads = [g / n for g in grads]
        means = _all_reduce(torch.stack([loss.float(), metrics["moe_dropped"].detach().float()]))
        means = means / n
        return finish(state, means[0], means[1], grads, ef)

    def step_dp(state: TrainState, tokens: torch.Tensor, labels: torch.Tensor,
                frontend: Optional[torch.Tensor] = None):
        if isinstance(state, elastic.ShardedState):  # the JAX step's in_specs=P()
            state = elastic.gather_state(state, cfg, mesh)
        if graphs.eager_route(eager, tokens, collectives=True):
            return run_dp(state, tokens, labels, frontend)
        return state, step_graphs(state.params, state,
                                  lambda t, y, f: run_dp(state, t, y, f)[1],
                                  tokens, labels, frontend)

    return step_dp


def _check_mesh(mesh) -> Dict[str, int]:
    if not dist.is_initialized():
        raise RuntimeError("the pjit step needs a process group: call "
                           "torch.distributed.init_process_group first")
    shape = specs.mesh_shape(mesh)
    if math.prod(shape.values()) != dist.get_world_size():
        raise ValueError(f"the pjit step's mesh {tuple(shape.values())} must span every one of "
                         f"the {dist.get_world_size()} ranks of the process group")
    return shape


def _make_pjit_step(cfg: ModelConfig, tcfg: TrainConfig, mesh, eager: bool,
                    step_graphs: _StepGraphs) -> StepFn:
    """The tensor-parallel step (``make_train_step``'s ``mode="pjit"``); its
    graphs are owned by the tensor-parallel model over the state's blocks."""
    shape = _check_mesh(mesh)
    sspecs = specs.state_specs(cfg, shape)
    pspecs, ospecs = sspecs.params, sspecs.opt.master
    names = list(pspecs)
    model_axis, dp = elastic.shard_axes(cfg, mesh)
    partial = tp.partial_grad_names(pspecs, model_axis.size)
    split = [tp.is_split(pspecs[n]) for n in names]
    zero = [n for n in names if ospecs[n] != pspecs[n]]  # ZeRO-1 splits their AdamW state
    coord = dict(zip(shape, mesh.get_coordinate()))
    full = elastic.param_shapes(cfg)
    # a ZeRO-1 block's place inside this rank's parameter block
    inner = {}
    for n in zero:
        if elastic.holds(n, ospecs[n], cfg, shape, coord):
            src = elastic.shard_slices(full[n], ospecs[n], shape, coord)
            dst = elastic.shard_slices(full[n], pspecs[n], shape, coord)
            inner[n] = tuple(slice(a.start - b.start, a.stop - b.start) for a, b in zip(src, dst))
    held: Dict[str, Any] = {}

    def placed(state) -> elastic.ShardedState:
        """``state`` as a ``ShardedState``: a whole ``TrainState`` (what
        ``reshard_state`` gives where every spec keeps every tensor whole)
        becomes one whose blocks are its own tensors, so that the step
        updates it in place, as it does a ``ShardedState``."""
        if isinstance(state, elastic.ShardedState):
            return state
        if not all(elastic.is_whole(sp) for tree in (pspecs, ospecs) for sp in tree.values()):
            raise ValueError("the pjit step takes the state that elastic.reshard_state placed "
                             "on its mesh: here the specs split tensors, so a ShardedState")
        if held.get("whole") is not state.params:
            held.update(whole=state.params,
                        blocks={n: p.detach() for n, p in state.params.named_parameters()})
        o = state.opt
        return elastic.ShardedState(
            held["blocks"], opt.AdamWState(o.step, dict(zip(names, o.master)),
                                           dict(zip(names, o.mu)), dict(zip(names, o.nu))),
            {}, sspecs, coord)

    def model_of(state: elastic.ShardedState) -> M.Model:
        """The tensor-parallel model over a placed state's parameter blocks,
        built here: the caller's model, if any, is left as it is."""
        if held.get("params") is not state.params:
            held.update(params=state.params, model=elastic.sharded_model(
                cfg, state.params, mesh, trainable=True))
        return held["model"]

    def gradients(state, tokens, labels, frontend=None):
        model = model_of(placed(state))
        B, mb, n = tokens.shape[0], tcfg.microbatches, dp.size
        if B % (mb * n):
            raise ValueError(f"a global batch of {B} does not split into {mb} microbatches "
                             f"over {n} data-parallel ranks")
        per, mine = B // mb, B // (mb * n)
        acc_loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
        acc = None
        with model.tp.batch_rows(n > 1):
            for i in range(mb):  # this rank's rows of the JAX step's microbatch i
                rows = slice(i * per + dp.index * mine, i * per + (dp.index + 1) * mine)
                loss, metrics, grads = _grads_of(cfg, model, tokens[rows], labels[rows],
                                                 None if frontend is None else frontend[rows])
                if mb == 1:
                    acc, acc_loss = grads, loss
                    break
                if acc is None:
                    acc = [torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                           for g in grads]
                for a, g in zip(acc, grads):
                    a.add_(g.float() / mb)
                acc_loss = acc_loss + loss / mb
        grads = dict(zip(names, acc))
        if partial:  # partial sums on each rank of the model axis
            flat = model_axis.all_reduce(torch.cat([grads[k].reshape(-1) for k in partial]))
            for k, part in zip(partial, flat.split([grads[k].numel() for k in partial])):
                grads[k] = part.view(grads[k].shape)
        means = torch.stack([acc_loss.float(), metrics["moe_dropped"].detach().float()])
        if n > 1:
            summed = _sum_flat([grads[k] for k in names], group=dp.group)
            grads = {k: g / n for k, g in zip(names, summed)}
            means = _all_reduce(means, group=dp.group) / n
        return means[0], {"moe_dropped": means[1]}, grads

    def run(state, tokens, labels, frontend):
        blocks = placed(state)
        model, o = model_of(blocks), blocks.opt
        master, mu, nu = o.master, o.mu, o.nu
        loss, metrics, grads = gradients(blocks, tokens, labels, frontend)
        for p in model.parameters():
            p.grad = None
        clipped, gnorm = opt.clip_by_global_norm([grads[k] for k in names], tcfg.clip_norm,
                                                 split, model_axis)
        del grads
        lr = opt.cosine_schedule(state.opt.step, tcfg.peak_lr, tcfg.warmup_steps,
                                 tcfg.total_steps)
        mine = [k for k in names if master[k] is not None]
        g = dict(zip(names, clipped))
        new, _ = opt.adamw_update(
            [g[k][inner[k]] if k in inner else g[k] for k in mine],
            opt.AdamWState(state.opt.step, [master[k] for k in mine], [mu[k] for k in mine],
                           [nu[k] for k in mine]),
            lr, b1=tcfg.b1, b2=tcfg.b2, weight_decay=tcfg.weight_decay,
            compute_dtype=cfg.param_dtype)
        del clipped, g
        params = dict(model.named_parameters())
        new = dict(zip(mine, new))
        with torch.no_grad():
            for k in names:
                if k not in zero:
                    params[k].copy_(new[k])
            if zero:  # each data rank's slices, gathered into every rank's blocks
                elastic.gather_blocks({k: new.get(k) for k in zero}, ospecs, pspecs, cfg, mesh,
                                      ("data",), out={k: params[k].data for k in zero})
        metrics = {"moe_dropped": metrics["moe_dropped"], "loss": loss, "grad_norm": gnorm,
                   "lr": lr}
        return state, metrics

    def step(state, tokens: torch.Tensor, labels: torch.Tensor,
             frontend: Optional[torch.Tensor] = None):
        if graphs.eager_route(eager, tokens, collectives=True):
            return run(state, tokens, labels, frontend)
        return state, step_graphs(model_of(placed(state)), state,
                                  lambda t, y, f: run(state, t, y, f)[1], tokens, labels, frontend)

    step.gradients = gradients
    return step


def train_loop(
    cfg: ModelConfig,
    tcfg: TrainConfig,
    pipeline,
    steps: int,
    state: Optional[TrainState] = None,
    step0: int = 0,
    frontend: Optional[torch.Tensor] = None,
    callback: Optional[Callable[[int, TrainState, Dict[str, float]], None]] = None,
    device="cuda",
):
    """The host loop of ``launch/train.py`` and the tests: ``steps`` steps on
    ``pipeline.batch_at(step)`` for step in [step0, step0 + steps), from
    ``state`` (a seed-0 init if None), the frontend's embeddings (if any)
    with every batch, each step's metrics read on the host after it (one
    counted fetch) and handed to ``callback(step, state, metrics)``.  On a
    CUDA device the steps replay ``make_train_step``'s graph.  Returns
    ``(state, history)``."""
    state = state if state is not None else init_train_state(cfg, tcfg, 0, device)
    step_fn = make_train_step(cfg, tcfg)
    history = []
    for s in range(step0, step0 + steps):
        tokens, labels = (torch.from_numpy(a).to(device, torch.int64) for a in pipeline.batch_at(s))
        state, metrics = step_fn(state, tokens, labels, frontend)
        values = runtime.device_fetch(list(metrics.values()))
        history.append({k: float(v) for k, v in zip(metrics, values)})
        if callback is not None:
            callback(s, state, history[-1])
    return state, history
