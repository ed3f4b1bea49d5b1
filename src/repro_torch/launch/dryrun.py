"""Multi-pod dry run: trace every (arch x shape x mesh) cell's step at full
width over a fake process group.

The port's counterpart of the JAX package's ``launch/dryrun.py``.  Where
that one lowers and compiles each cell's pjit step over 512 fake XLA
devices and reads XLA's analyses, this one runs the port's own step for the
cell once, as rank 0 of a fake process group of 256 ranks (``--mesh
single``, the production mesh (data 16, model 16)) or 512 (``multi``, (pod
2, data 16, model 16)), under ``FakeTensorMode``: every tensor has its
shape, dtype and device and no data, every collective returns at once, and
every kernel takes its shapes-only route (``kernels/ops.py``), so the run
allocates nothing and launches nothing.  The steps are the ones a user
runs: ``make_train_step(mode="pjit")`` on this rank's ``ShardedState``
(ZeRO-1 where the config says so), ``make_prefill_fn`` and
``make_serve_step`` with this rank's decode state, all on the tensor-parallel
model of this rank's parameter blocks (``elastic.sharded_model``), at the
config's published width and depth.  Every rank runs the same ops on blocks
of the same shapes (a spec splits a dim only where it divides, and the
batch rows the same way), so rank 0's view is every rank's: the record is
rank 0's.

Each record has the JAX package's keys:

* ``memory_analysis``: ``argument_size_in_bytes``, this rank's state and
  inputs exactly (the parameter blocks, AdamW's step, masters and moments,
  the tokens; for decode the cache blocks and the position), and
  ``peak_per_device_bytes``, the most bytes alive at once during the step
  (``torch.distributed._tools.mem_tracker.MemTracker``, the arguments
  included).  The port's tokens are int64 and every rank is given the
  global batch (the steps cut their rows), where the JAX package's are
  int32 and already cut.
* ``cost_analysis``: ``flops``, the matrix products that
  ``FlopCounterMode`` counts (``matmul_flops``) plus the kernels'
  operations (``kernel_flops``: K5 and its backward, K4, from their
  ``*_work`` functions), and ``bytes accessed``, each op's operand and
  result bytes plus the kernels' bytes.  These are unfused eager bytes:
  every torch op reads its operands and writes its result (a view moves
  nothing and an allocation writes nothing), where XLA counts a fusion's
  once, so they are far above what the card must move.  ``kernels`` gives
  each kernel's calls, operations and bytes.
* ``collectives``: the five kinds of the JAX package (``all-gather``,
  ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
  ``collective-permute``), each with its ``count`` and ``bytes`` a rank,
  and ``total_bytes``, ``total_count``.  Bytes are each collective's result
  bytes, as the JAX package counts the shape a collective returns; the
  port's own counters (``sharding/tp.STATS``, ``train_loop.DP_STATS``)
  count what a rank contributes, so an all-gather's is its result over the
  axis size.  Every all-reduce and all-gather the step made must be one
  those counters saw, and ``ported_counters`` holds them beside it (the
  BST dry run's all-to-alls are its own calls).
* ``status`` ("ok", "skipped" where ``cell_is_runnable`` says so, or
  "error" with ``error`` and ``traceback``) and ``lower_s``, the seconds
  the traced step took.  The JAX package's ``compile_s`` has no
  counterpart: nothing is compiled.

Records go to ``DRYRUN_OUT`` (default ``experiments/dryrun_torch/``).  A
process has one default group, so ``--mesh both`` makes a fake group for
each mesh in turn.  The run imports no JAX.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh both]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Callable, Dict, Iterator, List, NamedTuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs import ARCH_IDS, canonical, get_config
from repro_torch.kernels import ops as kops
from repro_torch.launch.mesh import MULTI_POD_SHAPE, PRODUCTION_SHAPE, make_production_mesh
from repro_torch.models import model as M
from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig, cell_is_runnable, input_specs
from repro_torch.sharding import specs as specs_lib
from repro_torch.sharding import tp

RESULT_DIR = os.environ.get(
    "DRYRUN_OUT",
    os.path.join(os.path.dirname(__file__), "..", "..", "..", "experiments", "dryrun_torch"),
)

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
# The c10d ops that the port's ``torch.distributed`` calls dispatch to, by
# kind (``all_reduce``, ``all_gather``, ``all_gather_into_tensor``,
# ``all_to_all_single``); each one's first argument holds its result.
_C10D = {
    "allreduce_": "all-reduce",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "alltoall_base_": "all-to-all",
}


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tensors)
               if isinstance(t, torch.Tensor))


class Ledger(TorchDispatchMode):
    """Counts what the ops under it do: ``bytes``, each op's operand and
    result bytes (views and allocations excepted: they move nothing), and
    ``collectives``, each c10d collective's count and result bytes by kind.
    Any other c10d op is listed in ``other``, and so in the record."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.collectives = {k: {"count": 0, "bytes": 0} for k in COLLECTIVES}
        self.other: Dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns, name = func.namespace, func._schema.name.split("::")[-1]
        if ns == "c10d":
            if name in _C10D:
                self.collectives[_C10D[name]]["count"] += 1
                self.collectives[_C10D[name]]["bytes"] += _nbytes(args[0])
            else:
                self.other[name] = self.other.get(name, 0) + 1
        elif not (func.is_view or name.startswith("empty")):
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out

    def record(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {k: dict(v) for k, v in self.collectives.items()}
        out["total_bytes"] = sum(v["bytes"] for v in self.collectives.values())
        out["total_count"] = sum(v["count"] for v in self.collectives.values())
        if self.other:
            out["other_c10d_ops"] = dict(self.other)
        return out


@contextlib.contextmanager
def fake_group(world: int) -> Iterator[None]:
    """The default process group as rank 0 of ``world`` fake ranks: no
    communication, every collective returns at once (its outputs keep what
    they held).  Destroyed on exit, the subgroups ``tp`` made with it too."""
    from torch.testing._internal.distributed.fake_pg import FakeStore  # registers "fake"

    if dist.is_initialized():
        raise RuntimeError("a dry run makes its own fake process group: one is already set up")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    tp.forget_groups()
    try:
        yield
    finally:
        tp.forget_groups()
        dist.destroy_process_group()


class Step(NamedTuple):
    """One cell's step, ready to run once: ``run()``, and the tensors it is
    given (``arguments``: this rank's state and inputs)."""

    run: Callable[[], Any]
    arguments: List[torch.Tensor]


def _fake(t: torch.Tensor, device) -> torch.Tensor:
    """An uninitialised tensor of ``t``'s shape and dtype on ``device``:
    under ``FakeTensorMode`` a fake one."""
    return torch.empty(tuple(t.shape), dtype=t.dtype, device=device)


def _blocks(cfg: ModelConfig, tree, dtype, mesh_sizes, coord, device):
    """This rank's block of every parameter-shaped tensor under the specs
    ``tree`` (None for a layer a ZeRO-1 split gives to other ranks)."""
    from repro_torch.checkpoint import elastic

    full = elastic.param_shapes(cfg)
    out = {}
    for name, spec in tree.items():
        if not elastic.holds(name, spec, cfg, mesh_sizes, coord):
            out[name] = None
            continue
        rows = elastic.shard_slices(full[name], spec, mesh_sizes, coord)
        out[name] = torch.empty([s.stop - s.start for s in rows], dtype=dtype, device=device)
    return out


def _present(blocks) -> List[torch.Tensor]:
    return [t for t in blocks.values() if t is not None]


def build_step(cfg: ModelConfig, shape: ShapeConfig, mesh, variant=None) -> Step:
    """The port's step for one cell on ``mesh`` (a ``DeviceMesh`` over the
    whole default process group), with uninitialised inputs (fake ones
    under ``FakeTensorMode``) at ``shape``; the counterpart of the JAX
    package's ``build_lowered``.

    ``variant``: ``ModelConfig`` field overrides (``moe_groups``,
    ``sharding_strategy``, ``zero1``, ``remat_policy``, ...), plus
    ``seq_shard_cache`` (a decode cell's KV cache split over its slots:
    True, over its kv heads: False; the default lets the layout rule
    choose) and ``microbatches`` (a train cell's gradient accumulation)."""
    from repro_torch.checkpoint import elastic
    from repro_torch.optim.optimizer import AdamWState
    from repro_torch.serving import serve_loop
    from repro_torch.training.train_loop import TrainConfig, make_train_step

    variant = dict(variant or {})
    seq_shard = variant.pop("seq_shard_cache", None)
    microbatches = variant.pop("microbatches", 1)
    if variant:
        cfg = dataclasses.replace(cfg, **variant)
    device = elastic.mesh_device(mesh)
    sizes = specs_lib.mesh_shape(mesh)
    coord = dict(zip(sizes, mesh.get_coordinate()))
    ins = {k: _fake(t, device) for k, t in input_specs(cfg, shape).items()}
    B, S = shape.global_batch, shape.seq_len
    front = () if "frontend_embeds" not in ins else (ins["frontend_embeds"],)

    if shape.kind == "train":
        sspecs = specs_lib.state_specs(cfg, sizes)
        o = sspecs.opt
        state = elastic.ShardedState(
            params=_blocks(cfg, sspecs.params, cfg.param_dtype, sizes, coord, device),
            opt=AdamWState(
                step=torch.zeros((), dtype=torch.int32, device=device),
                master=_blocks(cfg, o.master, torch.float32, sizes, coord, device),
                mu=_blocks(cfg, o.mu, torch.float32, sizes, coord, device),
                nu=_blocks(cfg, o.nu, torch.float32, sizes, coord, device)),
            error_feedback={}, specs=sspecs, coord=coord)
        step = make_train_step(cfg, TrainConfig(microbatches=microbatches), mesh=mesh,
                               mode="pjit")
        arguments = [*_present(state.params), state.opt.step, *_present(state.opt.master),
                     *_present(state.opt.mu), *_present(state.opt.nu),
                     ins["tokens"], ins["labels"], *front]
        return Step(lambda: step(state, ins["tokens"], ins["labels"], *front), arguments)

    params = _blocks(cfg, specs_lib.param_specs(cfg, sizes), cfg.param_dtype, sizes, coord,
                     device)
    model = elastic.sharded_model(cfg, params, mesh)
    if shape.kind == "prefill":
        prefill = serve_loop.make_prefill_fn(cfg, mesh, batch=B, max_len=S)
        return Step(lambda: prefill(model, ins["tokens"], *front),
                    [*_present(params), ins["tokens"], *front])

    # decode: one token against a seq_len-deep cache (the encdec memory as deep)
    memory_len = S if cfg.family == "encdec" else None
    state = serve_loop.mesh_decode_state(cfg, mesh, B, S, device, memory_len, seq_shard)
    step = serve_loop.make_serve_step(cfg, mesh, batch=B, seq_shard=seq_shard)
    return Step(lambda: step(model, ins["tokens"], state),
                [*_present(params), ins["tokens"], *M.state_tensors(state).values(),
                 state.position])


def trace_step(step: Step) -> Dict[str, Any]:
    """Run ``step`` once under the counters (inside the ``FakeTensorMode``
    its inputs were made in): its memory, cost and collectives as the
    record's fields, and the seconds it took."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.training.train_loop import DP_STATS, reset_dp_stats

    tp.reset_stats()
    reset_dp_stats()
    kops.reset_shape_work()
    mem = MemTracker()
    mem.track_external(*step.arguments)
    ledger = Ledger()
    flops = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    with mem, flops, ledger:
        step.run()
    seconds = time.perf_counter() - t0
    # the step's own device: ``meta`` tensors (shapes the steps reckon with,
    # a whole decode state's among them) hold no memory
    peak = sum(row["Total"] for dev, row in mem.get_tracker_snapshot("peak").items()
               if torch.device(dev).type != "meta")
    kernels = {k: dict(v) for k, v in kops.SHAPE_WORK.items()}
    kernel_flops = sum(v["flop"] for v in kernels.values())
    kernel_bytes = sum(v["bytes"] for v in kernels.values())
    collectives = ledger.record()
    counters = {**{k: dict(v) for k, v in tp.STATS.items()}, "dp": dict(DP_STATS)}
    collectives["ported_counters"] = counters
    seen = sum(v["calls"] for v in counters.values())
    made = sum(collectives[k]["count"] for k in ("all-reduce", "all-gather"))
    if seen != made:
        raise RuntimeError(f"the step made {made} all-reduces and all-gathers, the port's "
                           f"counters saw {seen}: {counters}")
    return {
        "lower_s": seconds,
        "memory_analysis": {
            "argument_size_in_bytes": _nbytes(step.arguments),
            "peak_per_device_bytes": peak,
        },
        "cost_analysis": {
            "flops": float(flops.get_total_flops() + kernel_flops),
            "bytes accessed": float(ledger.bytes + kernel_bytes),
            "matmul_flops": float(flops.get_total_flops()),
            "kernel_flops": float(kernel_flops),
            "kernel_bytes": float(kernel_bytes),
            "kernels": kernels,
        },
        "collectives": collectives,
    }


def trace_cell(cfg: ModelConfig, shape: ShapeConfig, mesh_dims: Dict[str, int],
               variant=None) -> Dict[str, Any]:
    """One step's record fields (``trace_step``) traced as rank 0 of its
    own fake group on a mesh of ``mesh_dims`` (axis name -> size, in mesh
    order; e.g. ``{"data": 1, "model": 1}`` for one card), at any shape:
    what the tests and ``chip_smoke.py`` hold against the JAX package and
    against the card."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh

    with fake_group(math.prod(mesh_dims.values())):
        mesh = init_device_mesh("cpu", tuple(mesh_dims.values()),
                                mesh_dim_names=tuple(mesh_dims))
        with FakeTensorMode():
            return trace_step(build_step(cfg, shape, mesh, variant))


def production_mesh(mesh_kind: str):
    """The production mesh over the current (fake) process group, on the
    CPU device type: fake tensors on ``cuda`` cannot be made where torch
    has no CUDA, and the shapes are the same."""
    return make_production_mesh(multi_pod=(mesh_kind == "multi"), device_type="cpu")


def world_of(mesh_kind: str) -> int:
    return math.prod(MULTI_POD_SHAPE if mesh_kind == "multi" else PRODUCTION_SHAPE)


def run_cell(arch: str, shape_name: str, mesh_kind: str, save: bool = True, variant=None,
             tag: str = "") -> Dict[str, Any]:
    """One cell's record (see the module docstring), over the fake group of
    ``mesh_kind``'s world, which must be the default group already
    (``fake_group``); written to ``RESULT_DIR`` with ``save``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    runnable, reason = cell_is_runnable(cfg, shape)
    rec: Dict[str, Any] = {
        "arch": cfg.name,
        "shape": shape_name,
        "mesh": mesh_kind,
        "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
        "kind": shape.kind,
        "n_params": cfg.n_params(),
        "n_active_params": cfg.n_active_params(),
    }
    if variant:
        rec["variant"] = {k: str(v) for k, v in variant.items()}
        rec["tag"] = tag
    if not runnable:
        rec["status"] = "skipped"
        rec["skip_reason"] = reason
        return _finish(rec, save, tag)
    try:
        mesh = production_mesh(mesh_kind)
        with FakeTensorMode():
            rec.update(trace_step(build_step(cfg, shape, mesh, variant)))
        rec["status"] = "ok"
        ma, ca = rec["memory_analysis"], rec["cost_analysis"]
        print(f"[{cfg.name} x {shape_name} x {mesh_kind}] "
              f"peak={ma['peak_per_device_bytes']:.4e} B "
              f"arguments={ma['argument_size_in_bytes']:.4e} B "
              f"flops={ca['flops']:.4e} bytes={ca['bytes accessed']:.4e} "
              f"collective_bytes={rec['collectives']['total_bytes']:.4e} "
              f"traced in {rec['lower_s']:.1f}s")
    except Exception as e:  # a cell's failure is its record; the run goes on
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"[{cfg.name} x {shape_name} x {mesh_kind}] FAILED: {rec['error']}")
    return _finish(rec, save, tag)


def _finish(rec, save: bool, tag: str = ""):
    if save:
        os.makedirs(RESULT_DIR, exist_ok=True)
        slug = f"{canonical(rec['arch'])}_{rec['shape']}_{rec['mesh']}"
        if tag:
            slug += f"__{tag}"
        with open(os.path.join(RESULT_DIR, slug + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def _done(arch: str, shape: str, mesh_kind: str) -> bool:
    path = os.path.join(RESULT_DIR, f"{canonical(arch)}_{shape}_{mesh_kind}.json")
    try:
        with open(path) as f:
            return json.load(f).get("status") in ("ok", "skipped")
    except (OSError, ValueError):
        return False


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None, help="architecture id (see configs/)")
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true", help="run every cell")
    ap.add_argument("--skip-existing", action="store_true",
                    help="skip cells whose result JSON already says ok/skipped")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    archs = ARCH_IDS if (args.all or args.arch is None) else [canonical(args.arch)]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]

    failures = 0
    for mk in meshes:
        with fake_group(world_of(mk)):
            for a in archs:
                for s in shapes:
                    if args.skip_existing and _done(a, s, mk):
                        continue
                    failures += run_cell(a, s, mk)["status"] == "error"
    if failures:
        raise SystemExit(f"{failures} cell(s) failed")


if __name__ == "__main__":
    main()
