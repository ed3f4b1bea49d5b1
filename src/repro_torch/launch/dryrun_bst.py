"""Dry run of the paper's own workload on the production mesh: the sharded
hybrid BST lookup, a key chunk a rank.

The port's counterpart of the JAX package's ``launch/dryrun_bst.py``: the
tree vertically partitioned over ``model`` (a subtree a rank, the register
layer replicated), the keys split over every rank, traced as rank 0 of a
fake process group (``launch/dryrun.py``'s ``fake_group``) under
``FakeTensorMode`` at a 2^21 - 1 node tree and 65,536 keys a rank.  The
chain is the port's own, the phases of ``core/plans.py``: the register
route (``route_phase``), the queue dispatch (``dispatch_phase``, kernel K4),
the buffers' gather (``gather_phase``), the keys and their live mask to
their subtrees (two ``all_to_all_single``), the subtree descent
(``descend_phase``, kernel K1), the values and found flags back (two
more), and the combine (``combine_phase``).  It is the membership lookup,
which bounds the ordered ops too: each is one descent of the same traffic
shape.  At ``--capacity-frac 1`` a buffer is as deep as the local batch
and one round places every key; below it, the rounds are the port's
sharded server's (``core/distributed.py``): the capped round, its stall
rounds, and the stall-free drain round, which the port always runs behind
a capped round (the JAX package's runs only when a key is left, so its
dry run has none: the difference is that round's four all-to-alls).

The record has the JAX package's terms, reckoned with the H100's rates
(``repro_torch.hardware``), each a rank's:

* ``t_compute_s``: the descent's integer work, keys x (H + 1) levels x 4
  operations (compare, select, index step), over the CUDA cores' rate;
* ``t_memory_s``: keys x (H + 1) levels x 8 bytes (each level's key and
  value) over HBM's rate;
* ``t_collective_s``: the all-to-alls' result bytes over one direction
  of NVLink (a rank receives them while it sends as many): an upper bound
  on the rate, since a production mesh's 16-rank model axis spans two
  8-card NVLink domains;
* ``dominant`` and ``keys_per_sec_bound``: the global chunk over the
  largest of the three.

Also the kernels' work as the shapes-only route counted it (``kernels``),
the collectives as ``launch/dryrun.py`` counts them (result bytes), the
rank's peak bytes, and ``lower_s``.  Written to ``DRYRUN_OUT``.

  PYTHONPATH=src python -m repro_torch.launch.dryrun_bst [--mesh single|multi]
"""

from __future__ import annotations

import argparse
import json
import math
import os
from typing import Any, Dict

import torch
import torch.distributed as dist

from repro_torch import hardware
from repro_torch.core import plans as plans_lib
from repro_torch.core.distributed import STALL_ROUNDS
from repro_torch.launch import dryrun as DR


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


def build_lookup(mesh, tree_nodes: int, chunk_per_device: int,
                 capacity_frac: float) -> Dict[str, Any]:
    """The lookup of one rank's chunk on ``mesh`` (a ``DeviceMesh`` with a
    ``model`` axis over the whole default process group), as a
    ``dryrun.Step`` with uninitialised operands (fake ones under
    ``FakeTensorMode``), and its sizes: ``{"step", "height", "global_chunk",
    "capacity", "rounds"}``."""
    M = mesh.size(mesh.mesh_dim_names.index("model"))
    group = mesh.get_group("model")
    split = int(math.log2(M))
    height = int(math.log2(tree_nodes + 1)) - 1
    if (1 << split) != M or (1 << (height + 1)) - 1 != tree_nodes or split > height:
        raise ValueError(f"a perfect tree of {tree_nodes} nodes does not split into {M} subtrees")
    sub_h = height - split
    sub_n = (1 << (sub_h + 1)) - 1
    B = chunk_per_device
    cap = max(1, int(B * capacity_frac))
    device = torch.device(mesh.device_type)
    reg_n = (1 << max(split, 1)) - 1

    def empty(*shape):
        return torch.empty(shape, dtype=torch.int32, device=device)

    queries, sub_k, sub_v = empty(B), empty(1, sub_n), empty(1, sub_n)
    reg_k, reg_v = empty(reg_n), empty(reg_n)
    capped = cap < B
    rounds = [cap] * (1 + (STALL_ROUNDS if capped else 0)) + ([B] if capped else [])

    def one_round(dest, pending, depth):
        dplan = plans_lib.dispatch_phase("queue", dest, M, depth, active=pending)
        send_q, send_live = plans_lib.gather_phase(queries, dplan)
        recv_q = _all_to_all(send_q, group)
        recv_live = _all_to_all(send_live.to(torch.int32), group) != 0
        vals, fnd = plans_lib.descend_phase(sub_k, sub_v, sub_h, recv_q.reshape(1, -1),
                                            recv_live.reshape(1, -1))
        back_v = _all_to_all(vals[0].reshape(M, depth), group)
        back_f = _all_to_all(fnd[0].to(torch.int32).reshape(M, depth), group) != 0
        got_v, got_f = plans_lib.combine_phase(back_v, back_f, dplan, B)
        return got_v, got_f, dplan.overflow

    def run():
        dest, val, found = plans_lib.route_phase(reg_k, reg_v, queries, split)
        pending = ~found
        for depth in rounds:
            got_v, got_f, overflow = one_round(dest, pending, depth)
            placed = pending & ~overflow
            val = torch.where(placed, got_v, val)
            found = found | (placed & got_f)
            pending = overflow
        return val, found

    return {"step": DR.Step(run, [queries, sub_k, sub_v, reg_k, reg_v]), "height": height,
            "global_chunk": B * mesh.size(), "capacity": cap, "rounds": rounds}


def lookup_record(mesh, mesh_kind: str, tree_nodes: int, chunk_per_device: int,
                  capacity_frac: float) -> Dict[str, Any]:
    """The traced lookup's record (the module docstring's terms)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        built = build_lookup(mesh, tree_nodes, chunk_per_device, capacity_frac)
        traced = DR.trace_step(built["step"])
    height, cb = built["height"], traced["collectives"]
    levels = chunk_per_device * (height + 1)
    t_comp = 4 * levels / hardware.FP32_FLOP_PER_S
    t_mem = 8 * levels / hardware.HBM_BYTES_PER_S
    t_coll = cb["total_bytes"] / hardware.NVLINK_BYTES_PER_S
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    return {
        "mesh": mesh_kind,
        "tree_nodes": tree_nodes,
        "global_chunk": built["global_chunk"],
        "keys_per_device": chunk_per_device,
        "capacity_frac": capacity_frac,
        "capacity": built["capacity"],
        "rounds": built["rounds"],
        "collectives": cb,
        "kernels": traced["cost_analysis"]["kernels"],
        "peak_per_device_bytes": traced["memory_analysis"]["peak_per_device_bytes"],
        "card": f"{hardware.CARD}, {hardware.POWER_LIMIT_W:.0f} W (data sheet rates)",
        "t_compute_s": t_comp,
        "t_memory_s": t_mem,
        "t_collective_s": t_coll,
        "dominant": max(terms, key=terms.get),
        "keys_per_sec_bound": built["global_chunk"] / max(terms.values()),
        "lower_s": traced["lower_s"],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--tree-nodes", type=int, default=(1 << 21) - 1)
    ap.add_argument("--chunk-per-device", type=int, default=65536)
    ap.add_argument("--capacity-frac", type=float, default=1.0)
    args = ap.parse_args(argv)

    with DR.fake_group(DR.world_of(args.mesh)):
        rec = lookup_record(DR.production_mesh(args.mesh), args.mesh, args.tree_nodes,
                            args.chunk_per_device, args.capacity_frac)
    out = os.path.join(DR.RESULT_DIR, f"bst_engine_{args.mesh}.json")
    os.makedirs(DR.RESULT_DIR, exist_ok=True)
    with open(out, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps({k: v for k, v in rec.items() if k not in ("collectives", "kernels")},
                     indent=1))
    print("collective bytes/device:", rec["collectives"]["total_bytes"])
    return rec


if __name__ == "__main__":
    main()
