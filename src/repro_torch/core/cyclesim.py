"""Cycle-accurate model of the paper's FPGA pipeline (faithful reproduction).

This module reproduces the paper's *own evaluation methodology*: count the
clock cycles needed to drain a stream of keys through each implementation
(Hrz, Dup4, Dup8, Hyb4, Hyb4q, Hyb8, Hyb8q) and report throughput relative to
the Hrz baseline (paper Fig. 7).

Model, mapped 1:1 from §II:

* BRAM partitions are dual-port  ->  each tree (or subtree) admits at most
  ``PORTS = 2`` new keys per cycle into its level pipeline.
* Horizontal partitioning makes each tree a depth-(h+1) pipeline: once keys
  are admitted they never conflict again; total time = last admission cycle
  + pipeline latency.
* ``Hrz``  : one tree, 2 keys/cycle, no stalls.
* ``DupN`` : N replica trees, 2N keys/cycle, no stalls, N x memory.
* ``HybN`` : top ``log2(N)`` levels in registers (no port limit; a whole
  chunk of ``2N`` keys traverses them simultaneously), N vertical subtrees
  below.  Keys found in registers finish immediately; survivors are routed to
  their subtree's buffer (capacity ``2N``, the paper's configuration).  A
  subtree admits up to 2 buffered keys per cycle.  If any key of the incoming
  chunk cannot be buffered, the frontend STALLS: no new chunk enters until
  every pending key is placed (paper §II.C.3).
  - direct mapping: key with chunk index i may only use slot i; each cycle the
    two ports fetch the two earliest occupied slots ("the key which comes
    earlier in the buffer is selected", §II.C.3 / Fig. 5).
  - queue mapping: per-buffer read/write pointers; keys pack densely at
    write_ptr + label where label counts earlier same-destination keys in the
    chunk (paper Fig. 6).

Stall accounting: a cycle is stalled exactly when the frontend cannot fetch
a new chunk because keys of the previous chunk are still waiting for buffer
slots after that cycle's placement pass.  The cycle a chunk enters is never
a stall (a fetch happened), and the cycle its last deferred key places is
not either -- the frontend resumes and fetches the next chunk in the same
cycle.  Both mappings share one placement rule and one departure rate
(<= PORTS buffered keys per subtree per cycle, drainable the cycle after
they are written), so queue vs direct differ only in which slot a key may
occupy -- the paper's actual distinction.

The simulator is plain NumPy/Python on purpose: it is a *model checker* for
the hardware semantics, not a performance path.  The performance path is
core/engine.py + kernels/.  A copy of the JAX package's ``core/cyclesim.py``;
only the register-layer route runs in torch, on the tree's device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import tree as tree_lib
from repro_torch.core.engine import EngineConfig

PORTS = 2  # dual-port BRAM


@dataclasses.dataclass
class SimResult:
    name: str
    n_keys: int
    cycles: int
    stall_cycles: int
    keys_per_cycle: float
    memory_nodes: int
    pipeline_latency: int

    def speedup_vs(self, base: "SimResult") -> float:
        return base.cycles / self.cycles


def route_to_subtrees(
    tree: tree_lib.TreeData, keys: np.ndarray, register_levels: int
) -> np.ndarray:
    """Destination subtree for each key, -1 if resolved inside registers.

    The route runs on the tree's device (``tree.register_layer_route``),
    and the routes come to the host in one copy: the simulator is an
    offline model, not a serving path, so this copy is outside the
    server's fetch budget (``runtime.device_fetch`` does not count it)."""
    queries = torch.from_numpy(np.asarray(keys, dtype=np.int32)).to(tree.device)
    dest, _, found = tree_lib.register_layer_route(tree, queries, register_levels)
    dest, found = torch.stack([dest, found.to(torch.int32)]).cpu().numpy()
    dest[found != 0] = -1
    return dest


def simulate(
    config: EngineConfig,
    tree: tree_lib.TreeData,
    keys: np.ndarray,
    max_cycles: Optional[int] = None,
) -> SimResult:
    keys = np.asarray(keys, dtype=np.int32)
    K = keys.size
    h = tree.height
    if config.strategy == "hrz":
        cycles = math.ceil(K / PORTS) + (h + 1)
        return SimResult(config.name, K, cycles, 0, K / cycles, tree.n_nodes, h + 1)
    if config.strategy == "dup":
        n = config.n_trees
        cycles = math.ceil(K / (PORTS * n)) + (h + 1)
        return SimResult(
            config.name, K, cycles, 0, K / cycles, tree.n_nodes * n, h + 1
        )
    if config.strategy != "hyb":
        raise ValueError(config.strategy)
    return _simulate_hybrid(config, tree, keys, max_cycles)


def _simulate_hybrid(
    config: EngineConfig,
    tree: tree_lib.TreeData,
    keys: np.ndarray,
    max_cycles: Optional[int],
) -> SimResult:
    N = config.n_trees
    reg_levels = int(math.log2(N))
    chunk = PORTS * N  # keys fetched per cycle == max searchable in parallel
    capacity = chunk  # paper: buffer size == that maximum (Hyb4->8, Hyb8->16)
    K = keys.size
    h = tree.height
    sub_h = h - reg_levels
    # latency: reg_levels register compares + subtree pipeline + result cycle
    latency = reg_levels + (sub_h + 1)
    if max_cycles is None:
        max_cycles = 64 * (math.ceil(K / PORTS) + latency) + 1024

    dest_all = route_to_subtrees(tree, keys, max(reg_levels, 1))
    if reg_levels == 0:
        dest_all = np.zeros(K, dtype=np.int64)

    queue_mode = config.mapping == "queue"
    # Buffer state.
    if queue_mode:
        counts = np.zeros(N, dtype=np.int64)  # occupancy per circular queue
    else:
        occupied = np.zeros((N, capacity), dtype=bool)

    next_key = 0  # stream position
    pending: list[tuple[int, int]] = []  # [(chunk_index, dest)] awaiting slots
    admitted = 0  # keys admitted into subtree pipelines (or done in regs)
    last_admit_cycle = 0
    stall_cycles = 0
    cycle = 0

    def try_place(ci: int, d: int) -> bool:
        """One buffer-write attempt -- the ONE placement rule both mappings
        share, so queue and direct mode cannot drift apart in admission
        semantics (they differ only in which slot a key may occupy)."""
        if queue_mode:
            if counts[d] < capacity:
                counts[d] += 1
                return True
            return False
        if not occupied[d, ci]:
            occupied[d, ci] = True
            return True
        return False

    while admitted < K:
        cycle += 1
        if cycle > max_cycles:
            raise RuntimeError(f"{config.name}: no convergence in {max_cycles} cycles")
        # ---- 1) subtree ports drain buffers (2 keys per subtree per cycle).
        # Departure semantics are identical across mappings: every subtree
        # admits at most PORTS buffered keys per cycle, and keys written in
        # this cycle's frontend pass (steps 2/3) become drainable next
        # cycle -- the queue path decrements aggregate occupancy, the
        # direct path clears the two earliest occupied slots ("the key
        # which comes earlier in the buffer is selected", paper §II.C.3),
        # but the per-cycle departure count is the same.
        if queue_mode:
            drained = np.minimum(counts, PORTS)
            admitted += int(drained.sum())
            if drained.sum():
                last_admit_cycle = cycle
            counts -= drained
        else:
            for s in range(N):
                occ = occupied[s]
                nz = np.flatnonzero(occ)
                take = nz[:PORTS]
                if take.size:
                    occ[take] = False
                    admitted += int(take.size)
                    last_admit_cycle = cycle
        # ---- 2) frontend: place pending keys first.  A cycle is a STALL
        # exactly when the frontend cannot fetch a new chunk because keys
        # are still waiting for buffer slots after this pass (paper
        # §II.C.3: "fetching [the] new chunk stalls until all the keys of
        # the current chunk are stored").  The entry cycle itself is NOT a
        # stall -- a chunk was fetched then -- and the cycle in which the
        # last pending key places is not either: the frontend resumes and
        # fetches the next chunk in the same cycle (fall through below).
        # Counting the entry cycle AND the blocked passes double-booked
        # every deferral episode by one cycle of both stall and latency.
        if pending:
            pending = [(ci, d) for ci, d in pending if not try_place(ci, d)]
            if pending:
                stall_cycles += 1
                continue  # frontend blocked: no fetch this cycle
        # ---- 3) new chunk enters the register layer
        if next_key >= K:
            continue
        hi = min(next_key + chunk, K)
        idxs = np.arange(next_key, hi)
        dests = dest_all[idxs]
        next_key = hi
        # register hits complete without touching buffers
        reg_hits = int((dests < 0).sum())
        if reg_hits:
            admitted += reg_hits
            last_admit_cycle = cycle
        pending = [
            (int(ci), int(d))
            for ci, d in zip(range(len(idxs)), dests)
            if d >= 0 and not try_place(int(ci), int(d))
        ]

    cycles = last_admit_cycle + latency
    return SimResult(
        config.name,
        K,
        cycles,
        stall_cycles,
        K / cycles,
        tree.n_nodes,
        latency,
    )


def run_paper_matrix(
    tree: tree_lib.TreeData,
    key_sets: Dict[str, np.ndarray],
    configs: Optional[Dict[str, EngineConfig]] = None,
) -> Dict[str, Dict[str, SimResult]]:
    """The paper's full evaluation grid: {keyset: {impl: SimResult}}."""
    from repro_torch.core.engine import PAPER_CONFIGS

    configs = configs or PAPER_CONFIGS
    out: Dict[str, Dict[str, SimResult]] = {}
    for set_name, keys in key_sets.items():
        row = {}
        for impl, cfg in configs.items():
            row[impl] = simulate(cfg, tree, keys)
        out[set_name] = row
    return out
