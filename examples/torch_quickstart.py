"""Quickstart of the PyTorch/CUDA port: the BST accelerator's public API.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The counterpart of ``examples/quickstart.py`` on ``repro_torch``: builds a
key/value tree, runs lookups AND ordered queries (predecessor / successor /
range_count / range_scan) through every strategy of the paper (horizontal
/ duplicated / hybrid direct / hybrid queue), checks that every strategy
returns identical answers, and reproduces the cycle-accurate throughput
comparison on the paper's three key distributions (Fig. 7) with the
port's cycle model.  On the card (the default) the descents are the
port's kernels; ``--device cpu`` runs their plain versions.
"""

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.core import PAPER_CONFIGS, BSTEngine, build_tree
from repro_torch.core.cyclesim import run_paper_matrix
from repro_torch.data.keysets import make_key_sets, make_tree_data


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tree-keys", type=int, default=(1 << 14) - 1)
    ap.add_argument("--queries", type=int, default=4096)
    ap.add_argument("--stream", type=int, default=16384, help="keys a set in the cycle model")
    args = ap.parse_args(argv)
    configs = {name: dataclasses.replace(cfg, device=args.device)
               for name, cfg in PAPER_CONFIGS.items()}

    # 1) keys -> perfect BFS-layout tree
    keys, values = make_tree_data(args.tree_keys, seed=0)
    engine = BSTEngine(keys, values, configs["Hyb8q"])
    print(f"tree: {engine.tree.n_nodes} nodes, height {engine.tree.height}, on {engine.device}")

    # 2) batched lookup (hybrid partitioning + queue-mapped buffers)
    rng = np.random.default_rng(1)
    queries = rng.choice(np.concatenate([keys, keys + 1]), args.queries).astype(np.int32)
    vals, found = engine.lookup(queries)
    print(f"looked up {queries.size} keys: {int(found.sum())} found")

    # 3) ordered queries ride the same single descent
    pk, pv, ok = engine.query("predecessor", queries)  # floor(q)
    sk, sv, sok = engine.query("successor", queries)  # ceiling(q)
    lo, hi = queries, (queries + 64).astype(np.int32)
    counts = engine.query("range_count", lo, hi)  # |[lo, hi]|
    rk, rv, taken = engine.query("range_scan", lo, hi, k=4)  # first 4 pairs
    print(
        f"ordered: {int(ok.sum())} predecessors, {int(sok.sum())} successors, "
        f"mean range size {float(counts.float().mean()):.1f}, "
        f"scanned {int(taken.sum())} pairs"
    )

    # 4) every strategy returns identical results -- only throughput differs
    for name, cfg in configs.items():
        eng = BSTEngine(keys, values, cfg)
        v, f = eng.lookup(queries)
        assert torch.equal(v, vals) and torch.equal(f, found), name
        c = eng.query("range_count", lo, hi)
        assert torch.equal(c, counts), name
        print(f"  {name:6s}: identical results, memory={eng.memory_nodes()} nodes")

    # 5) the paper's evaluation: cycles to drain a key stream (Fig. 7)
    tree = build_tree(keys, values, device=args.device)
    sets = make_key_sets(tree, args.stream)
    res = run_paper_matrix(tree, sets)
    print("\nspeedup vs Hrz (cycle-accurate):")
    impls = list(PAPER_CONFIGS)
    print("         " + "".join(f"{i:>8s}" for i in impls))
    for sname, row in res.items():
        base = row["Hrz"]
        print(f"{sname:>8s} " + "".join(f"{r.speedup_vs(base):8.2f}" for r in row.values()))
    return res


if __name__ == "__main__":
    main()
