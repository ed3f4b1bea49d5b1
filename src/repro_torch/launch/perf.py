"""Perf hill-climb runner: re-trace chosen dry-run cells with variants.

The port's counterpart of the JAX package's ``launch/perf.py``: its
``ITERATIONS`` table, key for key, each iteration an (arch, shape, variant,
tag, hypothesis) row, run through the port's ``launch/dryrun.run_cell``
over the fake process group of the mesh and written to
``DRYRUN_OUT/<slug>__<tag>.json``, the before rows being the untagged
records of ``launch/dryrun.py``.  The hypotheses are the JAX package's
text, copied as they stand: the figures in them are its own dry runs' (its
GSPMD partitioning, its device), none of them the port's; the port's
records are what to read beside them.  Iteration 3's change was a JAX
attention rewrite with no variant key, so here it re-traces the cell as
it is.

  PYTHONPATH=src python -m repro_torch.launch.perf --iter 1   (or 2, 3, all)
"""

from __future__ import annotations

import argparse

from repro_torch.launch.dryrun import fake_group, run_cell, world_of

# (arch, shape, variant, tag, hypothesis) -- the three §Perf cells + extras
ITERATIONS = {
    "1": (
        "mixtral_8x7b",
        "train_4k",
        {"moe_groups": 32},
        "moegroups32",
        "grouped dispatch makes the token prefix-sum device-local; "
        "collective bytes should drop ~100x to grad-allreduce + TP levels",
    ),
    "1b": (
        "mixtral_8x22b",
        "train_4k",
        {"moe_groups": 32},
        "moegroups32",
        "same as iter 1 on the 141B config",
    ),
    "2": (
        "granite_3_8b",
        "decode_32k",
        {"seq_shard_cache": True},
        "seqshard",
        "sequence-sharding the KV cache over the model axis divides cache "
        "residency by 16 and replaces the gather with tiny softmax-stat "
        "reductions",
    ),
    "3": (
        "hymba_1p5b",
        "train_4k",
        {},  # the change is the q-block-outer attention (code-level)
        "qblockattn",
        "q-block-outer attention with rematerialized inner scans saves only "
        "the attention output per block instead of nblk x (B,S,KV,G,hd) "
        "accumulator carries; peak memory should drop several-fold",
    ),
    "2b": (
        "qwen3_1p7b",
        "decode_32k",
        {"seq_shard_cache": True},
        "seqshard",
        "iter 2's fix generalizes to every kv_heads<model arch",
    ),
    "1c": (
        "mixtral_8x7b",
        "prefill_32k",
        {"moe_groups": 32},
        "moegroups32",
        "grouped dispatch fixes prefill's collective term too",
    ),
    # --- revised after iter 1 was REFUTED: the TB-scale all-reduce came from
    # the scatter-add combine, not the prefix-sum dispatch.
    "1r": (
        "mixtral_8x7b",
        "train_4k",
        {"moe_groups": 32},
        "gathercombine",
        "gather-based combine (no scatter over the token dim) + grouped "
        "dispatch: GSPMD keeps all MoE traffic group-local; expect collective "
        "bytes to fall from ~9.8 TB to grad-allreduce + TP scale (<0.5 TB)",
    ),
    "1rb": (
        "mixtral_8x22b",
        "train_4k",
        {"moe_groups": 32},
        "gathercombine",
        "same on 141B",
    ),
    "1rc": (
        "mixtral_8x7b",
        "prefill_32k",
        {"moe_groups": 32},
        "gathercombine",
        "same fix on the prefill cell",
    ),
    "3b": (
        "hymba_1p5b",
        "train_4k",
        {"microbatches": 4},
        "qblockattn_mb4",
        "grad accumulation over 4 microbatches divides live activations by 4 "
        "on top of iter 3: 41 GiB -> ~16 GiB/device",
    ),
    # --- iter 4: the roofline table shows TP activation collectives dominate
    # every dense train cell (granite: 15.1 s collective vs 1.5 s compute).
    # At global_batch 256 == chips and <= 8B params, pure DP eliminates them.
    "4": (
        "granite_3_8b",
        "train_4k",
        {"sharding_strategy": "dp_only"},
        "dponly",
        "replicated params + batch over all 256 chips: activation collectives "
        "-> 0; remaining traffic = one grad all-reduce (~8B x 4B x 2 wire / "
        "256 = manageable); expect collective term 15.1 s -> ~1.3 s, cell "
        "flips compute-bound",
    ),
    "4b": (
        "qwen3_1p7b",
        "train_4k",
        {"sharding_strategy": "dp_only"},
        "dponly",
        "same for qwen3 (5.2 s collective vs 0.33 s compute at baseline)",
    ),
    "4c": (
        "hymba_1p5b",
        "train_4k",
        {"sharding_strategy": "dp_only", "microbatches": 4},
        "dponly_mb4",
        "combine iter 3b with pure DP for the hybrid arch",
    ),
    # --- iter 1p: gather-combine alone was NOT enough (GSPMD still chose to
    # replicate the (E,C,D) buffers).  Pin the group axis to the DP mesh axes
    # with explicit with_sharding_constraint.
    "1p": (
        "mixtral_8x7b",
        "train_4k",
        {"moe_groups": 32},
        "pinned",
        "explicit sharding constraints pin the dispatch group dim to "
        "(pod,data): every gather/einsum/combine is group-local; expect "
        "collective bytes ~9.9 TB -> < 1 TB",
    ),
    "1pb": (
        "mixtral_8x22b",
        "train_4k",
        {"moe_groups": 32},
        "pinned",
        "same on 141B",
    ),
    "1pc": (
        "mixtral_8x7b",
        "prefill_32k",
        {"moe_groups": 32},
        "pinned",
        "same fix on the prefill cell",
    ),
    # --- iter 5: iter 1p leaves 41 GB/device of param+opt state on the
    # mixtral cell (> 16 GB HBM).  ZeRO-1 shards master/mu/nu over the data
    # axis along each leaf's leading (stacked-layer) dim.
    "5": (
        "mixtral_8x7b",
        "train_4k",
        {"moe_groups": 32, "zero1": True},
        "pinned_zero1",
        "ZeRO-1 opt-state sharding: argument bytes 41 GB -> ~6 GB/device; "
        "grads reduce-scatter instead of all-reduce (less wire too)",
    ),
    "5b": (
        "qwen3_1p7b",
        "train_4k",
        {"sharding_strategy": "dp_only", "zero1": True},
        "dponly_zero1",
        "dp_only replicates 24 GB of opt state on qwen3; ZeRO-1 shards it "
        "over data along stacked-layer dims",
    ),
    "5c": (
        "mixtral_8x22b",
        "train_4k",
        {"moe_groups": 32, "zero1": True},
        "pinned_zero1",
        "the 141B config only becomes HBM-feasible with both fixes",
    ),
    # --- stacking the adopted fixes per cell
    "4d": (
        "granite_3_8b",
        "train_4k",
        {"sharding_strategy": "dp_only", "zero1": True, "microbatches": 2},
        "dponly_zero1_mb2",
        "iter 4 won 10x on collectives but replicated 109 GB of state; "
        "ZeRO-1 (generalized to the first divisible dim) shards it back and "
        "mb=2 halves live activations",
    ),
    "4e": (
        "hymba_1p5b",
        "train_4k",
        {"sharding_strategy": "dp_only", "zero1": True, "microbatches": 4},
        "dponly_mb4_zero1",
        "hymba final stack: dp_only + mb4 + ZeRO-1",
    ),
    "5d": (
        "mixtral_8x7b",
        "train_4k",
        {"moe_groups": 32, "zero1": True, "microbatches": 8},
        "pinned_zero1_mb8",
        "mixtral final stack: 60 GB of temp is microbatchable activations; "
        "mb=8 should land the cell near the 16 GB HBM budget",
    ),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iter", default="all")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    args = ap.parse_args(argv)
    keys = list(ITERATIONS) if args.iter == "all" else [args.iter]
    records = []
    with fake_group(world_of(args.mesh)):
        for k in keys:
            arch, shape, variant, tag, hyp = ITERATIONS[k]
            print(f"=== iter {k}: {arch} x {shape} [{tag}]\n    hypothesis: {hyp}")
            records.append(run_cell(arch, shape, args.mesh, variant=variant, tag=tag))
    return records


if __name__ == "__main__":
    main()
