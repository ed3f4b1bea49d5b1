"""End-to-end driver on the PyTorch/CUDA port: serve a BST key-value store
with batched requests.

    PYTHONPATH=src python examples/torch_serve_bst.py [--requests 200000] [--device cpu]
    PYTHONPATH=src torchrun --nproc-per-node 4 examples/torch_serve_bst.py

The counterpart of ``examples/serve_bst.py`` on ``repro_torch``: a request
stream goes through ``BSTServer`` with each of the paper's strategies (keys
a second, found counts, memory); an ordered mix (predecessor /
range_count / range_scan) through the typed-request scheduler; a live
mixed read/write stream through the delta write path (upserts and
deletes in submission order, compaction at the high-water mark, no
rebuilds); a bulk insert/delete as a snapshot swap.  The sharded sections
run at the world the script is started in, one process a device: alone it
is a world of one, under ``torchrun`` as many ranks as it starts (NCCL on
the card, gloo with ``--device cpu``).  They show the vertically
partitioned lookup (keys routed to their subtrees by ``all_to_all``) and
the duplicated one, then the server itself over the mesh
(``BSTServer(mesh=...)``) for hrz, dup and hyb, live writes included.
Rank 0 prints.
"""

import argparse
import dataclasses
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import PAPER_CONFIGS, build_tree
from repro_torch.core.distributed import (
    make_distributed_query,
    make_dup_query,
    make_serving_mesh,
)
from repro_torch.data.keysets import make_tree_data
from repro_torch.serving import BSTServer


def _sync(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def serve_single(args, configs, keys, values, rng, say) -> None:
    """The single-device sections: every strategy, the ordered mix, the
    live write path and the snapshot swap."""
    stream = rng.choice(keys, args.requests).astype(np.int32)
    say(f"serving {args.requests} lookups in chunks of {args.chunk} on {args.device}")
    say(f"{'impl':8s} {'keys/s':>12s} {'found':>10s} {'memory(nodes)':>14s}")
    for name, cfg in configs.items():
        srv = BSTServer(keys, values, cfg, chunk_size=args.chunk)
        srv.warmup()
        srv.submit(stream)
        srv.drain()
        s = srv.stats
        assert s.found == args.requests, (name, s.found)  # every key is stored
        say(f"{name:8s} {s.keys_per_sec:12.0f} {s.found:10d} {srv.memory_nodes():14d}")

    # ---- ordered workload mix: typed request kinds, per-op accounting
    srv = BSTServer(keys, values, configs["Hyb8q"], chunk_size=args.chunk)
    srv.warmup(("predecessor", "range_count", "range_scan"))
    n_ord = max(args.chunk, args.requests // 8)
    ord_keys = rng.choice(np.concatenate([keys, keys + 1]), n_ord).astype(np.int32)
    lo = rng.choice(keys, n_ord).astype(np.int32)
    hi = (lo + rng.integers(0, 64, n_ord)).astype(np.int32)
    srv.submit(ord_keys, op="predecessor")
    srv.submit_range(lo, hi, op="range_count")
    srv.submit_range(lo, hi, op="range_scan")
    srv.drain()
    say("\nordered workload mix (Hyb8q):")
    say(f"{'op':12s} {'served':>10s} {'chunks':>7s} {'keys/s':>12s}")
    for op, st in srv.stats.per_op.items():
        say(f"{op:12s} {st.served:10d} {st.chunks:7d} {st.keys_per_sec:12.0f}")

    # ---- live write path: delta-buffered updates, compaction, no rebuilds
    cfg = dataclasses.replace(configs["Hyb8q"], delta_capacity=4096)
    srv = BSTServer(keys, values, cfg, chunk_size=args.chunk)
    srv.warmup()
    n_live = max(args.chunk, args.requests // 4)
    n_w = int(n_live * args.write_rate)
    wk = rng.integers(1, 2**20, n_w).astype(np.int32)
    reads = rng.choice(np.concatenate([keys, wk]), n_live - n_w).astype(np.int32)
    _sync(args.device)
    t0 = time.perf_counter()
    half = n_w // 2
    srv.submit_write(wk[:half], wk[:half] * 3)  # upserts ...
    srv.submit(reads[: reads.size // 2])  # ... reads see them after the barrier
    srv.submit_delete(wk[:half:7])  # tombstones ride the same queue
    srv.submit_write(wk[half:], wk[half:] * 3)
    srv.submit(reads[reads.size // 2:])
    srv.drain()
    _sync(args.device)
    dt = time.perf_counter() - t0
    s = srv.stats
    say(f"\nlive write path (Hyb8q, {args.write_rate:.0%} writes): "
        f"{s.served / dt:.0f} keys/s end-to-end, {s.updates} updates absorbed "
        f"on device, {s.compactions} compaction(s), 0 rebuilds")
    fresh = wk[half + 1: half + 9]
    v, f = srv.lookup(fresh)
    assert f.all() and np.array_equal(v, fresh * 3), (v, f)
    say(f"  post-write lookups: found {int(f.sum())}/{fresh.size} fresh keys")

    # ---- snapshot swap: bulk updates land between chunk streams
    srv = BSTServer(keys, values, configs["Hyb8q"], chunk_size=args.chunk)
    new_keys = np.arange(1, 2_001, 2, dtype=np.int32)  # odd keys: all absent
    srv.apply_updates(insert_keys=new_keys, insert_values=new_keys * 10,
                      delete_keys=keys[:1000])
    v, f = srv.lookup(new_keys)
    dead_v, dead_f = srv.lookup(keys[:1000])
    assert f.all() and not dead_f.any()
    say(f"\nsnapshot swap: inserted {new_keys.size} (found {int(f.sum())}), "
        f"deleted 1000 (still found {int(dead_f.sum())}), {srv.stats.snapshot_swaps} swap(s)")


def serve_sharded(args, keys, values, rng, say) -> None:
    """The sharded sections over the current process group."""
    world = dist.get_world_size()
    mesh_type = torch.device(args.device).type
    say(f"\ndistributed lookups ({world} rank(s), {dist.get_backend()}):")
    tree = build_tree(keys, values, device=args.local_device)
    stream = rng.choice(keys, args.requests).astype(np.int32)
    chunks = [stream[i: i + args.chunk] for i in range(0, len(stream), args.chunk)][:8]
    if len(chunks[-1]) != args.chunk:  # pad the final partial chunk to the chunk's shape
        chunks[-1] = np.pad(chunks[-1], (0, args.chunk - len(chunks[-1])))
    for label, make in (
        ("vertical(all_to_all)",
         lambda: make_distributed_query(tree, make_serving_mesh("hyb", mesh_type), "model")),
        ("duplicated(DP)",
         lambda: make_dup_query(tree, make_serving_mesh("dup", mesh_type), "data")),
    ):
        query = make()
        query("lookup", chunks[0])
        _sync(args.device)
        t0 = time.perf_counter()
        for c in chunks:
            v, f = query("lookup", c)
        _sync(args.device)
        dt = time.perf_counter() - t0
        say(f"  {label:22s} {len(chunks) * args.chunk / dt:12.0f} keys/s")
        # the same handle serves ordered ops (predecessor shown)
        pk, pv, ok = query("predecessor", chunks[0])
        say(f"  {'':22s} predecessor ok for {int(ok.sum())} keys")

    # ---- sharded serving: the server itself over the mesh
    say(f"\nsharded BSTServer ({world} rank(s), double-buffered scheduler):")
    say(f"{'strategy':10s} {'keys/s':>12s} {'chunks':>7s} {'found':>10s}")
    n_srv = max(args.chunk * 4, args.requests // 4)
    srv_stream = rng.choice(keys, n_srv).astype(np.int32)
    for strategy in ("hrz", "dup", "hyb"):
        cfg = dataclasses.replace(
            PAPER_CONFIGS["Hyb8q" if strategy == "hyb" else "Hrz"], strategy=strategy,
            n_trees=1 if strategy == "hrz" else max(2, world), device=args.local_device)
        srv = BSTServer(keys, values, cfg, chunk_size=args.chunk,
                        mesh=make_serving_mesh(strategy, mesh_type))
        srv.warmup()
        srv.submit(srv_stream)
        srv.drain()
        s = srv.stats
        assert s.found == n_srv, (strategy, s.found)
        say(f"{strategy:10s} {s.keys_per_sec:12.0f} {s.chunks:7d} {s.found:10d}")

    # live writes through the sharded hybrid server: every rank ingests the
    # same writes into its replicated delta buffer
    cfg = dataclasses.replace(PAPER_CONFIGS["Hyb8q"], n_trees=max(2, world), delta_capacity=4096,
                              device=args.local_device)
    srv = BSTServer(keys, values, cfg, chunk_size=args.chunk,
                    mesh=make_serving_mesh("hyb", mesh_type))
    srv.warmup()
    wk = np.unique(rng.integers(1, 2**20, args.chunk).astype(np.int32))
    srv.submit_write(wk, wk * 5)
    srv.submit(wk[: wk.size // 2])
    srv.drain()
    v, f = srv.lookup(wk[:8])
    assert f.all() and np.array_equal(v, wk[:8] * 5), (v, f)
    say(f"  sharded write path: {srv.stats.updates} updates absorbed, "
        f"{int(f.sum())}/8 fresh keys found, {srv.stats.compactions} compaction(s)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=200_000)
    ap.add_argument("--chunk", type=int, default=8_192)
    ap.add_argument("--tree-keys", type=int, default=(1 << 16) - 1)
    ap.add_argument("--write-rate", type=float, default=0.1,
                    help="fraction of the live mixed stream that is writes")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    on_card = torch.device(args.device).type == "cuda"
    backend = "nccl" if on_card else "gloo"
    started_here = not dist.is_initialized()
    if started_here:
        if "WORLD_SIZE" in os.environ:  # torchrun's environment
            if on_card:
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    args.local_device = f"cuda:{torch.cuda.current_device()}" if on_card else args.device
    lead = dist.get_rank() == 0

    def say(msg: str) -> None:
        if lead:
            print(msg, flush=True)

    keys, values = make_tree_data(args.tree_keys, seed=0)
    rng = np.random.default_rng(1)
    configs = {name: dataclasses.replace(cfg, device=args.local_device)
               for name, cfg in PAPER_CONFIGS.items()}
    try:
        serve_single(args, configs, keys, values, rng, say)
        serve_sharded(args, keys, values, rng, say)
    finally:
        if started_here:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
