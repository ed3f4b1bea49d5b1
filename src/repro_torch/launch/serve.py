"""Serving drivers: LM decoding, and the sharded BST store.

LM mode -- batched greedy decoding with prefill and the decode caches:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b --smoke \\
        --device cpu --batch 4 --prompt-len 32 --new-tokens 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch seamless-m4t-medium --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-2b --smoke --device cpu

Every family is served: dense, moe, ssm (mamba2), hybrid (hymba), encdec
(seamless-m4t) and vlm (internvl2).  Parameters come from a seed
(``init_params``), prompts from numpy's generator, and so do the stub
frontends' embeddings (N(0, 0.02), in the parameter dtype), shaped by
``input_specs``: seamless's encoder takes a frame per prompt position,
internvl2's 256 patch embeddings replace the first prompt positions.  On
the card the prefill and the decode step run as CUDA graphs, captured
before the timed prefill.  It prints the prefill time, decode tokens per
second and the first sequence's token ids.  The published config is
served whole: mixtral-8x7b's 32 layers (93.4 GB in bf16) do not fit one
80 GB card, so on one card it runs with the smoke config only
(``chip_smoke.py`` cuts its depth to 16).

BST mode -- the paper's accelerator served sharded, one process per
device: ``BSTServer(mesh=...)`` routes fixed-shape chunks through the
strategy's sharded program behind the double-buffered read loop, with live
writes riding the replicated delta buffer:

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \\
        --bst --bst-strategy hyb --requests 100000 --chunk 8192
    PYTHONPATH=src python -m repro_torch.launch.serve --bst --device cpu

Under ``torchrun`` the process group comes from its environment (NCCL on
the card, one device per rank); without it the store runs as a world of
one.  ``--device cpu`` selects gloo.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.models import model as M
from repro_torch.models.config import ShapeConfig, input_specs
from repro_torch.serving.serve_loop import make_prefill_fn, make_serve_step, prefill_graph


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bst_main(args) -> None:
    """Serve a lookup stream and a mixed write tail through the sharded
    BSTServer; rank 0 prints."""
    import torch.distributed as dist

    on_card = torch.device(args.device).type == "cuda"
    backend = "nccl" if on_card else "gloo"
    if "WORLD_SIZE" in os.environ:  # torchrun's environment
        local_rank = int(os.environ.get("LOCAL_RANK", 0))
        if on_card:
            torch.cuda.set_device(local_rank)
        dist.init_process_group(backend, init_method="env://")
    else:
        local_rank = 0
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    try:
        _serve_bst(args, f"cuda:{local_rank}" if on_card else "cpu", backend)
    finally:
        dist.destroy_process_group()


def _serve_bst(args, device: str, backend: str) -> None:
    import torch.distributed as dist

    from repro_torch.core.distributed import make_serving_mesh
    from repro_torch.core.engine import EngineConfig
    from repro_torch.data.keysets import make_tree_data
    from repro_torch.serving import BSTServer

    strategy = args.bst_strategy
    mesh = make_serving_mesh(strategy, torch.device(device).type)
    n_devices = mesh.size()
    cfg = EngineConfig(
        strategy=strategy,
        n_trees=1 if strategy == "hrz" else max(2, n_devices),
        mapping="queue",
        device=device,
        delta_capacity=args.chunk // 2,
    )
    keys, values = make_tree_data((1 << 16) - 1, seed=0)
    srv = BSTServer(keys, values, cfg, chunk_size=args.chunk, mesh=mesh)
    srv.warmup()
    rng = np.random.default_rng(1)
    stream = rng.choice(keys, args.requests).astype(np.int32)
    lead = dist.get_rank() == 0

    t0 = time.perf_counter()
    srv.submit(stream)
    srv.drain()
    dt = time.perf_counter() - t0
    s = srv.stats
    if lead:
        print(
            f"sharded {strategy} x {n_devices} {backend} ranks on {device}: "
            f"{args.requests} lookups in {dt:.3f}s ({s.keys_per_sec:.0f} keys/s busy, "
            f"{s.found} found, {s.chunks} chunks)"
        )

    # a mixed tail: the writes ride the replicated delta buffer
    wk = rng.integers(1, 2**20, args.chunk).astype(np.int32)
    srv.submit_write(wk, wk * 3)
    srv.submit(wk[: args.chunk // 2])
    srv.drain()
    _, found = srv.lookup(wk[:16])
    nodes = srv.memory_nodes_per_device()  # a collective: every rank calls it
    if lead:
        print(
            f"write path: {srv.stats.updates} updates absorbed, "
            f"{int(found.sum())}/16 fresh keys found, {srv.stats.compactions} "
            f"compaction(s); {nodes} key slots on the fullest device"
        )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--smoke", action="store_true", help="the reduced smoke config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--bst", action="store_true", help="serve the sharded BST store")
    ap.add_argument("--bst-strategy", default="hyb", choices=("hrz", "dup", "hyb"))
    ap.add_argument("--requests", type=int, default=100_000)
    ap.add_argument("--chunk", type=int, default=8_192)
    args = ap.parse_args(argv)

    if args.bst:
        return bst_main(args)
    if args.arch is None:
        ap.error("--arch is required (or pass --bst for the BST store)")
    if args.new_tokens < 1:
        ap.error("--new-tokens must be >= 1")
    device = torch.device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.family == "vlm" and args.prompt_len < cfg.frontend_len:
        ap.error(f"{cfg.name}: --prompt-len must hold the {cfg.frontend_len} patch embeddings")
    model = M.init_params(cfg, seed=0, device=device)
    B, S = args.batch, args.prompt_len
    rng = np.random.default_rng(1)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))).to(device)
    frontend = ()
    if cfg.frontend is not None:
        spec = input_specs(cfg, ShapeConfig("serve", S, B, "prefill"))["frontend_embeds"]
        draw = rng.standard_normal(tuple(spec.shape), dtype=np.float32) * 0.02
        frontend = (torch.from_numpy(draw).to(device, spec.dtype),)

    if device.type == "cuda":
        t0 = time.perf_counter()
        prefill_graph(cfg, model, prompts, *frontend, max_len=S + args.new_tokens)
        print(f"prefill and decode steps captured as CUDA graphs in "
              f"{time.perf_counter() - t0:.3f}s")
    _sync(device)
    t0 = time.perf_counter()
    logits, state = make_prefill_fn(cfg, max_len=S + args.new_tokens)(model, prompts, *frontend)
    tok = logits.argmax(dim=-1, keepdim=True)
    _sync(device)
    t1 = time.perf_counter()
    print(f"prefill: {B}x{S} in {t1 - t0:.3f}s on {device}")

    step = make_serve_step(cfg)
    outs = [tok]
    for _ in range(args.new_tokens - 1):
        logits, state = step(model, tok, state)
        tok = logits.argmax(dim=-1, keepdim=True)
        outs.append(tok)
    gen = torch.cat(outs, dim=1)
    _sync(device)
    dt = time.perf_counter() - t1
    print(
        f"decode: {args.new_tokens} tokens x {B} seqs in {dt:.3f}s "
        f"({B * args.new_tokens / dt:.1f} tok/s)"
    )
    print("sample token ids:", gen[0, :16].tolist())


if __name__ == "__main__":
    main()
