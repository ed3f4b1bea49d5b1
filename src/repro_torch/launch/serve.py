"""Serving driver, LM mode: batched greedy decoding with prefill + KV cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b --smoke \\
        --device cpu --batch 4 --prompt-len 32 --new-tokens 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b --smoke --device cpu

Parameters come from a seed (``init_params``), prompts from numpy's
generator.  On the card the decode step runs as one CUDA graph, captured
before the timed prefill.  It prints the prefill time, decode tokens per
second and the first sequence's token ids.  The published config is
served whole: mixtral-8x7b's 32 layers (93.4 GB in bf16) do not fit one
80 GB card, so on one card it runs with the smoke config only
(``chip_smoke.py`` cuts its depth to 16).  The sharded BST store (``--bst``) is not ported yet
and raises.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.models import model as M
from repro_torch.serving.serve_loop import decode_graph, make_prefill_fn, make_serve_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--smoke", action="store_true", help="the reduced smoke config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--bst", action="store_true", help="serve the sharded BST store")
    args = ap.parse_args(argv)

    if args.bst:
        raise NotImplementedError(
            "the sharded BST store (--bst) is not ported yet (ROADMAP.md Queue 1 item 9)"
        )
    if args.arch is None:
        ap.error("--arch is required")
    if args.new_tokens < 1:
        ap.error("--new-tokens must be >= 1")
    device = torch.device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = M.init_params(cfg, seed=0, device=device)
    B, S = args.batch, args.prompt_len
    rng = np.random.default_rng(1)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))).to(device)

    if device.type == "cuda":
        t0 = time.perf_counter()
        decode_graph(cfg, model, B, S + args.new_tokens)
        print(f"decode step captured as a CUDA graph in {time.perf_counter() - t0:.3f}s")
    _sync(device)
    t0 = time.perf_counter()
    logits, state = make_prefill_fn(cfg, max_len=S + args.new_tokens)(model, prompts)
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
