"""Training launcher: the host loop around ``make_train_step``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --steps 4 --batch 4 --seq 2048
    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b --smoke --device cpu \\
        --steps 20

The port of the JAX package's ``launch/train.py``, with its flags: the
published config (``--smoke`` the reduced one) from a seed-0 init, batches
from the stateless ``TokenPipeline`` (batch = f(seed, step)), microbatch
accumulation, and the straggler policy (a step over ``--step-deadline-s``
exits with code 42 for a restart).  ``--device`` defaults to the card.
The encdec and vlm families get their stub frontend embeddings from numpy
(N(0, 0.02), shaped by ``input_specs``), as ``launch/serve.py`` makes them.
``--compression`` is accepted and, on one device, has no effect (the
train loop's module docstring says why).  Checkpoints (``--ckpt-dir``,
``--ckpt-every``, ``--resume``) are not ported yet and raise.  The steps run
in ``train_loop``; each prints its loss, gradient norm, learning rate,
milliseconds and tokens per second, and its time runs until its metrics
reach the host.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models.config import ShapeConfig, input_specs
from repro_torch.training.train_loop import TrainConfig, init_train_state, train_loop

DEADLINE_EXIT = 42  # the straggler policy's exit code: restart this worker


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compression", default=None, choices=[None, "bf16", "int8"])
    ap.add_argument("--step-deadline-s", type=float, default=None,
                    help="straggler mitigation: abort if a step exceeds this")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.ckpt_dir is not None or args.ckpt_every is not None or args.resume:
        raise NotImplementedError("checkpoints (--ckpt-dir, --ckpt-every, --resume) are not "
                                  "ported yet (ROADMAP.md Queue 1 item 13g)")

    device = torch.device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    tcfg = TrainConfig(
        peak_lr=args.lr,
        warmup_steps=max(10, args.steps // 20),
        total_steps=args.steps,
        microbatches=args.microbatches,
        compression=args.compression,
    )
    pipe = TokenPipeline(cfg.vocab_size, args.seq, args.batch)
    state = init_train_state(cfg, tcfg, seed=0, device=device)
    frontend = None
    if cfg.frontend is not None:
        spec = input_specs(cfg, ShapeConfig("train", args.seq, args.batch, "train"))
        spec = spec["frontend_embeds"]
        draw = np.random.default_rng(1).standard_normal(tuple(spec.shape), dtype=np.float32)
        frontend = torch.from_numpy(draw * 0.02).to(device, spec.dtype)

    t_start = time.perf_counter()
    last = [t_start]  # when the previous step's metrics reached the host

    def report(s, _state, metrics):
        now = time.perf_counter()
        dt, last[0] = now - last[0], now
        if args.step_deadline_s and dt > args.step_deadline_s and s > 0:
            # Straggler policy: a healthy fleet restarts this worker from the
            # last checkpoint rather than dragging the collective.
            print(f"step {s} exceeded deadline ({dt:.1f}s) -- aborting for restart")
            raise SystemExit(DEADLINE_EXIT)
        print(
            f"step {s:5d} loss={metrics['loss']:.4f} gnorm={metrics['grad_norm']:.3f} "
            f"lr={metrics['lr']:.2e} {dt * 1e3:.0f}ms {args.batch * args.seq / dt:.0f} tok/s"
            f" on {device}", flush=True)

    state, _ = train_loop(cfg, tcfg, pipe, args.steps, state=state, frontend=frontend,
                          callback=report, device=device)
    print(f"done in {time.perf_counter() - t_start:.1f}s")
    return state


if __name__ == "__main__":
    main()
