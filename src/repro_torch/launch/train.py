"""Training launcher: the fault-tolerant host loop around ``make_train_step``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --steps 4 --batch 4 --seq 2048
    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b --smoke --device cpu \\
        --steps 20 --ckpt-dir /tmp/ckpt [--resume]

The port of the JAX package's ``launch/train.py``, with its flags: the
published config (``--smoke`` the reduced one) from a seed-0 init, batches
from the stateless ``TokenPipeline`` (batch = f(seed, step)), microbatch
accumulation, checkpoints and the straggler policy.  ``--device`` defaults
to the card.  The encdec and vlm families get their stub frontend
embeddings from numpy (N(0, 0.02), shaped by ``input_specs``), as
``launch/serve.py`` makes them.  ``--compression`` is accepted and, on one
device, has no effect (the train loop's module docstring says why).

``--ckpt-dir`` saves through ``CheckpointManager(keep=3,
save_async=True)`` (the JAX package's format: ``checkpoint/store.py``)
after every step s with (s + 1) % ``--ckpt-every`` == 0 (default 50) and
once more at the end, each with ``extra={"pipeline_step": s}``.
``--resume`` restores the latest checkpoint there (if any) and continues
from its step + 1 to ``--steps``.  A step over ``--step-deadline-s`` (not
the first of a run, which builds and warms up) exits with code 42 for a
restart from the last checkpoint; the launcher first waits for a
checkpoint still being written, so the restart finds it.  The steps run in
``train_loop``; each prints its loss, gradient norm, learning rate,
milliseconds and tokens per second.  A step's time, which the deadline
is held to, runs from the end of the previous step's report (its
checkpoint's host snapshot included) until its metrics reach the host,
as the JAX launcher times the step alone.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
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
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compression", default=None, choices=[None, "bf16", "int8"])
    ap.add_argument("--step-deadline-s", type=float, default=None,
                    help="straggler mitigation: abort if a step exceeds this")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

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
    mgr = CheckpointManager(args.ckpt_dir, keep=3, save_async=True) if args.ckpt_dir else None
    state = init_train_state(cfg, tcfg, seed=0, device=device)
    step0 = 0
    if mgr is not None and args.resume:
        try:
            state, step0, _extra = mgr.restore(state)
            step0 += 1
            print(f"resumed from step {step0 - 1}")
        except FileNotFoundError:
            pass
    frontend = None
    if cfg.frontend is not None:
        spec = input_specs(cfg, ShapeConfig("train", args.seq, args.batch, "train"))
        spec = spec["frontend_embeds"]
        draw = np.random.default_rng(1).standard_normal(tuple(spec.shape), dtype=np.float32)
        frontend = torch.from_numpy(draw * 0.02).to(device, spec.dtype)

    t_start = time.perf_counter()
    last = [t_start]  # when the previous step's report ended: this step's start

    def report(s, state, metrics):
        dt = time.perf_counter() - last[0]
        if args.step_deadline_s and dt > args.step_deadline_s and s > step0:
            # Straggler policy: a healthy fleet restarts this worker from the
            # last checkpoint rather than dragging the collective.
            print(f"step {s} exceeded deadline ({dt:.1f}s) -- aborting for restart", flush=True)
            if mgr is not None:
                mgr.wait()
            raise SystemExit(DEADLINE_EXIT)
        if mgr is not None and (s + 1) % args.ckpt_every == 0:
            mgr.save(s, state, extra={"pipeline_step": s})
        print(
            f"step {s:5d} loss={metrics['loss']:.4f} gnorm={metrics['grad_norm']:.3f} "
            f"lr={metrics['lr']:.2e} {dt * 1e3:.0f}ms {args.batch * args.seq / dt:.0f} tok/s"
            f" on {device}", flush=True)
        last[0] = time.perf_counter()  # the next step's time leaves out this save and print

    state, _ = train_loop(cfg, tcfg, pipe, max(args.steps - step0, 0), state=state, step0=step0,
                          frontend=frontend, callback=report, device=device)
    if mgr is not None:
        mgr.save(args.steps - 1, state, extra={"pipeline_step": args.steps - 1})
        mgr.wait()
    print(f"done in {time.perf_counter() - t_start:.1f}s")
    return state


if __name__ == "__main__":
    main()
