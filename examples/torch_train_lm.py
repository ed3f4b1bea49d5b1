"""Train a small LM end-to-end with the PyTorch/CUDA port's stack.

    PYTHONPATH=src python examples/torch_train_lm.py --arch qwen3-1.7b --steps 200 [--device cpu]

The counterpart of ``examples/train_lm.py`` on ``repro_torch``: the reduced
(smoke) architecture config, the token pipeline, AdamW with the cosine
schedule, gradient clipping, a checkpoint every ``--ckpt-every`` steps and
at the end -- the same code path ``repro_torch.launch.train`` runs at
scale, on the card by default.
"""

import argparse
import tempfile

from repro_torch.launch.train import main as train_main


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--ckpt-dir", default=None, help="default: a new temporary directory")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    ckpt = args.ckpt_dir or tempfile.mkdtemp(prefix="torch_train_lm_ckpt_")
    print(f"checkpoints -> {ckpt}")
    return train_main(
        [
            "--arch", args.arch,
            "--steps", str(args.steps),
            "--batch", str(args.batch),
            "--seq", str(args.seq),
            "--smoke",
            "--ckpt-dir", ckpt,
            "--ckpt-every", str(args.ckpt_every),
            "--lr", "3e-3",
            "--device", args.device,
        ]
    )


if __name__ == "__main__":
    main()
