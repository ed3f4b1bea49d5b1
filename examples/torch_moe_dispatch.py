"""The paper's buffers inside a Mixtral MoE layer, on the PyTorch/CUDA port:
direct vs queue mapping.

    PYTHONPATH=src python examples/torch_moe_dispatch.py [--device cpu]

The counterpart of ``examples/moe_dispatch.py`` on ``repro_torch``: expert
dispatch with capacity is the paper's buffer placement problem.  The queue
mapping (kernel K4 on the card: FIFO labels, dense packing) keeps at least
as many token -> expert assignments as the direct (position-slot) mapping
at every capacity factor -- the Fig. 5 vs Fig. 6 behaviour -- which the
example asserts.
"""

import argparse
import dataclasses

import torch

from repro_torch.configs import smoke_config
from repro_torch.models import model as M
from repro_torch.models.moe import expert_capacity, moe_ffn

CAPACITY_FACTORS = (0.5, 0.75, 1.0, 1.25, 1.5, 2.0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    args = ap.parse_args(argv)
    cfg = smoke_config("mixtral_8x7b")
    model = M.init_params(cfg, seed=0, device=args.device)
    lp = model.layers[0].moe  # one layer's MoE parameters
    gen = torch.Generator(device=args.device).manual_seed(1)
    x = torch.randn((args.batch, args.seq, cfg.d_model), generator=gen,
                    device=args.device) * 0.5
    T = x.shape[0] * x.shape[1]

    print(f"tokens={T} experts={cfg.n_experts} top_k={cfg.top_k} on {x.device}")
    print(f"{'capacity_factor':>16s} {'capacity':>9s} {'queue drop%':>12s} {'direct drop%':>13s}")
    rows = []
    with torch.no_grad():
        for cf in CAPACITY_FACTORS:
            drops = {}
            for mapping in ("queue", "direct"):
                c = dataclasses.replace(cfg, capacity_factor=cf, moe_dispatch=mapping)
                _, dropped = moe_ffn(c, lp, x)
                drops[mapping] = float(dropped) * 100
            cap = expert_capacity(dataclasses.replace(cfg, capacity_factor=cf), T)
            print(f"{cf:16.2f} {cap:9d} {drops['queue']:12.2f} {drops['direct']:13.2f}")
            assert drops["queue"] <= drops["direct"], (cf, drops)
            rows.append((cf, cap, drops["queue"], drops["direct"]))
    print("\nqueue mapping == the paper's contribution, and is the default for")
    print("the mixtral-8x7b / mixtral-8x22b configs (moe_dispatch='queue').")
    return rows


if __name__ == "__main__":
    main()
