"""mixtral-8x7b [moe]: 8 experts top-2, SWA.

Assignment: 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000,
MoE 8e top-2, sliding window 4096 [arXiv:2401.04088; hf].

Expert dispatch uses the paper's queue mapping by default
(moe_dispatch="queue"); "direct" selects the position-mapped variant for
the Fig.5-style drop-rate comparison (benchmarks/moe_dispatch_bench.py).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    n_experts=8,
    top_k=2,
    moe_dispatch="queue",
    capacity_factor=1.25,
    sliding_window=4096,
    rope_theta=1e6,
    # DP-pinned dispatch groups + ZeRO-1
    moe_groups=32,
    zero1=True,
)
