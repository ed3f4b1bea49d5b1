"""mixtral-8x22b [moe]: 8 experts top-2, SWA.

Assignment: 56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768,
MoE 8e top-2, sliding window 4096 [arXiv:2401.04088; hf].
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
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
