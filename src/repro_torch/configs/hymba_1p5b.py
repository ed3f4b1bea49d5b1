"""hymba-1.5b [hybrid]: parallel attention + mamba heads per layer.

Assignment: 32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001,
ssm_state=16 [arXiv:2411.13676; hf].  Head dim 64.  Simplifications noted
in DESIGN.md §4: every layer uses SWA (the published model keeps 3 global
layers; homogeneous layers keep the (L, ...) scan stackable) and meta
tokens are omitted.  The SSM branch runs at expand=1 with 16-dim state.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    ssm_state=16,
    ssm_expand=1,
    ssm_head_dim=64,
    sliding_window=1024,
    rope_theta=1e4,
)
