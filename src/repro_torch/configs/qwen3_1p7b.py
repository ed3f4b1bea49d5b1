"""qwen3-1.7b [dense]: qk_norm + GQA, tied embeddings.

Assignment: 28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936
[hf:Qwen/Qwen3-8B; hf].  Qwen3 uses head_dim=128 and per-head RMS q/k norm.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab_size=151936,
    qk_norm=True,
    tie_embeddings=True,
    rope_theta=1e6,
)
