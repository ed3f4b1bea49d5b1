"""internvl2-2b [vlm]: InternViT (stub) + internlm2-1.8b backbone.

Assignment: 24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553
[arXiv:2404.16821; hf].  The vision frontend is a STUB: it
supplies 256 precomputed patch embeddings (448px, patch 14, pixel-shuffle
x0.5) that override the first 256 decoder positions; loss is masked there.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    frontend="vision",
    frontend_len=256,
    rope_theta=1e6,
)
