"""tinyllama-1.1b [dense]: llama2-arch small.

Assignment: 22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000
[arXiv:2401.02385; hf].  Head dim 64.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    family="dense",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=5632,
    vocab_size=32000,
    rope_theta=1e4,
)
