"""seamless-m4t-medium [audio]: enc-dec multimodal backbone.

Assignment: 12L d_model=1024 16H (GQA kv=16) d_ff=4096 vocab=256206
[arXiv:2308.11596; hf].  12 encoder + 12 decoder layers; the speech
frontend (w2v-BERT conformer) is a STUB -- it supplies
precomputed frame embeddings of width d_model (DESIGN.md §4).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,
    encoder_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    frontend="audio",
    rope_theta=1e4,
)
