"""SeamlessM4T-large-v2: speech encoder (STUB frontend: precomputed frame
embeddings) + text decoder, encoder-decoder [arXiv:2308.11596]."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,            # decoder layers
    n_encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    encoder_frontend="embed",
)
