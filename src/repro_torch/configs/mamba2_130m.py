"""Mamba2-130M: attention-free SSD (state-space duality)
[arXiv:2405.21060]."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=1,           # no attention heads (attn-free)
    n_kv_heads=1,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    tie_embeddings=True,
    subquadratic=True,
)
