"""Zamba2-2.7B: Mamba2 backbone + one shared attention block applied every
6th layer (weights reused across applications) [arXiv:2411.15242]."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    shared_attn_every=6,
    subquadratic=True,          # SSM backbone; only the shared block keeps KV
    tie_embeddings=True,
)
