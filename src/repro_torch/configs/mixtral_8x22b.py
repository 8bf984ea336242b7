"""Mixtral-8x22B: 8 experts top-2, sliding-window attention
[arXiv:2401.04088]."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    moe_d_ff=16384,
    vocab_size=32768,
    n_experts=8,
    experts_per_token=2,
    sliding_window=4096,
    subquadratic=True,    # SWA: KV cache capped at the window
)
