"""Kimi K2: trillion-parameter MoE, 384 experts top-8, GQA kv=8
[arXiv:2501.kimi2 paper-table]."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=112,
    d_ff=2048,            # per-expert hidden width (paper table)
    moe_d_ff=2048,
    vocab_size=163840,
    n_experts=384,
    experts_per_token=8,
)
