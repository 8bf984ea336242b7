"""ChatGLM3-6B: dense, GQA kv=2, 2d-RoPE (rotary on half the head dims),
QKV bias [arXiv:2406.12793]."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    rope_fraction=0.5,          # 2d rope: rotary applied to half the dims
    qkv_bias=True,
)
