"""Gemma2-2B: alternating local(4096)/global attention, logit softcapping,
GeGLU, tied embeddings, head_dim=256 [arXiv:2408.00118]."""

from .base import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    unit=(BlockSpec("attn", window=4096, is_global=False), BlockSpec("mlp"),
          BlockSpec("attn", is_global=True), BlockSpec("mlp")),
    attn_softcap=50.0,
    final_softcap=30.0,
    sliding_window=4096,
    tie_embeddings=True,
    activation="geglu",
)
