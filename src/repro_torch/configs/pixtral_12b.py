"""Pixtral-12B: Pixtral-ViT frontend (STUB: precomputed patch embeddings
enter via input_specs) + Mistral-NeMo-style decoder backbone
[hf:mistralai/Pixtral-12B-2409]."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    frontend="embed",     # patch embeddings precomputed by the stub
)
