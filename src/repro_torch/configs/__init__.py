"""Architecture registry of the port: the same ten archs as the JAX
package's (dense, the Mamba2 SSM, the zamba2 hybrid, the MoE models, the
embedding-fed VLM backbone and the encoder-decoder)."""

import dataclasses

from .base import SHAPES, BlockSpec, ModelConfig, ShapeConfig
from .chatglm3_6b import CONFIG as chatglm3_6b
from .gemma2_2b import CONFIG as gemma2_2b
from .kimi_k2_1t import CONFIG as kimi_k2_1t
from .mamba2_130m import CONFIG as mamba2_130m
from .mixtral_8x22b import CONFIG as mixtral_8x22b
from .pixtral_12b import CONFIG as pixtral_12b
from .qwen2p5_32b import CONFIG as qwen2p5_32b
from .seamless_m4t_v2 import CONFIG as seamless_m4t_v2
from .smollm_360m import CONFIG as smollm_360m
from .zamba2_2p7b import CONFIG as zamba2_2p7b

ARCHS = {
    "chatglm3-6b": chatglm3_6b,
    "gemma2-2b": gemma2_2b,
    "smollm-360m": smollm_360m,
    "qwen2.5-32b": qwen2p5_32b,
    "mamba2-130m": mamba2_130m,
    "zamba2-2.7b": zamba2_2p7b,
    "kimi-k2-1t-a32b": kimi_k2_1t,
    "mixtral-8x22b": mixtral_8x22b,
    "pixtral-12b": pixtral_12b,
    "seamless-m4t-large-v2": seamless_m4t_v2,
}


def get_arch(name: str) -> ModelConfig:
    return ARCHS[name]


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Smoke-test variant: same family/pattern, tiny dimensions."""
    layers_per_unit = max(1, sum(1 for b in cfg.unit
                                 if b.kind in ("attn", "mamba")))
    small = dict(
        n_layers=2 * layers_per_unit if cfg.shared_attn_every == 0
        else 2 * cfg.shared_attn_every,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2),
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        n_experts=min(cfg.n_experts, 8) if cfg.n_experts else 0,
        experts_per_token=min(cfg.experts_per_token, 2)
        if cfg.n_experts else 0,
        moe_d_ff=32 if cfg.moe_d_ff else None,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=16,
        ssm_chunk=16,
        sliding_window=32 if cfg.sliding_window else None,
        n_encoder_layers=2 if cfg.n_encoder_layers else 0,
        unit=(),  # rebuilt for the reduced dims
    )
    small.update(overrides)
    return dataclasses.replace(cfg, **small)


def cells(arch: str):
    """The (arch x shape) cells of this arch: `long_500k` only for the
    sub-quadratic archs."""
    cfg = get_arch(arch)
    return [shape for shape in SHAPES.values()
            if shape.name != "long_500k" or cfg.subquadratic]


ALL_CELLS = [(a, s.name) for a in ARCHS for s in cells(a)]

__all__ = ["ALL_CELLS", "ARCHS", "SHAPES", "BlockSpec", "ModelConfig",
           "ShapeConfig", "cells", "get_arch", "reduced"]
