"""Gradient compression: int8 block quantisation with error feedback.

A port of the JAX package's `runtime/compression.py`, bit for bit: each
gradient leaf is cut into blocks of `block` values (the last one padded
with zeros), scaled by its block's max |value| / 127, rounded half to
even (`torch.round`, as `jnp.round`), clipped to [-127, 127] and scaled
back.  A leaf smaller than one block passes through unchanged.  In the
reference the quantise -> dequantise pair brackets the data-parallel
all-reduce; on one card it is the numerics alone.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from ..tree import tree_map


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    block: int = 256          # values per quantisation block
    dtype: Any = torch.int8


def _quantize(x: torch.Tensor, block: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    flat = x.reshape(-1).float()
    pad = (-flat.numel()) % block
    flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    q = torch.clamp(torch.round(blocks / torch.clamp(scale, min=1e-30)),
                    -127, 127)
    return q.to(torch.int8), scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor, shape,
                size: int) -> torch.Tensor:
    out = (q.float() * scale).reshape(-1)[:size]
    return out.reshape(shape)


def compress_decompress(grads: Any, cfg: CompressionConfig) -> Any:
    """Quantise and dequantise each gradient leaf."""
    def per_leaf(g):
        if g.numel() < cfg.block:
            return g
        q, s = _quantize(g, cfg.block)
        return _dequantize(q, s, g.shape, g.numel()).to(g.dtype)

    return tree_map(per_leaf, grads)


def compress_with_error_feedback(grads: Any, residual: Any,
                                 cfg: CompressionConfig) -> Tuple[Any, Any]:
    """Stateful variant: quantisation error accumulates in `residual` and
    is re-injected next step (unbiased in the long run)."""
    def per_leaf(g, r):
        if g.numel() < cfg.block:
            return g, torch.zeros_like(r)
        corrected = g.float() + r
        q, s = _quantize(corrected, cfg.block)
        approx = _dequantize(q, s, g.shape, g.numel())
        return approx.to(g.dtype), corrected - approx

    out = tree_map(per_leaf, grads, residual)
    return (tree_map(lambda _, o: o[0], grads, out),
            tree_map(lambda _, o: o[1], grads, out))


def init_residual(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
