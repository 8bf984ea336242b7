"""Shared layer primitives: norms, RoPE, MLPs, embeddings.

Plain functions `f(params, x, ...) -> y` over a params dict with the JAX
package's keys and its (in, out) weight layout.  Compute dtype is the
params' (bf16 in serving) with fp32 reductions, and every cast sits where
the reference (`repro.models.layers`) puts it, so the two agree to
rounding.  Initialisers draw from an explicit `torch.Generator`.

On a mesh a weight may be this rank's 'model' shard
(`runtime/sharding.py: compute_spec`), which its width shows against
the config's: the MLP then runs Megatron's column-parallel up and gate
products and a row-parallel down product summed over 'model'; the
embedding is vocab-parallel (ids outside the rank's rows of the table
look up zeros, then a sum over 'model') and the unembedding gives the
rank's columns of the logits.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.rmsnorm.ops import rmsnorm as rmsnorm_kernel
from ..kernels.rmsnorm.ref import rmsnorm_ref

Params = Dict[str, torch.Tensor]
DTYPE = torch.bfloat16

#: `impl` values that route through the hand-written kernels
KERNEL_IMPLS = ("auto", "kernel")


def _dense_init(gen: torch.Generator, shape, scale_axis: int = 0,
                device=None) -> torch.Tensor:
    """N(0, 1) / sqrt(fan) in fp32, cast to bf16, as the reference's
    `_dense_init` draws (different numbers: another generator).  Scaled
    in place: a (384, 7168, 2048) expert stack is 22.5 GB in fp32, and a
    second fp32 tensor would add as much again to the peak."""
    scale = 1.0 / math.sqrt(max(1, shape[scale_axis]))
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return w.mul_(scale).to(DTYPE)


# --------------------------------------------------------------------------
# RMSNorm
# --------------------------------------------------------------------------

def rmsnorm_init(d: int, device=None) -> Params:
    return {"scale": torch.ones((d,), dtype=DTYPE, device=device)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-6,
            impl: str = "auto") -> torch.Tensor:
    """With impl "auto"/"kernel" through the kernel wrapper (the CUDA
    kernel on a CUDA tensor); "naive"/"chunked" take the plain version."""
    if impl in KERNEL_IMPLS:
        return rmsnorm_kernel(x, params["scale"], eps)
    return rmsnorm_ref(x, params["scale"], eps)


# --------------------------------------------------------------------------
# RoPE (interleaved pairs; partial application rotates the leading dims)
# --------------------------------------------------------------------------

def rope_frequencies(head_dim: int, fraction: float, theta: float,
                     positions: torch.Tensor):
    """cos/sin tables (..., rot_dim/2) for given positions (any shape)."""
    rot = int(head_dim * fraction) // 2 * 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32,
                        device=positions.device) / rot
    inv = 1.0 / torch.pow(theta, exps)    # fp32; no host-to-device copy
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               fraction: float = 1.0) -> torch.Tensor:
    """x: (B, S, H, D); cos/sin: (B?, S, rot/2) broadcast over heads.
    Rotates the pairs (x[2i], x[2i+1]); dims past `rot` pass through."""
    rot = cos.shape[-1] * 2
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., 0::2].float(), xr[..., 1::2].float()
    c = cos[..., None, :].float()
    s = sin[..., None, :].float()
    y1 = x1 * c - x2 * s
    y2 = x2 * c + x1 * s
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape).to(x.dtype)
    return torch.cat([yr, xp], dim=-1) if xp.shape[-1] else yr


# --------------------------------------------------------------------------
# MLP (SiLU-gated / GeGLU / plain GeLU)
# --------------------------------------------------------------------------

def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")     # jax.nn.gelu's default


def mlp_init(gen: torch.Generator, d: int, d_ff: int, activation: str,
             device=None) -> Params:
    p = {"w_up": _dense_init(gen, (d, d_ff), device=device),
         "w_down": _dense_init(gen, (d_ff, d), device=device)}
    if activation in ("silu", "geglu"):
        p["w_gate"] = _dense_init(gen, (d, d_ff), device=device)
    return p


def mlp(params: Params, x: torch.Tensor, activation: str,
        d_ff: Optional[int] = None) -> torch.Tensor:
    """`d_ff`, the layer's whole hidden width, says whether the weights
    are 'model' shards (tensor-parallel); None: they are whole."""
    up = x @ params["w_up"]
    if activation in ("silu", "geglu"):
        gate = x @ params["w_gate"]
        act = F.silu if activation == "silu" else _gelu
        h = act(gate.float()).to(x.dtype) * up
    else:
        h = _gelu(up.float()).to(x.dtype)
    y = h @ params["w_down"]
    from ..runtime.parallel import model_slice, psum_model
    if d_ff is not None and model_slice("mlp/w_down", params["w_down"].shape,
                                        d_ff) is not None:
        y = psum_model(y)
    return y


# --------------------------------------------------------------------------
# Embedding / unembedding
# --------------------------------------------------------------------------

def embedding_init(gen: torch.Generator, cfg: ModelConfig,
                   device=None) -> Params:
    p = {"table": _dense_init(gen, (cfg.vocab_size, cfg.d_model), 1,
                              device=device)}
    if not cfg.tie_embeddings:
        p["unembed"] = _dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                   device=device)
    return p


def embed(params: Params, tokens: torch.Tensor,
          cfg: ModelConfig) -> torch.Tensor:
    from ..runtime.parallel import model_slice, psum_model
    table = params["table"]
    rows = model_slice("embed/table", table.shape, cfg.vocab_size)
    if rows is None:
        x = table[tokens]
    else:
        local = tokens.long() - rows.start
        mine = (local >= 0) & (local < table.shape[0])
        x = table[torch.where(mine, local, 0)]
        x = psum_model(torch.where(mine[..., None], x, 0.0).to(x.dtype))
    if cfg.tie_embeddings:
        # sqrt(d) is rounded to the activation dtype before the multiply
        # (31.0 for d=960 in bf16), as in the reference
        scale = torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float32)
        x = x * float(scale.to(x.dtype))
    return x


def unembed(params: Params, x: torch.Tensor, cfg: ModelConfig,
            ) -> torch.Tensor:
    """Logits in fp32: the matmul runs in the params' dtype, then casts.
    A vocab-parallel weight gives this rank's columns of the logits."""
    if cfg.tie_embeddings:
        logits = x @ params["table"].T
    else:
        logits = x @ params["unembed"]
    cap: Optional[float] = cfg.final_softcap
    if cap:
        return torch.tanh(logits.float() / cap) * cap
    return logits.float()
