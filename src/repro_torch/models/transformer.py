"""Decoder-only LM assembled from pattern units (the dense path).

Parameters are stacked (n_units, ...) as in the reference, where
`lax.scan` runs the unit body over that axis; here a Python loop over the
unit index takes its place.  MoE, Mamba and hybrid units belong to later
slices of the port and raise `NotImplementedError`.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from .attention import (attention, attention_init, decode_attention,
                        init_kv_cache)
from .layers import (embed, embedding_init, mlp, mlp_init, rmsnorm,
                     rmsnorm_init, unembed)

Params = Dict[str, Any]

_LATER = {"moe": "MoE units (ROADMAP Queue 1 item 10)",
          "mamba": "Mamba/SSD units (ROADMAP Queue 1 item 9)"}


def check_dense(cfg: ModelConfig) -> None:
    """Raise for what this slice of the port does not run yet."""
    if cfg.shared_attn_every:
        raise NotImplementedError(f"{cfg.name}: hybrid shared-attention "
                                  f"models (ROADMAP Queue 1 item 9)")
    for spec in cfg.unit:
        if spec.kind in _LATER:
            raise NotImplementedError(f"{cfg.name}: {_LATER[spec.kind]}")


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def _block_init(gen, spec, cfg: ModelConfig, device) -> Params:
    p = {"norm": rmsnorm_init(cfg.d_model, device)}
    if spec.kind == "attn":
        p["attn"] = attention_init(gen, cfg, device)
    else:
        p["mlp"] = mlp_init(gen, cfg.d_model, spec.d_ff or cfg.d_ff,
                            cfg.activation, device)
    return p


def _stack(trees):
    """List of identical nested dicts -> one dict of stacked tensors."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def init_params(gen: torch.Generator, cfg: ModelConfig,
                device=None) -> Params:
    """Same keys, shapes, dtypes and distributions as the reference's
    `init_params`; the numbers differ (another generator)."""
    check_dense(cfg)
    params: Params = {
        "embed": embedding_init(gen, cfg, device),
        "final_norm": rmsnorm_init(cfg.d_model, device),
    }
    units = [{f"b{j}": _block_init(gen, spec, cfg, device)
              for j, spec in enumerate(cfg.unit)}
             for _ in range(cfg.n_units)]
    params["units"] = _stack(units)
    return params


def _unit(params: Params, u: int):
    """Parameters of unit u: views into the stacked tensors."""
    if isinstance(params, dict):
        return {k: _unit(v, u) for k, v in params.items()}
    return params[u]


# --------------------------------------------------------------------------
# full-sequence forward (prefill)
# --------------------------------------------------------------------------

def _apply_block(p: Params, spec, x, cfg: ModelConfig, positions, impl):
    h = rmsnorm(p["norm"], x, cfg.norm_eps, impl)
    if spec.kind == "attn":
        y = attention(p["attn"], h, cfg, positions, window=spec.window,
                      impl=impl)
    else:
        y = mlp(p["mlp"], h, cfg.activation)
    return x + y


def forward(params: Params, inputs: torch.Tensor, cfg: ModelConfig,
            impl: str = "auto", remat: bool = True
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """inputs: (B, S) int tokens, or (B, S, d) embeddings for frontend
    stubs.  Returns (logits fp32 (B, S, V), aux_loss scalar)."""
    if inputs.ndim == 2:
        x = embed(params["embed"], inputs, cfg)
    else:
        x = inputs.to(torch.bfloat16)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)

    def unit_fn(x, unit_params):
        for j, spec in enumerate(cfg.unit):
            x = _apply_block(unit_params[f"b{j}"], spec, x, cfg, positions,
                             impl)
        return x

    for u in range(cfg.n_units):
        up = _unit(params["units"], u)
        if remat and torch.is_grad_enabled():
            x = checkpoint(unit_fn, x, up, use_reentrant=False)
        else:
            x = unit_fn(x, up)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps, impl)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return unembed(params["embed"], x, cfg), aux


# --------------------------------------------------------------------------
# decode: KV caches stacked over units
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> Params:
    """Stacked per-unit KV caches (leading axis = unit index)."""
    check_dense(cfg)
    cache = {}
    for j, spec in enumerate(cfg.unit):
        if spec.kind == "attn":
            c = init_kv_cache(cfg, batch, max_len, spec.window, device)
            cache[f"b{j}"] = {k: torch.zeros((cfg.n_units,) + v.shape,
                                             dtype=v.dtype, device=device)
                              for k, v in c.items()}
    return {"units": cache}


def decode_step(params: Params, cache: Params, token: torch.Tensor,
                pos: int, cfg: ModelConfig, impl: str = "auto"
                ) -> Tuple[torch.Tensor, Params]:
    """token: (B, 1) int (or (B, 1, d) embeddings); pos: int position.
    Returns (logits (B, 1, V) fp32, cache).  The cache is updated in
    place (see `decode_attention`); `impl` picks the RMSNorm route, and
    attention is always the naive path, as in the reference."""
    if token.ndim == 2:
        x = embed(params["embed"], token, cfg)
    else:
        x = token.to(torch.bfloat16)
    for u in range(cfg.n_units):
        up = _unit(params["units"], u)
        for j, spec in enumerate(cfg.unit):
            p = up[f"b{j}"]
            h = rmsnorm(p["norm"], x, cfg.norm_eps, impl)
            if spec.kind == "attn":
                cb = _unit(cache["units"][f"b{j}"], u)
                y, _ = decode_attention(p["attn"], h, cb, cfg, pos,
                                        window=spec.window)
            else:
                y = mlp(p["mlp"], h, cfg.activation)
            x = x + y
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps, impl)
    return unembed(params["embed"], x, cfg), cache
