"""Decoder-only LM assembled from pattern units: dense, Mamba2 (SSM) and
the zamba2-style hybrid.

Parameters are stacked (n_units, ...) as in the reference, where
`lax.scan` runs the unit body over that axis; here a Python loop over the
unit index takes its place.

Hybrid models run super-units of `shared_attn_every` Mamba blocks, each
followed by ONE shared attention+MLP block whose weights live outside
the stack and are reused by every application.  Their Mamba params are
stacked (u_outer, every, ...) with no `b{j}` key, and the shared block is
`params["shared"]` = {norm1, attn, norm2, mlp}, as in the reference; the
reference's nested scans become nested loops.  MoE units raise
`NotImplementedError` (a later slice of the port).
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
from .ssm import decode_mamba, init_ssm_cache, mamba_block, mamba_init

Params = Dict[str, Any]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what the port does not run yet."""
    if cfg.is_encdec:
        raise NotImplementedError(f"{cfg.name}: encoder-decoder models "
                                  f"(ROADMAP Queue 1 item 11)")
    if any(spec.kind == "moe" for spec in cfg.unit):
        raise NotImplementedError(f"{cfg.name}: MoE units "
                                  f"(ROADMAP Queue 1 item 10)")


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def _block_init(gen, spec, cfg: ModelConfig, device) -> Params:
    p = {"norm": rmsnorm_init(cfg.d_model, device)}
    if spec.kind == "attn":
        p["attn"] = attention_init(gen, cfg, device)
    elif spec.kind == "mlp":
        p["mlp"] = mlp_init(gen, cfg.d_model, spec.d_ff or cfg.d_ff,
                            cfg.activation, device)
    elif spec.kind == "mamba":
        p["mamba"] = mamba_init(gen, cfg, device)
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
    check_supported(cfg)
    params: Params = {
        "embed": embedding_init(gen, cfg, device),
        "final_norm": rmsnorm_init(cfg.d_model, device),
    }
    if cfg.shared_attn_every:
        u_outer = cfg.n_layers // cfg.shared_attn_every
        params["units"] = _stack([
            _stack([_block_init(gen, cfg.unit[0], cfg, device)
                    for _ in range(cfg.shared_attn_every)])
            for _ in range(u_outer)])
        params["shared"] = {
            "norm1": rmsnorm_init(cfg.d_model, device),
            "attn": attention_init(gen, cfg, device),
            "norm2": rmsnorm_init(cfg.d_model, device),
            "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.activation,
                            device),
        }
        return params
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
    elif spec.kind == "mamba":
        y = mamba_block(p["mamba"], h, cfg, impl=impl)
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

    if cfg.shared_attn_every:
        shared = params["shared"]

        def unit_fn(x, unit_params):
            for k in range(cfg.shared_attn_every):
                x = _apply_block(_unit(unit_params, k), cfg.unit[0], x, cfg,
                                 positions, impl)
            h = rmsnorm(shared["norm1"], x, cfg.norm_eps, impl)
            x = x + attention(shared["attn"], h, cfg, positions, impl=impl)
            h = rmsnorm(shared["norm2"], x, cfg.norm_eps, impl)
            return x + mlp(shared["mlp"], h, cfg.activation)
        n_outer = cfg.n_layers // cfg.shared_attn_every
    else:
        def unit_fn(x, unit_params):
            for j, spec in enumerate(cfg.unit):
                x = _apply_block(unit_params[f"b{j}"], spec, x, cfg,
                                 positions, impl)
            return x
        n_outer = cfg.n_units

    for u in range(n_outer):
        up = _unit(params["units"], u)
        if remat and torch.is_grad_enabled():
            x = checkpoint(unit_fn, x, up, use_reentrant=False)
        else:
            x = unit_fn(x, up)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps, impl)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return unembed(params["embed"], x, cfg), aux


# --------------------------------------------------------------------------
# decode: KV/SSM caches stacked over units
# --------------------------------------------------------------------------

def _stacked_zeros(tree, lead):
    """Zeros of the tree's shapes and dtypes with leading axes `lead`."""
    return {k: torch.zeros(lead + v.shape, dtype=v.dtype, device=v.device)
            for k, v in tree.items()}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> Params:
    """Stacked per-unit caches (leading axis = unit index; hybrids stack
    their Mamba caches (u_outer, every) and keep one KV cache for each
    application of the shared block)."""
    check_supported(cfg)
    if cfg.shared_attn_every:
        u_outer = cfg.n_layers // cfg.shared_attn_every
        return {
            "units": _stacked_zeros(init_ssm_cache(cfg, batch, device),
                                    (u_outer, cfg.shared_attn_every)),
            "shared": _stacked_zeros(init_kv_cache(cfg, batch, max_len,
                                                   device=device),
                                     (u_outer,)),
        }
    cache = {}
    for j, spec in enumerate(cfg.unit):
        if spec.kind == "attn":
            c = init_kv_cache(cfg, batch, max_len, spec.window, device)
        elif spec.kind == "mamba":
            c = init_ssm_cache(cfg, batch, device)
        else:
            continue
        cache[f"b{j}"] = _stacked_zeros(c, (cfg.n_units,))
    return {"units": cache}


def _decode_block(p, spec, cache_b, x, cfg: ModelConfig, pos: int, impl):
    h = rmsnorm(p["norm"], x, cfg.norm_eps, impl)
    if spec.kind == "attn":
        y, _ = decode_attention(p["attn"], h, cache_b, cfg, pos,
                                window=spec.window)
    elif spec.kind == "mamba":
        y, _ = decode_mamba(p["mamba"], h, cache_b, cfg, impl)
    else:
        y = mlp(p["mlp"], h, cfg.activation)
    return x + y


def decode_step(params: Params, cache: Params, token: torch.Tensor,
                pos: int, cfg: ModelConfig, impl: str = "auto"
                ) -> Tuple[torch.Tensor, Params]:
    """token: (B, 1) int (or (B, 1, d) embeddings); pos: int position.
    Returns (logits (B, 1, V) fp32, cache).  The cache is updated in
    place (see `decode_attention`, `decode_mamba`); `impl` picks the
    RMSNorm route, and attention is always the naive path, as in the
    reference."""
    if token.ndim == 2:
        x = embed(params["embed"], token, cfg)
    else:
        x = token.to(torch.bfloat16)
    if cfg.shared_attn_every:
        shared = params["shared"]
        for u in range(cfg.n_layers // cfg.shared_attn_every):
            up, cu = _unit(params["units"], u), _unit(cache["units"], u)
            for k in range(cfg.shared_attn_every):
                x = _decode_block(_unit(up, k), cfg.unit[0], _unit(cu, k), x,
                                  cfg, pos, impl)
            h = rmsnorm(shared["norm1"], x, cfg.norm_eps, impl)
            y, _ = decode_attention(shared["attn"], h,
                                    _unit(cache["shared"], u), cfg, pos)
            x = x + y
            h = rmsnorm(shared["norm2"], x, cfg.norm_eps, impl)
            x = x + mlp(shared["mlp"], h, cfg.activation)
    else:
        for u in range(cfg.n_units):
            up = _unit(params["units"], u)
            for j, spec in enumerate(cfg.unit):
                cb = cache["units"].get(f"b{j}")
                x = _decode_block(up[f"b{j}"], spec,
                                  None if cb is None else _unit(cb, u), x,
                                  cfg, pos, impl)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps, impl)
    return unembed(params["embed"], x, cfg), cache
