"""Decoder-only LM assembled from pattern units: dense, MoE, Mamba2 (SSM)
and the zamba2-style hybrid.

Parameters are stacked (n_units, ...) as in the reference, where
`lax.scan` runs the unit body over that axis; here a Python loop over the
unit index takes its place.

Hybrid models run super-units of `shared_attn_every` Mamba blocks, each
followed by ONE shared attention+MLP block whose weights live outside
the stack and are reused by every application.  Their Mamba params are
stacked (u_outer, every, ...) with no `b{j}` key, and the shared block is
`params["shared"]` = {norm1, attn, norm2, mlp}, as in the reference; the
reference's nested scans become nested loops.  Encoder-decoder models are
`models/encdec.py`.

A batch whose rows do not divide over the mesh's data axes reaches the
forward as the rank's part of each row's sequence (or whole, on every
rank), with its `SeqSplit`: the positions are the rank's own, the
attention reads the keys of the whole sequence (`models/attention.py`),
the Mamba2 mixer carries its state across the ranks (`models/ssm.py`)
and the MoE blocks take the reference's blocks of tokens
(`models/moe.py`).

On a mesh the params are the DTensors the rules place: the leaves
outside the unit loop are gathered once a call (`parallel.gather_params`)
and each unit's inside the loop, one unit at a time, inside the function
that `checkpoint` wraps (`parallel.unit_shards`, `gather_unit`), as GSPMD
gathers them inside the reference's scan body; the blocks compute
tensor-parallel on this rank's 'model' shards of the weights
(`models/attention.py`, `models/layers.py`, `models/ssm.py`,
`models/moe.py`); the norms and the residual stream stay whole on every
rank of 'model'.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..tree import tree_map
from .attention import (attention, attention_init, decode_attention,
                        init_kv_cache)
from .layers import (embed, embedding_init, mlp, mlp_init, rmsnorm,
                     rmsnorm_init, unembed)
from .moe import moe_block, moe_init
from .ssm import decode_mamba, init_ssm_cache, mamba_block, mamba_init

Params = Dict[str, Any]


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
    elif spec.kind == "moe":
        p["moe"] = moe_init(gen, cfg, device)
    elif spec.kind == "mamba":
        p["mamba"] = mamba_init(gen, cfg, device)
    return p


def _stack(make, n: int):
    """n calls of `make` (each an identical nested dict of tensors) ->
    one dict of (n, ...) stacked tensors.  Each unit is copied into
    stacks allocated from the first one's shapes as soon as it is made,
    so the peak is the stacks plus one unit, not a list of every unit
    and the stacks beside it; a single unit is stacked as a view."""
    first = make()
    if n == 1:
        return tree_map(lambda t: t.unsqueeze(0), first)
    out = tree_map(lambda t: t.new_empty((n,) + t.shape), first)
    tree_map(lambda dst, src: dst[0].copy_(src), out, first)
    del first
    for u in range(1, n):
        tree_map(lambda dst, src: dst[u].copy_(src), out, make())
    return out


def init_params(gen: torch.Generator, cfg: ModelConfig,
                device=None) -> Params:
    """Same keys, shapes, dtypes and distributions as the reference's
    `init_params`; the numbers differ (another generator)."""
    params: Params = {
        "embed": embedding_init(gen, cfg, device),
        "final_norm": rmsnorm_init(cfg.d_model, device),
    }
    if cfg.shared_attn_every:
        u_outer = cfg.n_layers // cfg.shared_attn_every
        params["units"] = _stack(
            lambda: _stack(lambda: _block_init(gen, cfg.unit[0], cfg,
                                               device),
                           cfg.shared_attn_every), u_outer)
        params["shared"] = {
            "norm1": rmsnorm_init(cfg.d_model, device),
            "attn": attention_init(gen, cfg, device),
            "norm2": rmsnorm_init(cfg.d_model, device),
            "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.activation,
                            device),
        }
        return params
    params["units"] = _stack(
        lambda: {f"b{j}": _block_init(gen, spec, cfg, device)
                 for j, spec in enumerate(cfg.unit)}, cfg.n_units)
    return params


def _unit(params: Params, u: int):
    """Parameters (or caches) of unit u: views into the stacked tensors;
    a cache's non-tensor entry (`attention.SeqShard`) passes as it is."""
    if isinstance(params, dict):
        return {k: _unit(v, u) for k, v in params.items()}
    return params[u] if isinstance(params, torch.Tensor) else params


def _unbind(params: Params, n: int):
    """The n units' parameters from one `unbind` of each stacked tensor.

    Views, as `_unit` gives; but under autograd one unbind has one
    backward node that stacks the n units' gradients once, where n
    separate `params[u]` would each allocate and add a zero tensor of
    the whole stack's size."""
    if isinstance(params, dict):
        per_key = {k: _unbind(v, n) for k, v in params.items()}
        return [{k: per_key[k][u] for k in params} for u in range(n)]
    return params.unbind(0)


# --------------------------------------------------------------------------
# full-sequence forward (prefill)
# --------------------------------------------------------------------------

def _apply_block(p: Params, spec, x, cfg: ModelConfig, positions, impl,
                 aux):
    from ..runtime.parallel import shard_batch
    x = shard_batch(x)
    h = rmsnorm(p["norm"], x, cfg.norm_eps, impl)
    if spec.kind == "attn":
        y = attention(p["attn"], h, cfg, positions, window=spec.window,
                      impl=impl)
    elif spec.kind == "moe":
        y, a = moe_block(p["moe"], h, cfg)
        aux = aux + a
    elif spec.kind == "mamba":
        y = mamba_block(p["mamba"], h, cfg, impl=impl)
    else:
        y = mlp(p["mlp"], h, cfg.activation, spec.d_ff or cfg.d_ff)
    return x + y, aux


def _shared_block(shared: Params, x, cfg: ModelConfig, positions, impl):
    """The hybrid's shared attention + MLP block."""
    h = rmsnorm(shared["norm1"], x, cfg.norm_eps, impl)
    x = x + attention(shared["attn"], h, cfg, positions, impl=impl)
    h = rmsnorm(shared["norm2"], x, cfg.norm_eps, impl)
    return x + mlp(shared["mlp"], h, cfg.activation, cfg.d_ff)


def outside(params: Params, stacks=("units",)) -> Params:
    """The params with the leaves outside the unit loops as this rank
    computes with them (`parallel.gather_params`; plain tensors as they
    are) and the `stacks` as they are, for `run_units` to gather one
    unit at a time."""
    from ..runtime.parallel import gather_params
    return dict(gather_params({k: v for k, v in params.items()
                               if k not in stacks}),
                **{k: params[k] for k in stacks})


def run_units(unit_fn, x, stacked, n: int, prefix: str, remat: bool):
    """x through the n units of `stacked` (params at `prefix`):
    unit_fn(x, unit params) -> (x, aux), the aux summed.  Each unit's
    params are gathered inside the function that `checkpoint` wraps, so
    that the recompute gathers them again and no unit's gathered weights
    outlive it (`parallel.gather_unit`); that function runs under the
    caller's mesh, context and sequence split."""
    from ..launch.mesh import get_abstract_mesh, use_mesh
    from ..runtime.parallel import (gather_unit, get_context, get_seq_split,
                                    parallel_context, seq_split,
                                    unit_shards)
    mesh, ctx, split = get_abstract_mesh(), get_context(), get_seq_split()

    def body(x, shards):
        # the recompute runs in the backward, after the caller has left
        # its mesh, context and sequence split: it takes this forward's
        with use_mesh(mesh), parallel_context(ctx), seq_split(split):
            return unit_fn(x, gather_unit(shards))

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for shards in unit_shards(stacked, n, prefix):
        if remat and torch.is_grad_enabled():
            x, a = checkpoint(body, x, shards, use_reentrant=False)
        else:
            x, a = body(x, shards)
        aux = aux + a
    return x, aux


def positions_of(x: torch.Tensor, split) -> torch.Tensor:
    """(S,) int32: the positions of x's S tokens in the whole sequence,
    those of the rank's part under a sequence split (`SeqSplit`)."""
    start = 0 if split is None else split.offset
    return torch.arange(start, start + x.shape[1], dtype=torch.int32,
                        device=x.device)


def forward(params: Params, inputs: torch.Tensor, cfg: ModelConfig,
            impl: str = "auto", remat: bool = True, split=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """inputs: (B, S) int tokens, or (B, S, d) embeddings for frontend
    stubs.  Returns (logits fp32 (B, S, V), aux_loss scalar).

    `split` (a `sharding.SeqSplit`): inputs are the rank's part of the
    sequence, or the whole batch on every rank of a mesh whose data axes
    divide neither its rows nor its sequence; the units compute under it
    (`parallel.seq_split`)."""
    from ..runtime.parallel import seq_split
    params = outside(params)
    if inputs.ndim == 2:
        x = embed(params["embed"], inputs, cfg)
    else:
        x = inputs.to(torch.bfloat16)
    positions = positions_of(x, split)

    if cfg.shared_attn_every:
        shared = params["shared"]

        def unit_fn(x, unit_params):
            for inner in _unbind(unit_params, cfg.shared_attn_every):
                x, _ = _apply_block(inner, cfg.unit[0], x, cfg, positions,
                                    impl, 0.0)
            return _shared_block(shared, x, cfg, positions, impl), 0.0
        n_outer = cfg.n_layers // cfg.shared_attn_every
    else:
        def unit_fn(x, unit_params):
            aux = 0.0
            for j, spec in enumerate(cfg.unit):
                x, aux = _apply_block(unit_params[f"b{j}"], spec, x, cfg,
                                      positions, impl, aux)
            return x, aux
        n_outer = cfg.n_units

    with seq_split(split):
        x, aux = run_units(unit_fn, x, params["units"], n_outer, "units",
                           remat)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps, impl)
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
    elif spec.kind == "moe":
        y, _ = moe_block(p["moe"], h, cfg)
    else:
        y = mlp(p["mlp"], h, cfg.activation, spec.d_ff or cfg.d_ff)
    return x + y


def _decode_shared(shared: Params, cache_u, x, cfg: ModelConfig, pos: int,
                   impl):
    """The hybrid's shared block at a decode step, on one application's
    KV cache."""
    h = rmsnorm(shared["norm1"], x, cfg.norm_eps, impl)
    y, _ = decode_attention(shared["attn"], h, cache_u, cfg, pos)
    x = x + y
    h = rmsnorm(shared["norm2"], x, cfg.norm_eps, impl)
    return x + mlp(shared["mlp"], h, cfg.activation, cfg.d_ff)


def _decode_unit(unit_params: Params, unit_cache, x, cfg: ModelConfig,
                 pos: int, impl):
    """One pattern unit at a decode step (its blocks' caches, where they
    have one, written in place)."""
    for j, spec in enumerate(cfg.unit):
        x = _decode_block(unit_params[f"b{j}"], spec,
                          unit_cache.get(f"b{j}"), x, cfg, pos, impl)
    return x


def decode_step(params: Params, cache: Params, token: torch.Tensor,
                pos: int, cfg: ModelConfig, impl: str = "auto"
                ) -> Tuple[torch.Tensor, Params]:
    """token: (B, 1) int (or (B, 1, d) embeddings); pos: int position.
    Returns (logits (B, 1, V) fp32, cache).  The cache is updated in
    place (see `decode_attention`, `decode_mamba`); `impl` picks the
    RMSNorm route, and attention is always the naive path, as in the
    reference.  On a mesh each unit's params are gathered as the step
    reaches it (`parallel.gather_unit`)."""
    from ..runtime.parallel import gather_unit, unit_shards
    params = outside(params)
    if token.ndim == 2:
        x = embed(params["embed"], token, cfg)
    else:
        x = token.to(torch.bfloat16)
    if cfg.shared_attn_every:
        shared = params["shared"]
        n_outer = cfg.n_layers // cfg.shared_attn_every
        for u, shards in enumerate(unit_shards(params["units"], n_outer,
                                               "units")):
            up, cu = gather_unit(shards), _unit(cache["units"], u)
            for k in range(cfg.shared_attn_every):
                x = _decode_block(_unit(up, k), cfg.unit[0], _unit(cu, k), x,
                                  cfg, pos, impl)
            x = _decode_shared(shared, _unit(cache["shared"], u), x, cfg,
                               pos, impl)
    else:
        for u, shards in enumerate(unit_shards(params["units"], cfg.n_units,
                                               "units")):
            x = _decode_unit(gather_unit(shards), _unit(cache["units"], u),
                             x, cfg, pos, impl)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps, impl)
    return unembed(params["embed"], x, cfg), cache
