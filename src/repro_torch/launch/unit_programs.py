"""Single-unit programs of a cell: each unit's own roofline terms.

The JAX package lowers the pattern unit alone because `cost_analysis()`
counts a scan body once, and extrapolates total = full + sum_i k_i x
unit_i.  The port has no scan: its loops run every unit, so a count of
the whole program (`launch/roofline.py: count`) already covers them and
nothing is extrapolated.  These programs give the per-unit terms beside
it, as the reference's dry run reports them, with `k` the number of times
the unit runs in the program:

- uniform decoder (dense/moe/ssm/vlm): `unit`, n_units times
- hybrid (zamba2): `mamba_unit`, n_layers times, and the shared block,
  `shared_unit`, n_layers / shared_attn_every times
- enc-dec: `enc_unit`, n_encoder_layers times, and `dec_unit`, n_layers
  times

A unit program takes the first unit's parameters as the step takes
them (`runtime/parallel.py: unit_shards`: this rank's shards of the
placed state, or plain tensors off a mesh) and this rank's activations,
and gathers them inside, as the step gathers a unit inside its remat
boundary (`gather_unit`, the MoE stacks at their path's shard); under a
mesh and a ParallelContext it issues the step's collectives: the
unit's gathers, the tensor-parallel sums and gathers over 'model', and
the MoE blocks' own.  A decode unit takes its first unit's cache as the
step computes on it (`runtime/serve.py: cache_views`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..models import encdec as ED
from ..models import transformer as T
from ..runtime.parallel import (UnitShard, gather_params, gather_unit,
                                unit_shards)
from ..tree import leaves, tree_map

UnitProgram = Tuple[str, Callable, Tuple, int]  # (name, fn, args, k)


def _slice(tree, axes: int = 1):
    """The first unit of a stacked tree: `axes` leading axes indexed at 0
    (a cache's `SeqShard` entry kept as it is)."""
    def first(t):
        if not isinstance(t, torch.Tensor):
            return t
        for _ in range(axes):
            t = t[0]
        return t
    return tree_map(first, tree)


def _first(stacked, n: int, prefix: str, axes: int = 1):
    """The first unit of a stacked parameter tree as the step's loop
    takes it (`unit_shards`), `axes` leading axes in (the second, a
    hybrid's inner block, taken off the shard as its first block)."""
    unit = unit_shards(stacked, n, prefix)[0]
    for _ in range(axes - 1):
        unit = tree_map(lambda s: dataclasses.replace(
            s, local=s.local[0], lead=s.lead + 1)
            if isinstance(s, UnitShard) else s[0], unit)
    return unit


def _local(tree):
    """The tensors a program differentiates: a `UnitShard`'s shard."""
    return tree_map(lambda s: s.local if isinstance(s, UnitShard) else s,
                    tree)


def _live(tree):
    """The tree with each tensor (a shard's) detached and requiring grad."""
    def live(s):
        if isinstance(s, UnitShard):
            return dataclasses.replace(
                s, local=s.local.detach().requires_grad_())
        return s.detach().requires_grad_()
    return tree_map(live, tree)


def _x(cfg: ModelConfig, like: torch.Tensor, batch: int, seq: int):
    """A (batch, seq, d_model) bf16 activation of `like`'s kind (fake when
    the state is)."""
    return like.new_zeros((batch, seq, cfg.d_model), dtype=torch.bfloat16)


def _train_wrap(fn, remat: bool):
    """The unit's gradient program: forward (checkpointed when the step
    remats, so that its forward is replayed in the backward, as in the
    step) and backward of sum(y) + aux, for the unit's parameters and its
    activations (x, and the encoder states of a decoder unit, whose
    gradient the step needs too)."""
    def run(params, *acts):
        with torch.enable_grad():
            live = _live(params)
            xs = [a.detach().requires_grad_() for a in acts]
            if remat:
                y, aux = checkpoint(fn, live, *xs, use_reentrant=False)
            else:
                y, aux = fn(live, *xs)
            loss = y.float().sum() + aux
            return torch.autograd.grad(loss, leaves(_local(live)) + xs,
                                       allow_unused=True)
    return run


def _fwd_wrap(fn):
    @torch.no_grad()
    def run(params, x, *rest):
        return fn(params, x, *rest)[0]
    return run


def train_unit_programs(cfg: ModelConfig, state, batch: int, seq: int,
                        impl: str, grad: bool = True,
                        remat: bool = True) -> List[UnitProgram]:
    """The units of a train step (grad=True) or of a prefill (grad=False)
    at `batch` rows of `seq` tokens (this rank's rows); `state["params"]`
    as the step takes them (placed DTensors on a mesh)."""
    wrap = (lambda f: _train_wrap(f, remat)) if grad else _fwd_wrap
    params = state["params"]
    like = _like(params)
    positions = torch.arange(seq, dtype=torch.int32, device=like.device)
    x = _x(cfg, like, batch, seq)

    if cfg.is_encdec:
        def enc_fn(p, xx):
            return ED._enc_unit(gather_unit(p), xx, cfg, positions,
                                impl), 0.0

        def dec_fn(p, xx, enc):
            return ED._dec_unit(gather_unit(p), xx, enc, cfg, positions,
                                positions, impl), 0.0

        return [("enc_unit", wrap(enc_fn),
                 (_first(params["enc_units"], cfg.n_encoder_layers,
                         "enc_units"), x), cfg.n_encoder_layers),
                ("dec_unit", wrap(dec_fn),
                 (_first(params["dec_units"], cfg.n_layers, "dec_units"), x,
                  _x(cfg, like, batch, seq)), cfg.n_layers)]

    if cfg.shared_attn_every:
        n_outer = cfg.n_layers // cfg.shared_attn_every

        def mamba_fn(p, xx):
            return T._apply_block(gather_unit(p), cfg.unit[0], xx, cfg,
                                  positions, impl, 0.0)

        def shared_fn(p, xx):
            return T._shared_block(gather_params(p)["shared"], xx, cfg,
                                   positions, impl), 0.0

        return [("mamba_unit", wrap(mamba_fn),
                 (_first(params["units"], n_outer, "units", axes=2), x),
                 cfg.n_layers),
                ("shared_unit", wrap(shared_fn),
                 ({"shared": params["shared"]}, x), n_outer)]

    def unit_fn(p, xx):
        p, aux = gather_unit(p), 0.0
        for j, spec in enumerate(cfg.unit):
            xx, aux = T._apply_block(p[f"b{j}"], spec, xx, cfg, positions,
                                     impl, aux)
        return xx, aux

    return [("unit", wrap(unit_fn),
             (_first(params["units"], cfg.n_units, "units"), x),
             cfg.n_units)]


def decode_unit_programs(cfg: ModelConfig, params, cache, batch: int,
                         impl: str = "auto") -> List[UnitProgram]:
    """The units of one decode step of `batch` slots at position 7, each
    on its first unit's cache (written in place, as the step does);
    `params` as the step takes them (placed DTensors on a mesh)."""
    like = _like(params)
    x = _x(cfg, like, batch, 1)
    pos = 7

    if cfg.is_encdec:
        @torch.no_grad()
        def dec_fn(p, sc, cc, xx):
            return ED._dec_step(gather_unit(p), sc, cc, xx, cfg, pos, impl)

        return [("dec_unit", dec_fn,
                 (_first(params["dec_units"], cfg.n_layers, "dec_units"),
                  _slice(cache["self"]), _slice(cache["cross"]), x),
                 cfg.n_layers)]

    if cfg.shared_attn_every:
        n_outer = cfg.n_layers // cfg.shared_attn_every

        @torch.no_grad()
        def mamba_fn(p, c, xx):
            return T._decode_block(gather_unit(p), cfg.unit[0], c, xx, cfg,
                                   pos, impl)

        @torch.no_grad()
        def shared_fn(p, c, xx):
            return T._decode_shared(gather_params(p)["shared"], c, xx, cfg,
                                    pos, impl)

        return [("mamba_unit", mamba_fn,
                 (_first(params["units"], n_outer, "units", axes=2),
                  _slice(cache["units"], axes=2), x), cfg.n_layers),
                ("shared_unit", shared_fn,
                 ({"shared": params["shared"]}, _slice(cache["shared"]), x),
                 n_outer)]

    @torch.no_grad()
    def unit_fn(p, c, xx):
        return T._decode_unit(gather_unit(p), c, xx, cfg, pos, impl)

    return [("unit", unit_fn,
             (_first(params["units"], cfg.n_units, "units"),
              _slice(cache["units"]), x), cfg.n_units)]


def _like(params) -> torch.Tensor:
    """A tensor of the state's kind (fake when it is; a DTensor's local
    shard)."""
    from torch.distributed.tensor import DTensor
    t = params["embed"]["table"]
    return t.to_local() if isinstance(t, DTensor) else t
