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

A unit program takes the unit's parameters (views of the stacked state's
first unit, cut to what this rank computes with: `sharding.tp_local`)
and this rank's activations; under a mesh and a ParallelContext it
issues the step's collectives: the tensor-parallel sums and gathers over
'model', and the MoE blocks' own.  A decode unit takes its first unit's
cache as the step computes on it (`runtime/serve.py: cache_views`).
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..models import encdec as ED
from ..models import transformer as T
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
            live = tree_map(lambda t: t.detach().requires_grad_(), params)
            xs = [a.detach().requires_grad_() for a in acts]
            if remat:
                y, aux = checkpoint(fn, live, *xs, use_reentrant=False)
            else:
                y, aux = fn(live, *xs)
            loss = y.float().sum() + aux
            return torch.autograd.grad(loss, leaves(live) + xs,
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
    at `batch` rows of `seq` tokens (this rank's rows)."""
    wrap = (lambda f: _train_wrap(f, remat)) if grad else _fwd_wrap
    params = state["params"]
    like = params["embed"]["table"]
    positions = torch.arange(seq, dtype=torch.int32, device=like.device)
    x = _x(cfg, like, batch, seq)

    if cfg.is_encdec:
        def enc_fn(p, xx):
            return ED._enc_unit(p, xx, cfg, positions, impl), 0.0

        def dec_fn(p, xx, enc):
            return ED._dec_unit(p, xx, enc, cfg, positions, positions,
                                impl), 0.0

        return [("enc_unit", wrap(enc_fn), (_slice(params["enc_units"]), x),
                 cfg.n_encoder_layers),
                ("dec_unit", wrap(dec_fn),
                 (_slice(params["dec_units"]), x, _x(cfg, like, batch, seq)),
                 cfg.n_layers)]

    if cfg.shared_attn_every:
        def mamba_fn(p, xx):
            return T._apply_block(p, cfg.unit[0], xx, cfg, positions, impl,
                                  0.0)

        def shared_fn(p, xx):
            return T._shared_block(p, xx, cfg, positions, impl), 0.0

        return [("mamba_unit", wrap(mamba_fn),
                 (_slice(params["units"], axes=2), x), cfg.n_layers),
                ("shared_unit", wrap(shared_fn), (params["shared"], x),
                 cfg.n_layers // cfg.shared_attn_every)]

    def unit_fn(p, xx):
        aux = 0.0
        for j, spec in enumerate(cfg.unit):
            xx, aux = T._apply_block(p[f"b{j}"], spec, xx, cfg, positions,
                                     impl, aux)
        return xx, aux

    return [("unit", wrap(unit_fn), (_slice(params["units"]), x),
             cfg.n_units)]


def decode_unit_programs(cfg: ModelConfig, params, cache, batch: int,
                         impl: str = "auto") -> List[UnitProgram]:
    """The units of one decode step of `batch` slots at position 7, each
    on its first unit's cache (written in place, as the step does)."""
    like = params["embed"]["table"]
    x = _x(cfg, like, batch, 1)
    pos = 7

    if cfg.is_encdec:
        @torch.no_grad()
        def dec_fn(p, sc, cc, xx):
            return ED._dec_step(p, sc, cc, xx, cfg, pos, impl)

        return [("dec_unit", dec_fn,
                 (_slice(params["dec_units"]), _slice(cache["self"]),
                  _slice(cache["cross"]), x), cfg.n_layers)]

    if cfg.shared_attn_every:
        @torch.no_grad()
        def mamba_fn(p, c, xx):
            return T._decode_block(p, cfg.unit[0], c, xx, cfg, pos, impl)

        @torch.no_grad()
        def shared_fn(p, c, xx):
            return T._decode_shared(p, c, xx, cfg, pos, impl)

        return [("mamba_unit", mamba_fn,
                 (_slice(params["units"], axes=2),
                  _slice(cache["units"], axes=2), x), cfg.n_layers),
                ("shared_unit", shared_fn,
                 (params["shared"], _slice(cache["shared"]), x),
                 cfg.n_layers // cfg.shared_attn_every)]

    @torch.no_grad()
    def unit_fn(p, c, xx):
        return T._decode_unit(p, c, xx, cfg, pos, impl)

    return [("unit", unit_fn,
             (_slice(params["units"]), _slice(cache["units"]), x),
             cfg.n_units)]
