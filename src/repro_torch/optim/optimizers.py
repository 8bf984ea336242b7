"""Optimizers: AdamW and Adafactor (factored second moment), plus global
gradient-norm clipping and a cosine LR schedule.

A port of the JAX package's `optim/optimizers.py`.  Both optimizers keep
their state in trees of the params' structure, with the reference's keys
(`{"mu", "nu"}`; `{"v"}` holding `{"vr", "vc"}` or `{"v"}` per leaf),
and update functionally: `update` returns new params and a new state and
leaves its inputs as they were, as the reference does.

The step-dependent scalars (`step + 1`, `b1 ** t`, `b2 ** t`,
`t ** -0.8`, the learning rate) are float32 tensors on the params'
device, computed as the reference computes them, so the two agree to the
ulp and the card is never asked for a host round trip.

On a mesh the leaves are DTensors.  AdamW is elementwise and runs on
them as DTensor operations; Adafactor updates each rank's own shards,
as GSPMD compiles the reference's update: its row and column means and
the RMS clip's mean are local sums added over the mesh axes that split
them (`runtime/parallel.psum`, all-reduces), so no rank holds a whole
factored product.  Plain leaves take the reference's arithmetic as it
is written.

Quirks kept from the reference on purpose: weight decay goes to every
leaf with `ndim >= 2`, so a norm scale stacked over units, (n_units, d),
is decayed; Adafactor factors a leaf when its last two dims are both at
least 128, whatever its leading (stacked) dims, and ignores
`min_dim_factored`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from ..tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"             # adamw | adafactor
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.01
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    clip_norm: float = 1.0
    # adafactor
    decay_offset: float = 1e-30
    min_dim_factored: int = 128     # unused, as in the reference


def _step_tensor(step, device) -> torch.Tensor:
    """The step as the reference holds it: an int32 scalar."""
    if isinstance(step, torch.Tensor):
        return step.to(device=device, dtype=torch.int32)
    return torch.tensor(step, dtype=torch.int32, device=device)


def cosine_lr(cfg: OptimizerConfig, step) -> torch.Tensor:
    """Linear warm-up then cosine decay to 0; a float32 scalar tensor."""
    step = _step_tensor(step, step.device if isinstance(step, torch.Tensor)
                        else None)
    # (step + 1): the first step must not see lr == 0
    warm = torch.clamp((step + 1.0) / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(1, cfg.total_steps - cfg.warmup_steps),
                       0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * prog))


def _clip_scale(grads, max_norm: float):
    """(the factor that scales grads to global norm <= max_norm, the
    global norm)."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                        for g in leaves(grads)))
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0), gn


def _clipped(g, scale):
    return (g.float() * scale).to(g.dtype)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to global norm <= max_norm, the global norm before)."""
    scale, gn = _clip_scale(grads, max_norm)
    return tree_map(lambda g: _clipped(g, scale), grads), gn


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, Any], Tuple[Any, Any]]


def _first_device(params):
    return leaves(params)[0].device


def _pick(params, out, i):
    """Element i of the tuples at the leaves of `out` (params' structure)."""
    return tree_map(lambda _, o: o[i], params, out)


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------

#: entries of a leaf (a DTensor's: of its local shard) that AdamW updates
#: at a time.  A larger leaf is walked in slices, each computed as the
#: whole leaf would be, so that the update's fp32 temporaries are a few of
#: 256 MB and not a few copies of the leaf: zamba2-2.7b's mixer
#: projections are one stack of 1.44e9 entries, 5.8 GB a copy in fp32,
#: beside two 27 GB states on one card.
ADAMW_SLICE = 1 << 26


def adamw(cfg: OptimizerConfig) -> Optimizer:
    def init(params):
        def zeros(p):
            return torch.zeros_like(p, dtype=torch.float32)
        return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        from torch.distributed.tensor import DTensor
        scale, _ = _clip_scale(grads, cfg.clip_norm)
        # every rank reads the clip's factor (a replicated scalar) once
        local_scale = (scale.full_tensor() if isinstance(scale, DTensor)
                       else scale)
        step = _step_tensor(step, _first_device(params))
        lr = cosine_lr(cfg, step)
        t = step.float() + 1.0
        bc1 = 1.0 - torch.pow(cfg.b1, t)
        bc2 = 1.0 - torch.pow(cfg.b2, t)

        def leaf(p, g, mu, nu, decay, scale):
            g = _clipped(g, scale).float()
            mu = cfg.b1 * mu + (1 - cfg.b1) * g
            nu = cfg.b2 * nu + (1 - cfg.b2) * g * g
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
            if decay:
                u = u + cfg.weight_decay * p.float()
            return (p.float() - lr * u).to(p.dtype), mu, nu

        def sliced(p, g, mu, nu, decay, scale):
            """`leaf` a slice of ADAMW_SLICE entries at a time."""
            if p.numel() <= ADAMW_SLICE:
                return leaf(p, g, mu, nu, decay, scale)
            out = tuple(torch.empty_like(
                x, memory_format=torch.contiguous_format) for x in (p, mu, nu))
            flat = [x.reshape(-1) for x in (p, g, mu, nu)]
            for i in range(0, p.numel(), ADAMW_SLICE):
                part = leaf(*(x[i:i + ADAMW_SLICE] for x in flat), decay,
                            scale)
                for o, v in zip(out, part):
                    o.view(-1)[i:i + ADAMW_SLICE] = v
            return out

        def upd(p, g, mu, nu):
            decay = p.ndim >= 2
            if not isinstance(p, DTensor):
                return sliced(p, g, mu, nu, decay, scale)
            if any(not isinstance(x, DTensor) or x.placements != p.placements
                    or x.device_mesh != p.device_mesh for x in (g, mu, nu)):
                return leaf(p, g, mu, nu, decay, scale)
            # the four share their shards: the elementwise update on the
            # local shards, as the DTensor operations would run it
            local = sliced(*(x.to_local() for x in (p, g, mu, nu)), decay,
                           local_scale)
            return tuple(DTensor.from_local(
                v, p.device_mesh, p.placements, run_check=False,
                shape=x.shape, stride=x.stride())
                for v, x in zip(local, (p, mu, nu)))

        out = tree_map(upd, params, grads, state["mu"], state["nu"])
        return (_pick(params, out, 0),
                {"mu": _pick(params, out, 1), "nu": _pick(params, out, 2)})

    return Optimizer(init, update)


# --------------------------------------------------------------------------
# Adafactor (factored second moment, momentum-free)
# --------------------------------------------------------------------------

def _factored(p) -> bool:
    return p.ndim >= 2 and p.shape[-1] >= 128 and p.shape[-2] >= 128


def _split_axes(t, mesh) -> Dict[int, Tuple[str, ...]]:
    """For a DTensor leaf: each dim (counted from 0) mapped to the mesh
    axes of more than one rank that split it, in the mesh's order."""
    from torch.distributed.tensor import Shard
    out: Dict[int, Tuple[str, ...]] = {}
    for name, pl in zip(mesh.shape, t.placements):
        if isinstance(pl, Shard) and mesh.shape[name] > 1:
            d = pl.dim % t.ndim
            out[d] = out.get(d, ()) + (name,)
    return out


def _without_dim(placements, n: int, d: int) -> tuple:
    """The placements of a leaf of n dims with dim d reduced away: its
    shards there become replicas, those of later dims move down one."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for q in placements:
        k = q.dim % n if isinstance(q, Shard) else None
        out.append(q if k is None or k < d else
                   Replicate() if k == d else Shard(k - 1))
    return tuple(out)


def _adafactor_leaf(cfg: OptimizerConfig, p, g, v, lr, beta2):
    """The Adafactor update of one leaf.  A plain tensor takes the
    reference's arithmetic as it is written.  A DTensor leaf updates this
    rank's shards, as GSPMD runs the reference's update on each device:
    every elementwise term on the local tensors, each mean a local sum
    added over the mesh axes that split its dim (`parallel.psum`) and
    divided by the global size, the results wrapped as DTensors at the
    leaf's (and its state's) placements.  A dim no axis splits is whole
    here and takes the local mean, the plain arithmetic."""
    from torch.distributed.tensor import DTensor

    from ..launch.mesh import Mesh
    from ..runtime.parallel import psum
    n = p.ndim
    mesh = Mesh(p.device_mesh) if isinstance(p, DTensor) else None
    split = _split_axes(p, mesh) if mesh is not None else {}
    at = tuple(p.placements) if mesh is not None else None

    def local(t, placements):
        """t's local shard at `placements` (redistributed first where it
        is placed otherwise); a plain tensor as it is."""
        if placements is None:
            return t
        if tuple(t.placements) != placements:
            t = t.redistribute(t.device_mesh, placements)
        return t.to_local()

    def wrap(x, like, placements):
        if placements is None:
            return x
        return DTensor.from_local(x, like.device_mesh, placements,
                                  run_check=False, shape=like.shape,
                                  stride=like.stride())

    def mean(x, dim, axes, size):
        if not axes:
            return x.mean(dim)
        return psum(x.sum(dim), mesh, axes) / size

    pl = local(p, at)
    gl = local(g, at).float()
    g2 = gl * gl + cfg.decay_offset
    if _factored(p):
        rows, cols = split.get(n - 2, ()), split.get(n - 1, ())
        # `opt_shardings`: vr at the leaf's spec without its last dim, vc
        # without its second last
        at_vr = at and _without_dim(at, n, n - 1)
        at_vc = at and _without_dim(at, n, n - 2)
        vr = beta2 * local(v["vr"], at_vr) + (1 - beta2) * mean(
            g2, -1, cols, p.shape[-1])
        vc = beta2 * local(v["vc"], at_vc) + (1 - beta2) * mean(
            g2, -2, rows, p.shape[-2])
        denom = (vr[..., None] * vc[..., None, :]
                 / torch.clamp(mean(vr, -1, rows, p.shape[-2])[
                     ..., None, None], min=1e-30))
        u = gl * torch.rsqrt(denom + 1e-30)
        nv = {"vr": wrap(vr, v["vr"], at_vr),
              "vc": wrap(vc, v["vc"], at_vc)}
    else:
        vl = beta2 * local(v["v"], at) + (1 - beta2) * g2
        u = gl * torch.rsqrt(vl + 1e-30)
        nv = {"v": wrap(vl, v["v"], at)}
    # update clipping (Adafactor's RMS rule), over the whole leaf
    every = tuple(a for a in (mesh.shape if mesh is not None else ())
                  if any(a in axes for axes in split.values()))
    if every:
        ms = psum(torch.sum(u * u), mesh, every) / p.numel()
    else:
        ms = torch.mean(u * u)
    u = u / torch.clamp(torch.sqrt(ms + 1e-30), min=1.0)
    if p.ndim >= 2:
        u = u + cfg.weight_decay * pl.float()
    return wrap((pl.float() - lr * u).to(p.dtype), p, at), nv


def adafactor(cfg: OptimizerConfig) -> Optimizer:
    """On a mesh (DTensor leaves) each leaf updates its own shards; plain
    leaves take the reference's arithmetic as it is written
    (`_adafactor_leaf`)."""
    def init(params):
        def st(p):
            if _factored(p):
                return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                          device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=torch.float32,
                                          device=p.device)}
            return {"v": torch.zeros_like(p, dtype=torch.float32)}
        return {"v": tree_map(st, params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        grads, _ = clip_by_global_norm(grads, cfg.clip_norm)
        step = _step_tensor(step, _first_device(params))
        lr = cosine_lr(cfg, step)
        t = step.float() + 1.0
        beta2 = 1.0 - t ** -0.8

        def upd(p, g, v):
            return _adafactor_leaf(cfg, p, g, v, lr, beta2)

        out = tree_map(upd, params, grads, state["v"])
        return _pick(params, out, 0), {"v": _pick(params, out, 1)}

    return Optimizer(init, update)


def build_optimizer(cfg: OptimizerConfig) -> Optimizer:
    return {"adamw": adamw, "adafactor": adafactor}[cfg.name](cfg)
