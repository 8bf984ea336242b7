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

Quirks kept from the reference on purpose: weight decay goes to every
leaf with `ndim >= 2`, so a norm scale stacked over units, (n_units, d),
is decayed; Adafactor factors a leaf when its last two dims are both at
least 128, whatever its leading (stacked) dims, and ignores
`min_dim_factored`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Tuple

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


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to global norm <= max_norm, the global norm before)."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                        for g in leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


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

def adamw(cfg: OptimizerConfig) -> Optimizer:
    def init(params):
        def zeros(p):
            return torch.zeros_like(p, dtype=torch.float32)
        return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        grads, _ = clip_by_global_norm(grads, cfg.clip_norm)
        step = _step_tensor(step, _first_device(params))
        lr = cosine_lr(cfg, step)
        t = step.float() + 1.0
        bc1 = 1.0 - torch.pow(cfg.b1, t)
        bc2 = 1.0 - torch.pow(cfg.b2, t)

        def upd(p, g, mu, nu):
            g = g.float()
            mu = cfg.b1 * mu + (1 - cfg.b1) * g
            nu = cfg.b2 * nu + (1 - cfg.b2) * g * g
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
            if p.ndim >= 2:
                u = u + cfg.weight_decay * p.float()
            return (p.float() - lr * u).to(p.dtype), mu, nu

        out = tree_map(upd, params, grads, state["mu"], state["nu"])
        return (_pick(params, out, 0),
                {"mu": _pick(params, out, 1), "nu": _pick(params, out, 2)})

    return Optimizer(init, update)


# --------------------------------------------------------------------------
# Adafactor (factored second moment, momentum-free)
# --------------------------------------------------------------------------

def _factored(p) -> bool:
    return p.ndim >= 2 and p.shape[-1] >= 128 and p.shape[-2] >= 128


def adafactor(cfg: OptimizerConfig) -> Optimizer:
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
            g = g.float()
            g2 = g * g + cfg.decay_offset
            if _factored(p):
                vr = beta2 * v["vr"] + (1 - beta2) * g2.mean(-1)
                vc = beta2 * v["vc"] + (1 - beta2) * g2.mean(-2)
                denom = (vr[..., None] * vc[..., None, :]
                         / torch.clamp(vr.mean(-1)[..., None, None],
                                       min=1e-30))
                u = g * torch.rsqrt(denom + 1e-30)
                nv = {"vr": vr, "vc": vc}
            else:
                nv = {"v": beta2 * v["v"] + (1 - beta2) * g2}
                u = g * torch.rsqrt(nv["v"] + 1e-30)
            # update clipping (Adafactor's RMS rule)
            rms = torch.sqrt(torch.mean(u * u) + 1e-30)
            u = u / torch.clamp(rms, min=1.0)
            if p.ndim >= 2:
                u = u + cfg.weight_decay * p.float()
            return (p.float() - lr * u).to(p.dtype), nv

        out = tree_map(upd, params, grads, state["v"])
        return _pick(params, out, 0), {"v": _pick(params, out, 1)}

    return Optimizer(init, update)


def build_optimizer(cfg: OptimizerConfig) -> Optimizer:
    return {"adamw": adamw, "adafactor": adafactor}[cfg.name](cfg)
