"""Plain AdamW for the reference's training steps.

The update the training mix states, written out in float32: the
gradients clipped to a global norm, first and second moments, bias
correction, decoupled weight decay on every leaf of two or more
dimensions as the tree stacks it, a linear warm-up and cosine decay of
the learning rate.  Each leaf is stored back in its own dtype after the
update, as the configuration stores its weights (bfloat16 matrices and
norms, float32 SSM parameters).  Leaves are updated in place, a slice at
a time, so that a 2.7e9-weight model's float32 state fits one card.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

SLICE = 1 << 26


def learning_rate(opt: dict, step: int) -> float:
    warm = min((step + 1.0) / max(opt["warmup_steps"], 1), 1.0)
    span = max(1, opt["total_steps"] - opt["warmup_steps"])
    prog = min(max((step - opt["warmup_steps"]) / span, 0.0), 1.0)
    return opt["lr"] * warm * 0.5 * (1.0 + math.cos(math.pi * prog))


def global_norm(grads: Dict[str, torch.Tensor]) -> float:
    return math.sqrt(sum(float(torch.sum(g.double() ** 2))
                         for g in grads.values()))


def adamw_step(params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor], state: dict, opt: dict,
               step: int, dtypes: Dict[str, torch.dtype]
               ) -> Dict[str, float]:
    """One update of the float32 `params` and `state` ({"mu", "nu"},
    filled with zeros on the first step) in place, each param then
    rounded to the dtype that stores it.  `grads` is emptied as it is
    used.  Returns each leaf's clipped gradient norm, the gradient as
    the update takes it."""
    factor = min(1.0, opt["clip_norm"] / max(global_norm(grads), 1e-12))
    lr = learning_rate(opt, step)
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    bc1, bc2 = 1.0 - b1 ** (step + 1), 1.0 - b2 ** (step + 1)
    norms = {}
    for k in list(params):
        p, g = params[k], grads.pop(k)
        for name in ("mu", "nu"):
            state.setdefault(name, {}).setdefault(k, torch.zeros_like(p))
        flat = [t.reshape(-1) for t in (p, g, state["mu"][k],
                                        state["nu"][k])]
        sq = 0.0
        for i in range(0, p.numel(), SLICE):
            pp, gg, mm, vv = (t[i:i + SLICE] for t in flat)
            gg = gg * factor
            sq += float(torch.sum(gg.double() ** 2))
            mm.mul_(b1).add_((1 - b1) * gg)
            vv.mul_(b2).add_((1 - b2) * gg * gg)
            u = (mm / bc1) / (torch.sqrt(vv / bc2) + eps)
            if p.ndim >= 2:
                u = u + opt["weight_decay"] * pp
            pp.copy_((pp - lr * u).to(dtypes[k]).float())
        norms[k] = math.sqrt(sq)
        del g
    return norms
