"""The numbers that decide `correct`, and the decision.

Training (the first steps of the timed step, held to the reference's):

- `loss_err`: the largest gap between the program's loss and the
  reference's over the checked steps;
- `grad_err`: the first step's gradient as the optimizer took it (the
  program's first moment after one step, over 1 - b1), by the worst leaf:
  the gap between the two norms of a leaf over the larger of the
  reference's norm of that leaf and of its median leaf;
- `update_err`: the same for each leaf's change over the checked steps,
  leaving out the leaves whose reference gradient is under a thousandth
  of the median leaf's (they move by round-off alone).

Prefill (the last position's logits of a sample of the window's
prefills, against the reference's at the same prompts):

- `top_gap`: the widest gap by which the served token's reference logit
  lies below the reference's best.  Read and printed, not compared: one
  prompt whose route flips decides it;
- `logit_err`: of each prompt's largest logit difference over its
  reference logits' standard deviation, the largest once the mix's
  `spared_prompts` largest are set aside.  Where the router's top-2
  choice is a near tie, rounding flips it, and that prompt's logits
  move by about one deviation on either side of the comparison; any
  fault that touches more prompts than are spared fails it.

Each compared number has its limit in `limits/<cell>.json`; a run is
correct when every one is finite and at most its limit.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple


#: a leaf whose reference gradient norm is under this share of the
#: median leaf's is left out of `update_err`
STILL_LEAF = 1e-3


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
               keep=None) -> float:
    med = statistics.median(ref.values())
    worst = 0.0
    for k in ref:
        if keep is not None and k not in keep:
            continue
        gap = abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
        worst = max(worst, gap if math.isfinite(gap) else math.inf)
    return worst


def moving_leaves(ref_grad: Dict[str, float]) -> set:
    med = statistics.median(ref_grad.values())
    return {k for k, v in ref_grad.items() if v >= STILL_LEAF * med}


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """prog, ref: {"loss": [per step], "grad": {leaf: norm}, "change":
    {leaf: norm}}."""
    loss = max(abs(a - b) for a, b in zip(prog["loss"], ref["loss"]))
    grad = worst_leaf(prog["grad"], ref["grad"])
    change = worst_leaf(prog["change"], ref["change"],
                        moving_leaves(ref["grad"]))
    return {"loss_err": loss if math.isfinite(loss) else math.inf,
            "grad_err": grad, "update_err": change}


def per_prompt(pairs) -> Tuple[List[float], List[float]]:
    """(each prompt's gap, each prompt's logit error) of `pairs`:
    (program logits (B, V), served tokens (B,), reference logits (B, V))
    for each sampled prefill."""
    gaps, errs = [], []
    for prog, served, ref in pairs:
        ref, prog = ref.float(), prog.float().to(ref.device)
        picked = ref.gather(-1, served.long().to(ref.device)[:, None])[:, 0]
        gaps += (ref.max(-1).values - picked).tolist()
        errs += ((prog - ref).abs().amax(-1)
                 / ref.std(-1)).tolist()
    return gaps, errs


def _finite(x: float) -> float:
    return x if math.isfinite(x) else math.inf


def prefill_numbers(pairs, spared: int) -> Dict[str, float]:
    gaps, errs = per_prompt(pairs)
    if any(not math.isfinite(e) for e in gaps + errs):
        return {"top_gap": math.inf, "logit_err": math.inf}
    ranked = sorted(errs, reverse=True)
    return {"top_gap": _finite(max(gaps)),
            "logit_err": _finite(ranked[min(spared, len(ranked) - 1)])}


def judge(numbers: Dict[str, float], limits: Dict[str, dict]):
    """(correct, [(name, value, limit)]): every number that has a limit
    compared; a limit without its number is not correct."""
    rows, ok = [], bool(limits)
    for name in sorted(limits):
        value = numbers.get(name, math.inf)
        limit = limits.get(name, {}).get("limit", -math.inf)
        rows.append((name, value, limit))
        ok = ok and math.isfinite(value) and value <= limit
    return ok, rows
