"""Cells cut to a size the CPU runs in seconds, for the tests: every
width small, the traffic short, limits of their own."""

from __future__ import annotations

import dataclasses
import time

from portbench import spec
from portbench.harness import RunContext

SMALL = {
    "mamba2-1.3b": dict(n_layers=8, d_model=64, vocab_size=256, ssm_state=16,
                        ssm_head_dim=16, ssm_chunk=16),
    "mixtral-8x22b-14l": dict(n_layers=2, d_model=64, n_heads=4,
                             n_kv_heads=2, head_dim=16, d_ff=128,
                             moe_d_ff=32, vocab_size=256, sliding_window=16),
}
#: limits at these sizes (CPU, bfloat16 program, no prompt spared):
#: above the largest sound reading over seeds 20-27 (mamba2: loss
#: 0.0027, grad 0.0082, update 0.0188; mixtral: logit 0.0367, seed 20's
#: one flipped prompt, 0.415, left out) and below the control's least
#: (loss 0.0126; logit 0.197) and the half batch's (loss 0.077, grad
#: 0.17, update 0.036)
LIMITS = {"mamba2-train": dict(loss_err=0.006, grad_err=0.05,
                               update_err=0.03),
          "mixtral-prefill": dict(logit_err=0.06)}
TRAFFIC = {"train": dict(seq_len=32, trace_calls=1),
           "prefill": dict(seq_len=32, trace_calls=2, check_prefills=3,
                           spared_prompts=0)}


def small_cell(name: str) -> spec.Cell:
    limits = LIMITS[name]
    bench = spec.load()
    cell = spec.cell(bench, name)
    conf = next(w["config"] for w in bench["workloads"] if w["name"] == name)
    config = dict(cell.config, **SMALL[conf])
    traffic = dict(cell.traffic, **TRAFFIC[cell.traffic["kind"]])
    lim = {k: {"limit": v} for k, v in limits.items()}
    return dataclasses.replace(cell, config=config, traffic=traffic,
                               limits=lim)


def context(cell: spec.Cell, seed: int = 7, trace: bool = False,
            wrap=None, seconds: float = 0.0) -> RunContext:
    ctx = RunContext(cell=cell, seed=seed, seconds=seconds, trace=trace,
                     device="cpu", started=time.time())
    if wrap is not None:
        ctx.wrap = wrap
    return ctx
