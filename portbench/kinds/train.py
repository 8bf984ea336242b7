"""Training: a closed loop of the program's train step
(`runtime/train.py: make_train_step`), new token ids for every step.

Set-up builds the one state the window trains (weights drawn from the
seed, the program's optimizer state) and drives it through the mix's
`check_steps` first steps with the window's own call and feed; those
steps warm every shape and leave the readings the reference is held to:
each step's loss, the first gradient as the optimizer took it (from its
first moment) and each leaf's change over the steps.  The window then
runs whole steps back to back until the first that ends after
`seconds`, each step's loss read on the host; a traced run profiles a
stretch of it (`trace.TRACE_AT`).  After it the state is
freed and the plain reference (`reference/`) follows the same first
steps from the same weights and tokens.
"""

from __future__ import annotations

import math
import time

import torch

from .. import weights, yardstick
from ..compare import moving_leaves, train_numbers
from ..harness import (Outcome, RunContext, load_kernels, log,
                       program_weights, sync)
from ..reference import decoder, optim
from ..trace import TRACE_AT, traced


def _opt(traffic: dict) -> dict:
    return dict(traffic["optimizer"])


def make_batch(seed: int, traffic: dict, vocab: int, device,
               i: int) -> dict:
    B, S = traffic["batch"], traffic["seq_len"]
    t = weights.tokens(seed, 0, i, (B, S + 1), vocab, device)
    return {"tokens": t[:, :-1], "labels": t[:, 1:]}


def leaf_norms(tree) -> dict:
    return {p: float(torch.linalg.vector_norm(t.float()))
            for p, t in weights.named_leaves(tree)}


def changes(tree, specs, seed, device, branches) -> dict:
    """Each leaf's distance from the weights the seed drew."""
    out = {}
    for path, t in weights.named_leaves(tree):
        i, shape, dtype = specs[path]
        w0 = weights.draw_leaf(path, i, shape, dtype, seed, device,
                               branches)
        out[path] = float(torch.linalg.vector_norm(t.float() - w0.float()))
        del w0
    return out


def reference_readings(cfg: dict, traffic: dict, seed: int, specs, device,
                       mm=decoder.exact_matmul) -> dict:
    """The reference's loss a step, first clipped gradient and change a
    leaf over the mix's `check_steps` steps from the seed's weights and
    tokens."""
    decoder.setup_float32()
    opt = _opt(traffic)
    branches = weights.residual_branches(cfg)

    def initial(p):
        i, shape, dtype = specs[p]
        return weights.draw_leaf(p, i, shape, dtype, seed, device,
                                 branches).float()
    params = {p: initial(p) for p in specs}
    dtypes = {p: dtype for p, (_, _, dtype) in specs.items()}
    state, losses, first = {}, [], None
    for step in range(traffic["check_steps"]):
        b = make_batch(seed, traffic, cfg["vocab_size"], device, step)
        loss, grads = decoder.grads(
            params, b["tokens"], b["labels"], cfg, traffic["z_loss_weight"],
            mm=mm, rows_per_block=traffic.get("reference_rows", 1))
        losses.append(float(loss))
        norms = optim.adamw_step(params, grads, state, opt, step, dtypes)
        first = first or norms
        del grads
    change = {}
    for p in specs:
        change[p] = float(torch.linalg.vector_norm(params[p] - initial(p)))
    del params, state
    return {"loss": losses, "grad": first, "change": change}


def build(ctx: RunContext):
    """(train_step, state, specs) from the program, weights on the card."""
    from repro_torch.optim.optimizers import OptimizerConfig, build_optimizer
    from repro_torch.runtime.train import TrainConfig, make_train_step
    tr = ctx.cell.traffic
    mcfg = ctx.model_config()
    opt_cfg = OptimizerConfig(**_opt(tr))
    tcfg = TrainConfig(optimizer=opt_cfg, remat=tr["remat"],
                       z_loss_weight=tr["z_loss_weight"],
                       aux_loss_weight=tr["aux_loss_weight"])
    template, params = program_weights(ctx)
    specs = weights.leaf_specs(template)
    train_step, _ = make_train_step(mcfg, tcfg, ctx.device)
    state = {"params": params,
             "opt": build_optimizer(opt_cfg).init(params),
             "step": torch.zeros((), dtype=torch.int32, device=ctx.device)}
    return ctx.wrap("train_step", train_step), state, specs


def program_readings(ctx: RunContext, step_fn, state, specs):
    """Drive `state` through the check steps: (state, readings)."""
    tr, cfg = ctx.cell.traffic, ctx.cell.config
    b1 = tr["optimizer"]["b1"]
    losses, grad = [], None
    for i in range(tr["check_steps"]):
        state, m = step_fn(state, make_batch(ctx.seed, tr, cfg["vocab_size"],
                                             ctx.device, i))
        losses.append(float(m["loss"]))
        if grad is None:
            grad = {p: v / (1.0 - b1)
                    for p, v in leaf_norms(state["opt"]["mu"]).items()}
    change = changes(state["params"], specs, ctx.seed, ctx.device,
                     weights.residual_branches(cfg))
    return state, {"loss": losses, "grad": grad, "change": change}


def run(ctx: RunContext) -> Outcome:
    tr, cfg = ctx.cell.traffic, ctx.cell.config
    B, S, V = tr["batch"], tr["seq_len"], cfg["vocab_size"]
    marks = {"imports": ctx.since_start()}
    load_kernels(ctx.device)
    marks["kernels"] = ctx.since_start()
    step_fn, state, specs = build(ctx)
    marks["state"] = ctx.since_start()
    state, prog = program_readings(ctx, step_fn, state, specs)
    sync(ctx.device)
    setup_s = marks["first_steps"] = ctx.since_start()
    log("set-up, seconds from the process's start: " + ", ".join(
        f"{k} {v:.2f}" for k, v in marks.items()))

    call_s, box = [], {"state": state, "failed": 0}
    del state

    def one():
        i = tr["check_steps"] + len(call_s)
        batch = make_batch(ctx.seed, tr, V, ctx.device, i)
        t = time.perf_counter()
        box["state"], m = step_fn(box["state"], batch)
        loss = float(m["loss"])
        call_s.append(time.perf_counter() - t)
        box["failed"] += not math.isfinite(loss)

    trace, profiled = None, range(0)
    t0 = time.perf_counter()
    while True:
        if ctx.trace and trace is None and len(call_s) == TRACE_AT:
            at = len(call_s)
            trace = traced(one, tr["trace_calls"], ctx.on_card)
            profiled = range(at, len(call_s))
        else:
            one()
        end = time.perf_counter()
        if end - t0 >= ctx.seconds and (trace or not ctx.trace):
            break
    window_s = end - t0

    peak = torch.cuda.max_memory_allocated() if ctx.on_card else 0
    failed = box["failed"]
    del box
    if ctx.on_card:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref = reference_readings(cfg, tr, ctx.seed, specs, ctx.device)
    log(f"reference: {time.perf_counter() - t_ref:.1f} s; program losses "
        f"{prog['loss']}, reference {ref['loss']}; update_err over "
        f"{len(moving_leaves(ref['grad']))} of {len(ref['grad'])} leaves")
    n = len(call_s)
    return Outcome(
        host={"setup_s": setup_s,
              "train_tokens_per_s": n * B * S / window_s,
              "peak_mem_gib": peak / 2 ** 30},
        attempted=n, failed=int(failed),
        numbers=train_numbers(prog, ref), memory_peak_bytes=peak,
        call_s=call_s, flops_per_call=yardstick.train_flops(cfg, B, S),
        trace=trace, profiled=profiled)
