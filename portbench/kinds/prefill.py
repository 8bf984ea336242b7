"""Prefill: a closed loop of the program's batched prefill
(`runtime/serve.py: make_serve_fns`), one client sending a batch of new
prompts as soon as the last one's next tokens are on the host.

Each prefill is timed from handing its batch to `prefill` until the
argmax of its last position's logits is on the host: the time to first
token of a request on an idle server.  The window runs until the first
prefill that ends after `seconds`; a traced run profiles a stretch of
it (`trace.TRACE_AT`).  After it, a sample of the window's
prefills, drawn from the seed, is run again by the plain reference, and
the served tokens and logits are held to the reference's.
"""

from __future__ import annotations

import math
import time

import torch

from .. import weights, yardstick
from ..compare import per_prompt, prefill_numbers
from ..harness import (Outcome, RunContext, load_kernels, log,
                       program_weights, sync)
from ..reference import decoder
from ..trace import TRACE_AT, traced


def prompts(seed: int, traffic: dict, vocab: int, device, i: int):
    return weights.tokens(seed, 1, i, (traffic["batch"], traffic["seq_len"]),
                          vocab, device)


def sample(seed: int, n: int, k: int) -> list:
    g = torch.Generator().manual_seed(weights.mix(seed, 3))
    return sorted(torch.randperm(n, generator=g)[:k].tolist())


def reference_logits(params, cfg: dict, tokens, mm=decoder.exact_matmul):
    decoder.setup_float32()
    with torch.no_grad():
        return decoder.forward(params, tokens.long(), cfg, mm=mm,
                               last_only=True)


def build(ctx: RunContext):
    from repro_torch.runtime.serve import ServeConfig, make_serve_fns
    _, params = program_weights(ctx)
    prefill, _, _ = make_serve_fns(
        ctx.model_config(), ServeConfig(max_len=ctx.cell.traffic["seq_len"]),
        ctx.device)
    return ctx.wrap("prefill", prefill), params


def run(ctx: RunContext) -> Outcome:
    tr, cfg = ctx.cell.traffic, ctx.cell.config
    B, S, V = tr["batch"], tr["seq_len"], cfg["vocab_size"]
    marks = {"imports": ctx.since_start()}
    load_kernels(ctx.device)
    marks["kernels"] = ctx.since_start()
    prefill, params = build(ctx)
    marks["weights"] = ctx.since_start()

    def serve(i):
        batch = {"tokens": prompts(ctx.seed, tr, V, ctx.device, i)}
        t = time.perf_counter()
        last = prefill(params, batch)
        served = torch.argmax(last, dim=-1).cpu()
        return time.perf_counter() - t, last, served

    for i in range(tr["warm_calls"]):
        serve(-1 - i)
    sync(ctx.device)
    setup_s = marks["warm_calls"] = ctx.since_start()
    log("set-up, seconds from the process's start: " + ", ".join(
        f"{k} {v:.2f}" for k, v in marks.items()))

    call_s, kept, failed = [], [], 0

    def one():
        dt, last, served = serve(len(call_s))
        call_s.append(dt)
        kept.append((last.clone(), served))

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
    for last, _ in kept:
        failed += not bool(torch.isfinite(last).all())

    t_ref = time.perf_counter()
    pairs = []
    for i in sample(ctx.seed, len(call_s), tr["check_prefills"]):
        ref = reference_logits(params, cfg, prompts(ctx.seed, tr, V,
                                                    ctx.device, i))
        pairs.append((kept[i][0], kept[i][1], ref))
    gaps, errs = per_prompt(pairs)
    log(f"reference: {len(pairs)} prefills in "
        f"{time.perf_counter() - t_ref:.1f} s; each prompt's logit error, "
        f"largest first: {sorted(errs, reverse=True)}; its top gap: {gaps}")
    ms = sorted(s * 1e3 for s in call_s)
    n = len(call_s)
    return Outcome(
        host={"setup_s": setup_s,
              "prefill_tokens_per_s": n * B * S / window_s,
              "prefill_ms_p95": ms[max(0, math.ceil(0.95 * n) - 1)],
              "peak_mem_gib": peak / 2 ** 30},
        attempted=n * B, failed=failed * B,
        numbers=prefill_numbers(pairs, tr["spared_prompts"]),
        memory_peak_bytes=peak,
        call_s=call_s, flops_per_call=yardstick.prefill_flops(cfg, B, S),
        trace=trace, profiled=profiled)
