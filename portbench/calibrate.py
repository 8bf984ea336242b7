"""Readings that set a cell's limits: the program, the control and the
faults against the reference, over several seeds in one process.

    python3 -m portbench.calibrate --workload <name> --seeds 1,2,3 \
        [--control] [--faults] [--out FILE]

For each seed it prints one JSON line: the numbers `correct` compares
for the program (the lower readings), and with `--control` for the
reference computed with its weight products in float8 (`reference/
lowp.py`) put in the program's place, and with `--faults` (training
cells) for the program trained on half of each batch, the mean taken
over the rest.  A state left unchanged reads 1 on `grad_err` and
`update_err` by their definition and needs no run.  No window is
measured: training's readings come from the first steps, a prefill's
from the mix's `check_prefills` prefills run back to back at the cell's
size.  The benchmark's own runs never run this; it needs the cells'
card(s).
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import torch  # noqa: E402

from portbench import spec  # noqa: E402
from portbench.compare import (per_prompt, prefill_numbers,  # noqa: E402
                               train_numbers)
from portbench.harness import RunContext, load_kernels  # noqa: E402
from portbench.kinds import prefill as pf  # noqa: E402
from portbench.kinds import train as tn  # noqa: E402
from portbench.reference.lowp import fp8_matmul  # noqa: E402


def half_batch(name, fn):
    """The fault: the step sees the first half of each batch's rows."""
    if name != "train_step":
        return fn

    def step(state, batch):
        half = batch["tokens"].shape[0] // 2
        return fn(state, {k: v[:half] for k, v in batch.items()})
    return step


def train_seed(cell, seed, device, control, faults) -> dict:
    out = {}
    ctx = RunContext(cell=cell, seed=seed, seconds=0, trace=False,
                     device=device, started=time.time())
    step_fn, state, specs = tn.build(ctx)
    t = time.perf_counter()
    state, prog = tn.program_readings(ctx, step_fn, state, specs)
    out["program_s"] = time.perf_counter() - t
    del state
    if faults:
        ctx.wrap = half_batch
        step_fn, state, _ = tn.build(ctx)
        state, half = tn.program_readings(ctx, step_fn, state, specs)
        del state
    torch.cuda.empty_cache()
    t = time.perf_counter()
    ref = tn.reference_readings(cell.config, cell.traffic, seed, specs,
                                device)
    out["reference_s"] = time.perf_counter() - t
    out["program"] = train_numbers(prog, ref)
    out["losses"] = {"program": prog["loss"], "reference": ref["loss"]}
    if faults:
        out["half_batch"] = train_numbers(half, ref)
    if control:
        low = tn.reference_readings(cell.config, cell.traffic, seed, specs,
                                    device, mm=fp8_matmul)
        out["control"] = train_numbers(low, ref)
    return out


def prefill_seed(cell, seed, device, control) -> dict:
    tr, cfg = cell.traffic, cell.config
    ctx = RunContext(cell=cell, seed=seed, seconds=0, trace=False,
                     device=device, started=time.time())
    prefill, params = pf.build(ctx)
    kept = []
    t = time.perf_counter()
    with torch.no_grad():
        for i in range(tr["check_prefills"]):
            last = prefill(params, {"tokens": pf.prompts(
                seed, tr, cfg["vocab_size"], device, i)})
            kept.append((last.clone(), torch.argmax(last, -1).cpu()))
            del last
    out = {"program_s": time.perf_counter() - t}
    t = time.perf_counter()
    prog, low = [], []
    for i, (logits, served) in enumerate(kept):
        tokens = pf.prompts(seed, tr, cfg["vocab_size"], device, i)
        ref = pf.reference_logits(params, cfg, tokens)
        prog.append((logits, served, ref))
        if control:
            c = pf.reference_logits(params, cfg, tokens, mm=fp8_matmul)
            low.append((c, torch.argmax(c, -1).cpu(), ref))
    out["reference_s"] = time.perf_counter() - t
    out["program"] = prefill_numbers(prog, tr["spared_prompts"])
    out["per_prompt"] = {"program": per_prompt(prog)}
    if control:
        out["control"] = prefill_numbers(low, tr["spared_prompts"])
        out["per_prompt"]["control"] = per_prompt(low)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cell = spec.cell(spec.load(ROOT), args.workload, ROOT)
    device = "cuda"
    load_kernels(device)
    sink = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        if cell.traffic["kind"] == "train":
            row = train_seed(cell, seed, device, args.control, args.faults)
        else:
            row = prefill_seed(cell, seed, device, args.control)
        row = dict(workload=cell.name, seed=seed,
                   seconds=time.perf_counter() - t,
                   card=torch.cuda.get_device_name(0), **row)
        line = json.dumps(row)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
