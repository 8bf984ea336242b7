"""One run of one cell: the kind's driver, the decision on `correct`,
the metrics the cell reports, and the result's line.

`run_cell` takes the device it is given and does not look for a card
(`run.py` does); tests run it on the CPU at reduced sizes, and wrap the
program's timed entry through `RunContext.wrap` to plant faults.
"""

from __future__ import annotations

import dataclasses
import importlib
import math
import sys
import time
from typing import Callable, Dict, List, Optional

import torch

from . import spec, weights
from .compare import judge
from .trace import Trace

#: top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


@dataclasses.dataclass
class RunContext:
    cell: spec.Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    started: float                        # the process's start, time.time()
    wrap: Callable[[str, Callable], Callable] = lambda name, fn: fn

    def model_config(self):
        from repro_torch.configs.base import ModelConfig
        fields = {f.name for f in dataclasses.fields(ModelConfig)}
        return ModelConfig(**{k: v for k, v in self.cell.config.items()
                              if k in fields})

    def since_start(self) -> float:
        return time.time() - self.started

    @property
    def on_card(self) -> bool:
        return torch.device(self.device).type == "cuda"


@dataclasses.dataclass
class Outcome:
    host: Dict[str, float]          # end-to-end values by metric name
    attempted: int
    failed: int
    numbers: Dict[str, float]       # the numbers `correct` compares
    memory_peak_bytes: int
    call_s: List[float]             # host seconds of each window call
    flops_per_call: float           # model FLOPs of one call (yardstick)
    trace: Optional[Trace] = None
    profiled: range = range(0)      # the window's calls the profiler ran

    def untraced_s(self) -> List[float]:
        """Host seconds of the window's calls outside the profiler."""
        return [s for i, s in enumerate(self.call_s)
                if i not in self.profiled]


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def load_kernels(device) -> None:
    """Build (on a checkout's first run) and load the port's kernels."""
    if torch.device(device).type != "cuda":
        return
    from repro_torch.kernels._build import build_all, load
    names = ("flash_attention", "rmsnorm", "ssd")
    build_all(names)
    for n in names:
        load(n)


def program_weights(ctx: RunContext):
    """(the program's parameter tree on the meta device, the same tree
    with every leaf drawn from the seed on the run's device)."""
    from repro_torch.models import build_model
    template = build_model(ctx.model_config(), device="meta").init(
        torch.Generator())
    return template, weights.draw(template, ctx.seed, ctx.device,
                                  weights.residual_branches(ctx.cell.config))


def device_line(ctx: RunContext, peak: int) -> dict:
    if ctx.on_card:
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": ctx.cell.chips, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": ctx.cell.chips,
            "memory_peak_bytes": int(peak)}


def breakdown(tr: Trace) -> dict:
    top = sorted(tr.by_name().items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(tr.idle_by_host().items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:200], us / 1e6] for n, us in top],
            "idle_gaps": [[n[:200], us / 1e6] for n, us in idle]}


def run_cell(ctx: RunContext) -> dict:
    """The result's line (a dict) of one run."""
    kind = importlib.import_module(
        f"portbench.kinds.{ctx.cell.traffic['kind']}")
    out: Outcome = kind.run(ctx)
    correct, rows = judge(out.numbers, ctx.cell.limits)
    metrics = {}
    if not ctx.trace:
        for m in ctx.cell.end_to_end:
            metrics[m["name"]] = {"value": out.host[m["name"]],
                                  "unit": m["unit"]}
    else:
        for m in ctx.cell.per_layer:
            value = spec.reader(m["name"])(ctx.cell, out)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": bool(correct and out.failed == 0),
            "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics,
            "device": device_line(ctx, out.memory_peak_bytes)}
    if ctx.trace and out.trace is not None:
        line["device"]["busy_s"] = out.trace.busy_us / 1e6
        line["device"]["window_s"] = out.trace.window_us / 1e6
        line["breakdown"] = breakdown(out.trace)
    for name in sorted(set(out.numbers) - set(ctx.cell.limits)):
        log(f"reading (not compared) {name} {out.numbers[name]!r}")
    line["checks"] = {name: {"value": value if math.isfinite(value)
                             else str(value), "limit": limit}
                      for name, value, limit in rows}
    return line
