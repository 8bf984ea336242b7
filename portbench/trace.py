"""Reading the profiler's trace of a traced stretch of calls.

A `--trace 1` run profiles a stretch inside its measured window, from
the window's call `TRACE_AT` on, so that the traced calls run in the
window's own steady state.  `traced(run, calls)` runs `run` `calls`
times under torch.profiler (CPU and CUDA activities), after one call
the profiler runs through but keeps nothing of, inside a named range
that ends with a synchronise, so that the range's host interval covers
every device operation the calls queued.  `Trace` holds what the per-layer readers and the result's
`breakdown` need: each device operation's name and interval, the device
time under each host operator by name, the window, the union of the
device intervals (`busy_us`, copied from the program's
`launch/profile.py: _busy_us`), and the idle gaps between device
operations with what the host was doing in each.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Callable, Dict, List, Tuple

import torch

WINDOW = "portbench.traced_window"
#: the window's calls before the profiler starts
TRACE_AT = 2


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy


def gaps(intervals, start: float, end: float) -> List[Tuple[float, float]]:
    """The stretches of [start, end] that no interval covers."""
    out, at = [], start
    for a, b in sorted(intervals):
        if a > at:
            out.append((at, min(a, end)))
        at = max(at, b)
        if at >= end:
            break
    if at < end:
        out.append((at, end))
    return [(a, b) for a, b in out if b > a]


@dataclasses.dataclass
class Trace:
    calls: int
    window_us: float
    device: List[Tuple[str, float, float]]     # (name, start, end) in us
    host_ops: List[Tuple[str, float, float]]   # top-level host operators
    device_us_under: Dict[str, float]          # host op name -> device us
    on_card: bool = True

    @property
    def busy_us(self) -> float:
        return busy_us([(a, b) for _, a, b in self.device])

    def device_us(self, match: Callable[[str], bool]) -> float:
        return sum(b - a for n, a, b in self.device if match(n))

    def by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for n, a, b in self.device:
            out[n] = out.get(n, 0.0) + b - a
        return out

    def idle_by_host(self) -> Dict[str, float]:
        """Idle device time by the host operator running at each gap's
        start ("host: python" where none ran)."""
        if not self.device:
            return {}
        start = min(a for _, a, _ in self.host_ops) if self.host_ops else \
            min(a for _, a, _ in self.device)
        end = max(b for _, _, b in self.device)
        starts = [a for _, a, _ in self.host_ops]
        out: Dict[str, float] = {}
        for a, b in gaps([(x, y) for _, x, y in self.device], start, end):
            i = bisect.bisect_right(starts, a) - 1
            name = "host: python"
            if i >= 0 and self.host_ops[i][2] >= a:
                name = "host: " + self.host_ops[i][0]
            out[name] = out.get(name, 0.0) + b - a
        return out


def traced(run: Callable[[], None], calls: int, on_card: bool) -> Trace:
    """Trace `calls` calls of `run` after one call that the profiler runs
    through but keeps nothing of: the profiler's own start-up and the
    memory it takes on the card settle there, not in the traced calls."""
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    kept = []
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: kept.append(p.events())) as prof:
        run()
        if on_card:
            torch.cuda.synchronize()
        prof.step()
        with record_function(WINDOW):
            for _ in range(calls):
                run()
            if on_card:
                torch.cuda.synchronize()
        prof.step()
    return read(kept[0], calls, on_card)


def read(events, calls: int, on_card: bool) -> Trace:
    cpu = torch.autograd.DeviceType.CPU
    kind = torch.autograd.DeviceType.CUDA if on_card else cpu
    w0 = w1 = None
    device, host, under = [], [], {}
    for e in events:
        if e.name == WINDOW and e.device_type == cpu:
            w0, w1 = e.time_range.start, e.time_range.end
    for e in events:
        if e.is_user_annotation:      # a named range, not an operation
            continue
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == kind and on_card:
            device.append((e.name, a, b))
            continue
        if e.device_type != cpu:
            continue
        parent = e.cpu_parent
        while parent is not None and parent.is_user_annotation:
            parent = parent.cpu_parent
        if parent is None:
            host.append((e.name, a, b))
            if not on_card:       # on the CPU the host operators are the work
                device.append((e.name, a, b))
        if on_card:
            under[e.name] = under.get(e.name, 0.0) + e.device_time_total
    host.sort(key=lambda t: t[1])
    if w0 is None:
        w0 = min((a for _, a, _ in device), default=0.0)
        w1 = max((b for _, _, b in device), default=0.0)
    device = [(n, max(a, w0), min(b, w1)) for n, a, b in device
              if b > w0 and a < w1]
    return Trace(calls, w1 - w0, device, host, under, on_card)
