"""Critical-path extraction over a recorded `SimTrace` dependency DAG.

`repro_torch.sim.engine` records every transmission with its blocking edges
(`TraceEvent.deps`): the FIFO predecessor on the same server, the
channel-global quiesce a reuse zone queued behind, or — for an event
with no deps — the layer barrier.  Under the GEMINI execution model the
makespan is the sum of per-layer spans, and each layer's span is the
max over the compute / DRAM / NoC / wired-NoP / wireless terms; the
recorded trace carries all of them (coarse analytic spans for the
aggregate floors, per-packet events for the network planes).

The critical path is therefore assembled layer by layer: the event
whose completion realises the layer's span is the layer's *terminal*;
walking its dependency chain backwards (always to the latest-finishing
dependency) yields the blocking chain from the barrier to the terminal.
Each chain element is charged its *incremental* contribution — its end
minus the previous element's end — so the per-layer charges telescope
to exactly the layer span and the whole decomposition sums to the
makespan (pinned at rtol=1e-12 in tests/test_torch_critpath.py).

The headline observable is `critical_vs_busy`: the share of makespan
each plane *bounds* (critical share) against the share of busy-seconds
it *accumulates* (busy share).  A plane can be busy without ever being
binding — the divergence between the two rankings is what a load
balancer or a bandwidth-reallocation policy should act on (PAPERS.md:
2410.22262's characterization methodology, 2011.04107's agile
reallocation argument).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from .trace import SimTrace, TraceEvent

#: categories that can realise (bound) a layer span.  Raw per-port
#: ``dram`` events are EXCLUDED: under the pooled DRAM model the layer
#: term is the analytic aggregate (recorded as the ``dram-agg`` span),
#: and under the ports model the ``dram-agg`` span equals the max port
#: backlog — either way the agg span is the binding representative.
TERMINAL_CATS = ("compute", "noc", "dram-agg", "wired", "wireless")

#: cat -> plane label used by the share decompositions
PLANE_OF_CAT = {"wired": "wired", "wireless": "wireless",
                "dram": "dram", "dram-agg": "dram",
                "compute": "compute", "noc": "noc"}


def plane_of(cat: str) -> Optional[str]:
    """Plane label for a category (``an:`` analytic prefix stripped)."""
    if cat.startswith("an:"):
        cat = cat[3:]
    return PLANE_OF_CAT.get(cat)


@dataclasses.dataclass
class CritSegment:
    """One critical-path element and its incremental charge.

    ``crit_dur`` is the makespan attributed to this segment: its end
    minus the previous critical end (the layer barrier for a chain
    head).  It can be smaller than the event's own ``dur`` when the
    event overlapped its predecessor's tail, and equals the full layer
    span for a coarse analytic terminal (compute floor etc.).
    """

    eid: int
    track: str
    name: str
    cat: str
    layer: int
    ts: float
    dur: float
    crit_dur: float

    @property
    def plane(self) -> str:
        return plane_of(self.cat) or self.cat


@dataclasses.dataclass
class CriticalPath:
    """The blocking chain from t=0 to the makespan, layer by layer."""

    segments: List[CritSegment]
    makespan: float

    @property
    def total(self) -> float:
        """Sum of critical charges — equals ``makespan`` (rtol 1e-12)."""
        return sum(s.crit_dur for s in self.segments)

    def by_resource(self) -> Dict[str, float]:
        """Critical seconds per track, descending."""
        out: Dict[str, float] = {}
        for s in self.segments:
            out[s.track] = out.get(s.track, 0.0) + s.crit_dur
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))

    def by_plane(self) -> Dict[str, float]:
        """Critical seconds per plane, descending."""
        out: Dict[str, float] = {}
        for s in self.segments:
            out[s.plane] = out.get(s.plane, 0.0) + s.crit_dur
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))

    def critical_shares(self) -> Dict[str, float]:
        """Fraction of makespan each plane bounds (empty when zero)."""
        if not self.makespan:
            return {}
        return {p: v / self.makespan for p, v in self.by_plane().items()}

    def top_segments(self, n: int = 5) -> List[CritSegment]:
        """The ``n`` largest critical charges, descending."""
        return sorted(self.segments, key=lambda s: -s.crit_dur)[:n]


def _layer_geometry(st: SimTrace):
    """(starts, times) per layer, from `place_layers` metadata or — for
    a trace placed some other way — from the recorded layer spans."""
    starts = st.meta.get("layer_starts")
    times = st.meta.get("layer_times")
    if starts is not None and times is not None:
        return list(starts), list(times)
    windows = st.layer_windows()
    if not windows:
        return [], []
    L = max(windows) + 1
    starts = [windows.get(li, (0.0, 0.0))[0] for li in range(L)]
    times = [windows.get(li, (0.0, 0.0))[1] for li in range(L)]
    return starts, times


def critical_path(st: SimTrace) -> CriticalPath:
    """Extract the critical path of one recorded run.

    Degenerate traces follow the repo-wide empty-structure convention:
    zero events (or zero makespan) yield an empty segment list, never
    an exception.
    """
    starts, times = _layer_geometry(st)
    if not st.events or not times:
        return CriticalPath([], 0.0)

    by_eid: Dict[int, TraceEvent] = {}
    candidates: Dict[int, List[TraceEvent]] = {}
    for ev in st.events:
        if ev.eid >= 0:
            by_eid[ev.eid] = ev
        cat = ev.cat[3:] if ev.cat.startswith("an:") else ev.cat
        if cat in TERMINAL_CATS and ev.layer >= 0:
            candidates.setdefault(ev.layer, []).append(ev)

    segments: List[CritSegment] = []
    for li, (lt, ls) in enumerate(zip(times, starts)):
        evs = candidates.get(li)
        if not evs or lt <= 0.0:
            continue
        # terminal: the latest-finishing candidate realises the span.
        # Ties (e.g. the compute floor matching a drained queue) go to
        # the earliest-recorded event, which favours the coarse span —
        # a one-segment chain — over an equal-length queue replay.
        terminal = max(evs, key=lambda e: (e.end, -e.eid))
        chain: List[TraceEvent] = []
        ev: Optional[TraceEvent] = terminal
        seen = set()
        while ev is not None and ev.eid not in seen:
            chain.append(ev)
            seen.add(ev.eid)
            preds = [by_eid[d] for d in ev.deps if d in by_eid]
            ev = max(preds, key=lambda e: e.end) if preds else None
        chain.reverse()
        # incremental charges telescope: they sum to terminal.end - ls,
        # and the terminal realises the span, so the layer's charges
        # sum to the layer time exactly
        prev_end = ls
        for ev in chain:
            segments.append(CritSegment(
                eid=ev.eid, track=ev.track, name=ev.name, cat=ev.cat,
                layer=li, ts=ev.ts, dur=ev.dur,
                crit_dur=ev.end - prev_end))
            prev_end = ev.end
    return CriticalPath(segments, float(sum(times)))


def busy_shares(st: SimTrace) -> Dict[str, float]:
    """Fraction of total busy-seconds accumulated per plane."""
    busy: Dict[str, float] = {}
    for ev in st.events:
        plane = plane_of(ev.cat)
        if plane is not None:
            busy[plane] = busy.get(plane, 0.0) + ev.dur
    total = sum(busy.values())
    if not total:
        return {}
    return dict(sorted(((p, v / total) for p, v in busy.items()),
                       key=lambda kv: -kv[1]))


def critical_vs_busy(st: SimTrace,
                     cp: Optional[CriticalPath] = None) -> Dict[str, object]:
    """The headline divergence: what is *binding* vs what is *busy*.

    Returns ``{"critical": {plane: share}, "busy": {plane: share},
    "divergence": total-variation distance}``.  A divergence of 0 means
    busy time is a faithful proxy for end-to-end impact; large values
    mean a utilization-driven balancer would optimise the wrong plane.
    """
    cp = cp if cp is not None else critical_path(st)
    crit = cp.critical_shares()
    busy = busy_shares(st)
    planes = set(crit) | set(busy)
    div = 0.5 * sum(abs(crit.get(p, 0.0) - busy.get(p, 0.0))
                    for p in planes)
    return {"critical": crit, "busy": busy, "divergence": div}


def mark_critical(st: SimTrace,
                  cp: Optional[CriticalPath] = None) -> CriticalPath:
    """Flag critical events in-place (``ev.args["critical"] = True``).

    `repro_torch.obs.export.chrome_trace_events` renders flagged events as a
    distinct "critpath" Perfetto process so the blocking chain reads as
    one swim-lane.  Returns the (possibly freshly computed) path.
    """
    cp = cp if cp is not None else critical_path(st)
    on_path = {s.eid for s in cp.segments}
    for ev in st.events:
        if ev.eid in on_path:
            ev.args["critical"] = True
    return cp
