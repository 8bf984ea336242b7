"""`SimTrace`: the time-resolved event recorder shared by all planes.

A trace is a flat list of `TraceEvent`s — one per transmission served
on one resource — plus counter samples and free-form metadata.  Tracks
are resource names; the repo-wide naming convention is

- ``cut{c}``            a mesh cut's striped link bundle (striped model)
- ``cut{c}/l{j}``       parallel slot ``j`` of cut ``c`` (adaptive model)
- ``link{i}``           one directed mesh link (xy model)
- ``ch{c}``             a wireless channel (no spatial reuse)
- ``ch{c}/z{z}``        reuse zone ``z``'s server of channel ``c``
- ``ch{c}/g``           channel ``c``'s global (beyond-reuse-distance)
  phase, which quiesces every zone of the channel
- ``dram{d}``           one DRAM module's port
- ``compute`` / ``noc`` / ``dram(pooled)``   the analytic per-layer
  aggregate floors (package-level, as the GEMINI model costs them)
- ``layers``            one span per layer, named ``L{i}:{bottleneck}``
- ``balance``           the balancer's per-layer stitch decision

Categories (`TraceEvent.cat`) group tracks into planes: ``wired``,
``wireless``, ``dram``, ``compute``, ``noc``, ``dram-agg``, ``layer``,
``balancer``.  Analytic emitters reuse the same tracks with an
``an:`` category prefix (``an:wireless`` ...), so an event-engine
trace and an analytic trace of the same run line up track-for-track
when merged into one Perfetto view.

Both the event engine and the analytic plane know event times only
*relative to their layer's start* until all per-layer maxima are in;
`add_layer_event` therefore records pending (layer, offset) events and
`place_layers(layer_times)` shifts them onto the absolute timeline
under the GEMINI barrier (layer ``l`` starts when layer ``l-1``
drains).

The **active recorder** is how the analytic plane records without
threading a parameter through every signature: ``with recording(st):``
installs ``st``; `repro_torch.net.stack` and `repro_torch.core.balancer`
emit coarse spans into it when present (and suppress their internal
trial evaluations with ``recording(None)``).  When no recorder is
installed the emitters cost one ``None`` check.

The store stays on the host: events in Python lists, counters in
NumPy.  `add_layer_matrix` and `place_layers` also take tensors on any
device and copy each one to the host once a call, never element by
element (one wait for the card a call, not one per element).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

#: resource-plane categories an event-engine trace uses
RESOURCE_CATS = ("wired", "wireless", "dram")


@dataclasses.dataclass
class TraceEvent:
    """One transmission served on one resource (begin + duration).

    ``eid`` is the event's id within its trace (assigned by the
    recorder, dense from 0); ``deps`` lists the eids of the events
    whose completion gates this event's begin — the FIFO predecessor
    on the same server, the channel-global transmission a reuse zone
    queued behind, or the zone transmissions a global quiesce waited
    out.  An event with no deps begins at its layer's barrier.  The
    dependency DAG these edges span is what `repro_torch.obs.critpath`
    walks to extract the critical path.
    """

    track: str
    name: str
    ts: float                 # seconds, absolute (post `place_layers`)
    dur: float                # seconds
    cat: str = ""
    layer: int = -1
    args: dict = dataclasses.field(default_factory=dict)
    eid: int = -1
    deps: List[int] = dataclasses.field(default_factory=list)

    @property
    def end(self) -> float:
        return self.ts + self.dur


def host_array(x) -> np.ndarray:
    """A host float64 NumPy array of ``x`` (a tensor on any device is
    copied once)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, float)


class SimTrace:
    """Recorder: events + counters + metadata for one run."""

    def __init__(self, label: str = "sim"):
        self.label = label
        self.events: List[TraceEvent] = []
        # counter track -> [(ts, value)] samples
        self.counters: Dict[str, List[Tuple[float, float]]] = {}
        self.meta: dict = {}
        self._pending: List[TraceEvent] = []
        self._next_eid = 0

    # ------------------------------------------------------------------
    # recording
    # ------------------------------------------------------------------

    def _new_event(self, track, name, ts, dur, cat, layer, deps,
                   args) -> TraceEvent:
        ev = TraceEvent(track, name, float(ts), float(dur), cat,
                        int(layer), args, self._next_eid,
                        [int(d) for d in deps] if deps else [])
        self._next_eid += 1
        return ev

    def add(self, track: str, name: str, ts: float, dur: float,
            cat: str = "", layer: int = -1, deps=(), **args) -> int:
        """One absolutely-placed event; returns its eid."""
        ev = self._new_event(track, name, ts, dur, cat, layer, deps, args)
        self.events.append(ev)
        return ev.eid

    def add_layer_event(self, track: str, name: str, layer: int,
                        rel_start: float, dur: float, cat: str = "",
                        deps=(), **args) -> int:
        """One event at ``rel_start`` seconds after its layer's start.

        Pending until `place_layers` supplies the per-layer maxima that
        fix the layer starts.  Returns the event's eid so emitters can
        thread it into successors' ``deps``.
        """
        ev = self._new_event(track, name, rel_start, dur, cat, layer,
                             deps, args)
        self._pending.append(ev)
        return ev.eid

    def add_layer_matrix(self, mat, fmt: str, cat: str,
                         name: str = "span") -> None:
        """Pending spans from a (n_layers, n_tracks) duration matrix
        (an array, or a tensor on any device, copied to the host once).

        Column ``c`` goes to track ``fmt.format(c)``; zero durations
        are skipped.  The coarse-span form the analytic plane emits.
        """
        mat = host_array(mat)
        lay, col = np.nonzero(mat)
        for li, c in zip(lay, col):
            self.add_layer_event(fmt.format(c), name, int(li), 0.0,
                                 float(mat[li, c]), cat)

    def add_counter(self, track: str, ts: float, value: float) -> None:
        self.counters.setdefault(track, []).append((float(ts),
                                                    float(value)))

    def place_layers(self, layer_times) -> None:
        """Shift pending layer-relative events onto the barrier timeline.

        A degenerate call — zero layers, or pending events whose layer
        index is beyond ``layer_times`` — leaves those events at their
        relative offsets instead of raising (the empty-structure
        convention shared with `busy_by_resource` and
        `repro_torch.obs.metrics.utilization_timeline`).
        """
        layer_times = host_array(layer_times)
        starts = np.concatenate([[0.0], np.cumsum(layer_times)[:-1]]) \
            if layer_times.size else np.zeros(0)
        for ev in self._pending:
            if 0 <= ev.layer < len(starts):
                ev.ts += float(starts[ev.layer])
            self.events.append(ev)
        self._pending.clear()
        self.meta["layer_starts"] = starts.tolist()
        self.meta["layer_times"] = layer_times.tolist()

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------

    def tracks(self, cat: Optional[str] = None) -> List[str]:
        seen: Dict[str, None] = {}
        for ev in self.events:
            if cat is None or ev.cat == cat:
                seen.setdefault(ev.track, None)
        return list(seen)

    def busy_time(self, cat: Optional[str] = None) -> Dict[str, float]:
        """Integrated busy-seconds per track (sum of event durations)."""
        out: Dict[str, float] = {}
        for ev in self.events:
            if cat is None or ev.cat == cat:
                out[ev.track] = out.get(ev.track, 0.0) + ev.dur
        return out

    def busy_by_resource(self, cat: str, n: int,
                         prefix: str) -> np.ndarray:
        """(n,) busy-seconds keyed by the integer after ``prefix``.

        Aggregates sub-tracks — ``ch0/z1`` and ``ch0/g`` both fold into
        channel 0, ``cut2/l1`` into cut 2 — so the result is directly
        comparable to `EventResult.cut_busy` / ``channel_busy`` /
        ``dram_busy``.  Tracks that do not parse to an id in
        ``[0, n)`` are skipped (an empty or foreign trace yields
        zeros, never an exception).
        """
        out = np.zeros(n)
        for track, busy in self.busy_time(cat).items():
            head = track.split("/", 1)[0]
            if head.startswith(prefix):
                tail = head[len(prefix):]
                if tail.isdigit() and int(tail) < n:
                    out[int(tail)] += busy
        return out

    def span(self) -> Tuple[float, float]:
        """(first begin, last end) over all events."""
        if not self.events:
            return 0.0, 0.0
        t0 = min(ev.ts for ev in self.events)
        t1 = max(ev.ts + ev.dur for ev in self.events)
        return t0, t1

    def layer_windows(self) -> Dict[int, Tuple[float, float]]:
        """layer -> (start, duration), from the ``layer`` spans."""
        return {ev.layer: (ev.ts, ev.dur) for ev in self.events
                if ev.cat == "layer"}

    # ------------------------------------------------------------------
    # derived counter tracks
    # ------------------------------------------------------------------

    def derive_queue_counters(
            self, cats: Iterable[str] = RESOURCE_CATS) -> None:
        """Queue-depth samples per plane at each event-calendar pop.

        Every packet of a layer enqueues at the layer's start (the
        GEMINI barrier), so the plane's queue depth jumps to the layer's
        packet count there and steps down at each completion.
        """
        windows = self.layer_windows()
        for cat in cats:
            evs = [ev for ev in self.events if ev.cat == cat]
            if not evs:
                continue
            track = f"q:{cat}"
            per_layer: Dict[int, List[TraceEvent]] = {}
            for ev in evs:
                per_layer.setdefault(ev.layer, []).append(ev)
            for li, levs in sorted(per_layer.items()):
                start = windows.get(li, (min(e.ts for e in levs), 0.0))[0]
                depth = len(levs)
                self.add_counter(track, start, depth)
                for end in sorted(e.ts + e.dur for e in levs):
                    depth -= 1
                    self.add_counter(track, end, depth)
            self.counters[track].sort()

    def derive_utilization_counters(
            self, cats: Iterable[str] = RESOURCE_CATS) -> None:
        """Per-resource occupancy fraction, sampled once per layer."""
        windows = self.layer_windows()
        busy: Dict[Tuple[str, int], float] = {}
        for ev in self.events:
            if ev.cat in cats:
                key = (ev.track, ev.layer)
                busy[key] = busy.get(key, 0.0) + ev.dur
        for (track, li), b in sorted(busy.items()):
            start, dur = windows.get(li, (0.0, 0.0))
            self.add_counter(f"util:{track}", start, b / dur if dur else 0.0)

    def __len__(self) -> int:
        return len(self.events)


# ---------------------------------------------------------------------------
# active-recorder context (the analytic plane's hook)
# ---------------------------------------------------------------------------

_STACK: List[Optional[SimTrace]] = []


def active_recorder() -> Optional[SimTrace]:
    """The innermost installed recorder, or None (also when masked)."""
    return _STACK[-1] if _STACK else None


@contextlib.contextmanager
def recording(st: Optional[SimTrace]):
    """Install ``st`` as the active recorder for the block.

    ``recording(None)`` masks an outer recorder — the balancer uses it
    around trial evaluations so only the final timeline is emitted.
    """
    _STACK.append(st)
    try:
        yield st
    finally:
        _STACK.pop()
