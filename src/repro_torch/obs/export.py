"""Export a `SimTrace` to Chrome Trace Event Format JSON and ``.npz``.

The JSON form (https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU)
opens directly in Perfetto (https://ui.perfetto.dev) or
``chrome://tracing``: one process per plane (layers / compute / wired
NoP / wireless / DRAM / ...), one thread per resource track, complete
("X") events per transmission, and counter ("C") tracks for queue
depth, per-resource utilization, and per-plane injected bytes.
Timestamps are microseconds (the format's unit) as float64 — Perfetto
renders nanosecond-scale durations fine.

The ``.npz`` form is the lossless programmatic counterpart: raw
float64 seconds, columnar arrays, `load_npz` round-trips exactly
(pinned in tests/test_torch_obs.py).
"""

from __future__ import annotations

import json
from typing import Dict, List, Union

import numpy as np

from repro_torch.units import s_to_us

from .trace import SimTrace, TraceEvent

# plane -> process id (Perfetto sorts by pid; layers on top)
_PLANE_PIDS = {
    "layer": 0, "compute": 1, "noc": 2, "dram-agg": 3,
    "wired": 4, "wireless": 5, "dram": 6, "balancer": 7,
}
_CRIT_PID = 8             # critical-path swim-lane (obs.critpath marks)
_COUNTER_PID = 9
_OTHER_PID = 10           # unrecognised planes (was colliding with
#                           the counter pid when it was len(_PLANE_PIDS))
_FRAMEWORK_PID = 11       # self-profiling phases (obs.profile.to_trace):
#                           the framework's own wall time renders as its
#                           own process under the simulated-time planes
_PLANE_PIDS["framework"] = _FRAMEWORK_PID
_PID_STRIDE = 16          # per-trace offset when merging several traces


def _plane(cat: str) -> str:
    """Fold analytic categories onto their plane (``an:wireless`` ...)."""
    return cat.split(":", 1)[1] if cat.startswith("an:") else cat


def chrome_trace_events(
        traces: Union[SimTrace, Dict[str, SimTrace]]) -> dict:
    """The Chrome Trace Event JSON object for one or several traces.

    A dict merges multiple traces (e.g. ``{"event": ev.trace,
    "analytic": st}``) into one view with per-trace process groups, so
    analytic vs event discrepancies are visually diffable track by
    track.
    """
    if isinstance(traces, SimTrace):
        traces = {traces.label: traces}
    events: List[dict] = []
    for gi, (glabel, st) in enumerate(traces.items()):
        base = gi * _PID_STRIDE
        tids: Dict[tuple, int] = {}
        pids_used: Dict[int, str] = {}

        def tid_of(pid: int, track: str) -> int:
            key = (pid, track)
            if key not in tids:
                tids[key] = len([k for k in tids if k[0] == pid]) + 1
                events.append({"ph": "M", "pid": pid, "tid": tids[key],
                               "name": "thread_name",
                               "args": {"name": track}})
            return tids[key]

        def pid_of(plane: str, pid_override: int | None = None) -> int:
            pid = base + (_PLANE_PIDS.get(plane, _OTHER_PID)
                          if pid_override is None else pid_override)
            if pid not in pids_used:
                pids_used[pid] = plane
                events.append({"ph": "M", "pid": pid, "name": "process_name",
                               "args": {"name": f"{glabel}: {plane}"}})
                events.append({"ph": "M", "pid": pid,
                               "name": "process_sort_index",
                               "args": {"sort_index": pid}})
            return pid

        for ev in st.events:
            pid = pid_of(_plane(ev.cat) or "other")
            args = dict(ev.args)
            if ev.layer >= 0:
                args["layer"] = ev.layer
            events.append({
                "ph": "X", "name": ev.name, "cat": ev.cat or "event",
                "pid": pid, "tid": tid_of(pid, ev.track),
                "ts": s_to_us(ev.ts), "dur": s_to_us(ev.dur),
                "args": args,
            })
            if ev.args.get("critical"):
                # mirror onto the critical-path process so the blocking
                # chain (obs.critpath.mark_critical) reads as one
                # swim-lane in Perfetto
                crit = pid_of("critpath", _CRIT_PID)
                events.append({
                    "ph": "X", "name": f"{ev.name}@{ev.track}",
                    "cat": "critpath", "pid": crit,
                    "tid": tid_of(crit, "critical path"),
                    "ts": s_to_us(ev.ts), "dur": s_to_us(ev.dur),
                    "args": args,
                })
        cpid = base + _COUNTER_PID
        for track, samples in sorted(st.counters.items()):
            if samples and cpid not in pids_used:
                pids_used[cpid] = "counters"
                events.append({"ph": "M", "pid": cpid,
                               "name": "process_name",
                               "args": {"name": f"{glabel}: counters"}})
            for ts, value in samples:
                events.append({"ph": "C", "name": track, "pid": cpid,
                               "tid": 0, "ts": s_to_us(ts),
                               "args": {"value": value}})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {lbl: st.meta for lbl, st in traces.items()}}


def export_chrome_trace(traces: Union[SimTrace, Dict[str, SimTrace]],
                        path: str) -> dict:
    """Write the Chrome Trace JSON to ``path`` and return the object."""
    obj = chrome_trace_events(traces)
    with open(path, "w") as f:
        json.dump(obj, f)
    return obj


# ---------------------------------------------------------------------------
# compact .npz round trip
# ---------------------------------------------------------------------------

def export_npz(st: SimTrace, path: str) -> None:
    """Columnar, lossless ``.npz`` of one trace (see `load_npz`)."""
    tracks = sorted({ev.track for ev in st.events})
    t_idx = {t: i for i, t in enumerate(tracks)}
    cats = sorted({ev.cat for ev in st.events})
    c_idx = {c: i for i, c in enumerate(cats)}
    args = [json.dumps(ev.args, sort_keys=True) if ev.args else ""
            for ev in st.events]
    ctracks = sorted(st.counters)
    csamples = [np.asarray(st.counters[t], float).reshape(-1, 2)
                for t in ctracks]
    np.savez_compressed(
        path,
        label=np.array(st.label),
        meta=np.array(json.dumps(st.meta, sort_keys=True)),
        tracks=np.array(tracks, dtype=object),
        cats=np.array(cats, dtype=object),
        ev_track=np.array([t_idx[ev.track] for ev in st.events], np.int32),
        ev_cat=np.array([c_idx[ev.cat] for ev in st.events], np.int32),
        ev_name=np.array([ev.name for ev in st.events], dtype=object),
        ev_ts=np.array([ev.ts for ev in st.events]),
        ev_dur=np.array([ev.dur for ev in st.events]),
        ev_layer=np.array([ev.layer for ev in st.events], np.int32),
        ev_args=np.array(args, dtype=object),
        ev_eid=np.array([ev.eid for ev in st.events], np.int64),
        # ragged dependency lists stored flat + per-event lengths
        ev_dep_lens=np.array([len(ev.deps) for ev in st.events], np.int64),
        ev_deps=np.array([d for ev in st.events for d in ev.deps],
                         np.int64),
        counter_tracks=np.array(ctracks, dtype=object),
        counter_lens=np.array([len(s) for s in csamples], np.int64),
        counter_samples=(np.concatenate(csamples) if csamples
                         else np.zeros((0, 2))),
    )


def load_npz(path: str) -> SimTrace:
    """Inverse of `export_npz`, exact to the last float64 bit."""
    with np.load(path, allow_pickle=True) as z:
        st = SimTrace(label=str(z["label"]))
        st.meta = json.loads(str(z["meta"]))
        tracks = list(z["tracks"])
        cats = list(z["cats"])
        n = len(z["ev_ts"])
        # eid/deps columns absent in pre-critpath archives: default to
        # the unrecorded sentinel (-1, no deps)
        eids = z["ev_eid"] if "ev_eid" in z else np.full(n, -1, np.int64)
        if "ev_dep_lens" in z:
            bounds = np.concatenate([[0], np.cumsum(z["ev_dep_lens"])])
            flat = z["ev_deps"]
            deps = [flat[bounds[i]:bounds[i + 1]].tolist()
                    for i in range(n)]
        else:
            deps = [[] for _ in range(n)]
        for i, (ti, ci, name, ts, dur, layer, args) in enumerate(zip(
                z["ev_track"], z["ev_cat"], z["ev_name"], z["ev_ts"],
                z["ev_dur"], z["ev_layer"], z["ev_args"])):
            st.events.append(TraceEvent(
                str(tracks[ti]), str(name), float(ts), float(dur),
                str(cats[ci]), int(layer),
                json.loads(args) if args else {},
                int(eids[i]), [int(d) for d in deps[i]]))
        st._next_eid = int(eids.max()) + 1 if n and eids.max() >= 0 else 0
        pos = 0
        for track, n in zip(z["counter_tracks"], z["counter_lens"]):
            chunk = z["counter_samples"][pos:pos + int(n)]
            st.counters[str(track)] = [(float(a), float(b))
                                       for a, b in chunk]
            pos += int(n)
    return st
