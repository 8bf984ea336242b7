"""Label-keyed metrics registry, logging adapter, and the attribution
report that turns `bottleneck_share`'s "which resource" into "why".

- `MetricsRegistry` — counters / gauges / histograms keyed by (name,
  labels); `span(...)` is a wall-time context manager feeding a
  histogram; `logger(...)` returns the structured-print adapter the
  launch drivers route their progress output through.
- `utilization_timeline` — time-binned per-resource occupancy from a
  recorded `SimTrace`.
- `attribution_report` — per (layer, resource) decomposition of where
  the layer's span went:

  ==============  =========================================================
  column          meaning
  ==============  =========================================================
  ``service_s``   payload serving time (sum of event durations)
  ``queue_s``     packet waiting: sum over packets of (service begin -
                  layer start); for reuse-zone tracks this includes the
                  wait behind the channel's global phase
  ``quiesce_s``   the slice of ``queue_s`` explained by long-range
                  (channel-global) traffic quiescing the zone
  ``finish_s``    when the resource drained, relative to layer start
  ``idle_s``      layer span minus ``finish_s`` (the resource was done,
                  another plane was the bottleneck)
  ``busy_frac``   service_s / finish_s
  ``why``         "service" | "queueing" | "queueing behind long-range
                  quiesce" — which component dominates
  ==============  =========================================================

  Degenerate (zero-time / empty) traces return ``[]`` — the same
  explicit empty convention `SimResult.bottleneck_share` /
  `EventResult.bottleneck_share` use for zero-time runs.
"""

from __future__ import annotations

import contextlib
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.units import s_to_ms

from . import profile as _profile
from .trace import RESOURCE_CATS, SimTrace


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

class Metric:
    """One (name, labels) series: counter, gauge, or histogram."""

    def __init__(self, kind: str, name: str, labels: Tuple[Tuple[str, str],
                                                           ...]):
        self.kind = kind
        self.name = name
        self.labels = labels
        self.value = 0.0
        self.samples: List[float] = []

    def inc(self, v: float = 1.0) -> None:
        assert self.kind == "counter"
        self.value += v

    def set(self, v: float) -> None:
        assert self.kind == "gauge"
        self.value = float(v)

    def observe(self, v: float) -> None:
        assert self.kind == "histogram"
        self.samples.append(float(v))

    def summary(self) -> dict:
        out = {"kind": self.kind, "labels": dict(self.labels)}
        if self.kind == "histogram":
            s = np.asarray(self.samples) if self.samples else np.zeros(0)
            out.update(count=len(s),
                       sum=float(s.sum()),
                       mean=float(s.mean()) if len(s) else 0.0,
                       max=float(s.max()) if len(s) else 0.0)
        else:
            out["value"] = self.value
        return out


class MetricsRegistry:
    """Label-keyed metric store; one process-wide `DEFAULT_REGISTRY`."""

    def __init__(self):
        self._metrics: Dict[Tuple[str, Tuple], Metric] = {}

    def _get(self, kind: str, name: str, labels: dict) -> Metric:
        key = (name, tuple(sorted((k, str(v))
                                  for k, v in labels.items())))
        m = self._metrics.get(key)
        if m is None:
            m = self._metrics[key] = Metric(kind, name, key[1])
        elif m.kind != kind:
            raise ValueError(f"metric {name!r} already registered as "
                             f"{m.kind}, not {kind}")
        return m

    def counter(self, name: str, **labels) -> Metric:
        return self._get("counter", name, labels)

    def gauge(self, name: str, **labels) -> Metric:
        return self._get("gauge", name, labels)

    def histogram(self, name: str, **labels) -> Metric:
        return self._get("histogram", name, labels)

    @contextlib.contextmanager
    def span(self, name: str, **labels):
        """Wall-time a block into histogram ``name``; yields a dict
        whose ``seconds`` key holds the elapsed time on exit.

        Exception-safe: a raising body still records its elapsed time,
        but under an extra ``outcome=error`` label — the sample is
        never dropped and never pollutes the success distribution (the
        success-path histogram keys are unchanged).  Callers that read
        ``out["seconds"]`` after the block (placement anneal, the dse
        sweeps) only do so on success — on error the exception
        propagates before any provenance is stamped, which is the
        audited intent.

        Every span also opens a `profile.phase` of the same name, so
        under ``with obs.profiling():`` the registry's spans double as
        top-level profiler phases at zero extra call-site cost.

        A span never waits for the card (it wraps every sweep, profiled
        or not): its seconds run up to the wrapped code's last host
        read.  Every sweep it wraps ends by reading its results on the
        host, so that is the card's work too.
        """
        out = {"seconds": 0.0}
        failed = False
        with _profile.phase(name):
            t0 = time.perf_counter()
            try:
                yield out
            except BaseException:
                failed = True
                raise
            finally:
                out["seconds"] = time.perf_counter() - t0
                lbl = dict(labels, outcome="error") if failed else labels
                self.histogram(name, **lbl).observe(out["seconds"])

    def logger(self, name: str, stream=None) -> "MetricsLogger":
        return MetricsLogger(self, name, stream)

    def report(self) -> Dict[str, list]:
        """name -> list of per-label-set summaries (JSON-serialisable)."""
        out: Dict[str, list] = {}
        for (name, _), m in sorted(self._metrics.items()):
            out.setdefault(name, []).append(m.summary())
        return out

    def reset(self) -> None:
        self._metrics.clear()


class MetricsLogger:
    """Structured progress logging that also feeds the registry.

    ``log.info("step 12 done", step=12, ce=1.93)`` prints the message
    (plus the fields) and records: a per-level message counter and a
    gauge per numeric field — so a driver's progress output is
    machine-readable from `MetricsRegistry.report()` instead of lost
    to stdout.
    """

    def __init__(self, registry: MetricsRegistry, name: str, stream=None):
        self.registry = registry
        self.name = name
        self.stream = stream

    def _log(self, level: str, msg: str, **fields) -> None:
        self.registry.counter("log.messages", logger=self.name,
                              level=level).inc()
        for k, v in fields.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                self.registry.gauge(f"{self.name}.{k}").set(v)
        stream = self.stream or sys.stdout
        tail = "".join(f" {k}={v}" for k, v in fields.items()
                       if f"{v}" not in msg)
        prefix = "" if level == "info" else f"{level.upper()}: "
        print(f"{prefix}{msg}{tail}", file=stream)

    def info(self, msg: str, **fields) -> None:
        self._log("info", msg, **fields)

    def warning(self, msg: str, **fields) -> None:
        self._log("warning", msg, **fields)

    def error(self, msg: str, **fields) -> None:
        self._log("error", msg, **fields)


DEFAULT_REGISTRY = MetricsRegistry()


def get_logger(name: str, stream=None) -> MetricsLogger:
    """A `MetricsLogger` on the process-wide default registry."""
    return DEFAULT_REGISTRY.logger(name, stream)


# ---------------------------------------------------------------------------
# timelines
# ---------------------------------------------------------------------------

def utilization_timeline(st: SimTrace, cat: str, n_bins: int = 50,
                         t_end: Optional[float] = None
                         ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """(bin edges, track -> per-bin occupancy fraction) for one plane."""
    t_end = t_end if t_end is not None else st.span()[1]
    edges = np.linspace(0.0, t_end or 1.0, n_bins + 1)
    width = edges[1] - edges[0]
    out: Dict[str, np.ndarray] = {}
    for ev in st.events:
        if ev.cat != cat:
            continue
        util = out.setdefault(ev.track, np.zeros(n_bins))
        # overlap of [ts, ts+dur) with each bin
        lo = np.clip(ev.ts, edges[:-1], edges[1:])
        hi = np.clip(ev.ts + ev.dur, edges[:-1], edges[1:])
        util += np.maximum(hi - lo, 0.0) / width
    return edges, out


# ---------------------------------------------------------------------------
# attribution
# ---------------------------------------------------------------------------

def _trace_of(source) -> SimTrace:
    st = getattr(source, "trace", source)
    if not isinstance(st, SimTrace):
        raise ValueError(
            "attribution needs a recorded trace: run the engine with "
            "record=True (PacketSim(trace, net, record=True)) or pass a "
            "SimTrace")
    return st


def attribution_report(source, cats=RESOURCE_CATS) -> List[dict]:
    """Per (layer, resource) service/queueing/quiescence decomposition.

    ``source`` is an `EventResult` from a recorded run (or a `SimTrace`
    directly).  See the module docstring for the column glossary.
    Empty/degenerate traces return ``[]`` (the shared convention with
    `bottleneck_share`'s ``{}``).
    """
    st = _trace_of(source)
    windows = st.layer_windows()
    groups: Dict[Tuple[int, str], List] = {}
    glob_busy: Dict[Tuple[int, str], float] = {}   # (layer, "ch{c}") ->
    for ev in st.events:
        if ev.cat not in cats:
            continue
        groups.setdefault((ev.layer, ev.track), []).append(ev)
        head, _, sub = ev.track.partition("/")
        if sub == "g":
            key = (ev.layer, head)
            glob_busy[key] = glob_busy.get(key, 0.0) + ev.dur
    rows = []
    for (li, track), evs in sorted(groups.items()):
        start, span = windows.get(li, (min(e.ts for e in evs), 0.0))
        service = sum(e.dur for e in evs)
        finish = max(e.ts + e.dur for e in evs) - start
        queue = sum(e.ts - start for e in evs)
        head, _, sub = track.partition("/")
        quiesce = 0.0
        if sub.startswith("z"):
            # every packet of this zone queued behind the channel's
            # global phase before its own FIFO position
            quiesce = len(evs) * glob_busy.get((li, head), 0.0)
            quiesce = min(quiesce, queue)
        if queue > service:
            why = "queueing"
            if quiesce > 0.5 * queue:
                why = "queueing behind long-range quiesce"
        else:
            why = "service"
        rows.append({
            "layer": li, "track": track, "cat": evs[0].cat,
            "n_events": len(evs),
            "service_s": service, "queue_s": queue, "quiesce_s": quiesce,
            "finish_s": finish, "idle_s": max(span - finish, 0.0),
            "busy_frac": service / finish if finish else 0.0,
            "why": why,
        })
    return rows


def attribution_summary(source,
                        cats=RESOURCE_CATS + ("compute", "noc", "dram-agg")
                        ) -> Dict[str, dict]:
    """bottleneck -> {share, hot resource, why}: the upgraded
    `bottleneck_share`.

    For each bottleneck category of the run, reports its share of total
    time (exactly `bottleneck_share`'s number) plus the latest-draining
    resource among its bottlenecked layers and that resource's dominant
    ``why`` — e.g. ``wireless: 61% — ch0/z2 queueing behind long-range
    quiesce``.  Zero-time runs return ``{}``.
    """
    st = _trace_of(source)
    shares = source.bottleneck_share() if hasattr(
        source, "bottleneck_share") else {}
    rows = attribution_report(source, cats)
    windows = st.layer_windows()
    # layer -> bottleneck name, from the layer span labels "L{i}:{b}"
    layer_bn = {ev.layer: ev.name.split(":", 1)[1]
                for ev in st.events if ev.cat == "layer" and ":" in ev.name}
    cat_of_bn = {"nop": "wired", "wireless": "wireless", "dram": "dram",
                 "compute": "compute", "noc": "noc"}
    if "dram" not in {r["cat"] for r in rows}:   # pooled DRAM model
        cat_of_bn["dram"] = "dram-agg"
    out: Dict[str, dict] = {}
    for bn, share in shares.items():
        if share <= 0.0:
            continue
        layers = {li for li, b in layer_bn.items() if b == bn}
        cand = [r for r in rows
                if r["layer"] in layers and r["cat"] == cat_of_bn.get(bn)]
        entry = {"share": share, "track": None, "why": None}
        if cand:
            weight = {li: windows.get(li, (0, 0))[1] for li in layers}
            hot = max(cand, key=lambda r: (weight.get(r["layer"], 0.0),
                                           r["finish_s"]))
            entry.update(track=hot["track"], why=hot["why"])
        out[bn] = entry
    return out


def format_attribution(rows: List[dict], top: int = 12) -> str:
    """Human-readable table of the heaviest attribution rows."""
    rows = sorted(rows, key=lambda r: -r["finish_s"])[:top]
    if not rows:
        return "(empty trace)"
    hdr = (f"{'layer':>5} {'resource':<12} {'n':>5} {'service':>10} "
           f"{'queueing':>10} {'quiesce':>10} {'finish':>10}  why")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        lines.append(
            f"{r['layer']:>5} {r['track']:<12} {r['n_events']:>5} "
            f"{s_to_ms(r['service_s']):>9.3f}m "
            f"{s_to_ms(r['queue_s']):>9.3f}m "
            f"{s_to_ms(r['quiesce_s']):>9.3f}m "
            f"{s_to_ms(r['finish_s']):>9.3f}m  "
            f"{r['why']}")
    return "\n".join(lines)
