"""Observability: time-resolved tracing, metrics, and export.

The instrumentation the port's modelling planes (analytic
`repro_torch.core`, channel/MAC `repro_torch.net`, event-driven
`repro_torch.sim`, heterogeneous `repro_torch.arch`) share, as the JAX
package's `obs`.  Everything here is zero-cost when disabled: the
engines run exactly their uninstrumented code paths unless a recorder
is requested (`PacketSim(..., record=True)`) or installed (``with
obs.recording(st): simulate_hybrid(...)``), or a profiler is installed
(``with obs.profiling():``).  The recorded store lives on the host; the
engines copy what a recorder needs from the trace's device once a call.

- `trace`      — `SimTrace`: per-packet begin/end events on every
  resource (mesh cut/link, wireless channel x reuse zone, DRAM port,
  compute), per-layer spans, derived queue-depth/utilization counters,
  and the active-recorder context the analytic plane emits into.
- `export`     — lossless export to Chrome Trace Event Format JSON
  (open directly in https://ui.perfetto.dev) and a compact ``.npz``
  round-trippable form for programmatic analysis.
- `metrics`    — label-keyed counter/gauge/histogram registry with a
  logging adapter and span timers; time-binned utilization timelines;
  the attribution report that decomposes each layer's span into
  service vs queueing vs quiescence per resource.
- `critpath`   — critical-path extraction over the recorded dependency
  DAG (`TraceEvent.deps`): which busy time actually *bounds* the
  makespan, per resource and per plane, against the raw busy shares.
- `whatif`     — trace-driven what-if projection: replay the recorded
  layer terms under scaled wireless/DRAM/wired resources or a new
  channel plan, with a re-simulation validation harness.
- `profile`    — the framework's *self*-time: a deterministic
  hierarchical phase profiler (`with profiling() as prof:`) with the
  same zero-cost-when-disabled structural guarantee as `SimTrace`;
  `prof.to_trace()` exports the phases as a "framework" Perfetto
  process next to the simulated-time planes.
- `report`     — the cross-run bench observatory (stdlib-only): MAD
  changepoint/drift detection over the `bench_history.jsonl` ledger
  and a self-contained inline-SVG HTML trend report (``python -m
  repro_torch.launch.history --detect / --html``).
- `provenance` — `dse.provenance` records (config hash, seed, wall
  time, points evaluated) stamped into every sweep result.
"""

from .critpath import (CriticalPath, CritSegment, busy_shares,
                       critical_path, critical_vs_busy, mark_critical)
from .export import (chrome_trace_events, export_chrome_trace, export_npz,
                     load_npz)
from .metrics import (DEFAULT_REGISTRY, MetricsRegistry, attribution_report,
                      attribution_summary, format_attribution, get_logger,
                      utilization_timeline)
from .profile import (PhaseProfiler, PhaseRecord, active_profiler,
                      note_ndarray, phase, profile_report, profiling)
from .provenance import config_hash, make_provenance
from .report import (build_html, detect_all, detect_series,
                     format_findings, history_series, write_html)
from .trace import SimTrace, TraceEvent, active_recorder, recording
from .whatif import Projection, WhatIf, project, project_grid, validate

__all__ = [
    "SimTrace", "TraceEvent", "active_recorder", "recording",
    "chrome_trace_events", "export_chrome_trace", "export_npz", "load_npz",
    "DEFAULT_REGISTRY", "MetricsRegistry", "attribution_report",
    "attribution_summary", "format_attribution", "get_logger",
    "utilization_timeline",
    "CriticalPath", "CritSegment", "busy_shares", "critical_path",
    "critical_vs_busy", "mark_critical",
    "Projection", "WhatIf", "project", "project_grid", "validate",
    "PhaseProfiler", "PhaseRecord", "active_profiler", "note_ndarray",
    "phase", "profile_report", "profiling",
    "build_html", "detect_all", "detect_series", "format_findings",
    "history_series", "write_html",
    "config_hash", "make_provenance",
]
