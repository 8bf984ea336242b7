"""Deterministic hierarchical phase profiler: the framework's *own*
wall time, observable the same way `SimTrace` makes simulated time
observable.

`SimTrace` answers "where does the *simulated* run spend its time";
this module answers "where does the *simulator* spend its time".  The
design is grown out of `MetricsRegistry.span()` and mirrors the trace
plane's conventions:

- **Nested phases with parent tracking.**  ``with phase("name"):``
  opens a phase under whichever phase is currently open; a phase's
  identity is its slash-joined ``path`` ("dse.sweep_all/
  net.batched.evaluate/net.batched.wired"), so the same stage reached
  through different entry points aggregates separately.
- **Active-profiler context, exactly like `trace.recording`.**
  ``with profiling() as prof:`` installs a `PhaseProfiler` on a module
  stack; every instrumented hot path (`dse.sweep_all`,
  `net.batched.evaluate`, the `sim.engine` event loops, the
  `arch.placement` annealer — plus every `MetricsRegistry.span`)
  records into it.  When no profiler is installed the instrumented
  paths cost one ``None`` check and **construct nothing** (no
  `PhaseRecord`, no wait for the card) — the structural zero-cost pin
  (`tests/test_torch_profile.py` patches `PhaseRecord` to raise and
  runs the engines unprofiled).
- **The card's asynchronous launches.**  The engines enqueue their
  tensor work and return before the card has done it, so a host clock
  alone would charge a phase's work to whichever later phase waits for
  the card.  While a profiler is installed, and only where CUDA is
  initialised in the process, a phase's entry and exit (and the
  profiler's install and finalize) synchronise the card before they
  read the clock: each phase's wall time holds the card work it
  launched.  On the CPU nothing changes.
- **Per-phase wall time / call counts / peak bytes.**
  `note_ndarray(*arrays)` attributes the byte footprint (``nbytes``) of
  the arrays or tensors a stage materialises to the open phase; peaks
  propagate to parents, so a phase's ``peak_bytes`` bounds the largest
  single allocation burst under it.
- **Determinism.**  The profiler reads the wall clock (that is its
  job) but never influences the instrumented computation: results stay
  bit-identical with profiling on.

`profile_report` renders the aggregate table; `PhaseProfiler.to_trace`
lifts the phases into a `SimTrace` with category ``"framework"``, which
`obs.export.chrome_trace_events` maps to a dedicated "framework"
Perfetto process — simulated time and self time side by side in one
view.  `coverage()` is the honesty metric: the fraction of the
profiled wall attributed to named top-level phases.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import torch


def _clock() -> float:
    """The host clock, after the card (where CUDA is initialised) has
    finished what was launched so far."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return time.perf_counter()


class PhaseRecord:
    """One closed phase instance: begin/duration relative to the
    profiler's install time, plus its path and byte peak."""

    __slots__ = ("name", "path", "depth", "ts", "dur", "peak_bytes",
                 "outcome")

    def __init__(self, name: str, path: str, depth: int, ts: float):
        self.name = name
        self.path = path
        self.depth = depth
        self.ts = ts
        self.dur = 0.0
        self.peak_bytes = 0
        self.outcome = "ok"


class PhaseProfiler:
    """Collects `PhaseRecord`s while installed via `profiling`."""

    def __init__(self, label: str = "framework"):
        self.label = label
        self.records: List[PhaseRecord] = []
        self._open: List[PhaseRecord] = []
        self._t0: Optional[float] = None
        self.wall_s = 0.0

    # -- recording (only ever called with the profiler installed) ------

    def _install(self) -> None:
        if self._t0 is None:
            self._t0 = _clock()

    def _finalize(self) -> None:
        if self._t0 is not None:
            self.wall_s = _clock() - self._t0

    def _begin(self, name: str) -> PhaseRecord:
        parent = self._open[-1].path if self._open else ""
        rec = PhaseRecord(name, f"{parent}/{name}" if parent else name,
                          len(self._open), _clock() - self._t0)
        self._open.append(rec)
        return rec

    def _end(self, rec: PhaseRecord, outcome: str = "ok") -> None:
        self._open.pop()
        rec.dur = _clock() - self._t0 - rec.ts
        rec.outcome = outcome
        if self._open and rec.peak_bytes > self._open[-1].peak_bytes:
            self._open[-1].peak_bytes = rec.peak_bytes
        self.records.append(rec)

    def note_bytes(self, nbytes: int) -> None:
        if self._open and nbytes > self._open[-1].peak_bytes:
            self._open[-1].peak_bytes = int(nbytes)

    # -- analysis -------------------------------------------------------

    def measured_wall_s(self) -> float:
        """Wall seconds between install and finalize (live if open)."""
        if self.wall_s:
            return self.wall_s
        if self._t0 is not None:
            return time.perf_counter() - self._t0
        return 0.0

    def coverage(self) -> float:
        """Fraction of the measured wall attributed to named top-level
        phases — the >=90% acceptance metric."""
        wall = self.measured_wall_s()
        top = sum(r.dur for r in self.records if r.depth == 0)
        return top / wall if wall > 0.0 else 0.0

    def aggregate(self) -> Dict[str, dict]:
        """path -> {name, depth, calls, total_s, self_s, peak_bytes,
        errors}; ``self_s`` excludes named child phases."""
        agg: Dict[str, dict] = {}
        for r in self.records:
            a = agg.setdefault(r.path, {
                "name": r.name, "path": r.path, "depth": r.depth,
                "calls": 0, "total_s": 0.0, "self_s": 0.0,
                "peak_bytes": 0, "errors": 0})
            a["calls"] += 1
            a["total_s"] += r.dur
            if r.peak_bytes > a["peak_bytes"]:
                a["peak_bytes"] = r.peak_bytes
            a["errors"] += r.outcome != "ok"
        for a in agg.values():
            a["self_s"] = a["total_s"]
        for path, a in agg.items():
            parent = path.rsplit("/", 1)[0] if "/" in path else None
            if parent in agg:
                agg[parent]["self_s"] -= a["total_s"]
        return agg

    def to_trace(self):
        """The phases as a `SimTrace` (category ``"framework"``), ready
        for `obs.export.chrome_trace_events` — merge it with a recorded
        sim trace to see simulated time and self time side by side."""
        from .trace import SimTrace
        st = SimTrace(label=self.label)
        st.meta = {"kind": "profile", "wall_s": self.measured_wall_s(),
                   "coverage": self.coverage()}
        for r in sorted(self.records, key=lambda r: (r.ts, -r.dur)):
            st.add("phases", r.name, r.ts, r.dur, cat="framework",
                   path=r.path, peak_ndarray_bytes=r.peak_bytes,
                   outcome=r.outcome)
        return st


# ---------------------------------------------------------------------------
# active-profiler context (the `trace.recording` pattern)
# ---------------------------------------------------------------------------

_STACK: List[Optional[PhaseProfiler]] = []


def active_profiler() -> Optional[PhaseProfiler]:
    """The innermost installed profiler, or None (profiling disabled)."""
    return _STACK[-1] if _STACK else None


@contextlib.contextmanager
def profiling(prof: Optional[PhaseProfiler] = None):
    """Install ``prof`` (a fresh `PhaseProfiler` by default) for the
    block; yields it.  Nests like `trace.recording` — the innermost
    profiler wins; ``profiling(None)`` therefore starts a *new* scope
    rather than masking (self-profiling has no trial-evaluation
    suppression to express)."""
    prof = PhaseProfiler() if prof is None else prof
    prof._install()
    _STACK.append(prof)
    try:
        yield prof
    finally:
        _STACK.pop()
        prof._finalize()


class phase:
    """``with phase("stage"):`` — record the block into the active
    profiler; a no-op (one None check, nothing constructed) when
    profiling is disabled.  A raising body closes the phase with
    ``outcome="error"`` and re-raises."""

    __slots__ = ("name", "prof", "rec")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "phase":
        prof = _STACK[-1] if _STACK else None
        self.prof = prof
        if prof is not None:
            self.rec = prof._begin(self.name)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self.prof is not None:
            self.prof._end(self.rec, "error" if exc_type else "ok")
        return False


def note_ndarray(*arrays) -> None:
    """Attribute ``sum(a.nbytes)`` of the given arrays or tensors to the open
    phase of the active profiler (peak over notes; propagates to parent
    phases on exit).  Free when profiling is disabled."""
    prof = _STACK[-1] if _STACK else None
    if prof is not None:
        prof.note_bytes(sum(int(getattr(a, "nbytes", 0))
                            for a in arrays if a is not None))


# ---------------------------------------------------------------------------
# report
# ---------------------------------------------------------------------------

def profile_report(prof: PhaseProfiler, top: int = 30) -> str:
    """Human-readable aggregate table, heaviest phases first, with the
    coverage footer (the >=90% attribution acceptance line)."""
    agg = sorted(prof.aggregate().values(), key=lambda a: -a["total_s"])
    wall = prof.measured_wall_s()
    if not agg:
        return "(no phases recorded)"
    wid = max(len(a["path"]) for a in agg[:top])
    hdr = (f"{'phase':<{wid}} {'calls':>7} {'total':>10} {'self':>10} "
           f"{'%wall':>6} {'peak-bytes':>12}")
    lines = [hdr, "-" * len(hdr)]
    for a in agg[:top]:
        pct = 100.0 * a["total_s"] / wall if wall else 0.0
        err = f"  errors={a['errors']}" if a["errors"] else ""
        lines.append(
            f"{a['path']:<{wid}} {a['calls']:>7} {a['total_s']:>9.4f}s "
            f"{a['self_s']:>9.4f}s {pct:>5.1f}% {a['peak_bytes']:>12,}"
            f"{err}")
    lines.append(f"attributed {100.0 * prof.coverage():.1f}% of "
                 f"{wall:.4f}s wall to {len(agg)} named phases")
    return "\n".join(lines)
