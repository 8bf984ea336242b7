"""Dynamic-conditions resilience plane: fault scenarios over the planes.

The modelling planes (analytic GEMINI core, `repro_torch.net`
channel/MAC stack, `repro_torch.sim` event engine) assume a static,
reliable fabric.  This package injects *dynamic conditions* —
chiplet fail-stop, chiplet slow-down, mesh-link failure, and
SNR-dependent channel fading (`repro_torch.net.channel.SnrProfile`) — into
the existing planes and measures how much of the wireless speedup
survives them:

- `scenario`   — the event dataclasses + validated `FaultScenario`
  container.  A scenario is *declarative*: what degrades, from which
  layer boundary onward, by how much.
- `apply`      — scenario -> model arrays: trace derating for chip
  events (`derate_trace`), per-(layer, cut) wired service scaling and
  forced-failover sets for link failures (`link_fault_arrays`), and
  per-(layer, channel) effective wireless bandwidth for fades
  (`wireless_bw_matrix`).  `repro_torch.sim.engine.PacketSim(faults=...)`
  consumes these.
- `resilience` — the online-reshard controller (Heartbeat/ElasticPlan
  detection + per-era placement rebuild against the surviving
  topology) and the retained-speedup sweep (the JAX package's
  `fig_resilience` benchmark row).

The headline no static sweep can tell: when a mesh cut dies, the
shared wireless medium is the only path that survives by construction
— packets on a fully-dead cut are *forced* onto the wireless plane
(wired-only runs go to infinity), and the per-layer policies re-tune
around the degradation.
"""

from typing import TYPE_CHECKING

_SCENARIO_EXPORTS = (
    "ChipFailure", "ChipSlowdown", "LinkFailure", "SnrFade",
    "FaultScenario",
)
_APPLY_EXPORTS = ("derate_trace", "link_fault_arrays", "wireless_bw_matrix")
_RESILIENCE_EXPORTS = ("ReshardOutcome", "default_scenario", "degraded_run",
                       "reshard_run", "resilience_sweep")

__all__ = list(_SCENARIO_EXPORTS + _APPLY_EXPORTS + _RESILIENCE_EXPORTS)

if TYPE_CHECKING:   # pragma: no cover - static analysis only
    from .apply import (derate_trace, link_fault_arrays,  # noqa: F401
                        wireless_bw_matrix)
    from .resilience import (ReshardOutcome, default_scenario,  # noqa: F401
                             degraded_run, reshard_run, resilience_sweep)
    from .scenario import (ChipFailure, ChipSlowdown,  # noqa: F401
                           FaultScenario, LinkFailure, SnrFade)


def __getattr__(name: str):
    # lazy exports keep `repro_torch.sim.engine`'s late
    # `repro_torch.fault.apply` import cycle-free: importing the package
    # must not pull in `resilience` (which imports repro_torch.sim)
    # eagerly
    import importlib
    if name in _SCENARIO_EXPORTS:
        return getattr(importlib.import_module(f"{__name__}.scenario"), name)
    if name in _APPLY_EXPORTS:
        return getattr(importlib.import_module(f"{__name__}.apply"), name)
    if name in _RESILIENCE_EXPORTS:
        return getattr(importlib.import_module(f"{__name__}.resilience"),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
