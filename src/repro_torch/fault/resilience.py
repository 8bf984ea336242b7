"""Online-reshard controller and retained-speedup resilience sweep.

This is the *placement* half of the dynamic-conditions story (the
*traffic* half is `repro_torch.sim.policies.OnlineReshardPolicy`).  On a chip
event the runtime has two options:

- **degraded mode** — keep the deployed placement and let the surviving
  exec-set peers absorb the dead chip's share (`repro_torch.fault.
  apply.derate_trace`, run by the engine under any policy), or
- **online reshard** — detect the failure through the `Heartbeat`
  registry, `evict` the worker, gate feasibility through
  `ElasticPlan.plan`, rebuild the placement against the survivors (the
  rate-aware mappers re-split when `AcceleratorConfig.chiplet_tops` is
  derated), pay the weight-migration restream for every layer whose
  exec set moved, and continue.

`reshard_run` prices both and keeps the cheaper one — the controller
never commits to a rebuild that loses to simply limping along, so its
total is `min(resharded, degraded)` by construction.  Combined with
`OnlineReshardPolicy`'s per-layer stitch (<= static and <= adaptive
under the same faults), the online-reshard row dominates every static
row on every sweep cell.

`resilience_sweep` produces the paper-style headline: *speedup
retained* under k fail-stops and degraded SNR — the hybrid speedup
under fault divided by the fault-free hybrid speedup, per policy, with
the wired-only counterfactual degraded by the same chip events.

Where it runs: every engine run on its trace's device.  `reshard_run`,
`resilience_sweep` build their traces themselves, on ``device`` (the
card when None; without one they raise, and ``device="cpu"`` runs the
CPU route), and pass it to every `make_trace` they call.  The
heartbeat replay and the era loop are host Python, on host copies of
per-layer times.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.simulator import make_trace
from repro_torch.core.traffic import TrafficTrace, resolve_device
from repro_torch.net.config import as_network
from repro_torch.runtime.fault_tolerance import ElasticPlan, Heartbeat, \
    RecoveryEvent
from repro_torch.sim.engine import EventResult, PacketSim

from .apply import DEAD_CHIP_RATE_SCALE
from .scenario import ChipFailure, FaultScenario, SnrFade

#: logical heartbeat timeout in layer-index time: a chip that missed
#: the previous layer boundary's beat is declared dead at this one.
HEARTBEAT_TIMEOUT_LAYERS = 0.5


def degraded_run(trace: TrafficTrace, net, scenario: FaultScenario,
                 policy: str = "static",
                 link_model: str = "striped") -> EventResult:
    """One engine run under ``scenario`` with the deployed placement,
    on the trace's device."""
    sim = PacketSim(trace, as_network(net), link_model=link_model,
                    faults=scenario)
    return sim.run(policy)


def default_scenario(trace: TrafficTrace, k: int = 1,
                     fade_db: float = 0.0,
                     at_layer: Optional[int] = None) -> FaultScenario:
    """The bench's canonical scenario: k fail-stops + a package fade.

    Failed chips spread across the package (centre, far corner, origin,
    thirds) so the dead set never collapses onto one mesh region;
    failures strike together at one-third of the run (``at_layer``
    overrides).  A positive ``fade_db`` degrades every channel from
    layer 0.
    """
    n = trace.topo.config.n_chiplets
    order = list(dict.fromkeys(
        [n // 2, n - 1, 0, n // 3, (2 * n) // 3]))
    if not 0 <= k <= len(order):
        raise ValueError(f"k={k} fail-stops not supported on a "
                         f"{n}-chiplet package (max {len(order)})")
    at = max(1, trace.n_layers // 3) if at_layer is None else at_layer
    return FaultScenario(
        chip_failures=tuple(ChipFailure(c, at_layer=at)
                            for c in order[:k]),
        snr_fades=(SnrFade(fade_db),) if fade_db > 0.0 else ())


@dataclasses.dataclass(frozen=True)
class ReshardOutcome:
    """What the online-reshard controller did and what it cost."""
    total_time: float            # what the controller ships: min(...)
    degraded_time: float         # keep-placement projection
    resharded_time: float        # era-stitched rebuild incl. migration
    migration_time: float        # weight restream across all rebuilds
    resharded: bool              # True when the rebuild won
    events: Tuple[RecoveryEvent, ...]
    eras: Tuple[Tuple[int, int], ...]   # [start, end) layer spans

    @property
    def reshard_gain(self) -> float:
        """Fraction of degraded-mode time the rebuild saved (>= 0)."""
        if self.degraded_time <= 0.0:
            return 0.0
        return max(0.0, 1.0 - self.resharded_time / self.degraded_time)


def _heartbeat_detect(scenario: FaultScenario, n_chips: int,
                      n_layers: int) -> Tuple[List[RecoveryEvent],
                                              List[int]]:
    """Replay the failure timeline through the liveness machinery.

    Logical clock = layer index: every surviving chip beats at each
    layer boundary; a fail-stopped chip goes silent from its
    ``at_layer`` on and is detected (timeout 0.5 layers), evicted, and
    the survivor count gated through `ElasticPlan.plan`.  Returns the
    recovery log and the boundaries where a reshard is feasible.
    """
    fail_at: Dict[int, float] = {}
    for ev in scenario.chip_failures:
        fail_at[ev.chip] = min(ev.at_layer, fail_at.get(ev.chip, np.inf))
    slow_at: Dict[int, List[int]] = {}
    for ev in scenario.chip_slowdowns:
        slow_at.setdefault(ev.at_layer, []).append(ev.chip)
    hb = Heartbeat(timeout_s=HEARTBEAT_TIMEOUT_LAYERS)
    evicted: set = set()
    events: List[RecoveryEvent] = []
    feasible: List[int] = []
    boundaries = set(scenario.reshard_boundaries())
    for li in range(n_layers):
        for c in range(n_chips):
            if c not in evicted and fail_at.get(c, np.inf) > li:
                hb.beat(c, now=float(li))
        if li not in boundaries:
            continue
        dead = hb.dead(now=float(li))
        for w in dead:
            hb.evict(w)      # without this, every later poll re-fires
            evicted.add(w)
        n_alive = n_chips - len(evicted)
        try:
            plan = ElasticPlan.plan(n_alive, model_parallel=1)
        except RuntimeError:
            continue         # no survivors: reshard infeasible here
        feasible.append(li)
        if dead:
            events.append(RecoveryEvent(step=li, kind="failure",
                                        workers=dead,
                                        new_mesh=plan.mesh_shape))
        if li in slow_at:
            events.append(RecoveryEvent(step=li, kind="straggler",
                                        workers=sorted(slow_at[li]),
                                        new_mesh=plan.mesh_shape))
    return events, feasible


def _derated_rates(cfg, scenario: FaultScenario,
                   boundary: int) -> Tuple[float, ...]:
    """`chiplet_tops` with every chip event up to ``boundary`` applied."""
    rates = np.asarray(
        cfg.chiplet_tops if cfg.chiplet_tops is not None
        else [cfg.tops_per_chiplet] * cfg.n_chiplets, float)
    base = rates.copy()
    for ev in scenario.chip_slowdowns:
        if ev.at_layer <= boundary:
            rates[ev.chip] = min(rates[ev.chip], base[ev.chip] / ev.factor)
    for ev in scenario.chip_failures:
        if ev.at_layer <= boundary:
            rates[ev.chip] = base[ev.chip] * DEAD_CHIP_RATE_SCALE
    return tuple(float(r) for r in rates)


def _moved_share(prev: TrafficTrace, new: TrafficTrace, li: int) -> float:
    """Fraction of layer ``li``'s weights that changed owner.

    Shares are aligned by chip id across the two placements; each
    chip's *gained* share is weight it must stream in (the shrinking
    side's copy is simply dropped), so the moved fraction is
    ``sum_c max(0, share_new(c) - share_old(c))``.
    """
    old = dict(zip(prev.exec_chips[li],
                   np.asarray(prev.exec_shares[li], float)))
    gained = 0.0
    for c, s in zip(new.exec_chips[li],
                    np.asarray(new.exec_shares[li], float)):
        gained += max(0.0, float(s) - old.get(c, 0.0))
    return gained


def reshard_run(workload: str, net, scenario: FaultScenario, *,
                policy: str = "online-reshard", acc=None,
                mapping: Optional[str] = None,
                link_model: str = "striped",
                device=None) -> ReshardOutcome:
    """Price degraded mode vs an online reshard; ship the cheaper one.

    Era machinery: each chip-event boundary that passes the
    heartbeat/eviction/`ElasticPlan` gate starts a new era whose
    placement is rebuilt with `make_trace` on a `chiplet_tops`-derated
    accelerator (dead chips keep a vanishing rate so the rate-aware
    mappers assign them a vanishing share).  Residual *network* faults
    (link failures, fades) apply in every era; the weight slice of
    every layer whose exec set moved is restreamed from DRAM once per
    rebuild.  The degraded projection runs the same ``policy`` on the
    deployed placement, so ``total_time <= degraded_time`` always.
    Every trace is built on ``device`` (the card when None).
    """
    net = as_network(net)
    device = resolve_device(device)
    trace0 = make_trace(workload, acc, mapping, device=device)
    cfg = trace0.topo.config
    deg = degraded_run(trace0, net, scenario, policy=policy,
                       link_model=link_model)
    degraded_time = float(deg.total_time)

    events, feasible = _heartbeat_detect(
        scenario, cfg.n_chiplets, trace0.n_layers)
    if not feasible:
        return ReshardOutcome(degraded_time, degraded_time, np.inf, 0.0,
                              False, tuple(events),
                              ((0, trace0.n_layers),))

    residual = scenario.network_only()
    bounds = [0] + feasible + [trace0.n_layers]
    per_layer = deg.layer_times.cpu().numpy().copy()  # era 0: deployed
    migration = 0.0
    prev_trace = trace0
    cache: Dict[Tuple[float, ...], TrafficTrace] = {}
    eras: List[Tuple[int, int]] = []
    for start, end in zip(bounds[:-1], bounds[1:]):
        eras.append((start, end))
        if start == 0:
            continue
        rates = _derated_rates(cfg, scenario, start)
        trace_e = cache.get(rates)
        if trace_e is None:
            acc_e = dataclasses.replace(cfg, chiplet_tops=rates)
            trace_e = cache[rates] = make_trace(workload, acc_e, mapping,
                                                device=device)
        sim_e = PacketSim(trace_e, net, link_model=link_model,
                          faults=None if residual.is_null else residual)
        res_e = sim_e.run(policy)
        per_layer[start:end] = res_e.layer_times[start:end].cpu().numpy()
        if trace_e.weight_bytes is not None \
                and trace_e.exec_chips is not None \
                and prev_trace.exec_chips is not None:
            for li in range(start, trace0.n_layers):
                moved = _moved_share(prev_trace, trace_e, li)
                migration += float(moved) * float(trace_e.weight_bytes[li]) \
                    / cfg.dram_bw_total
        prev_trace = trace_e
    resharded = float(per_layer.sum()) + migration
    total = min(resharded, degraded_time)
    return ReshardOutcome(total, degraded_time, resharded, migration,
                          resharded < degraded_time, tuple(events),
                          tuple(eras))


def resilience_sweep(workloads: Sequence[str], net, *,
                     ks: Sequence[int] = (0, 1, 2),
                     fades: Sequence[float] = (3.0, 9.0),
                     policies: Sequence[str] = ("static", "adaptive",
                                                "online-reshard"),
                     acc=None, link_model: str = "striped",
                     device=None) -> Dict:
    """Retained-speedup grid: workloads x (k, fade) cells x policies.

    Per cell, ``retained = (wired_faulted / t_policy_faulted) /
    (wired_ff / t_policy_ff)`` — how much of the policy's fault-free
    hybrid speedup survives the scenario.  The wired-only
    counterfactual suffers the same chip events (derated trace) but has
    no wireless plane to fade or to fail over to.  The online-reshard
    row routes through `reshard_run`; every other policy keeps the
    deployed placement (`degraded_run`).  Traces are built on
    ``device`` (the card when None).
    """
    net = as_network(net)
    device = resolve_device(device)
    out: Dict[str, Dict] = {}
    for wl in workloads:
        trace = make_trace(wl, acc, device=device)
        sim_ff = PacketSim(trace, net, link_model=link_model)
        wired_ff = float(sim_ff.run_wired().total_time)
        speedup_ff = {p: wired_ff / float(sim_ff.run(p).total_time)
                      for p in policies}
        cells: Dict[str, Dict] = {}
        for k in ks:
            for fade in fades:
                sc = default_scenario(trace, k=k, fade_db=fade)
                wired_f = float(
                    PacketSim(trace, net, link_model=link_model,
                              faults=sc).run_wired().total_time)
                cell: Dict[str, Dict] = {}
                for p in policies:
                    if p == "online-reshard":
                        oc = reshard_run(wl, net, sc, policy=p, acc=acc,
                                         link_model=link_model,
                                         device=device)
                        t_pol, resharded = oc.total_time, oc.resharded
                    else:
                        t_pol = float(degraded_run(
                            trace, net, sc, policy=p,
                            link_model=link_model).total_time)
                        resharded = False
                    sp = wired_f / t_pol
                    cell[p] = {"time": t_pol, "speedup": sp,
                               "retained": sp / speedup_ff[p],
                               "resharded": resharded}
                cells[f"k{k}_fade{fade:g}"] = cell
        out[wl] = {"wired_ff": wired_ff, "speedup_ff": speedup_ff,
                   "cells": cells}
    return out
