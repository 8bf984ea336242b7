"""Event-driven vs analytic comparisons: fidelity + policy reports.

Two questions the new engine answers, packaged for the benchmark
driver and the figure scripts:

1. **Fidelity** — how much does GEMINI's analytic per-layer max hide?
   Per workload, compare the analytic hybrid against the event engine
   at each wired realism level: ``striped`` (the analytic idealization,
   time-resolved — must agree), ``adaptive`` (least-backlogged parallel
   link), ``xy`` (fixed dimension-ordered path).  The analytic value is
   a lower bound for all of them.

2. **Policies** — does an online policy recover (or beat) the paper's
   offline-swept optimum?  Per workload, the best static (threshold x
   injection) grid point vs the configured static point, the greedy
   per-packet policy, the adaptive per-layer policy, and the offline
   water-filling oracle.

Both run on the traces' device (each `PacketSim` follows its trace).
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np

from repro_torch.core.simulator import simulate_hybrid, simulate_wired
from repro_torch.net.config import NetworkConfig, as_network
from repro_torch.units import gbps_to_bytes_per_s, s_to_ms

from .engine import LINK_MODELS, PacketSim

DEFAULT_NET = NetworkConfig(bandwidth=gbps_to_bytes_per_s(96))
DEFAULT_POLICIES = ("static", "greedy", "adaptive", "oracle")


def fidelity_report(traces: Dict[str, object], net=None,
                    link_models: Iterable[str] = LINK_MODELS) -> dict:
    """Event-driven vs analytic hybrid, per workload and link model."""
    net = as_network(net or DEFAULT_NET)
    link_models = tuple(link_models)
    out: dict = {}
    worst = {m: 0.0 for m in link_models}
    for wl, tr in traces.items():
        an_base = simulate_wired(tr).total_time
        an_hyb = simulate_hybrid(tr, net).total_time
        an_sp = an_base / an_hyb
        row = {"analytic": {"wired_ms": s_to_ms(an_base),
                            "hybrid_ms": s_to_ms(an_hyb),
                            "speedup": an_sp}}
        for m in link_models:
            sim = PacketSim(tr, net, link_model=m)
            ev_base = sim.run_wired().total_time
            ev_hyb = sim.run("static").total_time
            ev_sp = ev_base / ev_hyb
            rel = abs(ev_sp - an_sp) / an_sp
            worst[m] = max(worst[m], rel)
            row[m] = {"wired_ms": s_to_ms(ev_base),
                      "hybrid_ms": s_to_ms(ev_hyb),
                      "speedup": ev_sp, "speedup_rel_err": rel,
                      "hybrid_vs_analytic": ev_hyb / an_hyb}
        out[wl] = row
    out["_summary"] = {m: {"worst_speedup_rel_err": worst[m]}
                       for m in link_models}
    return out


def policy_report(traces: Dict[str, object], net=None,
                  policies: Iterable[str] = DEFAULT_POLICIES,
                  grid_best: Optional[Dict[str, float]] = None) -> dict:
    """Per-workload event-driven speedups of each policy vs the grid.

    ``grid_best`` optionally supplies the per-workload best static
    (threshold x injection) speedup (e.g. from the batched DSE engine);
    when omitted it is computed here.
    """
    from repro_torch.core.dse import grid_best_speedup
    net = as_network(net or DEFAULT_NET)
    policies = tuple(policies)
    out: dict = {}
    wins = {p: 0 for p in policies}
    for wl, tr in traces.items():
        if grid_best and wl in grid_best:
            gbest = grid_best[wl]
        else:
            gbest = grid_best_speedup(tr, net)
        sim = PacketSim(tr, net)
        row = {"static_grid_best": gbest}
        for p in policies:
            res = sim.run(p)
            sp = sim.run_wired().total_time / res.total_time
            beats = bool(sp >= gbest - 1e-9)
            wins[p] += beats
            row[p] = {"speedup": sp,
                      "time_ms": s_to_ms(res.total_time),
                      "wireless_mb": res.wireless_bytes / 2**20,
                      "beats_grid": beats}
        out[wl] = row
    n = len(traces)
    out["_summary"] = {
        p: {"beats_grid": f"{wins[p]}/{n}",
            "mean_speedup": float(np.mean([out[wl][p]["speedup"]
                                           for wl in traces]))}
        for p in policies}
    return out
