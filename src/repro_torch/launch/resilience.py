"""Resilience walkthrough: dynamic conditions on the hybrid package.

    PYTHONPATH=src python -m repro_torch.launch.resilience [workload] \
        [--quick] [--device cuda|cpu]

The counterpart of the JAX package's `examples/resilience.py`, on the
port's `sim` and `fault` planes, on ``--device`` (the card by default;
without one it raises, and ``--device cpu`` runs the CPU route):

1. **Inject** — a chiplet fail-stop plus an SNR fade mid-run; compare
   the wired-only counterfactual, the paper's static filter, and the
   online-reshard policy under the SAME degraded conditions.
2. **Explain** — record the faulted run (`repro_torch.obs`) and show
   where the critical path moved (the dead chip's inflated compute vs
   the faded wireless channel) relative to the fault-free run.
3. **Decide** — the `reshard_run` controller prices degraded mode vs
   a heartbeat-gated placement rebuild, and a retained-speedup
   mini-grid reproduces one row of the JAX package's `fig_resilience`
   benchmark.

``--quick`` trims act 3's grid.  Retained speedups are printed with
every digit.
"""

from __future__ import annotations

import argparse
import sys
from typing import Tuple

from ..core import NetworkConfig, make_trace
from ..core.units import gbps_to_bytes_per_s, s_to_ms
from ..fault import (ChipFailure, FaultScenario, SnrFade, default_scenario,
                     reshard_run, resilience_sweep)
from ..obs import critical_path, critical_vs_busy
from ..sim import PacketSim


def inject(workload: str, net: NetworkConfig,
           device) -> Tuple[FaultScenario, list]:
    """Act 1's scenario and lines."""
    tr = make_trace(workload, device=device)
    n = tr.topo.config.n_chiplets
    sc = FaultScenario(
        chip_failures=(ChipFailure(n // 2, at_layer=tr.n_layers // 3),),
        snr_fades=(SnrFade(6.0),))
    lines = [f"== inject: {sc.describe()} on {workload} ({tr.device}) =="]
    sim0 = PacketSim(tr, net)
    simf = PacketSim(tr, net, faults=sc)
    wired0 = sim0.run_wired().total_time
    wiredf = simf.run_wired().total_time
    lines.append(f"  wired-only:      {s_to_ms(wired0):8.3f} ms fault-free "
                 f"-> {s_to_ms(wiredf):8.3f} ms faulted")
    for pol in ("static", "online-reshard"):
        t0 = sim0.run(pol).total_time
        tf = simf.run(pol).total_time
        retained = (wiredf / tf) / (wired0 / t0)
        lines.append(f"  {pol:<15s}  {s_to_ms(t0):8.3f} ms fault-free -> "
                     f"{s_to_ms(tf):8.3f} ms faulted  "
                     f"(retained {retained:.1%}, {retained!r})")
    return sc, lines


def explain(workload: str, net: NetworkConfig, sc: FaultScenario,
            device) -> list:
    """Act 2's lines: each run's three largest critical shares."""
    lines = ["== explain: critical-path shift under the scenario =="]
    tr = make_trace(workload, device=device)
    for label, faults in (("fault-free", None), ("faulted", sc)):
        res = PacketSim(tr, net, record=True, faults=faults).run("static")
        cp = critical_path(res.trace)
        crit = critical_vs_busy(res.trace, cp)["critical"]
        top = sorted(crit, key=crit.get, reverse=True)[:3]
        lines.append(f"  {label:<10s} critical share: " + ", ".join(
            f"{k}={crit[k]:.0%} ({crit[k]!r})" for k in top))
    return lines


def decide(workload: str, net: NetworkConfig, quick: bool, device) -> list:
    """Act 3's lines."""
    lines = ["== decide: reshard controller + retained-speedup row =="]
    tr = make_trace(workload, device=device)
    sc = default_scenario(tr, k=1, fade_db=3.0)
    oc = reshard_run(workload, net, sc, device=device)
    verdict = "reshard" if oc.resharded else "stay degraded"
    lines.append(f"  degraded {s_to_ms(oc.degraded_time):.3f} ms vs "
                 f"resharded {s_to_ms(oc.resharded_time):.3f} ms "
                 f"(migration {s_to_ms(oc.migration_time):.3f} ms) -> "
                 f"{verdict}")
    for ev in oc.events:
        lines.append(f"  recovery event: layer {ev.step} {ev.kind} "
                     f"workers={ev.workers} new_mesh={ev.new_mesh}")
    ks, fades = ((0, 1), (3.0,)) if quick else ((0, 1, 2), (3.0, 9.0))
    grid = resilience_sweep([workload], net, ks=ks, fades=fades,
                            device=device)
    for cell, d in grid[workload]["cells"].items():
        lines.append(f"  {cell:<10s} " + "  ".join(
            f"{p}={d[p]['retained']:.1%} ({d[p]['retained']!r})"
            for p in d))
    return lines


def report(workload: str, quick: bool, device: str) -> list:
    net = NetworkConfig(bandwidth=gbps_to_bytes_per_s(96))
    sc, lines = inject(workload, net, device)
    return (lines + explain(workload, net, sc, device)
            + decide(workload, net, quick, device))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("workload", nargs="?", default="zfnet")
    ap.add_argument("--quick", action="store_true",
                    help="act 3's grid cut to k in (0, 1) at 3 dB")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    lines = report(args.workload, args.quick, args.device)
    sys.stdout.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
