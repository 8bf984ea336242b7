"""The paper's experiment, end to end, on the port: bottleneck
characterisation, the wireless DSE, the Fig. 5 heatmap, the beyond-paper
network sweep (MAC protocols x channel plans) and the analytic balancer
— on the 144-TOPS 3x3-chiplet platform of Table 1.

    PYTHONPATH=src python -m repro_torch.launch.wireless_dse [workload] \
        [--quick] [--mix big_little|compute_mem|aimc_edge] \
        [--device cuda|cpu]

The counterpart of the JAX package's `examples/wireless_dse.py`, with
its event-driven policy sweep (`repro_torch.sim`: online policies
against the best offline-swept static point) and its heterogeneous
package co-design (`repro_torch.arch`: the ``--mix`` chiplet mix,
jointly placed and mapped by a seeded annealer under the wired and the
hybrid objective).  Accepts the paper's 15 workloads AND the LLM
frontier names ("<model>:<phase>", e.g. mixtral_8x22b:prefill —
tensor-/expert-parallel mappings with collective traffic).  The trace
is built on the host and evaluated on ``--device`` (the card by
default).  ``--quick`` trims the per-point heatmap to a 2x3 corner and
the co-design search to 40 annealing steps, one restart and 4 pool
samples.  Speedups are printed with every digit.
"""

from __future__ import annotations

import argparse
import sys

from ..arch import MIXES, codesign
from ..core import (LLM_WORKLOADS, ChannelPlan, MacConfig, NetworkConfig,
                    WirelessConfig, balance, make_trace, network_sweep,
                    policy_sweep, simulate_hybrid, simulate_wired, sweep)
from ..core.dse import INJECTIONS, THRESHOLDS
from ..core.units import gbps_to_bytes_per_s, s_to_ms
from ..core.workloads import WORKLOADS

_PCT = 100.0
_UJ_PER_J = 1e6


def report(wl: str, quick: bool, device: str,
           mix: str = "big_little") -> list:
    """Every section's lines, computed on ``device``."""
    if wl not in WORKLOADS and wl not in LLM_WORKLOADS:
        raise ValueError(f"pick one of {list(WORKLOADS)} or "
                         f"{list(LLM_WORKLOADS)}, not {wl!r}")
    lines = []
    tr = make_trace(wl, device=device)
    base = simulate_wired(tr)
    lines.append(f"== {wl} on 3x3 x 144 TOPS (wired baseline, "
                 f"{tr.device}) ==")
    lines.append(f"execution time: {s_to_ms(base.total_time):.3f} ms")
    lines.append("bottleneck shares: " + str(
        {k: f"{v:.0%}" for k, v in base.bottleneck_share().items()
         if v > 0.005}))
    coll = sum(m.nbytes for m in tr.messages if m.kind == "coll")
    if coll:
        total = sum(m.nbytes for m in tr.messages)
        mcast = sum(m.nbytes for m in tr.messages
                    if m.kind == "coll" and len(m.dsts) > 1)
        lines.append(f"collective traffic: {coll/total:.0%} of NoP bytes "
                     f"({mcast/total:.0%} broadcast-natured multicast)")

    for bw in (64, 96):
        r = sweep(tr, wl, bw)
        lines.append(f"\n== wireless {bw} Gb/s: DSE best speedup "
                     f"{_PCT*(r.best_speedup-1):.1f}% "
                     f"({r.best_speedup!r}; threshold={r.best_threshold}, "
                     f"injection={r.best_injection}) ==")

    thresholds = THRESHOLDS[:2] if quick else THRESHOLDS
    injections = INJECTIONS[::5] if quick else INJECTIONS
    lines.append("\nthreshold x injection heatmap (% speedup, 96 Gb/s):")
    lines.append("thr\\p " + " ".join(f"{p:5.2f}" for p in injections))
    for thr in thresholds:
        row = []
        for p in injections:
            h = simulate_hybrid(tr, WirelessConfig(gbps_to_bytes_per_s(96),
                                                   thr, p))
            row.append(_PCT * (base.total_time / h.total_time - 1))
        lines.append(f"  {thr}   " + " ".join(f"{v:5.1f}" for v in row))

    # beyond-paper: how much of the idealized speedup survives a real
    # MAC, and whether splitting the band into channels helps
    ns = network_sweep(tr, wl)
    table = ns.best_by_network()
    ideal = table[("ideal", "1ch")]
    lines.append("\nnetwork sweep (best % speedup over thr x inj x bw, per "
                 "MAC x channel plan; batched engine):")
    plans = sorted({k[1] for k in table})
    lines.append("  mac   " + " ".join(f"{p:>16s}" for p in plans))
    for mac in ("ideal", "tdma", "token"):
        cells = [f"{_PCT*(table[(mac, p)]-1):7.1f}%"
                 f" ({_PCT*(table[(mac, p)]-ideal):+5.1f})" for p in plans]
        lines.append(f"  {mac:5s} " + " ".join(f"{c:>16s}" for c in cells))
    lines.append(f"best network config: {ns.best_config.describe()} "
                 f"-> {_PCT*(ns.best_speedup-1):.1f}% "
                 f"(idealized optimum keeps {_PCT*(ideal-1):.1f}%)")

    for name, net in (
            ("ideal", NetworkConfig(gbps_to_bytes_per_s(96))),
            ("tdma 2ch", NetworkConfig(gbps_to_bytes_per_s(96),
                                       mac=MacConfig("tdma"),
                                       channels=ChannelPlan(2,
                                                            "interleaved"))),
    ):
        bal = balance(tr, net)
        lines.append(f"\nbeyond-paper balancer [{name}]: "
                     f"{_PCT*(bal.speedup_vs_wired-1):.1f}% "
                     f"(injected {bal.injected_fraction:.0%} of eligible "
                     f"volume, "
                     f"{bal.sim.wireless_energy_j*_UJ_PER_J:.1f} uJ "
                     f"wireless energy)")

    # beyond-paper: the event-driven simulator makes the paper's named
    # future work runnable — ONLINE wired/wireless load balancing,
    # decided per packet from instantaneous queue backlog, vs the best
    # offline-swept static (threshold x injection) point
    ps = policy_sweep(tr, wl)
    lines.append(f"\nevent-driven policy sweep (96 Gb/s, striped links, "
                 f"ideal MAC; wired baseline {s_to_ms(ps.base_time):.3f} "
                 f"ms):")
    lines.append(f"  best static grid point        "
                 f"{_PCT*(ps.grid_best_speedup-1):6.1f}% "
                 f"({ps.grid_best_speedup!r})")
    for pol in ("static", "greedy", "adaptive", "oracle"):
        sp = ps.policy_speedups[pol]
        mark = " <- beats the swept optimum" \
            if pol in ("greedy", "adaptive") \
            and sp >= ps.grid_best_speedup - 1e-9 else ""
        lines.append(f"  {pol:28s}  {_PCT*(sp-1):6.1f}% ({sp!r}){mark}")

    # beyond-paper: heterogeneous package co-design — make the package
    # itself a search variable: a catalog mix of chiplets, jointly placed
    # and mapped by a seeded annealer under the wired and the hybrid
    # objective
    r = codesign(wl, mix, steps=40 if quick else 200,
                 restarts=1 if quick else 2, n_samples=4 if quick else 10,
                 device=device)
    lines.append(f"\nheterogeneous co-design [mix={mix}, "
                 f"{'quick ' if quick else ''}annealed search, "
                 f"{r.n_evaluations} placements evaluated]:")
    lines.append(f"  best package               {r.package}")
    lines.append(f"  wired-optimal placement    "
                 f"{s_to_ms(r.wired.t_wired):10.3f} ms")
    lines.append(f"  co-designed hybrid         "
                 f"{s_to_ms(r.hybrid.t_hybrid):10.3f} ms "
                 f"({_PCT*(r.speedup_codesigned-1):+.1f}%, "
                 f"{r.speedup_codesigned!r})")
    lines.append(f"  greedy seed (hybrid plane) "
                 f"{s_to_ms(r.greedy.t_hybrid):10.3f} ms")
    lines.append(f"  placement spread best-vs-worst: wired "
                 f"{r.spread_wired:.2f}x -> hybrid {r.spread_hybrid:.2f}x"
                 + (" <- wireless shrinks placement sensitivity"
                    if r.spread_hybrid < r.spread_wired else ""))
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("workload", nargs="?", default="zfnet")
    ap.add_argument("--quick", action="store_true",
                    help="a 2x3 corner of the per-point heatmap")
    ap.add_argument("--mix", default="big_little", choices=sorted(MIXES),
                    help="the chiplet mix the co-design section searches")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    lines = report(args.workload, args.quick, args.device, args.mix)
    sys.stdout.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
