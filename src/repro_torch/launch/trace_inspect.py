"""Observability walkthrough: record a run, export it, explain it.

    PYTHONPATH=src python -m repro_torch.launch.trace_inspect [workload] \
        [--quick] [--out DIR] [--device cuda|cpu]

The counterpart of the JAX package's `examples/trace_inspect.py`, on
``--device`` (the card by default; without one it raises, and
``--device cpu`` runs the CPU route).  One workload runs through BOTH
time-resolving planes with the recorder on — the event-driven packet
simulator (`record=True`) and the analytic balancer (under
`recording(st)`) — then:

- exports a merged Chrome Trace Event JSON (open it at
  https://ui.perfetto.dev: one process per modelling plane, one thread
  per resource, counter tracks for queue depth / bytes moved),
- exports the compact lossless ``.npz`` form of the event trace,
- checks the busy-time invariant (per-resource event durations must sum
  to the engine's own busy aggregates),
- prints the attribution report — the decomposition of each layer span
  into service vs queueing vs quiescence that turns `bottleneck_share`'s
  "which resource" into "why",
- dumps the metrics-registry report (span timers, provenance counters).

``--quick`` switches to the small zfnet CNN.  Files go to ``--out``
(``build/repro_torch/traces`` by default).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from ..core import (LLM_WORKLOADS, ChannelPlan, NetworkConfig, balance,
                    make_trace)
from ..core.units import gbps_to_bytes_per_s, s_to_ms
from ..core.workloads import WORKLOADS
from ..obs import (DEFAULT_REGISTRY, SimTrace, attribution_report,
                   attribution_summary, export_chrome_trace, export_npz,
                   format_attribution, recording)
from ..sim import PacketSim

OUT_DIR = os.path.join("build", "repro_torch", "traces")
_PCT = 100.0


def report(wl: str, quick: bool, device: str, out_dir: str) -> list:
    """The walkthrough's lines; its files go to ``out_dir``."""
    if wl not in WORKLOADS and wl not in LLM_WORKLOADS:
        raise ValueError(f"pick one of {list(WORKLOADS)} or "
                         f"{list(LLM_WORKLOADS)}, not {wl!r}")
    os.makedirs(out_dir, exist_ok=True)
    safe = wl.replace(":", "_")
    # a 2-channel spatial-reuse plan so the trace shows the global-phase
    # quiesce the attribution report is built to explain
    net = NetworkConfig(bandwidth=gbps_to_bytes_per_s(96),
                        channels=ChannelPlan(n_channels=2, reuse_zones=4))
    tr = make_trace(wl, device=device)

    # -- event plane, recorded ------------------------------------------
    with DEFAULT_REGISTRY.span("launch.trace_inspect", workload=wl):
        sim = PacketSim(tr, net, record=True)
        res = sim.run("greedy")
    lines = [f"== {wl}: event-driven greedy run, recorder on "
             f"({tr.device}) ==",
             f"execution time: {s_to_ms(res.total_time):.3f} ms "
             f"({res.total_time!r} s), {len(res.trace)} trace events on "
             f"{len(res.trace.tracks())} tracks",
             "bottleneck shares: " + str(
                 {k: f"{v:.0%}" for k, v in res.bottleneck_share().items()
                  if v > 0.005})]

    # per-resource event durations must reproduce the engine's own busy
    # aggregates (tests/test_torch_obs.py pins it at 1e-12)
    wired = res.trace.busy_by_resource("wired", sim.n_cuts, "cut")
    wl_busy = res.trace.busy_by_resource(
        "wireless", net.channels.n_channels, "ch")
    if not (np.allclose(wired, res.cut_busy.cpu().numpy(), rtol=1e-12,
                        atol=0.0)
            and np.allclose(wl_busy, res.channel_busy.cpu().numpy(),
                            rtol=1e-12, atol=0.0)):
        raise AssertionError("busy-time invariant broken: the trace's "
                             "busy differs from the engine's")
    lines.append("busy-time invariant: trace == engine aggregates "
                 "(1e-12) OK")

    # -- analytic plane, recorded (same workload, balancer timeline) ----
    st_an = SimTrace(label=f"analytic:{wl}")
    with recording(st_an):
        bal = balance(tr, net)
    lines.append(f"analytic balancer: {s_to_ms(bal.sim.total_time):.3f} ms "
                 f"({_PCT*(bal.speedup_vs_wired-1):.1f}% over wired), "
                 f"{len(st_an)} analytic events")

    # -- exports --------------------------------------------------------
    chrome = os.path.join(out_dir, f"{safe}_trace.json")
    export_chrome_trace({"event": res.trace, "analytic": st_an}, chrome)
    npz = os.path.join(out_dir, f"{safe}_trace.npz")
    export_npz(res.trace, npz)
    lines.append(f"\nwrote {chrome} (open at https://ui.perfetto.dev) "
                 f"and {npz}")

    # -- attribution: from "which resource" to "why" --------------------
    lines += ["\n== attribution (heaviest rows) ==",
              "service = payload time on the resource; queueing = packets "
              "waiting for FIFO position;\nquiesce = the slice of queueing "
              "behind the channel's long-range global phase;\nfinish = "
              "when the resource drained within its layer span.",
              format_attribution(attribution_report(res),
                                 top=8 if quick else 12),
              "\n== bottleneck summary =="]
    for bn, e in attribution_summary(res).items():
        why = f" — {e['track']} {e['why']}" if e["track"] else ""
        lines.append(f"  {bn}: {e['share']:.0%}{why}")

    # -- metrics registry -----------------------------------------------
    rep = DEFAULT_REGISTRY.report()
    mpath = os.path.join(out_dir, f"{safe}_metrics.json")
    with open(mpath, "w") as f:
        json.dump(rep, f, indent=1, sort_keys=True, default=str)
    lines.append(f"\nmetrics report ({len(rep)} series) -> {mpath}")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("workload", nargs="?", default=None)
    ap.add_argument("--quick", action="store_true",
                    help="the small zfnet CNN when no workload is named")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    wl = args.workload or ("zfnet" if args.quick else "smollm_360m:prefill")
    lines = report(wl, args.quick, args.device, args.out)
    sys.stdout.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
