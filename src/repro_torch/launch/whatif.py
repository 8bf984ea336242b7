"""Critical-path + what-if walkthrough: what binds, and what would help.

    PYTHONPATH=src python -m repro_torch.launch.whatif [--quick] \
        [--out DIR] [--device cuda|cpu]

The counterpart of the JAX package's `examples/whatif.py`, on
``--device`` (the card by default; ``--device cpu`` runs the CPU
route).  For one paper workload and one LLM phase it records an event
run, then answers the two questions `repro_torch.obs` exists for:

1. **What actually bounds the makespan?**  The critical path over the
   recorded dependency DAG (`obs.critpath`): the top-5 critical
   segments, the per-plane critical shares, and their divergence from
   the raw busy shares — when the two disagree, utilization is lying
   about what to optimise.
2. **What would happen if a resource got faster?**  Three what-if
   projections (`obs.whatif`) replayed straight from the trace —
   wireless bandwidth x2, a 2-channel x4-reuse-zone plan, DRAM x2 —
   each validated against an actual re-simulation where a network
   re-simulation exists.

The Perfetto export carries the critical path as its own process
("critpath"), so the blocking chain reads as one swim-lane at
https://ui.perfetto.dev.  ``--quick`` drops the LLM phase.  Files go to
``--out`` (``build/repro_torch/traces`` by default).
"""

from __future__ import annotations

import argparse
import os
import sys

from ..core import NetworkConfig, make_trace
from ..core.units import gbps_to_bytes_per_s, s_to_ms
from ..obs import (WhatIf, critical_vs_busy, export_chrome_trace,
                   mark_critical, project, validate)
from ..sim import PacketSim
from .trace_inspect import OUT_DIR

_PCT = 100.0
_US_PER_S = 1e6


def inspect(wl: str, out_dir: str, device: str) -> list:
    """One workload's lines; its Perfetto file goes to ``out_dir``."""
    net = NetworkConfig(bandwidth=gbps_to_bytes_per_s(96))
    tr = make_trace(wl, device=device)
    res = PacketSim(tr, net, record=True).run("static")
    st = res.trace

    # -- critical path --------------------------------------------------
    cp = mark_critical(st)      # also flags events for the Perfetto lane
    lines = [f"\n== {wl}: {s_to_ms(res.total_time):.3f} ms over "
             f"{len(st.meta['layer_times'])} layers, "
             f"{len(cp.segments)} critical segments ({tr.device}) ==",
             "top-5 critical segments (crit = incremental makespan "
             "charge):"]
    for s in cp.top_segments(5):
        lines.append(f"  L{s.layer:<3d} {s.track:12s} {s.name:8s} "
                     f"crit={s.crit_dur*_US_PER_S:9.2f} us  ({s.plane})")
    cvb = critical_vs_busy(st, cp)
    lines.append("plane        critical  busy")
    for p in sorted(set(cvb["critical"]) | set(cvb["busy"]),
                    key=lambda p: -cvb["critical"].get(p, 0.0)):
        lines.append(f"  {p:10s} {cvb['critical'].get(p, 0.0):7.1%} "
                     f"{cvb['busy'].get(p, 0.0):7.1%}")
    lines.append(f"divergence (total variation): {cvb['divergence']:.2f} "
                 "— how badly busy-share ranking misleads")

    # -- what-if projections --------------------------------------------
    lines.append("what-if projections (trace replay, no re-simulation):")
    for k in (WhatIf(wireless_scale=2.0),
              WhatIf(n_channels=2, reuse_zones=4),
              WhatIf(dram_scale=2.0)):
        proj = project(st, k)
        line = (f"  {k.describe():20s} -> {s_to_ms(proj.total_time):.3f} "
                f"ms ({_PCT*(proj.speedup-1):+.1f}%)")
        try:    # validate where the knob maps onto a network re-sim
            v = validate(tr, net, k)
            line += f"  [re-sim err {_PCT*v['error']:.2f}%]"
        except ValueError:
            line += "  [no network re-sim for this knob]"
        lines.append(line)

    # -- Perfetto export with the critical-path lane --------------------
    path = os.path.join(out_dir, f"{wl.replace(':', '_')}_critpath.json")
    export_chrome_trace(st, path)
    lines.append(f"wrote {path} (critical path = its own process at "
                 "https://ui.perfetto.dev)")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="zfnet only (no LLM phase)")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    lines = []
    for wl in (["zfnet"] if args.quick
               else ["zfnet", "smollm_360m:prefill"]):
        lines += inspect(wl, args.out, args.device)
    sys.stdout.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
