"""Event-driven packet-level NoP simulator + load-balancing policies.

The third modelling plane (after `repro_torch.core`'s analytic GEMINI
reproduction and `repro_torch.net`'s channel/MAC stack), as the JAX
package's `sim`: a discrete-event simulator over the existing
`TrafficTrace` packetisation that resolves *time* — per-resource queues
on every directed mesh link, DRAM port, and wireless channel — so
online wired/wireless load-balancing policies (the paper's named future
work) become expressible and measurable.

- `calendar` — vectorized event-calendar primitives: segmented
  cumulative sums and first-occurrence flags (tensor code), and the
  host `ResourcePool` the per-packet loop mutates.
- `engine`   — `PacketSim` / `simulate_events`: the simulator.  The
  default configuration (striped cut bundles, pooled DRAM, ideal MAC)
  reproduces the analytic model's layer times exactly; ``adaptive`` /
  ``xy`` link models, per-port DRAM, and per-packet TDMA/token MACs
  add the realism the analytic form averages away.
- `policies` — static (the paper's filter), oracle (offline
  water-filling replay), greedy (per-packet join-shortest-plane), and
  adaptive (per-layer queue-informed filter re-tuning, provably >=
  every static grid point).
- `compare`  — fidelity (event vs analytic) and policy reports.

A simulator runs on its trace's device; per-packet online runs walk the
packets on the host (see `engine`).
"""

from .calendar import ResourcePool, first_occurrence, segment_cumsum
from .compare import fidelity_report, policy_report
from .engine import (DRAM_MODELS, LINK_MODELS, EventResult, PacketSim,
                     simulate_events)
from .policies import (POLICIES, AdaptivePolicy, FixedPolicy, GreedyPolicy,
                       OnlineReshardPolicy, OraclePolicy, Policy,
                       StaticPolicy, get_policy)

__all__ = [
    "ResourcePool", "first_occurrence", "segment_cumsum",
    "fidelity_report", "policy_report",
    "DRAM_MODELS", "LINK_MODELS", "EventResult", "PacketSim",
    "simulate_events",
    "POLICIES", "Policy", "StaticPolicy", "OraclePolicy", "GreedyPolicy",
    "AdaptivePolicy", "OnlineReshardPolicy", "FixedPolicy", "get_policy",
]
