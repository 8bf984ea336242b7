"""Core: the paper's contribution, on the port's tensors.

Package-scale reproduction (GEMINI-like simulator + wireless overlay),
with the wireless NoP network subsystem (`repro_torch.net`: MAC
arbitration, multi-channel plans, vectorized design-space engine), the
paper's sweeps, the scale-out frontier and the analytic balancer, as in
the JAX package's `core`; and the LM-scale hybrid collective plane
schedule (`hybrid_schedule`) on the port's counts.

Traces are built on the host and evaluated on their device: the CUDA
card unless the caller passes ``device="cpu"`` to `make_trace` or
`scaling_sweep`.  The event-driven plane (`repro_torch.sim`) and the
heterogeneous-package plane (`repro_torch.arch`) are re-exported
lazily, as in the JAX package, with the policy sweeps (`policy_sweep`,
`policy_sweep_all`), the fault plane's `resilience_sweep_all`, the
what-if guided sweep (`whatif_guided`, on `repro_torch.obs`) and the
heterogeneity frontier (`hetero_sweep`, `hetero_summary`) in `dse`.
"""

from repro_torch.net import ChannelPlan, MacConfig, NetworkConfig, as_network

from .topology import AcceleratorConfig, Topology, build_topology
from .wireless import (WirelessConfig, select_wireless, eligibility,
                       injection_hash)
from .simulator import (SimResult, make_trace, simulate_hybrid,
                        simulate_wired, speedup)
from .dse import (sweep, sweep_all, summary, SweepResult,
                  whatif_guided, GuidedSweepResult,
                  network_sweep, network_sweep_all, network_summary,
                  NetworkSweepResult, batched_design_space,
                  grid_anchor, grid_best_speedup,
                  policy_sweep, policy_sweep_all, PolicySweepResult,
                  resilience_sweep_all, hetero_sweep, hetero_summary,
                  SCALING_GRIDS, ScalingResult, reuse_plans, scaled_config,
                  scaling_sweep, scaling_summary)
from .balancer import balance, BalancerResult
from .collectives import CollectiveSpec, collective_bytes
from .mapper import (Mapping, expert_parallel_mapping, pipeline_mapping,
                     spatial_mapping, tensor_parallel_mapping)
from .workloads_llm import LLM_WORKLOADS, make_llm_trace

# `repro_torch.sim` (the event-driven engine) and `repro_torch.arch`
# (heterogeneous packages + placement co-design) are re-exported lazily
# (PEP 562): both import `repro_torch.core` submodules, so an eager
# import here would make the packages' initialisation order observable.
# Attribute access resolves against the fully-initialised package on
# first use.
_SIM_EXPORTS = (
    "PacketSim", "EventResult", "simulate_events",
    "StaticPolicy", "OraclePolicy", "GreedyPolicy", "AdaptivePolicy",
    "FixedPolicy", "get_policy", "POLICIES",
    "fidelity_report", "policy_report",
)
_ARCH_EXPORTS = (
    "ChipletSpec", "HeteroPackage", "CATALOG", "MIXES",
    "PlacementProblem", "PlacementResult", "CodesignResult",
    "codesign", "anneal", "exhaustive", "greedy_seed",
)


def __getattr__(name):
    if name in _SIM_EXPORTS:
        import repro_torch.sim
        return getattr(repro_torch.sim, name)
    if name in _ARCH_EXPORTS:
        import repro_torch.arch
        return getattr(repro_torch.arch, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "AcceleratorConfig", "Topology", "build_topology",
    "WirelessConfig", "select_wireless", "eligibility", "injection_hash",
    "NetworkConfig", "ChannelPlan", "MacConfig", "as_network",
    "SimResult", "make_trace", "simulate_hybrid", "simulate_wired",
    "speedup", "sweep", "sweep_all", "summary", "SweepResult",
    "whatif_guided", "GuidedSweepResult",
    "network_sweep", "network_sweep_all", "network_summary",
    "NetworkSweepResult", "batched_design_space",
    "grid_anchor", "grid_best_speedup",
    "policy_sweep", "policy_sweep_all", "PolicySweepResult",
    "resilience_sweep_all", "hetero_sweep", "hetero_summary",
    "SCALING_GRIDS", "ScalingResult", "reuse_plans", "scaled_config",
    "scaling_sweep", "scaling_summary",
    "balance", "BalancerResult",
    "CollectiveSpec", "collective_bytes",
    "Mapping", "pipeline_mapping", "spatial_mapping",
    "tensor_parallel_mapping", "expert_parallel_mapping",
    "LLM_WORKLOADS", "make_llm_trace",
    *_SIM_EXPORTS,
    *_ARCH_EXPORTS,
]
