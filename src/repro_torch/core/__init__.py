"""Core: the paper's contribution, on the port's tensors.

Package-scale reproduction (GEMINI-like simulator + wireless overlay),
with the wireless NoP network subsystem (`repro_torch.net`: MAC
arbitration, multi-channel plans, vectorized design-space engine), the
paper's sweeps, the scale-out frontier and the analytic balancer, as in
the JAX package's `core`; and the LM-scale hybrid collective plane
schedule (`hybrid_schedule`) on the port's counts.

Traces are built on the host and evaluated on their device: the CUDA
card unless the caller passes ``device="cpu"`` to `make_trace` or
`scaling_sweep`.  The event-driven (`sim`), heterogeneous-package
(`arch`), fault and observability planes are not ported yet.
"""

from repro_torch.net import ChannelPlan, MacConfig, NetworkConfig, as_network

from .topology import AcceleratorConfig, Topology, build_topology
from .wireless import (WirelessConfig, select_wireless, eligibility,
                       injection_hash)
from .simulator import (SimResult, make_trace, simulate_hybrid,
                        simulate_wired, speedup)
from .dse import (sweep, sweep_all, summary, SweepResult,
                  network_sweep, network_sweep_all, network_summary,
                  NetworkSweepResult, batched_design_space,
                  grid_anchor, grid_best_speedup,
                  SCALING_GRIDS, ScalingResult, reuse_plans, scaled_config,
                  scaling_sweep, scaling_summary)
from .balancer import balance, BalancerResult
from .collectives import CollectiveSpec, collective_bytes
from .mapper import (Mapping, expert_parallel_mapping, pipeline_mapping,
                     spatial_mapping, tensor_parallel_mapping)
from .workloads_llm import LLM_WORKLOADS, make_llm_trace

__all__ = [
    "AcceleratorConfig", "Topology", "build_topology",
    "WirelessConfig", "select_wireless", "eligibility", "injection_hash",
    "NetworkConfig", "ChannelPlan", "MacConfig", "as_network",
    "SimResult", "make_trace", "simulate_hybrid", "simulate_wired",
    "speedup", "sweep", "sweep_all", "summary", "SweepResult",
    "network_sweep", "network_sweep_all", "network_summary",
    "NetworkSweepResult", "batched_design_space",
    "grid_anchor", "grid_best_speedup",
    "SCALING_GRIDS", "ScalingResult", "reuse_plans", "scaled_config",
    "scaling_sweep", "scaling_summary",
    "balance", "BalancerResult",
    "CollectiveSpec", "collective_bytes",
    "Mapping", "pipeline_mapping", "spatial_mapping",
    "tensor_parallel_mapping", "expert_parallel_mapping",
    "LLM_WORKLOADS", "make_llm_trace",
]
