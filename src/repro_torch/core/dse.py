"""Design-space exploration: the paper's parameter sweeps (SIV-A) plus
the network dimensions the paper defers (MAC protocol, channel plan)
and the scale-out frontier (large meshes x spatial channel reuse).

The paper sweeps distance threshold in {1..4} x injection probability in
{0.10..0.80 step 0.05} x wireless bandwidth in {64, 96} Gb/s per
workload and reports the near-optimal configuration — the exploration
behind Fig. 4 and Fig. 5.  `sweep`/`sweep_all` reproduce it; `sweep_all`
runs on the vectorized `repro_torch.net.batched` engine by default (the
per-point loop agrees with it to float precision), and `network_sweep`
widens the grid with MAC protocols and multi-channel plans to report
the best full network configuration per workload — i.e. how much of the
idealized speedup survives a real MAC.  `policy_sweep` pits the
event-driven engine's online policies (`repro_torch.sim`) against the
grid's best point, and `resilience_sweep_all` runs the fault plane's
retained-speedup grid (`repro_torch.fault`).

Grids and design spaces live on the trace's device; each result waits
for it once, to copy its best point to the host.  The heterogeneity
frontier and the what-if guided sweep belong to the `arch` and `obs`
planes, and `provenance` stays None on every result until `obs` runs
here (it is excluded from comparisons).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.net.batched import (BatchedDesignSpace, GridResult,
                                     GridSpec, PAPER_BANDWIDTHS_GBPS,
                                     PAPER_INJECTIONS, PAPER_THRESHOLDS,
                                     argmax_value)
from repro_torch.net.channel import ChannelPlan
from repro_torch.net.config import NetworkConfig
from repro_torch.net.mac import MacConfig
from repro_torch.net.scatter import scatter_sum

from .simulator import (TrafficTrace, make_trace, simulate_hybrid,
                        simulate_wired)
from .topology import AcceleratorConfig
from .traffic import resolve_device
from .units import bytes_per_s_to_gbps, gbps_to_bytes_per_s
from .wireless import eligibility, injection_hash

# the paper's sweep axes (shared with GridSpec's defaults)
THRESHOLDS = PAPER_THRESHOLDS
INJECTIONS = PAPER_INJECTIONS
BANDWIDTHS_GBPS = PAPER_BANDWIDTHS_GBPS

# beyond-paper network axes: MAC protocols and channel plans (equal
# aggregate bandwidth, so plans trade arbitration overhead against
# per-channel load imbalance)
NETWORK_MACS = (MacConfig("ideal"), MacConfig("tdma"), MacConfig("token"))
NETWORK_PLANS = (ChannelPlan(1), ChannelPlan(2, "contiguous"),
                 ChannelPlan(2, "interleaved"), ChannelPlan(4, "interleaved"))


@dataclasses.dataclass
class SweepResult:
    workload: str
    bandwidth_gbps: int
    # speedup grid indexed [threshold, injection], on the trace's device
    grid: torch.Tensor
    best_speedup: float
    best_threshold: int
    best_injection: float
    provenance: Optional[dict] = dataclasses.field(
        default=None, compare=False)


def _result_from_grid(workload: str, bandwidth_gbps: int,
                      grid: torch.Tensor) -> SweepResult:
    best, flat = argmax_value(grid)
    ti, pi = np.unravel_index(flat, grid.shape)
    return SweepResult(workload, bandwidth_gbps, grid, best,
                       THRESHOLDS[ti], INJECTIONS[pi])


def sweep(trace: TrafficTrace, workload: str, bandwidth_gbps: int,
          mac: MacConfig | None = None,
          channels: ChannelPlan | None = None) -> SweepResult:
    """Per-point (threshold x injection) sweep via `simulate_hybrid`."""
    mac = mac if mac is not None else MacConfig("ideal")
    channels = channels if channels is not None else ChannelPlan(1)
    base = simulate_wired(trace).total_time
    grid = np.zeros((len(THRESHOLDS), len(INJECTIONS)))
    for ti, thr in enumerate(THRESHOLDS):
        for pi, p in enumerate(INJECTIONS):
            cfg = NetworkConfig(bandwidth=gbps_to_bytes_per_s(bandwidth_gbps),
                                distance_threshold=thr, injection_prob=p,
                                channels=channels, mac=mac)
            grid[ti, pi] = base / simulate_hybrid(trace, cfg).total_time
    return _result_from_grid(workload, bandwidth_gbps,
                             torch.from_numpy(grid).to(trace.device))


def batched_design_space(trace: TrafficTrace,
                         thresholds=THRESHOLDS) -> BatchedDesignSpace:
    """Assemble the vectorized engine's inputs from a traffic trace.

    The per-packet and per-layer cut loads are reduced straight from
    the sparse (message -> link) incidence by scatter sums on the
    trace's device — the dense per-link load matrix is never
    materialised.  The build is memoized on the trace (traces are
    immutable once built), its tensors on the trace's device.
    """
    key = tuple(thresholds)
    cached = getattr(trace, "_batched_dse", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    built = _build_design_space(trace, thresholds)
    trace._batched_dse = (key, built)
    return built


def _build_design_space(trace: TrafficTrace,
                        thresholds) -> BatchedDesignSpace:
    cut_mat, cut_bw = trace.cut_matrix()
    inc_cut = cut_mat[trace.inc_link]                  # (E, C)
    inc_bytes = trace.nbytes[trace.inc_msg]
    inc_layer = trace.layer[trace.inc_msg]
    pkt_cut = scatter_sum(trace.inc_msg, inc_cut, len(trace.nbytes))
    cut_base = scatter_sum(inc_layer, inc_bytes[:, None] * inc_cut,
                           trace.n_layers)
    t_rest = torch.stack([trace.t_compute, trace.t_dram,
                          trace.t_noc]).amax(dim=0)
    # the layer sum on the host, as NumPy sums it
    base_time = float(torch.maximum(t_rest, (cut_base / cut_bw).amax(dim=1))
                      .cpu().numpy().sum())
    return BatchedDesignSpace(
        n_layers=trace.n_layers,
        n_nodes=trace.topo.n_nodes,
        layer=trace.layer,
        nbytes=trace.nbytes,
        src=trace.src,
        eligibility={t: eligibility(trace, t) for t in thresholds},
        inj_hash=injection_hash(len(trace.nbytes), trace.device),
        pkt_cut=pkt_cut,
        cut_base=cut_base,
        cut_bw=cut_bw,
        t_rest=t_rest,
        base_time=base_time,
        max_hops=trace.max_hops,
        grid=trace.topo.config.grid,
        node_coords=trace.node_coords(),
    )


def sweep_all(traces: Dict[str, TrafficTrace],
              engine: str = "batched") -> List[SweepResult]:
    """The paper's full sweep over workloads x bandwidths.

    ``engine="batched"`` (default) evaluates every workload's whole
    (threshold x injection x bandwidth) grid with one pass of the
    vectorized engine; ``engine="loop"`` keeps the per-point
    `simulate_hybrid` double loop (the two agree to float precision).
    """
    if engine not in ("batched", "loop"):
        raise ValueError(f"unknown engine {engine!r}; use 'batched' or 'loop'")
    out = []
    if engine == "loop":
        for wl, trace in traces.items():
            for bw in BANDWIDTHS_GBPS:
                out.append(sweep(trace, wl, bw))
    else:
        spec = GridSpec()
        for wl, trace in traces.items():
            res = batched_design_space(trace).evaluate(spec)
            for bw in BANDWIDTHS_GBPS:
                out.append(_result_from_grid(wl, bw, res.ideal_grid(bw)))
    return out


@dataclasses.dataclass
class NetworkSweepResult:
    """Full network design space for one workload."""

    workload: str
    result: GridResult
    best_speedup: float
    best_config: NetworkConfig
    provenance: Optional[dict] = dataclasses.field(
        default=None, compare=False)

    def best_by_network(self) -> Dict[Tuple[str, str], float]:
        """(mac protocol, plan) -> best speedup over thr/inj/bw."""
        spec = self.result.spec
        best = self.result.speedup.flatten(2).amax(dim=2).tolist()
        return {(m.protocol, p.describe()): best[mi][pi]
                for mi, m in enumerate(spec.macs)
                for pi, p in enumerate(spec.plans)}


def network_sweep(trace: TrafficTrace, workload: str,
                  macs=NETWORK_MACS,
                  plans=NETWORK_PLANS) -> NetworkSweepResult:
    """Sweep MAC x channel-plan on top of the paper's grid (batched)."""
    spec = GridSpec(macs=tuple(macs), plans=tuple(plans))
    res = batched_design_space(trace).evaluate(spec)
    best, cfg = res.best()
    return NetworkSweepResult(workload, res, best, cfg)


def network_sweep_all(traces: Dict[str, TrafficTrace],
                      macs=NETWORK_MACS,
                      plans=NETWORK_PLANS) -> List[NetworkSweepResult]:
    return [network_sweep(tr, wl, macs, plans)
            for wl, tr in traces.items()]


def grid_anchor(trace: TrafficTrace,
                net: NetworkConfig) -> Tuple[float, int, float]:
    """(best speedup, threshold, injection) of the one-point anchor grid.

    The single (bandwidth, MAC, channel-plan) point every comparison
    anchors against — the balancer's per-layer stitch uses THIS helper.
    The exact bandwidth is threaded through (`GridSpec` accepts
    fractional Gb/s)."""
    spec = GridSpec(bandwidths_gbps=(bytes_per_s_to_gbps(net.bandwidth),),
                    macs=(net.mac,), plans=(net.channels,))
    res = batched_design_space(trace).evaluate(spec)
    best, flat = argmax_value(res.speedup)
    _, _, _, ti, ii = np.unravel_index(flat, res.speedup.shape)
    return best, spec.thresholds[ti], spec.injections[ii]


def grid_best_speedup(trace: TrafficTrace, net: NetworkConfig) -> float:
    """Best static (threshold x injection) speedup at ``net``'s
    bandwidth / MAC / channel plan, via the batched engine."""
    return grid_anchor(trace, net)[0]


# ---------------------------------------------------------------------------
# the event-driven policy sweep and the resilience grid
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PolicySweepResult:
    """Event-driven policy comparison for one workload.

    The paper's DSE picks ONE static (threshold x injection) point per
    workload offline; the event-driven engine (`repro_torch.sim`) lets
    online policies compete with that optimum on the same trace and
    network.
    """

    workload: str
    net: NetworkConfig
    base_time: float               # event-driven all-wired baseline
    grid_best_speedup: float       # best static grid point (same network)
    policy_speedups: Dict[str, float]
    policy_times: Dict[str, float]
    provenance: Optional[dict] = dataclasses.field(
        default=None, compare=False)

    def best_policy(self) -> Tuple[str, float]:
        name = max(self.policy_speedups, key=self.policy_speedups.get)
        return name, self.policy_speedups[name]


def policy_sweep(trace: TrafficTrace, workload: str,
                 net: NetworkConfig | None = None,
                 policies=("static", "greedy", "adaptive", "oracle")
                 ) -> PolicySweepResult:
    """Event-driven sweep of load-balancing policies on one workload,
    on the trace's device.

    The static grid best is evaluated with the batched engine (exact
    for the event engine's default striped/ideal configuration).
    """
    from repro_torch.sim import PacketSim  # late import: core re-exports sim
    net = net or NetworkConfig(bandwidth=gbps_to_bytes_per_s(96))
    grid_best = grid_best_speedup(trace, net)
    sim = PacketSim(trace, net)
    base = sim.run_wired().total_time
    times = {p: sim.run(p).total_time for p in policies}
    return PolicySweepResult(
        workload=workload, net=net, base_time=base,
        grid_best_speedup=grid_best,
        policy_speedups={p: base / t for p, t in times.items()},
        policy_times=times)


def policy_sweep_all(traces: Dict[str, TrafficTrace],
                     net: NetworkConfig | None = None,
                     policies=("static", "greedy", "adaptive", "oracle")
                     ) -> List[PolicySweepResult]:
    return [policy_sweep(tr, wl, net, policies)
            for wl, tr in traces.items()]


def resilience_sweep_all(workloads, net: NetworkConfig | None = None,
                         ks=(0, 1, 2), fades=(3.0, 9.0),
                         policies=("static", "adaptive",
                                   "online-reshard"),
                         device=None) -> Dict:
    """The retained-speedup grid (`repro_torch.fault`).

    Cells are (k fail-stops) x (package fade dB); each runs every
    policy against the same scenario, with the online-reshard row
    routed through the era-rebuild controller.  The returned dict is
    `repro_torch.fault.resilience.resilience_sweep`'s (traces built on
    ``device``: the card when None, raising without one), plus a
    ``"provenance"`` entry, None until the `obs` plane is ported.
    """
    from repro_torch.fault import resilience_sweep  # late: fault imports sim
    net = net or NetworkConfig(bandwidth=gbps_to_bytes_per_s(96))
    out = resilience_sweep(workloads, net, ks=tuple(ks), fades=tuple(fades),
                           policies=tuple(policies), device=device)
    out["provenance"] = None
    return out


# ---------------------------------------------------------------------------
# the scale-out frontier: large meshes x spatial channel reuse
# ---------------------------------------------------------------------------

# mesh sizes of the scaling study (3x3 is the paper's baseline point)
SCALING_GRIDS = ((4, 4), (6, 6), (8, 8), (12, 12), (16, 16))


def scaled_config(grid: Tuple[int, int], n_dram: int | None = None,
                  base: AcceleratorConfig | None = None) -> AcceleratorConfig:
    """Weak-scaled platform: Table-1 per-chiplet resources on an RxC mesh.

    Every per-chiplet rate (compute, NoC, NoP link, DRAM module pin
    rate) keeps its paper value; the package totals scale with the
    chiplet count, and the DRAM module count scales with the perimeter
    (four per full 4-chiplet side span, so a 16x16 package carries 16
    modules).  The *wireless* band does NOT scale — that is the
    experiment: a single shared medium serves ever more transmitters,
    which is exactly where spatial reuse earns its keep.
    """
    rows, cols = grid
    base = base or AcceleratorConfig()
    if n_dram is None:
        n_dram = max(4, 4 * (-(-max(rows, cols) // 4)))
    per_chip = base.tops_total / (base.grid[0] * base.grid[1])
    return dataclasses.replace(
        base, grid=(rows, cols), n_dram=n_dram,
        tops_total=per_chip * rows * cols,
        # per-chiplet vectors are geometry-bound; a scaled mesh restarts
        # from the uniform package
        chiplet_tops=None, chiplet_noc_bw=None, chiplet_sram=None,
        chiplet_pj_per_mac=None, chiplet_pj_per_bit_noc=None)


def reuse_plans(grid: Tuple[int, int],
                n_channels: int = 1) -> Tuple[ChannelPlan, ...]:
    """Candidate spatial-reuse plans for one mesh: zone tiles of 4 and 2.

    Coarse tiles keep more traffic zone-local (large reuse distance);
    fine tiles buy more concurrent zones.  The scaling sweep evaluates
    both and reports the better — on a mesh too small to tile (3x3,
    4x4 with tile 4) the list may be empty: there is nothing to reuse.
    """
    rows, cols = grid
    plans = []
    seen = set()
    for tile in (4, 2):
        zones = (-(-rows // tile)) * (-(-cols // tile))
        if zones > 1 and zones not in seen:
            seen.add(zones)
            plans.append(ChannelPlan(n_channels, reuse_zones=zones))
    return tuple(plans)


@dataclasses.dataclass
class ScalingResult:
    """One (mesh, workload) point of the scale-out frontier."""

    workload: str
    grid: Tuple[int, int]
    n_chiplets: int
    wired_time: float
    best_single: float            # best speedup, single shared channel
    best_reuse: float             # best speedup over the reuse plans
    best_reuse_plan: str          # describe() of the winning plan ("1ch"
    #                               when no reuse plan fits the mesh)
    provenance: Optional[dict] = dataclasses.field(
        default=None, compare=False)

    @property
    def recovered(self) -> float:
        """Speedup the reuse plans recover over the shared channel."""
        return self.best_reuse - self.best_single


def scaling_sweep(workloads=None, grids=SCALING_GRIDS,
                  bandwidth_gbps: float = 96,
                  engine: str = "batched",
                  device=None) -> List[ScalingResult]:
    """The scale-out frontier: (mesh size x wireless plan) per workload.

    For every mesh in ``grids`` (weak-scaled via `scaled_config`) and
    every workload, sweep the paper's (threshold x injection) grid for
    (i) the single shared wireless channel and (ii) the spatial-reuse
    plans of `reuse_plans`, and report the best speedup of each — the
    frontier showing where the global serialization point collapses and
    how much of the speedup distance-gated reuse recovers.

    ``engine="batched"`` (default) evaluates each (mesh, workload) grid
    in one vectorized pass; ``engine="loop"`` runs the naive per-point
    `simulate_hybrid` double loop.  Workload names may be paper
    workloads or LLM frontier names ("<model>:<phase>").  The traces are
    built on the host and evaluated on ``device``: the CUDA card when
    None (raises without one; pass ``device="cpu"``).
    """
    if engine not in ("batched", "loop"):
        raise ValueError(f"unknown engine {engine!r}; use 'batched' or 'loop'")
    device = resolve_device(device)
    if workloads is None:
        from .workloads import WORKLOADS
        workloads = list(WORKLOADS)
    out: List[ScalingResult] = []
    for grid in grids:
        acc = scaled_config(tuple(grid))
        plans = (ChannelPlan(1),) + reuse_plans(tuple(grid))
        spec = GridSpec(bandwidths_gbps=(bandwidth_gbps,), plans=plans)
        for wl in workloads:
            trace = make_trace(wl, acc, device=device)
            if engine == "batched":
                res = batched_design_space(trace).evaluate(spec)
                sp = res.speedup[0, :, 0]            # (plan, thr, inj)
                base = res.base_time
            else:
                base = simulate_wired(trace).total_time
                sp = torch.tensor([[[
                    base / simulate_hybrid(trace, NetworkConfig(
                        bandwidth=gbps_to_bytes_per_s(bandwidth_gbps),
                        distance_threshold=thr, injection_prob=p,
                        channels=plan)).total_time
                    for p in spec.injections]
                    for thr in spec.thresholds]
                    for plan in plans], dtype=torch.float64)
            per_plan = sp.flatten(1).amax(dim=1).tolist()
            best_single = per_plan[0]
            if len(plans) > 1:
                ri = 1 + int(np.argmax(per_plan[1:]))
                best_reuse, plan_desc = per_plan[ri], plans[ri].describe()
            else:
                best_reuse, plan_desc = best_single, plans[0].describe()
            out.append(ScalingResult(
                workload=wl, grid=tuple(grid),
                n_chiplets=acc.n_chiplets,
                wired_time=base,
                best_single=best_single, best_reuse=best_reuse,
                best_reuse_plan=plan_desc))
    return out


def scaling_summary(results: List[ScalingResult]
                    ) -> Dict[str, Dict[str, float]]:
    """Per-mesh aggregates of a `scaling_sweep` run."""
    out: Dict[str, Dict[str, float]] = {}
    for grid in sorted({r.grid for r in results}):
        rs = [r for r in results if r.grid == grid]
        out[f"{grid[0]}x{grid[1]}"] = {
            "mean_single": float(np.mean([r.best_single for r in rs])),
            "max_single": float(np.max([r.best_single for r in rs])),
            "mean_reuse": float(np.mean([r.best_reuse for r in rs])),
            "max_reuse": float(np.max([r.best_reuse for r in rs])),
            "mean_recovered": float(np.mean([r.recovered for r in rs])),
            "n": len(rs),
        }
    return out


def summary(results: List[SweepResult]) -> Dict[int, Tuple[float, float]]:
    """bandwidth -> (mean best speedup, max best speedup) over workloads.

    Bandwidths with no results are omitted."""
    out = {}
    for bw in BANDWIDTHS_GBPS:
        sp = [r.best_speedup for r in results if r.bandwidth_gbps == bw]
        if sp:
            out[bw] = (float(np.mean(sp)), float(np.max(sp)))
    return out


def network_summary(results: List[NetworkSweepResult]
                    ) -> Dict[Tuple[str, str], Tuple[float, float]]:
    """(mac, plan) -> (mean, max) best speedup over workloads."""
    keys = results[0].best_by_network().keys() if results else []
    tables = [r.best_by_network() for r in results]
    out = {}
    for key in keys:
        sp = [t[key] for t in tables]
        out[key] = (float(np.mean(sp)), float(np.max(sp)))
    return out
