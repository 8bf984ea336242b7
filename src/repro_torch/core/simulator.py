"""GEMINI-style layer-wise bottleneck simulator, wired and hybrid.

Per paper SIII-C: GEMINI is not cycle-accurate.  Per layer it computes the
compute time, the DRAM time, and aggregated NoC/NoP interconnect times,
declares the max of these the layer's bottleneck, and sums the per-layer
maxima into the total execution time.  We add the wireless channel as one
more per-layer term and keep the paper's dual-path accounting: wireless-
designated messages are ALSO costed on the wired path for the baseline, so
the speedup compares against unmodified GEMINI.

The wired NoP term models link congestion explicitly: per-layer byte loads
are accumulated on each directed XY-mesh link and the NoP time is the most
loaded link's service time — this is the "congested bisection links"
mechanism the paper identifies.

Every array stays on the trace's device; a result waits for the device
once, when `_finalize` copies its per-layer vectors and energies to the
host.  `SimResult.layer_times` and `layer_terms` stay tensors there.
Under an active recorder (``with repro_torch.obs.recording(st):``) the
same copy carries the per-layer terms, from which `_finalize` emits the
analytic timeline into ``st`` on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.net.config import NetworkConfig, as_network
from repro_torch.obs.trace import active_recorder
from repro_torch.net.stack import network_layer_times

from .mapper import pipeline_mapping, spatial_mapping
from .topology import AcceleratorConfig, build_topology
from .traffic import TrafficTrace, build_trace, resolve_device
from .units import BITS_PER_BYTE, pj_to_j
from .wireless import WirelessConfig, select_wireless, wireless_energy_joules
from .workloads import get_workload

BOTTLENECKS = ("compute", "dram", "noc", "nop", "wireless")

# Energy model (GEMINI/Accelergy-style constants): the paper's evaluation
# framework optimises EDP; we account energy alongside latency.
PJ_PER_MAC = 0.5            # bf16 MAC @ 7-nm class
PJ_PER_BIT_DRAM = 15.0      # DRAM access + interface
PJ_PER_BIT_NOP_HOP = 1.5    # wired D2D per hop (interposer SerDes)
PJ_PER_BIT_NOC = 0.3        # on-chip mesh, aggregate per transported bit
PJ_PER_BIT_WIRELESS = 1.0   # mm-wave transceiver (paper SI: ~1 pJ/bit)


@dataclasses.dataclass
class SimResult:
    total_time: float
    layer_times: torch.Tensor        # (L,) on the trace's device
    bottleneck: List[str]
    wireless_bytes: float = 0.0
    wireless_energy_j: float = 0.0
    energy_j: float = 0.0            # total platform energy per inference
    layer_terms: Optional[torch.Tensor] = None   # (L, 5) per-term stack

    @property
    def edp(self) -> float:
        """Energy-delay product (the GEMINI objective)."""
        return self.energy_j * self.total_time

    def bottleneck_share(self) -> Dict[str, float]:
        """Fraction of total time attributed to each bottleneck (Fig. 2).

        A degenerate (zero-time) run has no bottleneck: the explicit
        convention is an empty dict.
        """
        if not self.total_time:
            return {}
        shares = {b: 0.0 for b in BOTTLENECKS}
        for t, b in zip(self.layer_times.tolist(), self.bottleneck):
            shares[b] += t
        return {b: v / self.total_time for b, v in shares.items()}


def cut_times(trace: TrafficTrace,
              link_loads: torch.Tensor) -> torch.Tensor | None:
    """(L, n_cuts) service time of each directed mesh cut per layer, or
    None on a trace with no NoP link."""
    if not link_loads.numel():
        return None
    cut_mat, cut_bw = trace.cut_matrix()
    return link_loads @ cut_mat / cut_bw


def nop_times(trace: TrafficTrace, link_loads: torch.Tensor) -> torch.Tensor:
    """(L,) worst directed mesh-cut service time per layer ("congested
    bisection links"); zero on a trace with no NoP link."""
    t_cut = cut_times(trace, link_loads)
    if t_cut is None:
        return torch.zeros(trace.n_layers, dtype=torch.float64,
                           device=trace.device)
    return t_cut.amax(dim=1)


def _finalize(trace: TrafficTrace, link_loads: torch.Tensor,
              t_wireless: torch.Tensor, wl_bytes: torch.Tensor | None = None,
              wireless_energy_j=0.0, extra_bytes=0.0) -> SimResult:
    """Layer times, bottlenecks and energies of one configuration.

    ``wl_bytes`` is the (L,) wireless payload per layer.  The per-layer
    vectors and the energies reach the host in one copy; the totals over
    layers are then summed there as NumPy sums them, so a CPU run equals
    the JAX package's bit for bit where the layer terms do.
    """
    L = trace.n_layers
    t_cut = cut_times(trace, link_loads)
    t_nop = (t_cut.amax(dim=1) if t_cut is not None
             else torch.zeros(L, dtype=torch.float64, device=trace.device))
    stack = torch.stack([trace.t_compute, trace.t_dram, trace.t_noc, t_nop,
                         t_wireless])
    layer_times = stack.amax(dim=0)
    which = stack.argmax(dim=0)
    if wl_bytes is None:
        wl_bytes = torch.zeros_like(layer_times)
    energy = energy_joules(trace, link_loads, wl_bytes.sum() + extra_bytes)
    wl_energy = (wireless_energy_j if isinstance(wireless_energy_j,
                                                 torch.Tensor)
                 else torch.full((), wireless_energy_j, dtype=torch.float64,
                                 device=trace.device))
    st = active_recorder()
    parts = [layer_times, which.to(torch.float64), wl_bytes, energy.view(1),
             wl_energy.view(1)]
    if st is not None:   # the terms ride the same copy
        parts += [stack.reshape(-1)] + ([] if t_cut is None
                                        else [t_cut.reshape(-1)])
    host = torch.cat(parts).cpu().numpy()
    if st is not None:
        _record_analytic(st, host[3 * L + 2:], L, t_cut is not None)
    return SimResult(
        total_time=float(host[:L].sum()),
        layer_times=layer_times,
        bottleneck=[BOTTLENECKS[int(i)] for i in host[L:2 * L]],
        wireless_bytes=float(host[2 * L:3 * L].sum()),
        wireless_energy_j=float(host[3 * L + 1]),
        energy_j=float(host[3 * L]),
        layer_terms=stack.T.contiguous(),
    )


def _record_analytic(st, terms: np.ndarray, L: int, has_cuts: bool) -> None:
    """The analytic timeline of one configuration into ``st``, from the
    host copy of its (5, L) term stack and (L, n_cuts) cut times:
    coarse spans on the same tracks as the event engine's, with an
    ``an:`` category prefix, so merged exports line up track for
    track."""
    stack = terms[:5 * L].reshape(5, L)
    layer_times = stack.max(axis=0)
    which = stack.argmax(axis=0)
    st.add_layer_matrix(stack[0][:, None], "compute", "an:compute")
    st.add_layer_matrix(stack[2][:, None], "noc", "an:noc")
    st.add_layer_matrix(stack[1][:, None], "dram(pooled)", "an:dram-agg")
    if has_cuts:
        st.add_layer_matrix(terms[5 * L:].reshape(L, -1), "cut{}",
                            "an:wired")
    for li in range(L):
        st.add_layer_event(
            "layers", f"L{li}:{BOTTLENECKS[which[li]]}", li, 0.0,
            float(layer_times[li]), "layer",
            **{b: float(stack[i, li]) for i, b in enumerate(BOTTLENECKS)})
    st.place_layers(layer_times)
    st.meta.setdefault("plane", "analytic")
    st.meta["total_time"] = float(layer_times.sum())


def mac_energy_pj(trace: TrafficTrace):
    """Compute energy (pJ), heterogeneity-aware.

    Per-MAC coefficients live on the package (`AcceleratorConfig
    .chiplet_pj_per_mac`); a uniform coefficient vector collapses to the
    legacy `total_macs * pj` product (bit-identical homogeneous energy),
    a heterogeneous one charges each chiplet's MACs at its own rate.
    """
    pj = trace.topo.config.chiplet_pj_per_mac
    if pj is None or trace.macs_per_chiplet is None:
        return trace.total_macs * PJ_PER_MAC
    if all(v == pj[0] for v in pj):
        return trace.total_macs * float(pj[0])
    return trace.macs_per_chiplet @ torch.tensor(
        pj, dtype=torch.float64, device=trace.device)


def noc_energy_pj(trace: TrafficTrace):
    """On-chip-mesh transport energy (pJ), heterogeneity-aware (see
    `mac_energy_pj`; coefficients from `chiplet_pj_per_bit_noc`)."""
    pj = trace.topo.config.chiplet_pj_per_bit_noc
    if pj is None or trace.noc_bytes_per_chiplet is None:
        return trace.noc_bytes * BITS_PER_BYTE * PJ_PER_BIT_NOC
    if all(v == pj[0] for v in pj):
        return trace.noc_bytes * BITS_PER_BYTE * float(pj[0])
    return trace.noc_bytes_per_chiplet @ torch.tensor(
        pj, dtype=torch.float64, device=trace.device) * BITS_PER_BYTE


def energy_joules(trace: TrafficTrace, link_loads: torch.Tensor,
                  wireless_bytes=0.0) -> torch.Tensor:
    """Platform energy per inference: compute + DRAM + NoC + NoP + WL,
    a 0-dim float64 tensor on the trace's device."""
    e = pj_to_j(mac_energy_pj(trace))
    e = e + pj_to_j(trace.dram_bytes.sum() * BITS_PER_BYTE
                    * PJ_PER_BIT_DRAM)
    e = e + pj_to_j(noc_energy_pj(trace))
    e = e + pj_to_j(link_loads.sum() * BITS_PER_BYTE * PJ_PER_BIT_NOP_HOP)
    e = e + pj_to_j(wireless_bytes * BITS_PER_BYTE * PJ_PER_BIT_WIRELESS)
    return e


def wired_loads_without(trace: TrafficTrace,
                        injected: torch.Tensor) -> torch.Tensor:
    """(L, n_links) baseline loads less the injected packets' bytes, each
    subtracted in incidence order (packets outside the set subtract 0)."""
    loads = trace.baseline_link_loads()
    gone = torch.where(injected[trace.inc_msg], trace.nbytes[trace.inc_msg],
                       0.0)
    loads.view(-1).index_put_((trace.inc_flat(),), -gone, accumulate=True)
    return loads


def geometry(trace: TrafficTrace) -> dict:
    """`network_layer_times` geometry kwargs (spatial-reuse plans)."""
    return dict(grid=trace.topo.config.grid,
                node_coords=trace.node_coords(),
                max_hops=trace.max_hops)


def simulate_wired(trace: TrafficTrace) -> SimResult:
    """Baseline: everything over the wired NoP."""
    return _finalize(trace, trace.baseline_link_loads(),
                     torch.zeros(trace.n_layers, dtype=torch.float64,
                                 device=trace.device))


def simulate_hybrid(trace: TrafficTrace,
                    wcfg: WirelessConfig | NetworkConfig) -> SimResult:
    """Hybrid wired+wireless under the paper's decision function.

    Accepts the legacy `WirelessConfig` (single shared channel, ideal
    MAC — the paper's model) or a `repro_torch.net.NetworkConfig` with an
    explicit MAC protocol and multi-channel plan.
    """
    net = as_network(wcfg)
    injected = select_wireless(trace, net)
    # wired plane: baseline loads minus the injected messages' contributions
    loads = wired_loads_without(trace, injected)
    # wireless plane: per-channel MAC-costed service, max over channels
    # — per (channel, zone class) under a spatial-reuse plan
    # (degenerate 1-channel ideal plan == the paper's volume/bandwidth)
    t_wireless, wl_bytes, extra_bytes = network_layer_times(
        trace.n_layers, trace.layer, trace.nbytes, trace.src,
        trace.topo.n_nodes, injected, net, **geometry(trace))
    return _finalize(trace, loads, t_wireless, wl_bytes,
                     wireless_energy_joules(trace, injected, net,
                                            extra_bytes), extra_bytes)


def make_trace(workload: str, acc: AcceleratorConfig | None = None,
               mapping: str | None = None, device=None) -> TrafficTrace:
    """Convenience: workload name -> traffic trace on the default platform.

    The paper's 15 Table-1 workloads map with "pipeline" (GEMINI/
    SET-style, default) or "spatial" (full spatial split; the
    mapping-sensitivity contrast point).  LLM frontier names
    ("<model>:<phase>", e.g. "mixtral_8x22b:decode") route through
    `workloads_llm.make_llm_trace`, defaulting to the family's natural
    parallelism (expert-parallel for MoE, tensor-parallel otherwise)
    with its collective phases — "tensor"/"tensor_ring"/"expert" pick
    explicitly.  The trace is built on the host and lands on ``device``:
    the CUDA card when None (raises without one; pass ``device="cpu"``).
    """
    device = resolve_device(device)
    if ":" in workload:
        from .workloads_llm import make_llm_trace
        return make_llm_trace(workload, acc, mapping, device=device)
    topo = build_topology(acc)
    layers = get_workload(workload)
    if mapping in (None, "pipeline"):
        mapped = pipeline_mapping(layers, topo)
    elif mapping == "spatial":
        mapped = spatial_mapping(layers, topo)
    elif mapping in ("tensor", "tensor_ring"):
        from .mapper import tensor_parallel_mapping
        mapped = tensor_parallel_mapping(
            layers, topo,
            algorithm="ring" if mapping == "tensor_ring" else "tree")
    else:
        raise ValueError(f"unknown mapping {mapping!r}")
    return build_trace(layers, mapped, topo, device=device)


def speedup(trace: TrafficTrace, wcfg: WirelessConfig | NetworkConfig) -> float:
    base = simulate_wired(trace).total_time
    hybrid = simulate_hybrid(trace, wcfg).total_time
    return base / hybrid
