"""Scenario -> model arrays: how a `FaultScenario` lands on the planes.

Three independent effect groups, matching where each condition
physically bites:

- **chip events** are *trace-level*: they inflate the per-layer
  compute (and, for fail-stop, DRAM) terms that `build_trace` derived
  from the mapping.  `derate_trace` returns a new `TrafficTrace` with
  the same packet tensors (masks stay aligned) and derated
  ``t_compute``/``t_dram``.
- **link failures** are *wired-plane-level*: per-(layer, cut) service
  scaling for the striped model, per-(layer, link) detour remaps for
  the xy model, and the forced-failover packet set for fully-dead
  cuts.  `link_fault_arrays` feeds `repro_torch.sim.engine.PacketSim`.
- **SNR fades** are *wireless-plane-level*: per-(layer, channel)
  effective bandwidth through the `SnrProfile` Shannon capacity ratio.

Degraded-mode fail-stop model (static policies, no reshard): the dead
chiplet's share is absorbed by its surviving exec-set peers at their
rates — per layer the exec group's effective throughput is the
share-weighted capacity ``sum(share_c * g_c)`` with ``g_c`` in
``{0, 1/factor, 1}``, so the layer's compute time inflates by
``total_share / capacity``.  A fully-dead exec set falls back to one
emergency absorber at single-chiplet rate (``total / max_share``).
The absorbed weight slice is re-streamed from DRAM every inference
(the absorber has no SRAM budget reserved for it): ``dead_share *
weight_bytes / dram_bw_total`` is added to the layer's DRAM term.
Traffic geometry is unchanged — the absorber adopts the dead chip's
router position, and interposer routers survive compute-die death.

Bit-identity contract (the differential pin): zero-magnitude events
produce *exactly* the fault-free numbers — the compute inflation is
the ratio ``total / (shares * g).sum()`` which is exactly 1.0 when
every ``g`` is 1.0 (same summation order), `derate_trace` returns the
*same trace object* when nothing changed, and a 0 dB fade scales
bandwidth by exactly 1.0 (`SnrProfile.capacity_scale`).

Where it runs: the per-layer loops (`derate_trace`, the detour remap of
`link_fault_arrays`) and the fade matrix run on the host, in NumPy, on
host copies of per-layer vectors; each result lands on the trace's
device once.  The forced-failover set is tensor code over the trace's
incidences on its device.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.topology import node_grid_coords
from repro_torch.core.traffic import TrafficTrace

from .scenario import DETOUR_FACTOR, FaultScenario

#: a failed chiplet keeps a vanishing compute rate in reshard rebuilds
#: (`AcceleratorConfig.chiplet_tops` must stay positive); rate-aware
#: mappers then assign it a vanishing share.
DEAD_CHIP_RATE_SCALE = 1e-9


def _host(x) -> np.ndarray:
    """A NumPy copy of a tensor (any device) or an array."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy().copy()
    return np.array(x)


# ---------------------------------------------------------------------------
# chip events -> trace derating
# ---------------------------------------------------------------------------

def derate_trace(trace: TrafficTrace,
                 scenario: FaultScenario) -> TrafficTrace:
    """Degraded-mode compute/DRAM inflation for chip events.

    Returns ``trace`` itself (same object) when no layer is affected,
    so fault-free configurations stay bit-identical.
    """
    if not scenario.has_chip_events:
        return trace
    if trace.exec_chips is None or trace.exec_shares is None:
        raise ValueError(
            "trace has no exec_chips/exec_shares metadata (hand-built?); "
            "rebuild it with repro_torch.core.traffic.build_trace to "
            "inject chip faults")
    n_chips = trace.topo.config.n_chiplets
    for ev in scenario.chip_failures + scenario.chip_slowdowns:
        if ev.chip >= n_chips:
            raise ValueError(
                f"chip {ev.chip} out of range for a {n_chips}-chiplet "
                f"package")
    t_comp = _host(trace.t_compute)
    t_dram = _host(trace.t_dram)
    dram_bw = trace.topo.config.dram_bw_total
    changed = False
    for li in range(trace.n_layers):
        chips = trace.exec_chips[li]
        if not chips:
            continue
        shares = np.asarray(trace.exec_shares[li], float)
        g = np.ones(len(chips))
        dead = np.zeros(len(chips), bool)
        for ev in scenario.chip_slowdowns:
            if li >= ev.at_layer:
                for k, c in enumerate(chips):
                    if c == ev.chip:
                        g[k] = min(g[k], 1.0 / ev.factor)
        for ev in scenario.chip_failures:
            if li >= ev.at_layer:
                for k, c in enumerate(chips):
                    if c == ev.chip:
                        dead[k], g[k] = True, 0.0
        if not dead.any() and np.all(g == 1.0):
            continue   # zero-magnitude / out-of-exec-set: untouched
        changed = True
        total = float(shares.sum())
        capacity = float((shares * g).sum())
        if capacity > 0.0:
            t_comp[li] *= total / capacity
        else:   # fully-dead exec set: one emergency single-chip absorber
            t_comp[li] *= total / float(shares.max())
        if dead.any() and trace.weight_bytes is not None:
            dead_share = float(shares[dead].sum())
            t_dram[li] += dead_share * float(trace.weight_bytes[li]) \
                / dram_bw
    if not changed:
        return trace
    dev = trace.device
    return dataclasses.replace(trace,
                               t_compute=torch.from_numpy(t_comp).to(dev),
                               t_dram=torch.from_numpy(t_dram).to(dev))


# ---------------------------------------------------------------------------
# link failures -> wired-plane arrays
# ---------------------------------------------------------------------------

def resolve_link_failures(trace: TrafficTrace,
                          scenario: FaultScenario
                          ) -> List[Tuple[int, int]]:
    """``(link_id, at_layer)`` pairs for the trace's link index."""
    out: List[Tuple[int, int]] = []
    for ev in scenario.link_failures:
        pairs = [(ev.a, ev.b)]
        if ev.both_directions:
            pairs.append((ev.b, ev.a))
        for pair in pairs:
            if pair not in trace.link_index:
                if ev.both_directions and pair == (ev.b, ev.a):
                    continue   # one-way topologies: forward leg suffices
                raise ValueError(
                    f"no mesh link {pair[0]} -> {pair[1]} in this trace")
            out.append((trace.link_index[pair], ev.at_layer))
    return out


def link_fault_arrays(trace: TrafficTrace, scenario: FaultScenario, *,
                      cut_of_link, k_par, n_cuts: int
                      ) -> Tuple[Optional[torch.Tensor],
                                 Optional[torch.Tensor],
                                 Optional[torch.Tensor],
                                 Optional[torch.Tensor]]:
    """``(cut_scale, link_remap, link_cost, forced)`` for the engine,
    tensors on the trace's device.

    - ``cut_scale (L, n_cuts)`` float64: striped service-time
      multiplier ``k / surviving`` (``inf`` on fully-dead cuts).
    - ``link_remap (L, n_links)`` int64: xy substitute link (the
      lowest-indexed surviving parallel link of the same cut; identity
      when alive or when the whole cut is dead).
    - ``link_cost (L, n_links)`` float64: xy service multiplier — 1
      alive, `DETOUR_FACTOR` on remapped crossings, ``inf`` on dead
      cuts.
    - ``forced (M,)`` bool: packets with a crossing on a fully-dead cut
      at their layer; the runtime diverts them to the wireless plane
      regardless of the paper's eligibility criteria (physical
      necessity), while wired-only baselines pay the infinity.

    ``cut_of_link`` and ``k_par`` may be tensors (any device) or arrays.
    All four are None when the scenario has no link failures.
    """
    fails = resolve_link_failures(trace, scenario)
    if not fails:
        return None, None, None, None
    cut_of_link, k_par = _host(cut_of_link), _host(k_par)
    L, n_links, M = trace.n_layers, trace.n_links, len(trace.nbytes)
    dead = np.zeros((L, n_links), bool)
    for lid, at in fails:
        dead[at:, lid] = True
    onehot = np.zeros((n_links, n_cuts))
    onehot[np.arange(n_links), cut_of_link] = 1.0
    dead_cnt = dead.astype(float) @ onehot            # (L, n_cuts), exact
    surv = k_par[None, :].astype(float) - dead_cnt
    cut_scale = np.ones((L, n_cuts))
    hit = dead_cnt > 0
    alive = surv > 0
    sel = hit & alive
    cut_scale[sel] = (k_par[None, :] / np.where(alive, surv, 1.0))[sel]
    cut_scale[hit & ~alive] = np.inf

    link_remap = np.tile(np.arange(n_links), (L, 1))
    link_cost = np.ones((L, n_links))
    for li in np.nonzero(dead.any(axis=1))[0]:
        for lid in np.nonzero(dead[li])[0]:
            cut = cut_of_link[lid]
            siblings = np.nonzero((cut_of_link == cut) & ~dead[li])[0]
            if len(siblings):
                link_remap[li, lid] = siblings[0]
                link_cost[li, lid] = DETOUR_FACTOR
            else:
                link_cost[li, lid] = np.inf

    # forced failover, over the incidences on the trace's device: a
    # packet is forced when any of its crossings hits a dead cut
    dev = trace.device
    alive_t = torch.from_numpy(alive).to(dev)
    cut_t = torch.from_numpy(cut_of_link.astype(np.int64)).to(dev)
    hits = (~alive_t[trace.layer[trace.inc_msg],
                     cut_t[trace.inc_link]]).to(torch.int64)
    forced = torch.zeros(M, dtype=torch.int64, device=dev).scatter_add_(
        0, trace.inc_msg, hits) > 0
    return (torch.from_numpy(cut_scale).to(dev),
            torch.from_numpy(link_remap.astype(np.int64)).to(dev),
            torch.from_numpy(link_cost).to(dev), forced)


# ---------------------------------------------------------------------------
# SNR fades -> wireless-plane bandwidth
# ---------------------------------------------------------------------------

def wireless_bw_matrix(trace: TrafficTrace, net,
                       scenario: FaultScenario) -> Optional[torch.Tensor]:
    """Per-(layer, channel) effective wireless bandwidth in B/s, float64
    on the trace's device (built on the host, copied once).

    Cumulative: concurrent fades on one channel add in dB.  Zero-fade
    entries carry exactly the nominal per-channel rate.  None when the
    scenario has no fades.
    """
    if not scenario.snr_fades:
        return None
    plan = net.channels
    L, C = trace.n_layers, plan.n_channels
    fade = np.zeros((L, C))
    for ev in scenario.snr_fades:
        if ev.channel is not None and ev.channel >= C:
            raise ValueError(
                f"fade channel {ev.channel} out of range for a "
                f"{C}-channel plan")
        cols = slice(None) if ev.channel is None else ev.channel
        fade[ev.at_layer:, cols] += ev.fading_db
    dist = scenario.snr.channel_distances(
        plan, trace.topo.n_nodes, node_grid_coords(trace.topo))
    scale = scenario.snr.capacity_scale(dist[None, :],
                                        torch.from_numpy(fade))
    return (plan.channel_bandwidth(net.bandwidth) * scale).to(trace.device)
