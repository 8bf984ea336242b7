"""Beyond-paper: analytic wired/wireless load balancer.

The paper sweeps (distance threshold x injection probability) and notes
that a "mechanism to balance the load between the wired and wireless
planes" is needed (SIV-B, SV) but leaves it to future work.  We build it.

Observation: per layer, the hybrid layer time is

    T(v) = max(T_rest, worst_cut_wired(V - v) / BW_cut, T_mac(v))

where v is the volume steered to the wireless plane out of the eligible
volume V and T_mac is the MAC-costed service time of the hottest
wireless channel.  The wired term falls and the wireless term rises
monotonically in v, so the optimum equalises them (water-filling),
clipped by eligibility and by T_rest (compute/DRAM/NoC floor) — there
is no benefit in rebalancing past the point where another element is
the bottleneck.

Greedy realisation: per layer, repeatedly move the eligible packet that
contributes most to the currently hottest mesh cut, while the hottest
wireless *channel* (under the configured MAC protocol and channel
plan) finishes no later than the hottest wired cut and the NoP still
exceeds the layer's floor.  A packet whose acceptance would overshoot
the wired time is discarded from candidacy (the wired side only gets
cheaper and the wireless side only costlier, so it can never become
acceptable later) and the search continues with smaller contributors.

The greedy pass is then anchored against the paper's sweep: the best
static (threshold x injection) grid point is evaluated on the same
trace/network, and each layer keeps whichever injected set — greedy
water-filling or the grid optimum — projects the smaller layer time
(layers are independent in the analytic model, so the per-layer stitch
is exact).  The balancer therefore matches or beats every (threshold,
injection) grid point *by construction*.

Where it runs: the greedy loop decides one packet at a time, so it runs
on the host, in NumPy, on host copies of the trace's arrays, one layer
at a time (a device launch per accepted packet would be pure overhead);
the anchor grid, both candidates' costings, the stitch and the final
costing run on the trace's device, and the result lands there.  With a
fault scenario (`repro_torch.fault`) the greedy pass sees the degraded
planes, from host copies of the fault plane's arrays.  Under an
active recorder (`repro_torch.obs.recording`) the trial evaluations
(the anchor grid, both candidates' costings, the wired baseline) run
with the recorder masked, so only the final timeline is emitted, with
one span a layer on the ``balance`` track for the stitch's choice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.net.config import NetworkConfig, as_network
from repro_torch.net.mac import mac_times
from repro_torch.net.stack import network_layer_times
from repro_torch.obs.trace import active_recorder, recording

from .simulator import (SimResult, _finalize, geometry, nop_times,
                        simulate_wired, wired_loads_without)
from .traffic import TrafficTrace
from .wireless import (WirelessConfig, eligibility, injection_filter,
                       wireless_energy_joules)


@dataclasses.dataclass
class BalancerResult:
    sim: SimResult
    injected: torch.Tensor        # bool per packet, on the trace's device
    speedup_vs_wired: float
    injected_fraction: float      # of eligible volume


def _mask_parts(trace: TrafficTrace, mask: torch.Tensor,
                net: NetworkConfig):
    """Per-layer (link loads, wired NoP time, wireless time) of a mask."""
    loads = wired_loads_without(trace, mask)
    t_wl, _, _ = network_layer_times(
        trace.n_layers, trace.layer, trace.nbytes, trace.src,
        trace.topo.n_nodes, mask, net, **geometry(trace))
    return loads, nop_times(trace, loads), t_wl


def _stitch_best(trace: TrafficTrace, net: NetworkConfig,
                 greedy_mask: torch.Tensor, t_rest: torch.Tensor):
    """Per-layer stitch of the greedy mask against the best grid point:
    ``(final mask, link loads, use_grid, t_grid, t_greedy)``.

    Trial evaluations (the anchor sweep and both candidate costings)
    run with the recorder masked — only the final chosen timeline is
    ever emitted into an active `SimTrace`.
    """
    from .dse import grid_anchor    # no cycle: dse doesn't import us
    with recording(None):
        _, thr, p = grid_anchor(trace, net)
        grid_mask = (eligibility(trace, thr)
                     & injection_filter(len(trace.nbytes), p, trace.device))
        gl, gnop, gwl = _mask_parts(trace, grid_mask, net)
        bl, bnop, bwl = _mask_parts(trace, greedy_mask, net)
    t_grid = torch.stack([t_rest, gnop, gwl]).amax(dim=0)
    t_greedy = torch.stack([t_rest, bnop, bwl]).amax(dim=0)
    use_grid = t_grid < t_greedy            # prefer greedy on ties
    final = torch.where(use_grid[trace.layer], grid_mask, greedy_mask)
    loads = torch.where(use_grid[:, None], gl, bl)
    return final, loads, use_grid, t_grid, t_greedy


def _record_stitch(st, use_grid: torch.Tensor, t_grid: torch.Tensor,
                   t_greedy: torch.Tensor) -> None:
    """One span per layer on the "balance" track: which candidate the
    stitch kept, and both projected times for the why (one host copy)."""
    g, tg, tb = torch.stack([use_grid.to(torch.float64), t_grid,
                             t_greedy]).cpu().numpy()
    for li in range(len(g)):
        st.add_layer_event(
            "balance", "grid" if g[li] else "greedy", li, 0.0,
            float(tg[li] if g[li] else tb[li]), "balancer",
            t_grid=float(tg[li]), t_greedy=float(tb[li]))


def _wl_time(mac, ch_bytes, ch_msgs, ch_active, bw_c, n_reuse) -> float:
    """Hottest-channel time of a (n_ch, n_zcls) aggregate matrix.

    With spatial reuse the last zone class is the global phase that
    quiesces every zone; a channel finishes at global + slowest zone."""
    t = mac_times(mac, ch_bytes, ch_msgs, ch_active, bw_c)
    if n_reuse == 1:
        return float(t[:, 0].max())
    return float((t[:, n_reuse] + t[:, :n_reuse].amax(dim=1)).max())


def _fault_planes(trace: TrafficTrace, net: NetworkConfig, faults):
    """Host ``(cut_scale (L, n_cuts), bw_mat (L, n_channels))`` of a
    fault scenario; None entries are fault-free planes."""
    if faults is None or faults.is_null:
        return None, None
    from repro_torch.fault.apply import (link_fault_arrays,  # no cycle
                                         wireless_bw_matrix)
    cut_mat, cut_bw = trace.cut_matrix()
    link_bw = trace.topo.config.nop_bw_per_side
    cut_scale, _, _, _ = link_fault_arrays(
        trace, faults, cut_of_link=cut_mat.argmax(dim=1),
        k_par=torch.round(cut_bw / link_bw).to(torch.int64),
        n_cuts=cut_mat.shape[1])
    bw_mat = wireless_bw_matrix(trace, net, faults)
    return tuple(None if t is None else t.cpu().numpy()
                 for t in (cut_scale, bw_mat))


def _greedy(trace: TrafficTrace, net: NetworkConfig,
            eligible: torch.Tensor, t_rest: torch.Tensor,
            faults=None) -> np.ndarray:
    """The water-filling pass, per layer on host copies: the bool mask
    of the packets it moves to the wireless plane.  Under ``faults``
    each layer's cut times are scaled by ``k / surviving`` (``inf`` on
    dead cuts) and its channels served at their faded rates."""
    from .dse import batched_design_space   # its per-packet cut counts
    cut_scale, bw_mat = _fault_planes(trace, net, faults)
    plan, mac = net.channels, net.mac
    n_ch, Z = plan.n_channels, plan.reuse_zones
    n_zc = 1 if Z == 1 else Z + 1
    bw_c = plan.channel_bandwidth(net.bandwidth)
    pkt_ch = plan.assign(trace.topo.n_nodes, trace.device)[trace.src]
    # zone class per packet: its source's zone when the hop span stays
    # within the reuse distance, else the channel-global class
    if Z == 1:
        pkt_zc = torch.zeros_like(pkt_ch)
    else:
        zone_of_node, rd = plan.assign_spatial(trace.topo.config.grid,
                                               trace.node_coords())
        pkt_zc = torch.where(trace.max_hops <= rd, zone_of_node[trace.src],
                             Z)
    cut_mat, cut_bw = trace.cut_matrix()
    # per-packet link lists from the sparse incidence, by packet
    order = torch.sort(trace.inc_msg, stable=True)[1]
    (layer, nbytes, src, pkt_ch, pkt_zc, eligible, t_rest, loads, cut_mat,
     cut_bw, inc_msg, inc_link, pkt_cut) = (
        t.cpu().numpy() for t in (
            trace.layer, trace.nbytes, trace.src, pkt_ch, pkt_zc, eligible,
            t_rest, trace.baseline_link_loads(), cut_mat, cut_bw,
            trace.inc_msg[order], trace.inc_link[order],
            batched_design_space(trace).pkt_cut))
    starts = np.searchsorted(inc_msg, np.arange(len(nbytes) + 1))

    injected = np.zeros(len(nbytes), bool)
    for li in range(trace.n_layers):
        cand = np.nonzero((layer == li) & eligible)[0]
        if cand.size == 0:
            continue
        layer_loads = loads[li].copy()
        # per-(channel, zone-class) aggregates on this layer's wireless
        # plane (one column per channel when the plan has no reuse)
        ch_bytes = np.zeros((n_ch, n_zc))
        ch_msgs = np.zeros((n_ch, n_zc))
        ch_srcs = [[set() for _ in range(n_zc)] for _ in range(n_ch)]
        ch_active = np.zeros((n_ch, n_zc))
        remaining = np.ones(cand.size, bool)
        bw_li = (bw_c if bw_mat is None
                 else torch.from_numpy(bw_mat[li][:, None]))
        state_changed = True
        while remaining.any():
            if state_changed:  # rejections leave the planes untouched
                cut_t = layer_loads @ cut_mat / cut_bw
                if cut_scale is not None:   # degraded stripes, dead cuts
                    # an idle dead cut is 0 * inf = nan, as in the JAX
                    # package: argmax then picks it and the layer stops
                    with np.errstate(invalid="ignore"):
                        cut_t = cut_t * cut_scale[li]
                hot = int(cut_t.argmax())
                t_nop = cut_t[hot]
                t_wl = _wl_time(mac, ch_bytes, ch_msgs, ch_active, bw_li, Z)
                if t_nop <= t_wl or t_nop <= t_rest[li]:
                    break  # balanced, or another element already dominates
                on_hot = pkt_cut[cand, hot] > 0
                state_changed = False
            # the first remaining eligible packet contributing most to
            # the hot cut
            c = np.where(remaining & on_hot, nbytes[cand], 0.0)
            j = int(c.argmax())
            if not c[j] > 0.0:
                break  # nothing eligible touches the hot cut
            remaining[j] = False
            mi = cand[j]
            ch, zc = pkt_ch[mi], pkt_zc[mi]
            # trial: this packet lands on its source's (channel, zone)
            row_b = ch_bytes[ch].copy()
            row_m = ch_msgs[ch].copy()
            row_a = ch_active[ch].copy()
            row_b[zc] += nbytes[mi]
            row_m[zc] += 1
            row_a[zc] = len(ch_srcs[ch][zc] | {int(src[mi])})
            t_row = mac_times(mac, row_b, row_m, row_a,
                              bw_c if bw_mat is None
                              else float(bw_mat[li, ch]))
            new_t_ch = float(t_row[0] if n_zc == 1
                             else t_row[Z] + t_row[:Z].max())
            # accept only if the wireless plane stays the earlier
            # finisher; a rejected packet can never fit later (the wired
            # side only falls, the wireless side only rises) — drop it
            # and keep searching smaller contributors
            if max(t_wl, new_t_ch) > t_nop:
                continue
            injected[mi] = True
            ch_bytes[ch] = row_b
            ch_msgs[ch] = row_m
            ch_srcs[ch][zc].add(int(src[mi]))
            ch_active[ch] = row_a
            layer_loads[inc_link[starts[mi]:starts[mi + 1]]] -= nbytes[mi]
            state_changed = True
    return injected


def balance(trace: TrafficTrace,
            wcfg: WirelessConfig | NetworkConfig,
            faults=None) -> BalancerResult:
    """Water-filling balance of the wired and wireless planes, anchored
    against the best static grid point of the same network;
    ``faults`` re-runs it against the *surviving* topology.

    With a `repro_torch.fault.FaultScenario`, the greedy per-layer loop
    sees the degraded planes: cut service scaled by ``k/surviving``
    (``inf`` on dead cuts, so everything eligible drains to wireless),
    and per-(layer, channel) effective bandwidth under the SNR fades.
    Chip events act on the trace, not the network — pass a
    `derate_trace`d trace (the engine does this for `OraclePolicy` /
    `OnlineReshardPolicy`).  The grid-anchor stitch and the returned
    `sim` timing fields stay fault-free projections: under faults the
    product is the ``injected`` mask (a candidate the fault-aware
    engine re-stitches exactly).
    """
    net = as_network(wcfg)
    eligible = eligibility(trace, threshold=1)  # balancer sees everything
    t_rest = torch.stack([trace.t_compute, trace.t_dram,
                          trace.t_noc]).amax(dim=0)
    greedy = torch.from_numpy(_greedy(trace, net, eligible, t_rest,
                                      faults)).to(trace.device)

    # anchor against the paper's sweep: per layer, keep whichever injected
    # set — greedy water-filling or the best static grid point — projects
    # the smaller layer time (exact: layers are independent analytically)
    injected, loads, use_grid, t_grid, t_greedy = _stitch_best(
        trace, net, greedy, t_rest)
    st = active_recorder()
    if st is not None:
        _record_stitch(st, use_grid, t_grid, t_greedy)

    # re-derive the wireless timeline + MAC energy overhead from the final
    # injected set through the same stack the simulator uses
    t_wireless, wl_bytes, extra_bytes = network_layer_times(
        trace.n_layers, trace.layer, trace.nbytes, trace.src,
        trace.topo.n_nodes, injected, net, **geometry(trace))
    sim = _finalize(trace, loads, t_wireless, wl_bytes,
                    wireless_energy_joules(trace, injected, net,
                                           extra_bytes), extra_bytes)
    with recording(None):   # the baseline is a trial, not the timeline
        base = simulate_wired(trace).total_time
    nbytes = trace.nbytes.cpu().numpy()
    elig_vol = float(nbytes[eligible.cpu().numpy()].sum()) or 1.0
    return BalancerResult(
        sim=sim, injected=injected,
        speedup_vs_wired=base / sim.total_time,
        injected_fraction=sim.wireless_bytes / elig_vol,
    )
