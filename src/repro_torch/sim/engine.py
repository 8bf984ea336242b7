"""Discrete-event, packet-level NoP simulator over a `TrafficTrace`.

The analytic core (`repro_torch.core.simulator`) follows GEMINI: per
layer it takes the max of aggregate compute/DRAM/NoC/NoP/wireless
terms, with the wired NoP costed as the most-loaded directed mesh *cut*
served at the cut's pooled bandwidth.  That form cannot express anything
that depends on time — queue backlog, burst ordering, or an online
policy choosing a plane per packet.  This engine re-costs the SAME
packetised trace (same 64 KiB packets, same XY/YX routes, same link
incidence) with time-resolved occupancy of every network resource:

- **wired plane** — three link models:
  - ``striped`` (default): each cut crossing is striped across the
    cut's k parallel links, the idealized spreading the analytic cut
    model assumes.  With a static injection set this reproduces the
    analytic layer times exactly (the fidelity anchor).
  - ``adaptive``: each crossing picks the least-backlogged parallel
    link of its cut at injection time (adaptive minimal routing);
    packet granularity and imbalance emerge.
  - ``xy``: each crossing uses its fixed dimension-ordered link —
    the most contended, single-path reality.
- **wireless plane** — per-channel FIFO servers costed per packet by
  the MAC protocol (`repro_torch.net.mac.mac_packet_times`): ideal is
  bit-compatible with the paper's volume/bandwidth aggregate; TDMA
  pays slot quantisation + guard per packet; token pays an acquisition
  wait that tracks the *instantaneous* active-station count.  Under a
  spatial-reuse plan (`ChannelPlan.reuse_zones > 1`) each channel
  splits into per-zone FIFOs serving concurrently; a packet whose hop
  span exceeds the reuse distance is heard package-wide and quiesces
  every zone of its channel.
- **DRAM ports** — ``pooled`` (default) keeps the analytic
  total-bytes/aggregate-bandwidth term; ``ports`` serves each DRAM
  module's queue at its own pin rate.

Execution keeps the GEMINI layer barrier: a layer's packets inject at
its start (in trace order) and the next layer starts when every queue
has drained — so per-layer event totals are comparable to the analytic
per-layer maxima, and the analytic value is a lower bound (each cut
must serve its bytes; pigeonhole puts one link at >= load/k).

Where it runs.  `PacketSim` follows its trace's device.  The route
geometry, the eligibility masks and every static injection set's
costing (one batched event pop per layer: scatter sums of per-packet
service times into (layer, resource) bins, float64 / int64 / bool
tensor code with no boolean selection) run there; a result reaches the
host once, for its totals and bottleneck labels.  Per-packet online
runs (the ``adaptive`` link model, `GreedyPolicy`) walk packets one
event at a time on the host, in NumPy, on host copies of the
precomputed arrays (copied once a simulator), costing each wireless
transmission in host floats by the same closed form as the tensor
path; each run's result lands on the trace's device once.

The JAX package's recorder (``record=True``, a `SimTrace` of every
event) belongs to the `obs` plane, which the port does not have yet.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.simulator import (BOTTLENECKS, PJ_PER_BIT_DRAM,
                                        PJ_PER_BIT_NOP_HOP, mac_energy_pj,
                                        noc_energy_pj)
from repro_torch.core.traffic import TrafficTrace
from repro_torch.core.units import BITS_PER_BYTE, pj_to_j
from repro_torch.core.wireless import eligibility, wireless_energy_joules
from repro_torch.net.config import as_network
from repro_torch.net.mac import (mac_packet_extra_bytes,
                                 mac_packet_extra_host, mac_packet_time_host,
                                 mac_packet_times)
from repro_torch.net.scatter import scatter_sum

from .calendar import ResourcePool, first_occurrence, segment_cumsum

LINK_MODELS = ("striped", "adaptive", "xy")
DRAM_MODELS = ("pooled", "ports")


@dataclasses.dataclass
class EventResult:
    """Time-resolved outcome of one event-driven run.  Per-layer and
    per-resource vectors and the injected mask are tensors on the
    trace's device; totals are host floats."""

    total_time: float
    layer_times: torch.Tensor      # (L,) per-layer span
    layer_finish: torch.Tensor     # (L,) event-calendar finish timestamps
    bottleneck: List[str]
    injected: torch.Tensor         # (M,) bool final per-packet plane
    wireless_bytes: float
    wireless_energy_j: float
    energy_j: float
    cut_busy: torch.Tensor         # (n_cuts,) wired busy-seconds per cut
    channel_busy: torch.Tensor     # (n_channels,)
    dram_busy: torch.Tensor        # (n_dram,)
    link_busy: Optional[torch.Tensor]  # (n_links,) for the ``xy`` model
    policy: str
    link_model: str
    dram_model: str
    trace: None = None             # the obs plane's SimTrace (not ported)
    layer_terms: Optional[torch.Tensor] = None

    @property
    def edp(self) -> float:
        return self.energy_j * self.total_time

    def bottleneck_share(self) -> Dict[str, float]:
        """Fraction of total time attributed to each bottleneck.

        A degenerate (zero-time) run has no bottleneck: the explicit
        convention is an empty dict.
        """
        if not self.total_time:
            return {}
        shares = {b: 0.0 for b in BOTTLENECKS}
        for t, b in zip(self.layer_times.tolist(), self.bottleneck):
            shares[b] += t
        return {b: v / self.total_time for b, v in shares.items()}


def _as_mask(mask, device) -> torch.Tensor:
    if isinstance(mask, torch.Tensor):
        return mask.to(device=device, dtype=torch.bool)
    return torch.from_numpy(np.asarray(mask, bool)).to(device)


class PacketSim:
    """Event-driven simulator for one (trace, network) pair.

    Precomputes the per-packet route geometry once, on the trace's
    device; `run` then costs any policy.  ``link_model``/``dram_model``
    select the realism level (see module docstring) — the defaults
    reproduce the analytic model for static injection sets.
    ``faults`` (a `repro_torch.fault.FaultScenario`) derates the trace
    for chip events and degrades the planes for link failures and fades.
    """

    def __init__(self, trace: TrafficTrace, net, *,
                 link_model: str = "striped", dram_model: str = "pooled",
                 record: bool = False, faults=None):
        if link_model not in LINK_MODELS:
            raise ValueError(f"link_model must be one of {LINK_MODELS}")
        if dram_model not in DRAM_MODELS:
            raise ValueError(f"dram_model must be one of {DRAM_MODELS}")
        if record:
            raise NotImplementedError(
                "record=True records a SimTrace, which belongs to the obs "
                "plane: the port's obs slice is not written yet")
        self.faults = None
        if faults is not None and not faults.is_null:
            if link_model == "adaptive":
                raise NotImplementedError(
                    "faults are not supported with the 'adaptive' link "
                    "model: its per-slot backlog routing has no exact "
                    "per-layer degraded projection; use 'striped' or 'xy'")
            # chip events derate the trace itself (compute/DRAM terms);
            # late import: repro_torch.fault.resilience imports this module
            from repro_torch.fault.apply import derate_trace
            trace = derate_trace(trace, faults)
            self.faults = faults
        self.trace = trace
        self.net = as_network(net)
        self.link_model = link_model
        self.dram_model = dram_model
        self._precompute()

    def _precompute(self) -> None:
        """Route-geometry / FIFO / eligibility precompute, on the
        trace's device."""
        trace = self.trace
        dev = trace.device
        cfg = trace.topo.config
        L, M = trace.n_layers, len(trace.nbytes)
        self.link_bw = cfg.nop_bw_per_side
        cut_mat, self.cut_bw = trace.cut_matrix()
        self.n_cuts = cut_mat.shape[1]
        self.cut_of_link = cut_mat.argmax(dim=1)
        self.k_par = torch.round(self.cut_bw / self.link_bw).to(torch.int64)

        # per-packet route CSR (edges sorted by packet, route order kept)
        msg_sorted, eorder = torch.sort(trace.inc_msg, stable=True)
        self._pk_links = trace.inc_link[eorder]
        self._pk_cuts = self.cut_of_link[self._pk_links]
        pkts = torch.arange(M + 1, device=dev)
        self._pk_starts = torch.searchsorted(msg_sorted, pkts)
        self.route_len = torch.diff(self._pk_starts)
        # compacted cut crossings: (packet, cut) -> link multiplicity,
        # with the striped per-link-bundle service time precomputed
        key = trace.inc_msg * self.n_cuts + self.cut_of_link[trace.inc_link]
        ukey, ucnt = torch.unique(key, sorted=True, return_counts=True)
        self._x_pkt = ukey // self.n_cuts
        self._x_cut = ukey % self.n_cuts
        self._x_add = ucnt * trace.nbytes[self._x_pkt] \
            / self.cut_bw[self._x_cut]
        self._x_starts = torch.searchsorted(self._x_pkt.contiguous(), pkts)
        x_lay = trace.layer[self._x_pkt]
        self._x_seg = x_lay * self.n_cuts + self._x_cut

        # per-layer packet lists (injection order = trace order)
        lay_sorted, self._lorder = torch.sort(trace.layer, stable=True)
        self._l_starts = torch.searchsorted(
            lay_sorted, torch.arange(L + 1, device=dev))

        # wireless plane: per-channel FIFOs — per (channel, zone) FIFOs
        # under a spatial-reuse plan, where a zone-local packet occupies
        # its source's zone server and a global (beyond-reuse-distance)
        # packet quiesces every zone of its channel
        plan = self.net.channels
        self.n_channels = plan.n_channels
        self.ch_of_node = plan.assign(trace.topo.n_nodes, dev)
        self.pkt_ch = self.ch_of_node[trace.src]
        self.bw_c = plan.channel_bandwidth(self.net.bandwidth)
        self.n_zones = plan.reuse_zones
        self.n_zcls = 1 if self.n_zones == 1 else self.n_zones + 1
        if self.n_zones == 1:
            self.pkt_zc = torch.zeros(M, dtype=torch.int64, device=dev)
        else:
            zone_of_node, rd = plan.assign_spatial(cfg.grid,
                                                   trace.node_coords())
            self.pkt_zc = torch.where(trace.max_hops <= rd,
                                      zone_of_node[trace.src], self.n_zones)
        # each packet's (layer, channel, zone class) wireless FIFO
        self._grp = (trace.layer * self.n_channels
                     + self.pkt_ch) * self.n_zcls + self.pkt_zc

        # DRAM ports
        self.n_dram = max(1, len(trace.topo.dram_coords))
        self.port_bw = cfg.dram_bw_per_chiplet
        nd = trace.dram_node
        self._dram_svc = torch.where(nd >= 0, trace.nbytes / self.port_bw,
                                     0.0)
        self._dram_seg = trace.layer * self.n_dram + nd.clamp(min=0)

        self.eligible = eligibility(trace, 1)   # online-policy candidacy
        self.t_rest = torch.stack([trace.t_compute, trace.t_dram,
                                   trace.t_noc]).amax(dim=0)
        self._elig_cache: Dict[int, torch.Tensor] = {1: self.eligible}
        self._wired_cache: Optional[EventResult] = None
        self._host_cache: Optional[SimpleNamespace] = None

        # dynamic conditions (repro_torch.fault): per-(layer, cut) wired
        # service scaling + forced wireless failover for link failures,
        # per-(layer, channel) effective bandwidth for SNR fades.  All
        # None on fault-free runs — every hot path tests for None only.
        self._cut_scale = self._link_remap = self._link_cost = None
        self._forced = self._wl_bw = None
        if self.faults is not None:
            from repro_torch.fault.apply import (link_fault_arrays,
                                                 wireless_bw_matrix)
            (self._cut_scale, self._link_remap, self._link_cost,
             self._forced) = link_fault_arrays(
                trace, self.faults, cut_of_link=self.cut_of_link,
                k_par=self.k_par, n_cuts=self.n_cuts)
            self._wl_bw = wireless_bw_matrix(trace, self.net, self.faults)

        # the striped service of each crossing (degraded stripes and dead
        # cuts scaled in), and the xy model's per-incidence link and
        # service (detours off dead links)
        self._x_w = self._x_add
        if self._cut_scale is not None:
            self._x_w = self._x_add * self._cut_scale[x_lay, self._x_cut]
        e_lay, e_lnk = trace.layer[trace.inc_msg], trace.inc_link
        self._e_w = trace.nbytes[trace.inc_msg] / self.link_bw
        if self._link_remap is not None:
            self._e_w = self._e_w * self._link_cost[e_lay, e_lnk]
            e_lnk = self._link_remap[e_lay, e_lnk]
        self._e_seg = e_lay * trace.n_links + e_lnk

    # ------------------------------------------------------------------
    # shared pieces
    # ------------------------------------------------------------------

    def elig(self, threshold: int) -> torch.Tensor:
        """Paper eligibility mask (criteria 1+2) at ``threshold``."""
        if threshold not in self._elig_cache:
            self._elig_cache[threshold] = eligibility(self.trace, threshold)
        return self._elig_cache[threshold]

    def _wireless_batch(self, injected: torch.Tensor):
        """Per-packet wireless service for a whole mask: ``(fifo, svc,
        extra_bytes)``, with ``svc`` zero off the mask.

        Packets on one channel are served FIFO in trace order; the
        token MAC's acquisition wait uses the station count active *at
        serve time*: the count of (FIFO, source) pairs first seen so far
        in the FIFO, an int64 segmented cumsum of first-occurrence flags
        over the FIFO-sorted injected packets (the others sorted into a
        group of their own past every FIFO).
        """
        tr, mac = self.trace, self.net.mac
        bw = (self.bw_c if self._wl_bw is None
              else self._wl_bw[tr.layer, self.pkt_ch])
        active = 0.0
        if mac.protocol == "token":       # the only MAC that reads it
            off = tr.n_layers * self.n_channels * self.n_zcls
            grp, order = torch.sort(torch.where(injected, self._grp, off),
                                    stable=True)
            pairs = grp * tr.topo.n_nodes + tr.src[order]
            active = torch.empty_like(grp)
            active[order] = segment_cumsum(first_occurrence(pairs), grp)
        svc = torch.where(injected,
                          mac_packet_times(mac, tr.nbytes, active, bw), 0.0)
        extra = torch.where(injected,
                            mac_packet_extra_bytes(mac, tr.nbytes, active),
                            0.0).sum()
        return self._grp, svc, extra

    def _dram_terms(self, busy_ld: torch.Tensor) -> torch.Tensor:
        if self.dram_model == "ports":
            return busy_ld.amax(dim=1)
        return self.trace.t_dram

    def _finish(self, mask: torch.Tensor, t_nop: torch.Tensor,
                t_wl: torch.Tensor, t_dram: torch.Tensor, extra_bytes,
                busies, policy_name: str) -> EventResult:
        tr = self.trace
        L = tr.n_layers
        stack = torch.stack([tr.t_compute, t_dram, tr.t_noc, t_nop, t_wl])
        layer_times = stack.amax(dim=0)
        which = stack.argmax(dim=0)
        wl_bytes = torch.where(mask, tr.nbytes, 0.0).sum()
        # platform energy: same (per-chiplet-aware) constants as the
        # analytic model; wired NoP bits = bytes x traversed links,
        # route-exact
        byte_links = torch.where(mask, 0.0,
                                 tr.nbytes * self.route_len).sum()
        energy = pj_to_j(
            mac_energy_pj(tr)
            + tr.dram_bytes.sum() * BITS_PER_BYTE * PJ_PER_BIT_DRAM
            + noc_energy_pj(tr)
            + byte_links * BITS_PER_BYTE * PJ_PER_BIT_NOP_HOP
            + (wl_bytes + extra_bytes) * BITS_PER_BYTE
            * self.net.energy_pj_per_bit)
        wl_energy = wireless_energy_joules(tr, mask, self.net, extra_bytes)
        # one copy to the host; the layer sum as NumPy sums it
        host = torch.cat([layer_times, which.to(torch.float64),
                          wl_bytes.view(1), energy.view(1),
                          wl_energy.view(1)]).cpu().numpy()
        cut_busy, channel_busy, dram_busy, link_busy = busies
        return EventResult(
            total_time=float(host[:L].sum()),
            layer_times=layer_times,
            layer_finish=torch.cumsum(layer_times, 0),
            bottleneck=[BOTTLENECKS[int(i)] for i in host[L:2 * L]],
            injected=mask,
            wireless_bytes=float(host[2 * L]),
            wireless_energy_j=float(host[2 * L + 2]),
            energy_j=float(host[2 * L + 1]),
            cut_busy=cut_busy, channel_busy=channel_busy,
            dram_busy=dram_busy, link_busy=link_busy,
            policy=policy_name, link_model=self.link_model,
            dram_model=self.dram_model)

    # ------------------------------------------------------------------
    # batched path: static injection sets, one event pop per layer
    # ------------------------------------------------------------------

    def _planned_parts(self, mask: torch.Tensor):
        """Vectorized per-layer network terms for a fixed injection set.

        Every bin sum runs over all crossings / incidences / packets in
        trace order, with zero weight where the mask drops an entry (a
        sum the JAX package takes over the kept entries alone; adding
        zeros leaves it bit-equal on the CPU)."""
        tr = self.trace
        L = tr.n_layers
        zero = torch.zeros(L, dtype=torch.float64, device=tr.device)
        # "adaptive" is served per event (`_run_online`); as a *planning*
        # projection it uses the striped (idealized) wired plane below
        if self.link_model != "xy":
            w = torch.where(mask[self._x_pkt], 0.0, self._x_w)
            busy = scatter_sum(self._x_seg, w, L * self.n_cuts) \
                .view(L, self.n_cuts)
            # a trace can have no mesh resources at all (single-column
            # grids where every route is chiplet-local or enters at the
            # aligned edge router) — the NoP term is then zero
            t_nop = busy.amax(dim=1) if busy.numel() else zero
            cut_busy, link_busy = busy.sum(dim=0), None
        else:  # "xy": fixed dimension-ordered links
            w = torch.where(mask[tr.inc_msg], 0.0, self._e_w)
            busy = scatter_sum(self._e_seg, w, L * tr.n_links) \
                .view(L, tr.n_links)
            t_nop = busy.amax(dim=1) if busy.numel() else zero
            link_busy = busy.sum(dim=0)
            cut_busy = scatter_sum(self.cut_of_link, link_busy, self.n_cuts)
        grp, svc, extra = self._wireless_batch(mask)
        busy_wl = scatter_sum(grp, svc, L * self.n_channels * self.n_zcls) \
            .view(L, self.n_channels, self.n_zcls)
        if self.n_zcls == 1:
            t_wl = busy_wl[:, :, 0].amax(dim=1)
        else:   # global phase quiesces the zones, locals run concurrently
            Z = self.n_zones
            t_wl = (busy_wl[:, :, Z]
                    + busy_wl[:, :, :Z].amax(dim=2)).amax(dim=1)
        busy_ld = scatter_sum(self._dram_seg, self._dram_svc,
                              L * self.n_dram).view(L, self.n_dram)
        busies = (cut_busy, busy_wl.sum(dim=(0, 2)), busy_ld.sum(dim=0),
                  link_busy)
        return t_nop, t_wl, self._dram_terms(busy_ld), extra, busies

    def _with_forced(self, mask: torch.Tensor) -> torch.Tensor:
        """OR the forced-failover set (dead-cut packets) into a mask.

        The runtime knows its dead routes and diverts their packets to
        the wireless plane regardless of the paper's eligibility
        criteria — every policy's executed mask includes them.  Only
        `run_wired` skips this: the wired-only counterfactual pays the
        infinity instead (the wireless-as-failover headline).
        """
        if self._forced is None:
            return mask
        return mask | self._forced

    def layer_times(self, mask: torch.Tensor) -> torch.Tensor:
        """Per-layer event times a fixed injection set would produce.

        Exact for the batched link models; the ``adaptive`` model uses
        the striped projection (policies plan on the idealized wired
        plane, the event run resolves the real one).  Forced-failover
        packets are included, so policy projections match execution.
        """
        t_nop, t_wl, t_dram, _, _ = self._planned_parts(
            self._with_forced(mask))
        tr = self.trace
        return torch.stack([tr.t_compute, t_dram, tr.t_noc, t_nop,
                            t_wl]).amax(dim=0)

    def _run_planned(self, mask: torch.Tensor, name: str,
                     force: bool = True) -> EventResult:
        if force:
            mask = self._with_forced(mask)
        t_nop, t_wl, t_dram, extra, busies = self._planned_parts(mask)
        return self._finish(mask, t_nop, t_wl, t_dram, extra, busies, name)

    # ------------------------------------------------------------------
    # sequential path: per-packet events (online policies / adaptive links)
    # ------------------------------------------------------------------

    def _host(self) -> SimpleNamespace:
        """Host NumPy copies of what the online loop reads, made once."""
        if self._host_cache is None:
            tr = self.trace
            arrays = dict(
                nbytes=tr.nbytes, src=tr.src, dram_node=tr.dram_node,
                dram_svc=self._dram_svc, pk_cuts=self._pk_cuts,
                pk_starts=self._pk_starts, pk_links=self._pk_links,
                x_starts=self._x_starts, x_cut=self._x_cut,
                x_add=self._x_add, lorder=self._lorder,
                l_starts=self._l_starts, k_par=self.k_par,
                cut_of_link=self.cut_of_link, pkt_ch=self.pkt_ch,
                pkt_zc=self.pkt_zc, eligible=self.eligible,
                t_rest=self.t_rest, cut_scale=self._cut_scale,
                link_remap=self._link_remap, link_cost=self._link_cost,
                forced=self._forced, wl_bw=self._wl_bw)
            self._host_cache = SimpleNamespace(**{
                k: None if v is None else v.cpu().numpy()
                for k, v in arrays.items()})
        return self._host_cache

    def _run_online(self, policy, mask: Optional[torch.Tensor],
                    name: str) -> EventResult:
        """The per-layer / per-packet event loop, on the host."""
        tr, mac, h = self.trace, self.net.mac, self._host()
        L, M = tr.n_layers, len(h.nbytes)
        mask = None if mask is None else mask.cpu().numpy()
        adaptive = self.link_model == "adaptive"
        xy = self.link_model == "xy"
        n_cuts, n_links = self.n_cuts, tr.n_links
        k_max = int(h.k_par.max()) if n_cuts else 1
        # physical parallel links of each cut (inf-padded, adaptive model)
        pad = np.zeros((n_cuts, k_max))
        pad[np.arange(k_max)[None, :] >= h.k_par[:, None]] = np.inf

        injected = np.zeros(M, bool)
        t_nop = np.zeros(L)
        t_wl = np.zeros(L)
        busy_ld = np.zeros((L, self.n_dram))
        cut_busy = np.zeros(n_cuts)
        # wireless airtime per channel (a global transmission's service
        # counts once, not once per quiesced zone server) — matches the
        # planned path's channel_busy accounting exactly
        wl_airtime = np.zeros(self.n_channels)
        extra_bytes = 0.0

        # per-resource next-free-time pools (barrier-rolled per layer);
        # the adaptive model keeps a raw (cut, parallel-slot) matrix so
        # the inf-padding of short cuts stays out of the busy accounting
        wired_pool = ResourcePool.of(n_links if xy else n_cuts)
        ch_pool = ResourcePool.of(self.n_channels * self.n_zones)
        dram_pool = ResourcePool.of(self.n_dram)

        for li in range(L):
            pkts = h.lorder[h.l_starts[li]:h.l_starts[li + 1]]
            linkmat = pad.copy() if adaptive else None
            ch_srcs = [[set() for _ in range(self.n_zcls)]
                       for _ in range(self.n_channels)]
            for p in pkts:
                v = h.nbytes[p]
                nd = h.dram_node[p]
                if nd >= 0:
                    dram_pool.serve(np.array([nd]),
                                    np.array([h.dram_svc[p]]))
                # --- wired projection (uncommitted) ---
                if adaptive:
                    cuts = h.pk_cuts[h.pk_starts[p]:h.pk_starts[p + 1]]
                    s = v / self.link_bw
                    trial = linkmat.copy()
                    proj_w = 0.0
                    for c in cuts:     # each crossing -> least-busy link
                        j = int(trial[c].argmin())
                        trial[c, j] += s
                        proj_w = max(proj_w, trial[c, j])
                elif xy:
                    ids = h.pk_links[h.pk_starts[p]:h.pk_starts[p + 1]]
                    svc = np.full(len(ids), v / self.link_bw)
                    if h.link_remap is not None:
                        svc = svc * h.link_cost[li, ids]
                        ids = h.link_remap[li, ids]
                    proj_w = wired_pool.peek(ids, svc) if len(ids) else 0.0
                else:
                    xs = slice(h.x_starts[p], h.x_starts[p + 1])
                    ids, svc = h.x_cut[xs], h.x_add[xs]
                    if h.cut_scale is not None:
                        svc = svc * h.cut_scale[li, ids]
                    proj_w = wired_pool.peek(ids, svc) if len(ids) else 0.0
                # --- wireless projection + decision ---
                go = False
                if h.eligible[p] or (h.forced is not None and h.forced[p]):
                    ch = int(h.pkt_ch[p])
                    zc = int(h.pkt_zc[p])
                    a_now = len(ch_srcs[ch][zc] | {int(h.src[p])})
                    bw_li = (self.bw_c if h.wl_bw is None
                             else float(h.wl_bw[li, ch]))
                    s_wl = mac_packet_time_host(mac, v, a_now, bw_li)
                    if zc >= self.n_zones:
                        # global transmission: quiesces every zone of its
                        # channel — starts when all are free, blocks all
                        ids_wl = np.arange(ch * self.n_zones,
                                           (ch + 1) * self.n_zones)
                        proj_wl = float(ch_pool.free[ids_wl].max() + s_wl)
                    else:
                        ids_wl = np.array([ch * self.n_zones + zc])
                        proj_wl = ch_pool.peek(ids_wl, np.array([s_wl]))
                    if mask is not None:
                        go = bool(mask[p])
                    else:
                        go = policy.decide(self, li, p, proj_w, proj_wl,
                                           float(h.t_rest[li]))
                elif mask is not None and mask[p]:
                    raise ValueError("injection mask selects an ineligible "
                                     "packet")
                # --- commit ---
                if go:
                    injected[p] = True
                    if zc >= self.n_zones:
                        ch_pool.free[ids_wl] = proj_wl
                    else:
                        ch_pool.serve(ids_wl, np.array([s_wl]))
                    wl_airtime[ch] += s_wl
                    ch_srcs[ch][zc].add(int(h.src[p]))
                    extra_bytes += mac_packet_extra_host(mac, v, a_now)
                elif adaptive:
                    linkmat = trial
                elif len(ids):
                    wired_pool.serve(ids, svc)
            # --- layer barrier: drain every queue, roll busy ---
            if adaptive:
                fin = np.where(np.isfinite(linkmat), linkmat, 0.0)
                t_nop[li] = fin.max() if fin.size else 0.0
                cut_busy += fin.sum(axis=1)
            else:
                t_nop[li] = wired_pool.horizon()
                wired_pool.roll()
            t_wl[li] = ch_pool.horizon()
            ch_pool.roll()
            busy_ld[li] = dram_pool.free
            dram_pool.roll()

        link_busy = None
        if xy:
            link_busy = wired_pool.busy
            cut_busy = np.bincount(h.cut_of_link, weights=link_busy,
                                   minlength=n_cuts)
        elif not adaptive:
            cut_busy = wired_pool.busy
        # the loop's result goes to the trace's device in one copy
        parts = [injected.astype(float), t_nop, t_wl, busy_ld.ravel(),
                 cut_busy, wl_airtime,
                 np.zeros(0) if link_busy is None else link_busy]
        flat = torch.from_numpy(np.concatenate(parts)).to(tr.device)
        (inj_d, t_nop_d, t_wl_d, busy_ld_d, cut_busy_d, airtime_d,
         link_busy_d) = torch.split(flat, [len(x) for x in parts])
        busy_ld_d = busy_ld_d.view(L, self.n_dram)
        busies = (cut_busy_d, airtime_d, busy_ld_d.sum(dim=0),
                  None if link_busy is None else link_busy_d)
        return self._finish(inj_d > 0, t_nop_d, t_wl_d,
                            self._dram_terms(busy_ld_d), extra_bytes,
                            busies, name)

    # ------------------------------------------------------------------
    # entry points
    # ------------------------------------------------------------------

    def run(self, policy="static") -> EventResult:
        """Simulate under ``policy`` (name, or a `policies.Policy`)."""
        from .policies import get_policy
        pol = get_policy(policy)
        mask = pol.plan_trace(self)
        if mask is not None:
            mask = _as_mask(mask, self.trace.device)
            if self.link_model != "adaptive":
                return self._run_planned(mask, pol.name)
            return self._run_online(pol, mask, pol.name)
        return self._run_online(pol, None, pol.name)

    def run_wired(self) -> EventResult:
        """All-wired baseline (the speedup denominator), cached.

        Under faults this is the wired-only counterfactual: forced
        failover does NOT apply, so a fully-dead cut costs infinity —
        the wired-only platform simply cannot finish.
        """
        if self._wired_cache is None:
            mask = torch.zeros(len(self.trace.nbytes), dtype=torch.bool,
                               device=self.trace.device)
            if self.link_model != "adaptive":
                self._wired_cache = self._run_planned(mask, "wired",
                                                      force=False)
            else:
                self._wired_cache = self._run_online(None, mask, "wired")
        return self._wired_cache

    def speedup(self, policy="static") -> float:
        return self.run_wired().total_time / self.run(policy).total_time


def simulate_events(trace: TrafficTrace, net, policy="static",
                    **kwargs) -> EventResult:
    """One-shot convenience: `PacketSim(trace, net, **kwargs).run(policy)`."""
    return PacketSim(trace, net, **kwargs).run(policy)
