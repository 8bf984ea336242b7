"""Vectorized design-space engine for the wireless network stack.

`dse.sweep` costs every (threshold, injection) point with a full
`simulate_hybrid` call: re-scattering baseline link loads, re-selecting
the injected set and re-reducing cut loads per point — a Python double
loop over the grid.  This engine exploits the structure of the sweep:

1. The injection filter is a fixed low-discrepancy hash compared
   against the injection probability, so a packet's fate across the
   whole injection axis is summarized by ONE integer — the index of the
   first grid probability that accepts it (its *bucket*).  A packet a
   threshold makes ineligible takes bucket ``NI``, past the axis.
2. Everything the simulator needs per configuration is a sum over the
   injected set: wireless bytes per (layer, channel), removed byte
   loads per (layer, mesh cut), message and active-transmitter counts.

So per (trace, threshold) we scatter each packet's contributions into
`(segment, bucket)` bins ONCE, and a cumulative sum along the bucket
axis yields the exact per-injection-probability aggregates for the
entire axis.  Bandwidth, MAC protocol and channel plan then act on those
small `(thresholds, layers, channels, inject)` tensors in closed form,
producing the full (threshold x injection x bandwidth x MAC x
channel-plan) speedup grid with no per-point simulation.

Every tensor lives on the device of the packet tensors it is built
from, and `evaluate` waits for the device only where it must size a
tensor (the transmitter groups, once per reuse distance); the results
stay there.  The module is `repro_torch.core`-independent: the caller
(`core.dse`) supplies the per-packet tensors, eligibility masks, the
injection hash and the mesh-cut geometry.  Under an installed profiler
(`repro_torch.obs.profiling`) `evaluate` and its stages record as the
JAX package's ``net.batched.*`` phases.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.obs import profile as obs_profile
from repro_torch.units import gbps_to_bytes_per_s

from .channel import ChannelPlan
from .config import NetworkConfig
from .mac import MacConfig, mac_times
from .scatter import bin_count, scatter_sum

# The paper's sweep axes (SIV-A): single source of truth, re-exported by
# `core.dse` as THRESHOLDS / INJECTIONS / BANDWIDTHS_GBPS.
PAPER_THRESHOLDS = (1, 2, 3, 4)
PAPER_INJECTIONS = tuple(round(0.10 + 0.05 * i, 2)
                         for i in range(15))            # .10..._.80
PAPER_BANDWIDTHS_GBPS = (64, 96)


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """The axes of one design-space evaluation.

    ``injections`` must be sorted ascending (the bucket trick relies on
    it).  The default spec covers the paper's Fig. 4/5 sweep with the
    idealized network — `dse.NETWORK_MACS`/`NETWORK_PLANS` widen it.
    """

    thresholds: Tuple[int, ...] = PAPER_THRESHOLDS
    injections: Tuple[float, ...] = PAPER_INJECTIONS
    # fractional Gb/s are honoured exactly (callers anchoring against
    # the grid must not round a non-integer-Gb/s network)
    bandwidths_gbps: Tuple[float, ...] = PAPER_BANDWIDTHS_GBPS
    macs: Tuple[MacConfig, ...] = (MacConfig("ideal"),)
    plans: Tuple[ChannelPlan, ...] = (ChannelPlan(1),)

    def __post_init__(self):
        inj = np.asarray(self.injections)
        if inj.size and np.any(np.diff(inj) <= 0):
            raise ValueError("injections must be strictly ascending")


def argmax_value(t: torch.Tensor) -> Tuple[float, int]:
    """(max, flat index of its first occurrence) of ``t``, in one copy
    to the host."""
    flat = t.reshape(-1)
    i = flat.argmax()
    value, index = torch.stack([flat[i], i.to(flat.dtype)]).tolist()
    return value, int(index)


@dataclasses.dataclass
class GridResult:
    """Speedup/total-time tensors indexed [mac, plan, bw, threshold, inj],
    on the design space's device."""

    spec: GridSpec
    base_time: float
    total_time: torch.Tensor
    speedup: torch.Tensor

    def best(self) -> Tuple[float, NetworkConfig]:
        """Best speedup over the whole grid and its `NetworkConfig`."""
        value, flat = argmax_value(self.speedup)
        mi, pi, bi, ti, ii = np.unravel_index(flat, self.speedup.shape)
        cfg = NetworkConfig(
            bandwidth=gbps_to_bytes_per_s(self.spec.bandwidths_gbps[bi]),
            distance_threshold=self.spec.thresholds[ti],
            injection_prob=self.spec.injections[ii],
            channels=self.spec.plans[pi],
            mac=self.spec.macs[mi])
        return value, cfg

    def ideal_grid(self, bandwidth_gbps: float) -> torch.Tensor:
        """(threshold, injection) speedup grid for the paper's network:
        ideal MAC, one channel, no spatial reuse."""
        mi = next(i for i, m in enumerate(self.spec.macs)
                  if m.protocol == "ideal")
        pi = next(i for i, p in enumerate(self.spec.plans)
                  if p.n_channels == 1 and p.reuse_zones == 1)
        bi = self.spec.bandwidths_gbps.index(bandwidth_gbps)
        return self.speedup[mi, pi, bi]


class BatchedDesignSpace:
    """Per-trace precomputation + grid evaluation.

    Parameters (tensors on one device; M packets, L layers, C mesh cuts):

    - ``layer``/``nbytes``/``src``: per-packet layer id, size, source.
    - ``eligibility``: threshold -> (M,) bool mask (paper criteria 1+2).
    - ``inj_hash``: (M,) low-discrepancy hash; packet injected iff
      ``hash < p`` (paper criterion 3).
    - ``pkt_cut``: (M, C) number of the packet's route links in each
      directed mesh cut.
    - ``cut_base``: (L, C) baseline (all-wired) byte load per cut.
    - ``cut_bw``: (C,) service bandwidth per cut.
    - ``t_rest``: (L,) wireless-independent floor
      ``max(compute, dram, noc)``.
    - ``base_time``: wired baseline total time (speedup denominator).
    - ``max_hops``/``grid``/``node_coords``: per-packet NoP hop span and
      the package geometry — only needed when a `GridSpec` plan uses
      spatial reuse (``reuse_zones > 1``), which gates packets on hop
      span and zones nodes by grid position.
    """

    def __init__(self, *, n_layers: int, n_nodes: int, layer: torch.Tensor,
                 nbytes: torch.Tensor, src: torch.Tensor,
                 eligibility: Dict[int, torch.Tensor],
                 inj_hash: torch.Tensor, pkt_cut: torch.Tensor,
                 cut_base: torch.Tensor, cut_bw: torch.Tensor,
                 t_rest: torch.Tensor, base_time: float,
                 max_hops: torch.Tensor | None = None, grid=None,
                 node_coords: torch.Tensor | None = None):
        self.n_layers = n_layers
        self.n_nodes = n_nodes
        self.layer = layer
        self.nbytes = nbytes
        self.src = src
        self.eligibility = eligibility
        self.inj_hash = inj_hash
        self.pkt_cut = pkt_cut
        self.cut_base = cut_base
        self.cut_bw = cut_bw
        self.t_rest = t_rest
        self.base_time = float(base_time)
        self.max_hops = max_hops
        self.grid = None if grid is None else tuple(grid)
        self.node_coords = node_coords
        # transmitter-group structures ((layer, src[, locality]) sorted
        # packet order + group id per sorted packet, for min-bucket
        # reductions), cached by the reuse distance that splits local
        # from global
        self._grp_cache: Dict[int | None, tuple] = {}
        self._bucket_cache: Dict[tuple, torch.Tensor] = {}

    @property
    def device(self) -> torch.device:
        return self.nbytes.device

    def _groups(self, local: torch.Tensor | None, cache_key):
        """Sorted transmitter groups, optionally split by reuse locality.

        Returns ``(order, gid, g_layer, g_src, g_local)``: the stable
        sort of the packets by group, each sorted packet's group id, and
        for each distinct (layer, src[, local]) transmitter group its
        layer, source and locality (None without a locality split).
        """
        if cache_key in self._grp_cache:
            return self._grp_cache[cache_key]
        key = self.layer * self.n_nodes + self.src
        if local is not None:
            key = key * 2 + local
        sorted_key, order = torch.sort(key, stable=True)
        first = torch.ones_like(sorted_key, dtype=torch.bool)
        first[1:] = sorted_key[1:] != sorted_key[:-1]
        gid = torch.cumsum(first, 0) - 1
        gkey = sorted_key[first]
        g_local = None
        if local is not None:
            g_local = (gkey % 2).to(torch.bool)
            gkey = gkey // 2
        out = (order, gid, gkey // self.n_nodes, gkey % self.n_nodes,
               g_local)
        self._grp_cache[cache_key] = out
        return out

    # ------------------------------------------------------------------
    # bucketed cumulative aggregates
    # ------------------------------------------------------------------

    def _buckets(self, injections) -> torch.Tensor:
        """Index of the first grid probability that injects each packet,
        cached by the grid (its copy to the device waits on the host)."""
        key = tuple(injections)
        if key not in self._bucket_cache:
            grid = torch.tensor(key, dtype=torch.float64).to(self.device)
            self._bucket_cache[key] = torch.searchsorted(
                grid, self.inj_hash, right=True)
        return self._bucket_cache[key]

    def _cum(self, flat_seg, n_seg, bucket, n_inj, weights=None):
        """Scatter (segment, bucket) sums, then cumsum the bucket axis.

        Returns (n_seg, n_inj): value at injection index j is the sum of
        entries whose bucket <= j, i.e. the aggregate over the injected
        set at the j-th injection probability.
        """
        flat = flat_seg * (n_inj + 1) + bucket
        size = n_seg * (n_inj + 1)
        binned = (bin_count(flat, size) if weights is None
                  else scatter_sum(flat, weights, size))
        return binned.view(n_seg, n_inj + 1).cumsum(dim=1)[:, :n_inj]

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------

    def evaluate(self, spec: GridSpec | None = None) -> GridResult:
        with obs_profile.phase("net.batched.evaluate"):
            return self._evaluate(spec)

    def _evaluate(self, spec: GridSpec | None) -> GridResult:
        spec = spec if spec is not None else GridSpec()
        missing = [t for t in spec.thresholds if t not in self.eligibility]
        if missing:
            raise ValueError(
                f"thresholds {missing} have no precomputed eligibility "
                f"mask; declare them when building the design space "
                f"(batched_design_space(trace, thresholds=...))")
        L, C = self.n_layers, len(self.cut_bw)
        NT, NI = len(spec.thresholds), len(spec.injections)
        with obs_profile.phase("net.batched.buckets"):
            bucket = self._buckets(spec.injections)
            # per threshold: each packet's bucket, NI (never) where
            # ineligible
            buckets = [torch.where(self.eligibility[t], bucket, NI)
                       for t in spec.thresholds]

        # --- wired plane: removed cut loads and t_nop, per (thr, inj) ---
        t_nop = torch.empty((NT, L, NI), dtype=torch.float64,
                            device=self.device)
        M = len(self.nbytes)
        # one fused scatter over the (cut, layer, bucket) index space
        seg = (torch.arange(C, device=self.device)[:, None] * L
               + self.layer[None, :]).reshape(-1)
        weights = (self.pkt_cut.T * self.nbytes).reshape(-1)
        with obs_profile.phase("net.batched.wired"):
            for ti, b in enumerate(buckets):
                removed = self._cum(seg, C * L, b.expand(C, M).reshape(-1),
                                    NI, weights=weights).view(C, L, NI)
                residual = self.cut_base.T[:, :, None] - removed
                t_nop[ti] = (residual / self.cut_bw[:, None, None]) \
                    .amax(dim=0)
            obs_profile.note_ndarray(t_nop)

        # --- wireless plane: per-plan (bytes, msgs, active) aggregates,
        # with a zone-class axis (0..Z-1 zone-local, Z global) when the
        # plan spatially reuses the band; msgs/active only matter to
        # non-ideal MACs and are skipped otherwise ---
        need_counts = any(m.protocol != "ideal" for m in spec.macs)
        with obs_profile.phase("net.batched.wireless"):
            per_plan = self._wireless_aggregates(spec, buckets, need_counts,
                                                 L, NI)

        # --- closed-form assembly over (mac, plan, bandwidth) ---
        with obs_profile.phase("net.batched.assemble"):
            total = self._assemble(spec, per_plan, t_nop, NT, NI)
            obs_profile.note_ndarray(total)
        # tensor / tensor: `float / tensor` multiplies by a reciprocal
        return GridResult(spec, self.base_time, total,
                          torch.full_like(total, self.base_time) / total)

    def _assemble(self, spec, per_plan, t_nop, NT, NI) -> torch.Tensor:
        """Total time of every (mac, plan, bandwidth, thr, inj) point."""
        shape = (len(spec.macs), len(spec.plans),
                 len(spec.bandwidths_gbps), NT, NI)
        total = torch.empty(shape, dtype=torch.float64, device=self.device)
        # floor is (NT, L, NI): the wireless-independent layer terms
        floor = torch.maximum(self.t_rest[None, :, None], t_nop)
        for mi, mac in enumerate(spec.macs):
            for pi, plan in enumerate(spec.plans):
                by, ms, ac, Z, nz = per_plan[pi]
                for bi, bw in enumerate(spec.bandwidths_gbps):
                    bw_c = plan.channel_bandwidth(gbps_to_bytes_per_s(bw))
                    t = mac_times(mac, by, ms, ac, bw_c)
                    if nz == 1:
                        t_ch = t[..., 0, :]
                    else:   # global phase + concurrent zone-local
                        t_ch = t[..., Z, :] + t[..., :Z, :].amax(dim=3)
                    t_wl = t_ch.amax(dim=2)
                    # layers summed in order (a cumsum's last entry), as
                    # NumPy sums a middle axis: a CPU run is bit-equal
                    total[mi, pi, bi] = torch.maximum(floor, t_wl).cumsum(
                        dim=1)[:, -1]
        return total

    def _wireless_aggregates(self, spec, buckets, need_counts, L, NI):
        """Per-plan (bytes, msgs, active) bucketed aggregates — the
        wireless half of `evaluate`."""
        NT = len(buckets)
        per_plan = []
        bmin_cache: Dict[tuple, torch.Tensor] = {}
        for plan in spec.plans:
            n_ch = plan.n_channels
            ch_of_node = plan.assign(self.n_nodes, self.device)
            Z = plan.reuse_zones
            if Z == 1:
                nz, zcls, rd = 1, 0, None
                order, gid, g_lay, g_src, g_loc = self._groups(None, None)
                g_zc = 0
            else:
                if self.grid is None or self.node_coords is None \
                        or self.max_hops is None:
                    raise ValueError(
                        "plans with reuse_zones > 1 need the package "
                        "geometry; build the design space with max_hops, "
                        "grid and node_coords")
                zone_of_node, rd = plan.assign_spatial(self.grid,
                                                       self.node_coords)
                local = self.max_hops <= rd
                nz = Z + 1
                zcls = torch.where(local, zone_of_node[self.src], Z)
                order, gid, g_lay, g_src, g_loc = self._groups(local, rd)
                g_zc = torch.where(g_loc, zone_of_node[g_src], Z)
            ch = ch_of_node[self.src]
            seg_all = (self.layer * n_ch + ch) * nz + zcls
            n_seg = L * n_ch * nz
            by = torch.stack([self._cum(seg_all, n_seg, b, NI,
                                        weights=self.nbytes)
                              for b in buckets]).view(NT, L, n_ch, nz, NI)
            ms = ac = None
            if need_counts:
                ms = torch.stack([self._cum(seg_all, n_seg, b, NI)
                                  for b in buckets]
                                 ).view(NT, L, n_ch, nz, NI)
                gseg = (g_lay * n_ch + ch_of_node[g_src]) * nz + g_zc
                # a transmitter group is active from the earliest
                # bucket of its eligible packets
                acs = []
                for ti, b in enumerate(buckets):
                    if (rd, ti) not in bmin_cache:
                        bmin_cache[rd, ti] = torch.full(
                            (len(gseg),), NI, dtype=torch.int64,
                            device=self.device).scatter_reduce_(
                            0, gid, b[order], "amin")
                    acs.append(self._cum(gseg, n_seg, bmin_cache[rd, ti],
                                         NI))
                ac = torch.stack(acs).view(NT, L, n_ch, nz, NI)
            obs_profile.note_ndarray(by, ms, ac)
            per_plan.append((by, ms, ac, Z, nz))
        return per_plan
