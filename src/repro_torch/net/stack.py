"""Per-layer wireless service times for one network configuration.

Given the flat per-packet tensors of a traffic trace and the boolean
injected set chosen by the paper's decision function, aggregate the
wireless traffic per (layer, channel) — and, under a spatial-reuse plan,
per (layer, channel, zone class) — cost each channel under the MAC
protocol, and return the per-layer wireless time as the max over the
concurrently operating channels.

Reuse costing (`ChannelPlan.reuse_zones > 1`): each packet classifies as
*zone-local* (hop span within the plan's ``reuse_distance``; occupies
its source's zone only) or *global* (heard package-wide; serializes
against every zone of its channel).  A channel's layer time is

    t = t_mac(global traffic) + max over zones of t_mac(zone traffic)

— the global phase quiesces all zones, the local phases run
concurrently.  With the degenerate plan (1 channel, 1 zone, ideal MAC)
this is exactly the paper's `volume / bandwidth` term.

Everything runs on the device of the packet tensors with no host sync:
packets outside the injected set are scattered with weight zero (bytes,
messages) or flagged absent (transmitters), so no boolean selection
waits for its size.  Under an active recorder
(`repro_torch.obs.recording`) the per-channel times are copied to the
host once and emitted as coarse spans.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.obs.trace import active_recorder, host_array

from .config import NetworkConfig
from .mac import mac_extra_bytes, mac_times
from .scatter import scatter_sum


def channel_aggregates(n_layers: int, layer: torch.Tensor,
                       nbytes: torch.Tensor, src: torch.Tensor,
                       ch_of_node: torch.Tensor, n_channels: int,
                       injected: torch.Tensor,
                       zcls: torch.Tensor | None = None,
                       n_zcls: int = 1) -> Tuple[torch.Tensor, torch.Tensor,
                                                 torch.Tensor]:
    """(bytes, msgs, active) float64 aggregates for the injected set.

    Without ``zcls`` each is (n_layers, n_channels).  With a per-packet
    zone-class tensor (0..K-1 zone-local, K global) each is (n_layers,
    n_channels, n_zcls); ``active`` counts distinct (layer, source,
    zone-class) transmitter appearances, since one source can hold both
    local and global traffic in a layer.
    """
    n_nodes = len(ch_of_node)
    zc = torch.zeros_like(layer) if zcls is None else zcls
    flat = (layer * n_channels + ch_of_node[src]) * n_zcls + zc
    size = n_layers * n_channels * n_zcls
    shape = ((n_layers, n_channels) if zcls is None
             else (n_layers, n_channels, n_zcls))
    inj = injected.to(torch.float64)
    bytes_lc = scatter_sum(flat, nbytes * inj, size)
    msgs_lc = scatter_sum(flat, inj, size)
    # a (layer, source, zone class) transmitter is present when any of
    # its packets is injected; sum the present ones into their channel
    key = (layer * n_nodes + src) * n_zcls + zc
    present = torch.zeros(n_layers * n_nodes * n_zcls, dtype=torch.float64,
                          device=layer.device).scatter_reduce_(
        0, key, inj, "amax")
    active_lc = torch.zeros(n_layers, n_channels, n_zcls, dtype=torch.float64,
                            device=layer.device).index_add_(
        1, ch_of_node, present.view(n_layers, n_nodes, n_zcls))
    return (bytes_lc.view(shape), msgs_lc.view(shape),
            active_lc.view(shape))


def network_layer_times(n_layers: int, layer: torch.Tensor,
                        nbytes: torch.Tensor, src: torch.Tensor,
                        n_nodes: int, injected: torch.Tensor,
                        net: NetworkConfig, *, grid=None, node_coords=None,
                        max_hops=None) -> Tuple[torch.Tensor, torch.Tensor,
                                                torch.Tensor]:
    """Per-layer wireless times under ``net``.

    Returns ``(t_wireless (L,), wl_bytes_per_layer (L,), extra_bytes)``,
    tensors on the packets' device, where ``extra_bytes`` (0-dim) is the
    MAC's non-payload transmission overhead for the energy model.  A
    spatial-reuse plan additionally needs the package geometry: ``grid``
    (rows, cols), ``node_coords`` (the (n_nodes, 2) clamped grid
    positions, on the packets' device) and per-packet ``max_hops``.
    """
    dev = layer.device
    plan = net.channels
    ch_of_node = plan.assign(n_nodes, dev)
    bw_c = plan.channel_bandwidth(net.bandwidth)
    if plan.reuse_zones == 1:
        # single interference domain per channel
        bytes_lc, msgs_lc, active_lc = channel_aggregates(
            n_layers, layer, nbytes, src, ch_of_node, plan.n_channels,
            injected)
        t_lc = mac_times(net.mac, bytes_lc, msgs_lc, active_lc, bw_c)
        extra = mac_extra_bytes(net.mac, bytes_lc, msgs_lc, active_lc).sum()
        st = active_recorder()
        if st is not None:
            st.add_layer_matrix(t_lc, "ch{}", "an:wireless")
        return t_lc.amax(dim=1), bytes_lc.sum(dim=1), extra
    if grid is None or node_coords is None or max_hops is None:
        raise ValueError(
            "a spatial-reuse plan (reuse_zones > 1) needs the package "
            "geometry: pass grid=, node_coords= and max_hops=")
    Z = plan.reuse_zones
    zone_of_node, rd = plan.assign_spatial(grid, node_coords)
    zcls = torch.where(max_hops <= rd, zone_of_node[src], Z)
    bytes_lcz, msgs_lcz, active_lcz = channel_aggregates(
        n_layers, layer, nbytes, src, ch_of_node, plan.n_channels,
        injected, zcls=zcls, n_zcls=Z + 1)
    t_lcz = mac_times(net.mac, bytes_lcz, msgs_lcz, active_lcz, bw_c)
    t_lc = t_lcz[..., Z] + t_lcz[..., :Z].amax(dim=-1)
    extra = mac_extra_bytes(net.mac, bytes_lcz, msgs_lcz, active_lcz).sum()
    st = active_recorder()
    if st is not None:
        _record_zones(st, host_array(t_lcz), Z)
    return t_lc.amax(dim=1), bytes_lcz.sum(dim=(1, 2)), extra


def _record_zones(st, t_lcz: np.ndarray, Z: int) -> None:
    """Coarse spans of a reuse plan's (L, C, Z + 1) host times: the
    global phase first (it quiesces the channel), the zone phases
    concurrently after it — the schedule the costing assumes."""
    for li, c in zip(*np.nonzero(t_lcz.max(axis=-1))):
        g = float(t_lcz[li, c, Z])
        if g > 0.0:
            st.add_layer_event(f"ch{c}/g", "span", int(li), 0.0, g,
                               "an:wireless")
        for z in range(Z):
            if t_lcz[li, c, z] > 0.0:
                st.add_layer_event(f"ch{c}/z{z}", "span", int(li), g,
                                   float(t_lcz[li, c, z]), "an:wireless")
