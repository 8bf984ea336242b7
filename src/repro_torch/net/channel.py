"""Wireless channel plane: shared channel, FDM multi-channel, and
distance-gated spatial reuse.

The paper's platform has one antenna per chiplet/DRAM module tuned to a
single shared frequency band; serialization per layer is one global
`volume / bandwidth` term.  Two orthogonal ways out of that global
serialization point:

- **Frequency division** (graphene-class agile transceivers): split the
  band into several channels with each node's transmitter tuned to its
  zone's channel.  Transmissions on different channels proceed
  concurrently, so the per-layer wireless time becomes a per-channel
  max instead of one global sum.
- **Spatial reuse** (the standard answer for *large* meshes, where even
  a per-channel population saturates): tile the package into
  ``reuse_zones`` spatially-separated interference zones.  A
  transmission whose NoP hop span stays within ``reuse_distance`` only
  occupies its source's zone — zones transmit concurrently on the SAME
  frequency; a longer-range transmission is heard across zones and
  serializes globally on its channel.  Per (layer, channel) the service
  time becomes ``t(global) + max_z t(zone z)``.

Zone assignment policies (node id -> frequency channel):

- ``contiguous``: equal blocks of consecutive node ids.  Matches a
  physical-layout zoning (neighbouring chiplets share a channel), which
  concentrates a pipeline stage's traffic on one channel.
- ``interleaved``: round-robin ``node % n_channels``.  Spreads adjacent
  (and therefore usually co-active) transmitters across channels, which
  balances per-channel load for pipeline mappings.

Spatial zones are assigned by *grid position* (`assign_spatial`): the
package is tiled into a near-aspect-matched ``kr x kc`` factorization of
``reuse_zones``, and every node (DRAM modules clamped onto their edge)
belongs to the tile it sits in.

``n_channels == 1, reuse_zones == 1`` reproduces the paper's
single-shared-medium behaviour bit-for-bit regardless of policy.

The node -> channel and node -> zone maps are int64 tensors on the
device the caller names (or of the coordinates it passes), so the
engines index packets with them where the packets are; the SNR model is
elementwise torch in float64 on the device of its inputs.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

POLICIES = ("contiguous", "interleaved")


@dataclasses.dataclass(frozen=True)
class ChannelPlan:
    """Frequency-division + spatial-reuse plan for the wireless plane.

    ``bandwidth_per_channel=None`` divides the aggregate wireless
    bandwidth evenly, i.e. the comparison against the single shared
    channel is at equal aggregate bandwidth.  A float pins each
    channel's rate instead (aggregate then scales with ``n_channels``).

    ``reuse_zones`` (K) tiles the package into K spatial interference
    zones that transmit concurrently; ``reuse_distance`` is the NoP hop
    span up to which a transmission stays local to its source's zone
    (``None`` derives the zone-tile diameter, so exactly the
    transmissions that fit inside one tile-sized neighbourhood reuse
    the band).  ``reuse_zones == 1`` is the single shared medium — the
    gate is moot and every transmission is zone-local by construction.
    """

    n_channels: int = 1
    policy: str = "contiguous"
    bandwidth_per_channel: float | None = None
    reuse_zones: int = 1
    reuse_distance: int | None = None

    def __post_init__(self):
        if self.n_channels < 1:
            raise ValueError(f"n_channels must be >= 1, got {self.n_channels}")
        if self.policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}")
        if self.reuse_zones < 1:
            raise ValueError(
                f"reuse_zones must be >= 1, got {self.reuse_zones}")
        if self.reuse_distance is not None and self.reuse_distance < 0:
            raise ValueError(
                f"reuse_distance must be >= 0, got {self.reuse_distance}")

    def channel_bandwidth(self, aggregate_bw: float) -> float:
        """Per-channel service rate in B/s."""
        if self.bandwidth_per_channel is not None:
            return self.bandwidth_per_channel
        return aggregate_bw / self.n_channels

    def assign(self, n_nodes: int, device="cpu") -> torch.Tensor:
        """Frequency channel id per node (compute chiplets then DRAM),
        int64 on ``device``."""
        nodes = torch.arange(n_nodes, device=device)
        if self.n_channels == 1:
            return torch.zeros_like(nodes)
        if self.policy == "interleaved":
            return nodes % self.n_channels
        # contiguous equal blocks (last block absorbs the remainder)
        return torch.clamp(nodes * self.n_channels // max(n_nodes, 1),
                           max=self.n_channels - 1)

    def zone_tiling(self, grid: Tuple[int, int]) -> Tuple[int, int]:
        """``(kr, kc)`` zone-tile factorization of ``reuse_zones``.

        Picks the divisor pair closest to the grid's aspect ratio so
        non-square grids tile sensibly; raises if no divisor pair fits
        inside the grid (e.g. 5 zones on a 2x8 mesh).
        """
        rows, cols = grid
        K = self.reuse_zones
        pairs = [(d, K // d) for d in range(1, K + 1)
                 if K % d == 0 and d <= rows and K // d <= cols]
        if not pairs:
            raise ValueError(
                f"reuse_zones={K} has no (kr x kc) factorization fitting "
                f"a {rows}x{cols} grid")
        return min(pairs, key=lambda p: abs(p[0] / p[1] - rows / cols))

    def assign_spatial(self, grid: Tuple[int, int],
                       coords) -> Tuple[torch.Tensor, int]:
        """``(zone_of_node, reuse_distance)`` for one package geometry.

        ``coords`` is the (n_nodes, 2) integer grid positions (DRAM
        modules clamped onto their edge —
        `repro_torch.core.topology.node_grid_coords`); the zones are an
        int64 tensor on its device (the CPU for a NumPy array).  The derived
        ``reuse_distance`` is the zone-tile Manhattan diameter; with a
        single zone that is the whole-package diameter, so every
        transmission classifies as zone-local and the plan degenerates
        to the shared medium exactly.
        """
        rows, cols = grid
        kr, kc = self.zone_tiling(grid)
        coords = torch.as_tensor(coords, dtype=torch.int64)
        zone = ((coords[:, 0] * kr // rows) * kc
                + coords[:, 1] * kc // cols)
        rd = self.reuse_distance
        if rd is None or self.reuse_zones == 1:
            # tile diameter: ceil(rows/kr) - 1 + ceil(cols/kc) - 1.  A
            # single zone's tile is the whole package, whose diameter
            # bounds every route — the gate never fires (and an explicit
            # reuse_distance is ignored: one zone IS the shared medium).
            rd = (-(-rows // kr) - 1) + (-(-cols // kc) - 1)
        return zone, int(rd)

    def describe(self) -> str:
        s = "1ch" if self.n_channels == 1 \
            else f"{self.n_channels}ch-{self.policy}"
        if self.reuse_zones > 1:
            s += f"-x{self.reuse_zones}reuse"
        return s


# ---------------------------------------------------------------------------
# SNR / fading -> effective capacity (the dynamic-conditions plane)
# ---------------------------------------------------------------------------

def _f64(x) -> torch.Tensor:
    """float64 tensor of ``x``, on the device of ``x`` if it is one."""
    return torch.as_tensor(x, dtype=torch.float64)


def shannon_capacity(snr_db) -> torch.Tensor:
    """Normalized Shannon capacity ``log2(1 + SNR)`` in bit/s/Hz."""
    return torch.log2(1.0 + 10.0 ** (_f64(snr_db) / 10.0))


@dataclasses.dataclass(frozen=True)
class SnrProfile:
    """Distance + degradation -> effective wireless rate, Shannon-style.

    The package has no physical scale of its own (the topology is a unit
    grid), so the profile carries it: ``pitch_mm`` converts grid hops to
    millimetres.  The link budget is a log-distance model around a
    reference point: a transmission spanning distance ``d`` sees

        ``snr_db(d) = ref_snr_db - 10 * path_loss_exp * log10(d / ref)``

    (clamped at the reference for shorter spans — the budget is set by
    the worst-case in-package reach, shorter hops don't beat it), and a
    fading event of ``fading_db`` lowers that SNR directly.  The
    *capacity scale* is the ratio of faded to clear Shannon capacity,

        ``C(snr - fade) / C(snr)``  with  ``C(s) = log2(1 + 10^(s/10))``,

    so zero fading is exactly 1.0 and the same dB of fading costs more
    capacity on a longer, lower-SNR span.
    """

    ref_snr_db: float = 15.0       # link budget at the reference span
    ref_distance_mm: float = 10.0  # span the budget is quoted at
    path_loss_exp: float = 2.0     # in-package log-distance exponent
    pitch_mm: float = 10.0         # chiplet pitch: one grid hop in mm

    def __post_init__(self):
        if self.ref_snr_db <= 0:
            raise ValueError(f"ref_snr_db must be > 0, got {self.ref_snr_db}")
        if self.ref_distance_mm <= 0 or self.pitch_mm <= 0:
            raise ValueError("ref_distance_mm and pitch_mm must be > 0")
        if self.path_loss_exp < 1.0:
            raise ValueError(
                f"path_loss_exp must be >= 1, got {self.path_loss_exp}")

    def snr_db_at(self, distance_mm) -> torch.Tensor:
        """Clear-channel SNR (dB) at physical span ``distance_mm``."""
        d = torch.clamp(_f64(distance_mm), min=self.ref_distance_mm)
        return (self.ref_snr_db
                - 10.0 * self.path_loss_exp
                * torch.log10(d / self.ref_distance_mm))

    def capacity_scale(self, distance_mm, fading_db) -> torch.Tensor:
        """Fraction of nominal capacity surviving ``fading_db`` at span
        ``distance_mm`` — exactly 1.0 when the fade is 0 dB."""
        fade = _f64(fading_db)
        if bool(((fade < 0) | ~torch.isfinite(fade)).any()):
            raise ValueError("fading_db must be finite and >= 0")
        snr = self.snr_db_at(distance_mm)
        return torch.where(fade == 0.0, 1.0,
                           shannon_capacity(snr - fade)
                           / shannon_capacity(snr))

    def channel_distances(self, plan: ChannelPlan, n_nodes: int,
                          coords) -> torch.Tensor:
        """Worst-case physical span (mm) served by each frequency
        channel: the Manhattan diameter of the channel's member set vs
        the whole package (a transmission must reach every listener),
        scaled by the pitch.  Host geometry, as `ChannelPlan.assign`."""
        coords = np.asarray(coords, np.float64)
        ch = plan.assign(n_nodes).numpy()
        dist = np.zeros(plan.n_channels, np.float64)
        lo, hi = coords.min(axis=0), coords.max(axis=0)
        for c in range(plan.n_channels):
            m = coords[ch == c]
            if len(m) == 0:
                dist[c] = self.ref_distance_mm
                continue
            # member must reach the farthest package corner it talks to
            span = np.maximum(hi - m.min(axis=0), m.max(axis=0) - lo)
            dist[c] = max(float(span.sum()), 1.0) * self.pitch_mm
        return torch.from_numpy(dist)

    def effective_bandwidth(self, plan: ChannelPlan, aggregate_bw: float,
                            n_nodes: int, coords,
                            fading_db) -> torch.Tensor:
        """Per-channel effective rate (B/s) under ``fading_db`` (scalar
        or per-channel tensor), on the device of ``fading_db``."""
        bw_c = plan.channel_bandwidth(aggregate_bw)
        fade = _f64(fading_db)
        dist = self.channel_distances(plan, n_nodes, coords).to(fade.device)
        return bw_c * self.capacity_scale(dist, fade)
