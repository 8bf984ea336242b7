"""Package-scale topology for the wireless-enabled multi-chiplet accelerator.

Faithful to the paper's Table 1 platform: an RxC grid of compute chiplets
(3x3 by default, arbitrary — and non-square — grids up to 16x16 and
beyond for the scale-out frontier), DRAM chiplets on the package
periphery, an XY-mesh NoP between chiplets, an XY-mesh NoC inside each
chiplet, and one antenna + transceiver at the geometric center of every
compute chiplet and DRAM module (paper SIII-B1).

Distances are expressed in NoP hops (the unit the paper's distance
threshold uses).  Antenna coordinates are derived from the physical layout
so the wireless plane is single-hop between any two antennas.  All-pairs
hop distances are available vectorized (`Topology.hop_matrix`) — large
meshes cost the route walk once, not per message.

Host Python and NumPy, as in the JAX package's `core/topology.py`: the
geometry is built once per trace, before any array goes to the device.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Tuple

import numpy as np

from .units import gbps_to_bytes_per_s

Coord = Tuple[int, int]


@dataclasses.dataclass(frozen=True)
class AcceleratorConfig:
    """Platform parameters (paper Table 1 defaults).

    Rates are bytes/second internally; the paper quotes Gb/s for NoC/NoP/
    wireless and GB/s for DRAM.  Construction validates the package
    geometry — a mismatched per-chiplet vector or an impossible grid
    fails HERE with a clear message, not deep inside `build_trace`.
    """

    grid: Tuple[int, int] = (3, 3)          # compute chiplets
    n_dram: int = 4                          # DRAM chiplets on the perimeter
    tops_total: float = 144e12               # 144 TOPS across the package
    dram_bw_per_chiplet: float = 16e9        # 16 GB/s per DRAM chiplet
    nop_bw_per_side: float = gbps_to_bytes_per_s(32)   # per mesh side
    noc_bw_per_port: float = gbps_to_bytes_per_s(64)   # per NoC port
    wireless_bw: float = gbps_to_bytes_per_s(64)       # paper: 64 or 96
    pe_mesh: Tuple[int, int] = (16, 16)      # PEs per chiplet (NoC nodes)
    chiplet_mm: float = 5.0                  # chiplet edge length (layout only)
    freq_ghz: float = 1.0
    # --- heterogeneous package (the `arch` plane) ---
    # Per-chiplet vectors, indexed by chiplet id (row-major grid slot).
    # `None` (the default) keeps the uniform package: every rate derives
    # from the scalars above and every modelling plane takes the exact
    # code path it took before heterogeneity existed.  `HeteroPackage
    # .to_config()` populates them; each consumer falls back to the
    # uniform expression whenever the values it needs are all equal, so
    # a package of identical chiplets is bit-identical to the scalars.
    chiplet_tops: Tuple[float, ...] | None = None         # ops/s per slot
    chiplet_noc_bw: Tuple[float, ...] | None = None       # B/s per NoC port
    chiplet_sram: Tuple[int, ...] | None = None           # weight-SRAM bytes
    chiplet_pj_per_mac: Tuple[float, ...] | None = None
    chiplet_pj_per_bit_noc: Tuple[float, ...] | None = None

    def __post_init__(self):
        ints = (int, np.integer)   # numpy ints (e.g. from array axes) count
        rows, cols = (self.grid if isinstance(self.grid, tuple)
                      and len(self.grid) == 2 else (0, 0))
        if not (isinstance(rows, ints) and isinstance(cols, ints)
                and rows >= 1 and cols >= 1):
            raise ValueError(
                f"grid must be a (rows, cols) tuple of positive ints, "
                f"got {self.grid!r}")
        if not (isinstance(self.n_dram, ints) and self.n_dram >= 1):
            raise ValueError(
                f"n_dram must be a positive int, got {self.n_dram!r}")
        n = rows * cols
        for field in ("chiplet_tops", "chiplet_noc_bw", "chiplet_sram",
                      "chiplet_pj_per_mac", "chiplet_pj_per_bit_noc"):
            v = getattr(self, field)
            if v is None:
                continue
            if len(v) != n:
                raise ValueError(
                    f"{field} must have one entry per chiplet "
                    f"({rows}x{cols} grid -> {n}), got {len(v)}")
            if any(x <= 0 for x in v):
                raise ValueError(f"{field} entries must be positive")

    @property
    def n_chiplets(self) -> int:
        return self.grid[0] * self.grid[1]

    @property
    def tops_per_chiplet(self) -> float:
        return self.tops_total / self.n_chiplets

    @property
    def dram_bw_total(self) -> float:
        return self.dram_bw_per_chiplet * self.n_dram

    # --- NoP bisection: for an RxC XY mesh, the vertical bisection cut has
    # R links; multicast/reduction flows that cross the package midline all
    # share them (paper SI: "congested bisection links").
    @property
    def nop_bisection_bw(self) -> float:
        return self.grid[0] * self.nop_bw_per_side


@dataclasses.dataclass(frozen=True)
class Topology:
    config: AcceleratorConfig
    chiplet_coords: Tuple[Coord, ...]
    dram_coords: Tuple[Coord, ...]           # virtual grid coords off the edges
    antenna_xy_mm: Tuple[Tuple[float, float], ...]  # one per chiplet then DRAM

    @property
    def n_nodes(self) -> int:
        return len(self.chiplet_coords) + len(self.dram_coords)

    def _is_dram(self, node: int) -> bool:
        return node >= len(self.chiplet_coords)

    def route(self, src: int, dst: int,
              order: str = "xy") -> List[Tuple[Coord, Coord]]:
        """Directed XY (dimension-ordered) mesh route between two nodes.

        DRAM chiplets attach to every edge router along their package side
        with enough attach links to carry their full 16 GB/s (i.e. the
        attach hop is DRAM-bandwidth-limited, which `t_dram` already
        accounts for) — so routes to/from DRAM contribute only the *mesh*
        links beyond the aligned edge router.
        """
        dc = self._coord(dst)
        sc = self._coord(src)
        links: List[Tuple[Coord, Coord]] = []
        if self._is_dram(src):
            sc = self._grid_entry(src, dc)
        if self._is_dram(dst):
            dc = self._grid_entry(dst, sc)
        x, y = sc
        dims = (0, 1) if order == "xy" else (1, 0)
        for dim in dims:
            if dim == 0:
                step = 1 if dc[0] > x else -1
                while x != dc[0]:
                    links.append(((x, y), (x + step, y)))
                    x += step
            else:
                step = 1 if dc[1] > y else -1
                while y != dc[1]:
                    links.append(((x, y), (x, y + step)))
                    y += step
        return links

    def _grid_entry(self, dram: int, toward: Coord) -> Coord:
        """Edge-router grid coordinate where a DRAM's traffic enters."""
        r, c = self._coord(dram)
        rows, cols = self.config.grid
        if r == -1:
            return (0, min(max(toward[1], 0), cols - 1))
        if r == rows:
            return (rows - 1, min(max(toward[1], 0), cols - 1))
        if c == -1:
            return (min(max(toward[0], 0), rows - 1), 0)
        return (min(max(toward[0], 0), rows - 1), cols - 1)

    def nop_hops(self, a: int, b: int) -> int:
        """XY-route hop distance between two nodes (DRAM attach-aware)."""
        return int(self.hop_matrix()[a, b])

    def hop_matrix(self) -> np.ndarray:
        """All-pairs XY hop distances, (n_nodes, n_nodes), cached.

        Chiplet-chiplet distance is Manhattan on the grid.  A DRAM module
        attaches to every edge router along its package side (see
        `route`), so the distance to/from a DRAM is the perpendicular
        distance to that side — vectorized here so large meshes pay one
        array pass instead of a per-pair route walk.
        """
        cached = getattr(self, "_hop_matrix", None)
        if cached is not None:
            return cached
        rows, cols = self.config.grid
        n_chip = len(self.chiplet_coords)
        coords = np.array(self.chiplet_coords, np.int64)      # (n_chip, 2)
        h = np.abs(coords[:, None, :] - coords[None, :, :]).sum(axis=2)
        n = self.n_nodes
        hops = np.zeros((n, n), np.int64)
        hops[:n_chip, :n_chip] = h
        # chiplet <-> DRAM: one virtual coordinate is off-grid; the route
        # enters at the edge router aligned with the chiplet, so only the
        # perpendicular axis contributes.
        for j, (rd, cd) in enumerate(self.dram_coords):
            if 0 <= rd < rows:          # left/right side: column distance
                d = np.abs(coords[:, 1] - min(max(cd, 0), cols - 1))
            else:                        # top/bottom side: row distance
                d = np.abs(coords[:, 0] - min(max(rd, 0), rows - 1))
            hops[:n_chip, n_chip + j] = d
            hops[n_chip + j, :n_chip] = d
        # DRAM <-> DRAM (unused by traffic, kept route-exact for takers)
        for a in range(n_chip, n):
            for b in range(n_chip, n):
                if a != b:
                    hops[a, b] = len(self.route(a, b))
        object.__setattr__(self, "_hop_matrix", hops)
        return hops

    def multicast_route(self, src: int, dsts: List[int],
                        order: str = "xy") -> List[Tuple[Coord, Coord]]:
        """Directed link set of a dimension-ordered multicast tree."""
        links = set()
        for d in dsts:
            links.update(self.route(src, d, order))
        return sorted(links)

    def multicast_hops(self, src: int, dsts: List[int]) -> int:
        """Byte-hop multiplier (distinct links) of an XY multicast tree."""
        return len(self.multicast_route(src, dsts))

    def max_unicast_hops(self, src: int, dsts: List[int]) -> int:
        return max(self.nop_hops(src, d) for d in dsts)

    def _coord(self, node: int) -> Coord:
        n_chip = len(self.chiplet_coords)
        if node < n_chip:
            return self.chiplet_coords[node]
        return self.dram_coords[node - n_chip]


def dram_positions(rows: int, cols: int, n_dram: int) -> Tuple[Coord, ...]:
    """Perimeter DRAM placement, parametric in the module count.

    Up to four modules reproduce the paper's Fig. 1 exactly: one centred
    per package side, in the fixed side order (top, bottom, left, right).
    Beyond four — large-mesh packages need the aggregate DRAM bandwidth
    to scale with the perimeter — modules are dealt round-robin over the
    four sides and spread evenly along each side, so an `n_dram = 16`
    16x16 package gets four evenly-spaced modules per side.
    """
    mid_r, mid_c = rows // 2, cols // 2
    legacy = ((-1, mid_c), (rows, mid_c), (mid_r, -1), (mid_r, cols))
    if n_dram <= 4:
        return legacy[:n_dram]
    per_side = [n_dram // 4 + (s < n_dram % 4) for s in range(4)]
    out: List[Coord] = []
    for side, k in enumerate(per_side):
        span = cols if side < 2 else rows
        for i in range(k):
            pos = (2 * i + 1) * span // (2 * k)      # evenly spaced centres
            out.append(((-1, pos), (rows, pos),
                        (pos, -1), (pos, cols))[side])
    return tuple(out)


def build_topology(config: AcceleratorConfig | None = None) -> Topology:
    cfg = config or AcceleratorConfig()
    rows, cols = cfg.grid
    chiplets = tuple(itertools.product(range(rows), range(cols)))
    dram = dram_positions(rows, cols, cfg.n_dram)

    # Antenna at the centre of every chiplet / DRAM (paper SIII-B1): physical
    # coordinates derived from grid position and chiplet pitch.
    pitch = cfg.chiplet_mm + 1.0  # 1 mm inter-chiplet spacing
    ant = tuple(
        (c[1] * pitch + cfg.chiplet_mm / 2, c[0] * pitch + cfg.chiplet_mm / 2)
        for c in chiplets + dram
    )
    return Topology(cfg, chiplets, dram, ant)


def nearest_dram(topo: Topology, chiplet: int) -> int:
    """DRAM node id (global) closest to a chiplet, used for weight fetch.

    Ties break toward the lowest node id (the legacy `min` order);
    computed once for the whole package from the hop matrix and cached —
    the traffic generator calls this per spill message.
    """
    cached = getattr(topo, "_nearest_dram", None)
    if cached is None:
        n_chip = len(topo.chiplet_coords)
        cached = n_chip + topo.hop_matrix()[:n_chip, n_chip:].argmin(axis=1)
        object.__setattr__(topo, "_nearest_dram", cached)
    return int(cached[chiplet])


def node_grid_coords(topo: Topology) -> np.ndarray:
    """(n_nodes, 2) int grid coordinates, DRAM virtual coords clamped.

    The spatial channel-reuse model (`repro_torch.net.channel`) tiles the
    package into interference zones by grid position; DRAM modules are
    clamped onto their adjacent edge row/column so every node lands in
    a zone.
    """
    rows, cols = topo.config.grid
    coords = np.array(topo.chiplet_coords + topo.dram_coords, np.int64)
    coords[:, 0] = np.clip(coords[:, 0], 0, rows - 1)
    coords[:, 1] = np.clip(coords[:, 1], 0, cols - 1)
    return coords


def chiplet_neighbourhood(topo: Topology) -> Dict[int, List[int]]:
    """Adjacency (1-hop) map over compute chiplets, for mapping locality."""
    n = len(topo.chiplet_coords)
    return {
        i: [j for j in range(n) if j != i and topo.nop_hops(i, j) == 1]
        for i in range(n)
    }
