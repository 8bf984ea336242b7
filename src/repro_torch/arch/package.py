"""`HeteroPackage`: a chiplet spec for every grid slot, lowered to the
existing platform description.

The package is the fourth modelling plane's state: WHICH chiplet sits
WHERE.  It lowers to an (extended) `AcceleratorConfig` — the per-slot
rate/SRAM/energy vectors ride on optional config fields — so every
existing consumer (`build_topology`, `build_trace`, `simulate_hybrid`,
`PacketSim`, the batched DSE engine) works unchanged.  A package of
identical chiplets lowers to vectors whose consumers all collapse to
the legacy uniform expressions, keeping the homogeneous reproduction
bit-identical (tests/test_torch_arch.py pins this).
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Sequence, Tuple

from repro_torch.core.topology import (AcceleratorConfig, Topology,
                                       build_topology)

from .catalog import ChipletSpec, get_mix, get_spec


@dataclasses.dataclass(frozen=True)
class HeteroPackage:
    """Per-slot chiplet assignment on a rows x cols compute grid.

    ``slots[i]`` is the spec of chiplet id ``i`` — the same row-major
    slot numbering `Topology` uses, so slot vectors index directly by
    chiplet id everywhere downstream.
    """

    grid: Tuple[int, int]
    slots: Tuple[ChipletSpec, ...]

    def __post_init__(self):
        if len(self.slots) != self.grid[0] * self.grid[1]:
            raise ValueError(
                f"{self.grid[0]}x{self.grid[1]} grid needs "
                f"{self.grid[0] * self.grid[1]} slots, got {len(self.slots)}")

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------

    @classmethod
    def uniform(cls, spec: str | ChipletSpec = "standard",
                grid: Tuple[int, int] = (3, 3)) -> "HeteroPackage":
        """Homogeneous package (the paper platform when ``standard``)."""
        s = get_spec(spec)
        return cls(grid, (s,) * (grid[0] * grid[1]))

    @classmethod
    def from_mix(cls, mix: str | Sequence[str | ChipletSpec],
                 grid: Tuple[int, int] = (3, 3),
                 order: Sequence[int] | None = None) -> "HeteroPackage":
        """Package from a named catalog mix (or explicit spec sequence).

        ``order`` permutes the mix over the slots (``slots[i] =
        mix[order[i]]``) — the placement engine's knob; identity when
        omitted.
        """
        names = get_mix(mix) if isinstance(mix, str) else tuple(mix)
        specs = tuple(get_spec(s) for s in names)
        if order is not None:
            if sorted(order) != list(range(len(specs))):
                raise ValueError(f"order must permute 0..{len(specs) - 1}")
            specs = tuple(specs[j] for j in order)
        return cls(grid, specs)

    def placed(self, order: Sequence[int]) -> "HeteroPackage":
        """Re-placement: slot i takes the current ``slots[order[i]]``."""
        return HeteroPackage(self.grid,
                             tuple(self.slots[j] for j in order))

    # ------------------------------------------------------------------
    # views
    # ------------------------------------------------------------------

    @property
    def n_slots(self) -> int:
        return len(self.slots)

    @property
    def is_uniform(self) -> bool:
        return all(s == self.slots[0] for s in self.slots)

    @property
    def tops_total(self) -> float:
        return float(sum(s.tops for s in self.slots))

    def describe(self) -> str:
        counts = Counter(s.name for s in self.slots)
        body = "+".join(f"{n}x{name}" for name, n in sorted(counts.items()))
        return f"{self.grid[0]}x{self.grid[1]}[{body}]"

    # ------------------------------------------------------------------
    # lowering
    # ------------------------------------------------------------------

    def to_config(self,
                  base: AcceleratorConfig | None = None) -> AcceleratorConfig:
        """Lower to an `AcceleratorConfig` carrying the per-slot vectors.

        Package-level parameters (DRAM, NoP mesh, wireless band) come
        from ``base`` (the paper's Table-1 defaults when omitted) — the
        heterogeneity question varies the chiplets, not the package
        substrate.
        """
        base = base or AcceleratorConfig()
        return dataclasses.replace(
            base, grid=self.grid,
            tops_total=self.tops_total,
            chiplet_tops=tuple(s.tops for s in self.slots),
            chiplet_noc_bw=tuple(s.noc_bw_per_port for s in self.slots),
            chiplet_sram=tuple(int(s.sram_bytes) for s in self.slots),
            chiplet_pj_per_mac=tuple(s.pj_per_mac for s in self.slots),
            chiplet_pj_per_bit_noc=tuple(s.pj_per_bit_noc
                                         for s in self.slots))

    def build_topology(self,
                       base: AcceleratorConfig | None = None) -> Topology:
        return build_topology(self.to_config(base))
