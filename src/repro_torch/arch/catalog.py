"""Chiplet catalog: the per-slot building blocks of a heterogeneous package.

The paper frames multi-chiplet systems as assemblies of "perhaps
heterogeneous" accelerators but evaluates a uniform package; related
work argues the wireless plane is the natural interconnect for exactly
the heterogeneous case (Abadal et al., graphene-based agile
interconnects) and that the wins hide in mapping/architecture co-design
(Guirado et al., arXiv:2011.14755).  This module provides the
vocabulary: a `ChipletSpec` carries everything the modelling planes
need to rate one grid slot — peak compute, NoC port bandwidth, the
weight-SRAM budget that decides streamed-vs-resident weights, and the
energy coefficients the EDP objective charges.

The "standard" preset IS the paper's Table-1 chiplet: its values are
read off the default `AcceleratorConfig` and the calibrated traffic
constants, so a package of 9 "standard" chiplets reproduces the paper
platform bit for bit (pinned in tests/test_torch_arch.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from repro_torch.core.simulator import PJ_PER_BIT_NOC, PJ_PER_MAC
from repro_torch.core.topology import AcceleratorConfig
from repro_torch.units import TERA
from repro_torch.core.traffic import WEIGHT_SRAM_BYTES

_DEFAULT = AcceleratorConfig()
STANDARD_TOPS = _DEFAULT.tops_per_chiplet        # 16 TOPS (144 / 3x3)
STANDARD_NOC_BW = _DEFAULT.noc_bw_per_port       # 64 Gb/s per NoC port


@dataclasses.dataclass(frozen=True)
class ChipletSpec:
    """One chiplet design point (a package grid slot's occupant)."""

    name: str
    tops: float                 # peak compute, ops/s (2 ops per MAC)
    noc_bw_per_port: float      # on-chip mesh port bandwidth, B/s
    sram_bytes: int             # weight-resident SRAM budget (global buffer)
    pj_per_mac: float           # compute energy coefficient
    pj_per_bit_noc: float       # on-chip transport energy coefficient

    def describe(self) -> str:
        return (f"{self.name}({self.tops / TERA:.0f}T,"
                f"{self.sram_bytes / 2**20:.0f}MiB)")


# Preset design points.  "standard" is the paper's Table-1 chiplet; the
# others bracket it along the axes the heterogeneity question cares
# about: a big/LITTLE compute pair (2x / 0.5x rate, SRAM and NoC scaled
# with area), a memory-heavy chiplet (half rate, 8x SRAM keeps big FC
# layers resident instead of streamed), and an AIMC-like analog
# in-memory tile (3x rate at ~0.2x the MAC energy, but a thin NoC and
# small digital buffer — the classic analog trade).
CATALOG: Dict[str, ChipletSpec] = {
    "standard": ChipletSpec("standard", STANDARD_TOPS, STANDARD_NOC_BW,
                            WEIGHT_SRAM_BYTES, PJ_PER_MAC, PJ_PER_BIT_NOC),
    "big": ChipletSpec("big", 2.0 * STANDARD_TOPS, 2.0 * STANDARD_NOC_BW,
                       2 * WEIGHT_SRAM_BYTES, 0.55, 0.35),
    "little": ChipletSpec("little", 0.5 * STANDARD_TOPS,
                          0.5 * STANDARD_NOC_BW, WEIGHT_SRAM_BYTES // 2,
                          0.40, 0.25),
    "mem": ChipletSpec("mem", 0.5 * STANDARD_TOPS, STANDARD_NOC_BW,
                       8 * WEIGHT_SRAM_BYTES, PJ_PER_MAC, PJ_PER_BIT_NOC),
    "aimc": ChipletSpec("aimc", 3.0 * STANDARD_TOPS, 0.5 * STANDARD_NOC_BW,
                        WEIGHT_SRAM_BYTES // 2, 0.10, PJ_PER_BIT_NOC),
}

# Named 3x3 package mixes (spec-name multisets; slot order is decided by
# placement, see arch/placement.py).  "big_little" keeps the paper's
# 144-TOPS package total (3x32 + 6x8); the others trade total compute
# for memory capacity / energy.
MIXES: Dict[str, Tuple[str, ...]] = {
    "big_little": ("big",) * 3 + ("little",) * 6,
    "compute_mem": ("standard",) * 6 + ("mem",) * 3,
    "aimc_edge": ("aimc",) * 3 + ("standard",) * 6,
}


def get_spec(spec: str | ChipletSpec) -> ChipletSpec:
    """Resolve a catalog name (or pass a spec through)."""
    if isinstance(spec, ChipletSpec):
        return spec
    if spec not in CATALOG:
        raise KeyError(f"unknown chiplet spec {spec!r}; pick one of "
                       f"{sorted(CATALOG)} or pass a ChipletSpec")
    return CATALOG[spec]


def get_mix(mix: str) -> Tuple[str, ...]:
    """Resolve a named mix (friendly error listing the choices)."""
    if mix not in MIXES:
        raise KeyError(f"unknown chiplet mix {mix!r}; pick one of "
                       f"{sorted(MIXES)} or pass the spec names directly")
    return MIXES[mix]
