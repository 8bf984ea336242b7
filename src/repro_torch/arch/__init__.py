"""`repro_torch.arch`: heterogeneous chiplet packages + placement co-design.

The fourth modelling plane.  `core` asks "what does the wireless plane
buy a FIXED uniform package"; `arch` makes the package itself a search
variable: a catalog of chiplet design points (`catalog.ChipletSpec`),
a per-slot package description that lowers onto the existing platform
config (`package.HeteroPackage`), and a deterministic placement/mapping
co-design engine whose objective is end-to-end makespan
(`placement.codesign`).  `dse.hetero_sweep` runs the headline study:
how much does the wireless plane shrink the best-vs-worst-placement
spread on heterogeneous packages?
"""

from .catalog import CATALOG, MIXES, ChipletSpec, get_mix, get_spec
from .package import HeteroPackage
from .placement import (CodesignResult, PlacementProblem, PlacementResult,
                        PlacementState, anneal, balanced_stages, codesign,
                        exhaustive, greedy_seed)

__all__ = [
    "CATALOG", "MIXES", "ChipletSpec", "get_mix", "get_spec",
    "HeteroPackage",
    "CodesignResult", "PlacementProblem", "PlacementResult",
    "PlacementState", "anneal", "balanced_stages", "codesign",
    "exhaustive", "greedy_seed",
]
