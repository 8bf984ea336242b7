"""Spatial mapping of workload layers onto chiplets (GEMINI-style, simplified).

GEMINI co-explores mapping with architecture using SET; its headline
property for our purposes is that every layer is *spatially partitioned*
across the chiplet array (output-channel / output-row tiling) and that
tensors produced under one partitioning are multicast to the consumers of
the next.  We implement that canonical spatial mapping:

- every layer with MACs is split across all compute chiplets
  (output-channel tiling, equal shares);
- pure data-movement layers (concat/add joins) inherit the partitioning of
  their producers, so an aligned join generates no NoP traffic;
- tensors consumed "far" in program order (> `spill_window` layers after
  production) are spilled to DRAM and re-fetched — GEMINI's
  communication-aware data placement heuristic.

The mapper returns, per layer, the chiplet share vector.  The traffic
generator (`traffic.py`) turns mapping + graph into messages.  Host
Python, as in the JAX package's `core/mapper.py`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, TYPE_CHECKING

import numpy as np

from .topology import Topology
from .workloads import Layer

if TYPE_CHECKING:   # runtime import stays in-function: collectives ->
    from .collectives import CollectiveSpec   # traffic -> mapper cycle


@dataclasses.dataclass
class Mapping:
    """Per-layer chiplet placement (+ the collectives it requires)."""

    chiplets: List[Sequence[int]]      # chiplet ids executing each layer
    shares: List[np.ndarray]           # fraction of the layer per chiplet
    spill_window: int = 4              # program-order distance before DRAM spill
    # collective phases the mapping emits at layer boundaries
    # (tensor-parallel all-reduces, MoE all-to-alls, ...); lowered to
    # messages by `traffic.generate_messages` via `collectives.lower`
    collectives: List["CollectiveSpec"] = dataclasses.field(
        default_factory=list)

    def share_of(self, layer: int, chiplet: int) -> float:
        seq = list(self.chiplets[layer])
        if chiplet not in seq:
            return 0.0
        return float(self.shares[layer][seq.index(chiplet)])


def chiplet_rates(topo: Topology) -> np.ndarray | None:
    """Per-chiplet compute rates (ops/s), or `None` for a uniform package.

    Heterogeneous packages (the `arch` plane's packages) carry a per-slot
    rate vector on the lowered `AcceleratorConfig`; a missing or
    all-equal vector means every legacy uniform-split expression applies
    unchanged (the homogeneous-parity contract).
    """
    r = topo.config.chiplet_tops
    if r is None:
        return None
    v = np.asarray(r, float)
    return None if np.all(v == v[0]) else v


def spatial_mapping(layers: List[Layer], topo: Topology,
                    spill_window: int = 4) -> Mapping:
    """Canonical GEMINI-like mapping: full spatial split of every layer.

    On a heterogeneous package the output-channel tiling is
    compute-balanced — each chiplet's share is proportional to its rate,
    so every chiplet finishes a layer at the same time (join/identity
    layers inherit the same partitioning, staying NoP-free).
    """
    n = topo.config.n_chiplets
    all_chips = tuple(range(n))
    rates = chiplet_rates(topo)
    share = (np.full((n,), 1.0 / n) if rates is None
             else rates / rates.sum())
    chiplets = [all_chips for _ in layers]
    shares = [share for _ in layers]
    return Mapping(chiplets, shares, spill_window)


def snake_order(topo: Topology) -> List[int]:
    """Boustrophedon chiplet order: consecutive pipeline stages adjacent."""
    rows, cols = topo.config.grid
    order = []
    for r in range(rows):
        cs = range(cols) if r % 2 == 0 else range(cols - 1, -1, -1)
        order.extend(r * cols + c for c in cs)
    return order


def pipeline_mapping(layers: List[Layer], topo: Topology,
                     n_stages: int | None = None,
                     spill_window: int = 6, refine: bool = True) -> Mapping:
    """GEMINI/SET-style inter-layer pipelined mapping (the default).

    Layers are packed into MAC-balanced contiguous pipeline stages; stage i
    runs on one chiplet, placed in snake order so consecutive stages are
    mesh neighbours (SET's locality-aware placement).  Cross-stage tensor
    edges become NoP transfers; *fan-out* edges reaching several stages
    become multicast — the traffic pattern the paper identifies as the NoP
    congestion source.
    """
    n = topo.config.n_chiplets
    # pipeline depth never exceeds half the layer count: a sensible mapper
    # does not spray a 10-layer workload over 9 single-layer stages
    n_stages = min(n_stages or n, n, max(1, len(layers) // 3))
    order = snake_order(topo)
    total = sum(lyr.macs for lyr in layers) or 1.0
    # every stage owns a contiguous chiplet group; when stages don't divide
    # the array the first n % n_stages stages take one extra chiplet, so
    # ALL chiplets are used (the trailing remainder used to sit idle)
    k, rem = divmod(n, n_stages)
    sizes = [k + (s < rem) for s in range(n_stages)]
    starts = [0]
    for sz in sizes:
        starts.append(starts[-1] + sz)
    groups = [tuple(order[starts[s]:starts[s + 1]]) for s in range(n_stages)]
    # MAC-balanced contiguous segmentation; on a heterogeneous package
    # the per-stage MAC target is proportional to the stage group's
    # aggregate compute rate rather than to its 1/n_stages head count
    rates = chiplet_rates(topo)
    if rates is not None:
        grp_rate = np.array([sum(rates[c] for c in g) for g in groups])
        cum_share = np.cumsum(grp_rate) / grp_rate.sum()
    acc, stage = 0.0, 0
    stage_of: List[int] = []
    for lyr in layers:
        stage_of.append(stage)
        acc += lyr.macs
        while (stage < n_stages - 1
               and acc >= (total * cum_share[stage] if rates is not None
                           else total * (stage + 1) / n_stages)):
            stage += 1
    # ...refined communication-aware: nudge each stage boundary (within a
    # small window) to the cut with the smallest crossing tensor, as a
    # mapping/communication co-optimising mapper (GEMINI/SET) would.
    W = max(1, len(layers) // (4 * n_stages)) if refine else 0
    for s in range(1, n_stages):
        if not W:
            break
        idxs = [i for i, st in enumerate(stage_of) if st == s]
        if not idxs:
            continue
        b = idxs[0]
        lo, hi = max(1, b - W), min(len(layers) - 1, b + W)
        best = min(range(lo, hi + 1),
                   key=lambda i: layers[i - 1].act_out)
        for i in range(min(b, best), max(b, best)):
            stage_of[i] = s if best < b else s - 1
    def _group_shares(g):
        """Within-group split: uniform, or rate-proportional on hetero."""
        if rates is None:
            return np.full((len(g),), 1.0 / len(g))
        v = rates[list(g)]
        return v / v.sum()

    chiplets: List[Sequence[int]] = [groups[s] for s in stage_of]
    shares = [_group_shares(groups[s]) for s in stage_of]
    # Weight-heavy layers (big FC / gate matrices) are spatially spread so
    # per-chiplet weight slices fit the SRAM budget — widening outward from
    # the layer's own stage group (GEMINI splits such layers spatially).
    # The budget is per-chiplet on heterogeneous packages (the group's
    # tightest slot, matching traffic._layer_sram's streamed-vs-resident
    # gate); uniform packages keep the calibrated global constant.
    from .traffic import WEIGHT_SRAM_BYTES  # calibrated constant
    sram_vec = topo.config.chiplet_sram
    for i, lyr in enumerate(layers):
        budget = (WEIGHT_SRAM_BYTES if sram_vec is None
                  else min(sram_vec[c] for c in chiplets[i]))
        if lyr.weights > budget:
            need = int(np.ceil(lyr.weights / budget))
            w = sizes[stage_of[i]]
            while w < min(need, n):
                w += max(1, k)
            w = min(w, n)
            start = starts[stage_of[i]]
            chiplets[i] = tuple(order[(start + j) % n] for j in range(w))
            shares[i] = _group_shares(chiplets[i])
    return Mapping(list(chiplets), shares, spill_window)


def _full_spread(layers: List[Layer], topo: Topology):
    """All layers on all chiplets, snake order (ring-adjacent neighbours).

    Shards are uniform on a homogeneous package and rate-proportional on
    a heterogeneous one (compute-balanced tensor/expert parallelism)."""
    parts = tuple(snake_order(topo))
    rates = chiplet_rates(topo)
    share = (np.full((len(parts),), 1.0 / len(parts)) if rates is None
             else rates[list(parts)] / rates[list(parts)].sum())
    return parts, [parts] * len(layers), [share] * len(layers)


def tensor_parallel_mapping(layers: List[Layer], topo: Topology,
                            spill_window: int = 4,
                            algorithm: str = "tree") -> Mapping:
    """Tensor-parallel mapping: every layer sharded across all chiplets.

    Weights are input-dim sharded (Megatron row-parallel), so layer
    outputs are *partial sums* that must be all-reduced across the
    chiplet group at layer boundaries.  Graphs that hint their sync
    points (`Layer.collective == "all_reduce"`, e.g. the o-proj / ff2
    boundaries the LLM builder marks) all-reduce only there — the
    Megatron 2-per-block pattern; unhinted graphs (the CNN zoo)
    all-reduce after every MAC layer.

    ``algorithm="tree"`` (default) reduces up a binary tree and fans the
    result out as ONE multicast — wired-suboptimal but broadcast-natured,
    i.e. the collective a hybrid NoP can serve in a single wireless slot
    (the dataflow/architecture co-design of arXiv:2011.14755).
    ``algorithm="ring"`` is the classic wired-optimal bandwidth ring
    whose neighbour unicasts stay on the mesh.

    Inter-layer activations stay chiplet-local (the group and tiling
    match producer to consumer), so the collectives ARE the mapping's
    NoP traffic — plus streamed weights and DRAM spills.
    """
    from .collectives import CollectiveSpec
    parts, chiplets, shares = _full_spread(layers, topo)
    hinted = any(lyr.collective for lyr in layers)
    specs = []
    for i, lyr in enumerate(layers):
        if hinted:
            sync = lyr.collective in ("all_reduce", "moe")
        else:
            sync = lyr.macs > 0 and lyr.act_out > 0
        if sync and lyr.act_out > 0:
            specs.append(CollectiveSpec("all_reduce", i, parts,
                                        float(lyr.act_out),
                                        algorithm=algorithm))
    return Mapping(chiplets, shares, spill_window, specs)


def expert_parallel_mapping(layers: List[Layer], topo: Topology,
                            spill_window: int = 4) -> Mapping:
    """Expert-parallel mapping for MoE graphs (hybrid EP + TP).

    Expert layers (`Layer.collective == "moe"`) spread their expert
    pool across all chiplets; each MoE boundary emits the all-to-all
    pair:

    - **dispatch**: a token goes to `experts_per_token` experts with the
      SAME activation payload, so each source chiplet's local token
      block is one multicast to the expert-owner chiplets it hits
      (`fanout = experts_per_token`) — broadcast-natured,
      wireless-eligible.  With ``experts_per_token == 1`` it decays to
      plain distinct-shard unicasts.
    - **combine**: per-token expert partial outputs are distinct per
      destination — a classic unicast all-to-all of
      ``experts_per_token``-scaled volume back to the token homes.

    Dense sublayers keep their tensor-parallel all-reduces (tree form)
    and ``"broadcast"``-hinted layers (router state) fan out from their
    first chiplet.  Raises on graphs with no ``"moe"`` layer — use
    `tensor_parallel_mapping` or `pipeline_mapping` there.
    """
    from .collectives import CollectiveSpec
    if not any(lyr.collective == "moe" for lyr in layers):
        raise ValueError("expert_parallel_mapping needs a graph with "
                         "'moe'-hinted layers (see workloads_llm); use "
                         "tensor_parallel_mapping for dense graphs")
    parts, chiplets, shares = _full_spread(layers, topo)
    k = len(parts)
    specs = []
    for i, lyr in enumerate(layers):
        if lyr.collective == "moe":
            ept = max(1, lyr.experts_per_token)
            specs.append(CollectiveSpec("all_to_all", i, parts,
                                        float(lyr.act_in) / k, fanout=ept))
            specs.append(CollectiveSpec("all_to_all", i, parts,
                                        float(lyr.act_out) * ept / k))
        elif lyr.collective == "all_reduce":
            specs.append(CollectiveSpec("all_reduce", i, parts,
                                        float(lyr.act_out),
                                        algorithm="tree"))
        elif lyr.collective == "broadcast":
            specs.append(CollectiveSpec("broadcast", i, parts,
                                        float(lyr.act_out)))
    return Mapping(chiplets, shares, spill_window, specs)
