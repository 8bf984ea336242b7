"""Placement / mapping co-design search over heterogeneous packages.

The search state is joint:

- **placement** — which `ChipletSpec` of the mix sits at which grid
  slot.  Stages run along the snake order (consecutive pipeline stages
  stay mesh neighbours, as in `mapper.pipeline_mapping`), so a
  placement is a permutation ``order`` with snake position ``j``
  occupied by ``specs[order[j]]``.
- **layer assignment** — a contiguous segmentation ``stage_of`` of the
  layer graph into ``min(n_slots, n_layers)`` non-empty stages; stage
  ``s`` executes on a contiguous run of snake positions (one slot per
  stage when the graph is deep enough, multi-slot groups with
  rate-proportional shares otherwise — the `pipeline_mapping` scheme).

The objective is the end-to-end makespan of the analytic pipeline
(`simulate_wired`, and for the hybrid plane the best static
(threshold x injection) point of `simulate_hybrid` via the batched DSE
engine — the paper's own operating point).  Three engines share one
memoised evaluator:

- `greedy_seed` — compute-balanced: segment by MACs, match the fastest
  chiplet to the heaviest stage (largest-job/fastest-machine), then
  re-segment against the placed rates.
- `anneal` — seeded simulated annealing over swap-two-slots and
  move-one-boundary neighbourhoods, with restarts and a final
  steepest-descent polish.  Same seed => identical result (pinned in
  tests/test_torch_arch.py).
- `exhaustive` — full joint enumeration on small problems (<= 6 slots),
  the ground truth that validates the annealer.

Where it runs: the search is host Python.  Each distinct evaluation
builds its trace on the host and lands it on the problem's device (the
CUDA card unless the caller passes ``device="cpu"``), where
`simulate_wired` and `grid_best_speedup` cost it; the memo holds the two
makespans as host floats.  The randomness is NumPy's
``default_rng(seed)`` on the host, drawn in the JAX package's order, so
one seed walks the same states on every device where the costs agree.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.dse import grid_best_speedup
from repro_torch.obs import profile as obs_profile
from repro_torch.obs.metrics import DEFAULT_REGISTRY
from repro_torch.obs.provenance import make_provenance
from repro_torch.core.mapper import Mapping, snake_order
from repro_torch.core.simulator import simulate_wired
from repro_torch.core.topology import AcceleratorConfig
from repro_torch.core.traffic import PACKET_BYTES, build_trace, resolve_device
from repro_torch.core.workloads import Layer, get_workload
from repro_torch.net.config import NetworkConfig
from repro_torch.units import gbps_to_bytes_per_s

from .catalog import ChipletSpec, get_mix, get_spec
from .package import HeteroPackage

OBJECTIVES = ("wired", "hybrid")


@dataclasses.dataclass(frozen=True)
class PlacementState:
    order: Tuple[int, ...]       # snake position j -> index into the mix
    stage_of: Tuple[int, ...]    # layer -> stage (= snake position)


@dataclasses.dataclass(frozen=True)
class PlacementResult:
    state: PlacementState
    slot_names: Tuple[str, ...]  # spec names along the snake order
    t_wired: float               # all-wired makespan (s)
    t_hybrid: float              # DSE-best hybrid makespan (s)
    objective: str
    method: str
    evaluations: int             # distinct states evaluated so far
    provenance: Optional[dict] = dataclasses.field(
        default=None, compare=False)  # dse.provenance of the search

    @property
    def makespan(self) -> float:
        return self.t_wired if self.objective == "wired" else self.t_hybrid

    @property
    def hybrid_speedup(self) -> float:
        return self.t_wired / self.t_hybrid


class PlacementProblem:
    """One (workload, chiplet mix, network) co-design instance.

    Evaluations are memoised per joint state, so the greedy seed, both
    annealing objectives and the exhaustive validator share work.  Each
    runs on ``device``: the CUDA card when None (raises without one;
    pass ``device="cpu"``); `anneal` and `exhaustive` search on their
    problem's device.
    """

    def __init__(self, workload: str | List[Layer],
                 mix: str | Sequence[str | ChipletSpec] = "big_little",
                 grid: Tuple[int, int] = (3, 3),
                 net: NetworkConfig | None = None,
                 base: AcceleratorConfig | None = None,
                 packet_bytes: float | None = None, device=None):
        self.device = resolve_device(device)
        if isinstance(workload, str):
            self.workload = workload
            self.layers = get_workload(workload)
            if packet_bytes is None and ":" in workload:
                from repro_torch.core.workloads_llm import auto_packet_bytes
                packet_bytes = auto_packet_bytes(self.layers)
        else:
            self.workload = "<layers>"
            self.layers = workload
        names = get_mix(mix) if isinstance(mix, str) else tuple(mix)
        self.mix = mix if isinstance(mix, str) else "<custom>"
        self.specs: Tuple[ChipletSpec, ...] = tuple(get_spec(s)
                                                    for s in names)
        self.grid = grid
        self.n_slots = grid[0] * grid[1]
        if len(self.specs) != self.n_slots:
            raise ValueError(f"mix has {len(self.specs)} specs for a "
                             f"{self.n_slots}-slot {grid} grid")
        self.net = net or NetworkConfig(bandwidth=gbps_to_bytes_per_s(96))
        self.base = base
        self.packet_bytes = packet_bytes or PACKET_BYTES
        self.snake = snake_order(
            HeteroPackage.uniform("standard", grid).build_topology(base))
        # stage s owns a contiguous run of snake positions; shallow
        # graphs get multi-slot stages (first remainder stages one extra)
        self.n_stages = min(self.n_slots, len(self.layers))
        k, rem = divmod(self.n_slots, self.n_stages)
        starts = [0]
        for s in range(self.n_stages):
            starts.append(starts[-1] + k + (s < rem))
        self.stage_pos: Tuple[Tuple[int, ...], ...] = tuple(
            tuple(range(starts[s], starts[s + 1]))
            for s in range(self.n_stages))
        self._memo: Dict[PlacementState, Tuple[float, float]] = {}

    # ------------------------------------------------------------------

    @property
    def evaluations(self) -> int:
        return len(self._memo)

    def package(self, order: Sequence[int]) -> HeteroPackage:
        """Slots along the snake: snake position j gets specs[order[j]]."""
        slots = [None] * self.n_slots
        for j, k in enumerate(order):
            slots[self.snake[j]] = self.specs[k]
        return HeteroPackage(self.grid, tuple(slots))

    def stage_rates(self, order: Sequence[int]) -> List[float]:
        """Aggregate compute rate of each stage's slot group."""
        return [sum(self.specs[order[j]].tops for j in pos)
                for pos in self.stage_pos]

    def mapping(self, state: PlacementState) -> Mapping:
        """Stage s -> its snake slot group, rate-proportional shares."""
        chiplets, shares = [], []
        for s in state.stage_of:
            pos = self.stage_pos[s]
            chips = tuple(self.snake[j] for j in pos)
            r = np.array([self.specs[state.order[j]].tops for j in pos])
            chiplets.append(chips)
            shares.append(np.full(len(pos), 1.0 / len(pos))
                          if np.all(r == r[0]) else r / r.sum())
        return Mapping(chiplets, shares, spill_window=6)

    def evaluate(self, state: PlacementState) -> Tuple[float, float]:
        """(wired makespan, DSE-best hybrid makespan) of a joint state."""
        if state in self._memo:
            return self._memo[state]
        # one phase per *distinct* evaluation: the profiler's call count
        # on "arch.evaluate" is the annealer's true evaluation count
        with obs_profile.phase("arch.evaluate"):
            topo = self.package(state.order).build_topology(self.base)
            trace = build_trace(self.layers, self.mapping(state),
                                topo, self.packet_bytes, device=self.device)
            t_wired = simulate_wired(trace).total_time
            t_hybrid = t_wired / grid_best_speedup(trace, self.net)
        self._memo[state] = (t_wired, t_hybrid)
        return t_wired, t_hybrid

    def cost(self, state: PlacementState, objective: str) -> float:
        if objective not in OBJECTIVES:
            raise ValueError(f"objective must be one of {OBJECTIVES}")
        t_wired, t_hybrid = self.evaluate(state)
        return t_wired if objective == "wired" else t_hybrid

    def result(self, state: PlacementState, objective: str,
               method: str,
               provenance: Optional[dict] = None) -> PlacementResult:
        t_wired, t_hybrid = self.evaluate(state)
        return PlacementResult(
            state=state,
            slot_names=tuple(self.specs[k].name for k in state.order),
            t_wired=t_wired, t_hybrid=t_hybrid,
            objective=objective, method=method,
            evaluations=self.evaluations,
            provenance=provenance)

    def provenance_config(self, objective: str, **extra) -> dict:
        """The hashed search configuration of this problem instance."""
        return {"workload": self.workload, "mix": self.mix,
                "grid": self.grid, "objective": objective,
                "net": self.net, "packet_bytes": self.packet_bytes,
                **extra}


# ----------------------------------------------------------------------
# segmentation + seeds
# ----------------------------------------------------------------------

def balanced_stages(macs: Sequence[float],
                    rates: Sequence[float]) -> List[int]:
    """Contiguous layer->stage split targeting rate-proportional MACs.

    Stage ``s`` closes once the running MAC total reaches the cumulative
    rate share of stages ``0..s``; every stage keeps at least one layer
    (the tail guard force-advances when the remaining stages would
    starve).  Deterministic, used as the seed and re-used by the greedy
    matcher after specs are placed.
    """
    L, n = len(macs), len(rates)
    if L < n:
        raise ValueError(f"{L} layers cannot fill {n} non-empty stages")
    total = float(sum(macs)) or 1.0
    cum = np.cumsum(np.asarray(rates, float))
    cum /= cum[-1]
    stage_of: List[int] = []
    stage, acc, in_stage = 0, 0.0, 0
    for i, m in enumerate(macs):
        starving = (L - i) <= (n - 1 - stage)
        if in_stage > 0 and stage < n - 1 and (
                starving or acc >= total * cum[stage]):
            stage += 1
            in_stage = 0
        stage_of.append(stage)
        in_stage += 1
        acc += float(m)
    return stage_of


def greedy_seed(problem: PlacementProblem) -> PlacementState:
    """Compute-balanced deterministic seed (largest job, fastest machine).

    1. Segment layers into MAC-balanced stages (rate-blind).
    2. Give the heaviest stage the fastest chiplet, second-heaviest the
       second-fastest, ... (stable sorts, so ties break by index).
    3. Re-segment against the placed per-stage rates.
    """
    macs = [lyr.macs for lyr in problem.layers]
    s0 = balanced_stages(macs, np.ones(problem.n_stages))
    load = np.zeros(problem.n_stages)
    for i, s in enumerate(s0):
        load[s] += macs[i]
    by_load = np.argsort(-load, kind="stable")
    by_rate = np.argsort([-s.tops for s in problem.specs], kind="stable")
    order = np.empty(problem.n_slots, int)
    nxt = 0          # heaviest stage group takes the fastest specs
    for stage in by_load:
        for j in problem.stage_pos[stage]:
            order[j] = by_rate[nxt]
            nxt += 1
    order_t = tuple(int(k) for k in order)
    return PlacementState(
        order_t, tuple(balanced_stages(macs, problem.stage_rates(order_t))))


# ----------------------------------------------------------------------
# neighbourhood moves
# ----------------------------------------------------------------------

def _swap_moves(problem: PlacementProblem,
                state: PlacementState) -> List[PlacementState]:
    """All placements one slot-swap away (distinct specs only)."""
    out = []
    order = state.order
    for i in range(len(order)):
        for j in range(i + 1, len(order)):
            if problem.specs[order[i]] != problem.specs[order[j]]:
                new = list(order)
                new[i], new[j] = new[j], new[i]
                out.append(PlacementState(tuple(new), state.stage_of))
    return out


def _boundary_moves(problem: PlacementProblem,
                    state: PlacementState) -> List[PlacementState]:
    """All segmentations one boundary shift away (stages stay non-empty)."""
    out = []
    stage_of = list(state.stage_of)
    n = problem.n_stages
    sizes = np.bincount(stage_of, minlength=n)
    first = np.searchsorted(stage_of, np.arange(n))
    for s in range(1, n):
        if sizes[s - 1] > 1:        # grow stage s leftwards
            new = list(stage_of)
            new[first[s] - 1] = s
            out.append(PlacementState(state.order, tuple(new)))
        if sizes[s] > 1:            # shrink stage s from the left
            new = list(stage_of)
            new[first[s]] = s - 1
            out.append(PlacementState(state.order, tuple(new)))
    return out


def _random_state(problem: PlacementProblem,
                  rng: np.random.Generator) -> PlacementState:
    order = tuple(int(k) for k in rng.permutation(problem.n_slots))
    # random non-empty contiguous segmentation
    L, n = len(problem.layers), problem.n_stages
    cuts = rng.choice(L - 1, size=n - 1, replace=False) + 1
    cuts = np.sort(cuts)
    stage_of = np.searchsorted(cuts, np.arange(L), side="right")
    return PlacementState(order, tuple(int(s) for s in stage_of))


def _polish(problem: PlacementProblem, state: PlacementState,
            objective: str, max_rounds: int = 200) -> PlacementState:
    """Steepest-descent over the full single-move neighbourhood."""
    cur, cost = state, problem.cost(state, objective)
    for _ in range(max_rounds):
        moves = (_swap_moves(problem, cur)
                 + _boundary_moves(problem, cur))
        costs = [problem.cost(m, objective) for m in moves]
        if not costs or min(costs) >= cost:
            return cur
        best = int(np.argmin(costs))
        cur, cost = moves[best], costs[best]
    return cur


# ----------------------------------------------------------------------
# search engines
# ----------------------------------------------------------------------

def anneal(problem: PlacementProblem, objective: str = "hybrid",
           seed: int = 0, steps: int = 300, restarts: int = 2,
           t_start: float = 0.05, t_end: float = 1e-3) -> PlacementResult:
    """Seeded simulated annealing + steepest-descent polish.

    Restart 0 starts from the greedy seed; later restarts from random
    joint states.  Deterministic for a fixed seed — the RNG stream is
    the only source of randomness.
    """
    evals0 = problem.evaluations
    with DEFAULT_REGISTRY.span("arch.anneal", objective=objective) as t:
        best = _anneal_search(problem, objective, seed, steps, restarts,
                              t_start, t_end)
    prov = make_provenance(
        "arch.anneal",
        problem.provenance_config(objective, steps=steps,
                                  restarts=restarts),
        seed=seed, points=problem.evaluations - evals0,
        wall_s=t["seconds"])
    return problem.result(best, objective, "anneal", provenance=prov)


def _anneal_search(problem: PlacementProblem, objective: str, seed: int,
                   steps: int, restarts: int, t_start: float,
                   t_end: float) -> PlacementState:
    rng = np.random.default_rng(seed)
    best = greedy_seed(problem)
    best_cost = problem.cost(best, objective)
    scale = best_cost or 1.0
    decay = (t_end / t_start) ** (1.0 / max(1, steps - 1))
    for restart in range(max(1, restarts)):
        cur = best if restart == 0 else _random_state(problem, rng)
        cur_cost = problem.cost(cur, objective)
        if cur_cost < best_cost:
            best, best_cost = cur, cur_cost
        temp = t_start
        for _ in range(steps):
            moves = (_swap_moves(problem, cur) if rng.random() < 0.5
                     else _boundary_moves(problem, cur))
            if not moves:    # degenerate axis (uniform mix / 1-layer stages)
                moves = (_swap_moves(problem, cur)
                         + _boundary_moves(problem, cur))
            if not moves:
                break        # single-state space: the seed is the optimum
            cand = moves[int(rng.integers(len(moves)))]
            c = problem.cost(cand, objective)
            de = (c - cur_cost) / scale
            if de <= 0 or rng.random() < math.exp(-de / temp):
                cur, cur_cost = cand, c
                if cur_cost < best_cost:
                    best, best_cost = cur, cur_cost
            temp *= decay
    return _polish(problem, best, objective)


def exhaustive(problem: PlacementProblem, objective: str = "hybrid",
               max_evals: int = 200_000) -> PlacementResult:
    """Full joint enumeration — ground truth on <= 6-slot packages."""
    n, L = problem.n_slots, len(problem.layers)
    ns = problem.n_stages
    if n > 6:
        raise ValueError("exhaustive enumeration is for <= 6-slot "
                         f"packages (got {n}); use anneal()")
    evals0 = problem.evaluations
    with DEFAULT_REGISTRY.span("arch.exhaustive",
                               objective=objective) as t:
        best = _exhaustive_search(problem, objective, max_evals)
    prov = make_provenance(
        "arch.exhaustive", problem.provenance_config(objective),
        points=problem.evaluations - evals0, wall_s=t["seconds"])
    return problem.result(best, objective, "exhaustive", provenance=prov)


def _exhaustive_search(problem: PlacementProblem, objective: str,
                       max_evals: int) -> PlacementState:
    n, L = problem.n_slots, len(problem.layers)
    ns = problem.n_stages
    seen, orders = set(), []
    for perm in itertools.permutations(range(n)):
        key = tuple(problem.specs[k].name for k in perm)
        if key not in seen:
            seen.add(key)
            orders.append(perm)
    n_seg = math.comb(L - 1, ns - 1)
    if len(orders) * n_seg > max_evals:
        raise ValueError(f"joint space {len(orders)} x {n_seg} exceeds "
                         f"max_evals={max_evals}")
    best, best_cost = None, math.inf
    for order in orders:
        for cuts in itertools.combinations(range(1, L), ns - 1):
            stage_of = np.searchsorted(np.asarray(cuts), np.arange(L),
                                       side="right")
            state = PlacementState(tuple(order),
                                   tuple(int(s) for s in stage_of))
            c = problem.cost(state, objective)
            if c < best_cost:
                best, best_cost = state, c
    return best


# ----------------------------------------------------------------------
# co-design driver
# ----------------------------------------------------------------------

@dataclasses.dataclass
class CodesignResult:
    """One (workload, mix) co-design cell of the hetero sweep."""

    workload: str
    mix: str
    package: str                 # describe() of the hybrid-best package
    greedy: PlacementResult
    wired: PlacementResult       # annealed under the wired objective
    hybrid: PlacementResult      # annealed under the hybrid objective
    spread_wired: float          # worst/best wired makespan over the pool
    spread_hybrid: float         # worst/best hybrid makespan, same pool
    speedup_hybrid: float        # wireless gain at the co-designed placement
    speedup_codesigned: float    # best-wired-package vs best-hybrid-package
    n_evaluations: int
    provenance: Optional[dict] = dataclasses.field(
        default=None, compare=False)  # dse.provenance of the whole cell


def balanced_state(problem: PlacementProblem,
                   order: Sequence[int]) -> PlacementState:
    """A placement with its deterministic compute-balanced segmentation."""
    macs = [lyr.macs for lyr in problem.layers]
    order_t = tuple(int(k) for k in order)
    return PlacementState(
        order_t, tuple(balanced_stages(macs, problem.stage_rates(order_t))))


def placement_pool(problem: PlacementProblem, seed: int,
                   n_samples: int) -> List[PlacementState]:
    """Placement-sensitivity pool: ``n_samples`` seeded random slot
    permutations, each with its compute-balanced segmentation.

    Only the PLACEMENT varies; every pool member keeps a sensibly
    balanced layer split (any real mapper re-balances after a
    re-placement).  The best-vs-worst spread over this pool therefore
    isolates what placement alone costs — the communication-distance
    sensitivity the wireless plane is hypothesised to erase.
    """
    rng = np.random.default_rng(seed)
    return [balanced_state(problem, rng.permutation(problem.n_slots))
            for _ in range(n_samples)]


def codesign(workload: str | List[Layer], mix: str = "big_little",
             net: NetworkConfig | None = None,
             grid: Tuple[int, int] = (3, 3),
             base: AcceleratorConfig | None = None,
             seed: int = 0, steps: int = 300, restarts: int = 2,
             n_samples: int = 10, device=None) -> CodesignResult:
    """Search one (workload, mix) cell under both planes.

    The two annealed optima are cross-polished (each plane's winner is
    hill-climbed under the other objective), so the co-designed hybrid
    can never lose to the wired optimum through search noise.  The
    spread pool (greedy + both optima + `placement_pool` samples) is
    evaluated under BOTH planes, so the wired and hybrid spreads are
    measured over the same placements.  The evaluations run on
    ``device`` (the card when None; see `PlacementProblem`).
    """
    problem = PlacementProblem(workload, mix, grid, net, base,
                               device=device)
    with DEFAULT_REGISTRY.span("arch.codesign", mix=mix) as t:
        wired = anneal(problem, "wired", seed=seed, steps=steps,
                       restarts=restarts)
        hybrid = anneal(problem, "hybrid", seed=seed, steps=steps,
                        restarts=restarts)
        cross_h = _polish(problem, wired.state, "hybrid")
        if problem.cost(cross_h, "hybrid") < hybrid.makespan:
            hybrid = problem.result(cross_h, "hybrid", "anneal+cross")
        cross_w = _polish(problem, hybrid.state, "wired")
        if problem.cost(cross_w, "wired") < wired.makespan:
            wired = problem.result(cross_w, "wired", "anneal+cross")
        pool = [greedy_seed(problem), wired.state, hybrid.state]
        pool += placement_pool(problem, seed + 1, n_samples)
        evals = np.array([problem.evaluate(s) for s in pool])
        t_w, t_h = evals[:, 0], evals[:, 1]
    return CodesignResult(
        workload=problem.workload, mix=problem.mix,
        package=problem.package(hybrid.state.order).describe(),
        greedy=problem.result(pool[0], "hybrid", "greedy"),
        wired=wired, hybrid=hybrid,
        spread_wired=float(t_w.max() / t_w.min()),
        spread_hybrid=float(t_h.max() / t_h.min()),
        speedup_hybrid=hybrid.hybrid_speedup,
        speedup_codesigned=wired.t_wired / hybrid.t_hybrid,
        n_evaluations=problem.evaluations,
        provenance=make_provenance(
            "arch.codesign",
            problem.provenance_config("both", steps=steps,
                                      restarts=restarts,
                                      n_samples=n_samples),
            seed=seed, points=problem.evaluations,
            wall_s=t["seconds"]))
