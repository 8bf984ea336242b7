"""Wired/wireless load-balancing policies for the event-driven engine.

The paper's evaluation fixes ONE (distance threshold x injection
probability) filter for a whole run and names "load balancing between
the wired and wireless interconnects" as the open problem.  This module
makes that problem runnable.  A policy answers one question — *which
plane does this packet take?* — at one of three information levels:

- `StaticPolicy` — the paper's SIII-B2 decision function: eligibility
  (multicast / distance threshold) gated by an injection probability.
  No state; the whole trace's assignment is known up front.
- `OraclePolicy` — the offline water-filling balancer
  (`repro_torch.core.balancer.balance`) replayed packet-for-packet: the
  hindsight reference a causal policy is measured against.
- `GreedyPolicy` — *dynamic, per packet*: at injection time, join the
  plane that delivers this packet earliest given the instantaneous
  queue backlog (wired: its route's most-backlogged resource;
  wireless: its channel's next-free time plus MAC cost).  Pure local
  state, no lookahead.
- `AdaptivePolicy` — *dynamic, per layer*: at each layer boundary the
  runtime inspects the injection queues (the layer's enqueued packets
  and their routes) and re-tunes the filter for that layer, choosing
  among the paper's (threshold x injection) settings and a greedy
  backlog-balanced split — whichever the queue contents project
  fastest.  Since the projection is exact for static per-layer sets,
  its total is ``sum_l min_c t_l(c) <= min_c sum_l t_l(c)``: it
  provably matches or beats EVERY fixed grid point of the paper's
  sweep, on every workload.
- `OnlineReshardPolicy` — the traffic half of `repro_torch.fault`'s
  online-reshard controller: the adaptive candidate pool plus the
  deployed static filter and the fault-aware water-filling balancer,
  stitched under the engine's (degraded) projections — never slower
  than static or adaptive under any injected failure set.
- `FixedPolicy` — replay an explicit per-packet mask (golden tests,
  external schedules).

Masks are bool tensors on the simulator's trace's device; the adaptive
stitch runs there (no host sync a candidate), the greedy candidate's
online run on the host (`engine.PacketSim._run_online`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.wireless import injection_hash
from repro_torch.net.batched import PAPER_INJECTIONS, PAPER_THRESHOLDS


class Policy:
    """Base: either plan the whole trace, or decide per packet."""

    name = "base"

    def plan_trace(self, sim) -> Optional[torch.Tensor]:
        """Full per-packet injection mask, or None for online deciding."""
        return None

    def decide(self, sim, layer: int, pkt: int, wired_finish: float,
               wireless_finish: float, floor: float) -> bool:
        """Online choice for one eligible packet at injection time."""
        raise NotImplementedError


class FixedPolicy(Policy):
    """Replay an explicit injection mask."""

    name = "fixed"

    def __init__(self, mask):
        self.mask = (mask.to(torch.bool) if isinstance(mask, torch.Tensor)
                     else torch.from_numpy(np.asarray(mask, bool)))

    def plan_trace(self, sim) -> torch.Tensor:
        return self.mask.to(sim.trace.device)


class StaticPolicy(Policy):
    """The paper's decision function at the net's (threshold, p)."""

    name = "static"

    def plan_trace(self, sim) -> torch.Tensor:
        return sim.elig(sim.net.distance_threshold) & (
            injection_hash(len(sim.trace.nbytes), sim.trace.device)
            < sim.net.injection_prob)


class OraclePolicy(Policy):
    """Replay the offline water-filling balancer's injected set."""

    name = "oracle"

    def plan_trace(self, sim) -> torch.Tensor:
        from repro_torch.core.balancer import balance  # late: core, sim
        return balance(sim.trace, sim.net, faults=sim.faults).injected


class GreedyPolicy(Policy):
    """Join-shortest-plane: earliest delivery for THIS packet, now.

    Injecting never slows the run down: the packet's wireless finish is
    below its wired finish, which is itself at most the all-wired
    layer's final backlog — so every layer ends no later than wired
    (speedup >= 1 by construction, verified in tests).
    """

    name = "greedy"

    def decide(self, sim, layer, pkt, wired_finish, wireless_finish,
               floor) -> bool:
        return wireless_finish < wired_finish


class AdaptivePolicy(Policy):
    """Per-layer filter re-tuning from the injection-queue contents.

    Candidates per layer: the paper's (threshold x injection) grid at
    the configured network, plus the greedy backlog split.  The engine
    executes the stitched per-layer masks; for the batched link models
    the projection used to choose equals the executed time exactly.
    """

    name = "adaptive"

    def candidates(self, sim) -> list:
        """Per-layer candidate masks (subclasses extend the pool)."""
        hash_ = injection_hash(len(sim.trace.nbytes), sim.trace.device)
        cands = [sim.elig(t) & (hash_ < p)
                 for t in PAPER_THRESHOLDS for p in PAPER_INJECTIONS]
        cands.append(sim.run(GreedyPolicy()).injected)
        return cands

    def plan_trace(self, sim) -> torch.Tensor:
        tr = sim.trace
        best_t = torch.full((tr.n_layers,), torch.inf, dtype=torch.float64,
                            device=tr.device)
        best_mask = torch.zeros(len(tr.nbytes), dtype=torch.bool,
                                device=tr.device)
        for mask in self.candidates(sim):
            t = sim.layer_times(mask)
            # a candidate that wins no layer leaves both unchanged
            win = t < best_t - 1e-15
            best_t = torch.where(win, t, best_t)
            best_mask = torch.where(win[tr.layer], mask, best_mask)
        return best_mask


class OnlineReshardPolicy(AdaptivePolicy):
    """Traffic half of the online-reshard controller (`repro_torch.fault`).

    Extends the adaptive per-layer re-tune with two extra candidates:
    the network's own deployed static filter (so the stitched plan
    dominates `StaticPolicy` even when the configured (threshold, p)
    pair sits outside the paper grid), and the offline water-filling
    balancer re-run against the *surviving* topology (fault-aware
    `repro_torch.core.balancer.balance`).  The per-layer stitch uses the
    engine's fault-aware projections, which are exact for the batched
    link models, so the total is <= every candidate's total under any
    injected failure set — the property test's guarantee.  The
    *placement* half (Heartbeat/ElasticPlan-gated trace rebuild on the
    survivors) lives in `repro_torch.fault.resilience.reshard_run`, which
    min-anchors against this policy's no-reshard projection.
    """

    name = "online-reshard"

    def candidates(self, sim) -> list:
        from repro_torch.core.balancer import balance  # late: core
        return super().candidates(sim) + [
            StaticPolicy().plan_trace(sim),
            balance(sim.trace, sim.net, faults=sim.faults).injected]


POLICIES = {cls.name: cls for cls in
            (StaticPolicy, OraclePolicy, GreedyPolicy, AdaptivePolicy,
             OnlineReshardPolicy)}


def get_policy(policy) -> Policy:
    """Resolve a policy name or pass an instance through."""
    if isinstance(policy, Policy):
        return policy
    if policy in POLICIES:
        return POLICIES[policy]()
    raise ValueError(f"unknown policy {policy!r}; "
                     f"pick one of {sorted(POLICIES)} or pass an instance")
