"""Trace-driven what-if projection: replay a recorded run under scaled
resources without re-simulating.

A recorded `SimTrace` (PacketSim with ``record=True``) carries, per
layer, everything the GEMINI layer-max needs: the analytic compute /
NoC / DRAM floors as coarse spans, and every network transmission as a
per-server event with its bytes, source and hop span.  Projecting a
resource change is then a *re-aggregation*, not a re-simulation:

- **wireless bandwidth x k** — every wireless service time shrinks by
  ``1/k``; exact for the ideal MAC (service = bytes / channel rate).
- **channel count / zoning / policy** — each transmission is
  re-bucketed onto the server the new `ChannelPlan` would give its
  source (``src``/``hops`` args recorded for exactly this), and the
  per-layer wireless term is re-assembled as the planned costing does:
  ``max_c (t_global(c) + max_z t_zone(c, z))``.
- **DRAM / wired scaling** — the aggregate DRAM term and the per-server
  wired backlogs scale inversely with bandwidth.
- **xy -> striped link model** — per-link backlogs fold onto their cut
  (`cut_of_link` metadata) at the cut's parallel-link count; the
  reverse projection is impossible (striping erased the per-link
  assignment) and raises.

The projection is a *model of the model*: FIFO order and the paper's
eligibility/injection decisions are frozen at record time, and
non-ideal MAC overheads scale proportionally rather than being
re-quantised.  `validate` closes the loop — it re-simulates the same
knob with a real `PacketSim` and reports the projection error (within
10% for ±25% bandwidth perturbations on every paper workload,
tests/test_torch_critpath.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.net.channel import ChannelPlan

from .trace import SimTrace

#: layer-term order, matching `repro_torch.core.simulator.BOTTLENECKS`
TERMS = ("compute", "dram", "noc", "nop", "wireless")


@dataclasses.dataclass(frozen=True)
class WhatIf:
    """One projection knob set (identity by default).

    ``wireless_scale`` multiplies the aggregate wireless bandwidth;
    ``n_channels`` / ``reuse_zones`` / ``channel_policy`` re-bucket the
    recorded transmissions under a new `ChannelPlan` (None keeps the
    recorded plan); ``dram_scale`` / ``wired_scale`` multiply those
    planes' bandwidths; ``link_model="striped"`` re-projects an ``xy``
    trace onto the idealized striped wired plane.
    """

    wireless_scale: float = 1.0
    n_channels: Optional[int] = None
    reuse_zones: Optional[int] = None
    channel_policy: Optional[str] = None
    dram_scale: float = 1.0
    wired_scale: float = 1.0
    link_model: Optional[str] = None

    def describe(self) -> str:
        parts = []
        if self.wireless_scale != 1.0:
            parts.append(f"wl x{self.wireless_scale:g}")
        if self.n_channels is not None:
            parts.append(f"{self.n_channels}ch")
        if self.reuse_zones is not None:
            parts.append(f"x{self.reuse_zones}reuse")
        if self.channel_policy is not None:
            parts.append(self.channel_policy)
        if self.dram_scale != 1.0:
            parts.append(f"dram x{self.dram_scale:g}")
        if self.wired_scale != 1.0:
            parts.append(f"wired x{self.wired_scale:g}")
        if self.link_model is not None:
            parts.append(f"->{self.link_model}")
        return " ".join(parts) or "identity"


@dataclasses.dataclass
class Projection:
    """Projected outcome of one `WhatIf` replay."""

    knobs: WhatIf
    total_time: float
    layer_times: np.ndarray
    base_time: float
    bottleneck: List[str]

    @property
    def speedup(self) -> float:
        """Projected speedup over the recorded run (>1 = faster)."""
        return self.base_time / self.total_time if self.total_time else 1.0


def _layer_busy(st: SimTrace, cat: str, L: int) -> Dict[str, np.ndarray]:
    """track -> (L,) busy-seconds for one event category."""
    out: Dict[str, np.ndarray] = {}
    for ev in st.events:
        if ev.cat == cat and 0 <= ev.layer < L:
            out.setdefault(ev.track, np.zeros(L))[ev.layer] += ev.dur
    return out


def _coarse_terms(st: SimTrace, L: int) -> np.ndarray:
    """(3, L) compute / dram-agg / noc floors from the coarse spans."""
    out = np.zeros((3, L))
    rows = {"compute": 0, "dram-agg": 1, "noc": 2}
    for ev in st.events:
        row = rows.get(ev.cat)
        if row is not None and 0 <= ev.layer < L:
            out[row, ev.layer] += ev.dur
    return out


def _wired_term(st: SimTrace, knobs: WhatIf, L: int) -> np.ndarray:
    meta = st.meta
    busy = _layer_busy(st, "wired", L)
    remodel = (knobs.link_model is not None
               and knobs.link_model != meta.get("link_model"))
    if remodel:
        if knobs.link_model != "striped":
            raise ValueError(
                f"cannot project link model "
                f"{meta.get('link_model')!r} -> {knobs.link_model!r}: "
                "striping erased the per-link assignment; only "
                "xy/adaptive -> 'striped' is recoverable from a trace")
        cut_of_link = meta.get("cut_of_link")
        k_par = meta.get("k_par")
        if cut_of_link is None or k_par is None:
            raise ValueError("trace lacks cut_of_link/k_par metadata "
                             "needed to re-stripe the wired plane")
        folded: Dict[int, np.ndarray] = {}
        for track, b in busy.items():
            head = track.split("/", 1)[0]
            if head.startswith("link"):
                cut = int(cut_of_link[int(head[4:])])
            elif head.startswith("cut"):
                cut = int(head[3:])
            else:
                continue
            folded[cut] = folded.get(cut, np.zeros(L)) + b
        busy = {f"cut{c}": b / max(int(k_par[c]), 1)
                for c, b in folded.items()}
    if not busy:
        return np.zeros(L)
    return np.max(np.stack(list(busy.values())), axis=0) \
        / knobs.wired_scale


def _wireless_term(st: SimTrace, knobs: WhatIf, L: int) -> np.ndarray:
    meta = st.meta
    evs = [ev for ev in st.events
           if ev.cat == "wireless" and 0 <= ev.layer < L]
    if not evs:
        return np.zeros(L)
    rebucket = (knobs.n_channels is not None
                or knobs.reuse_zones is not None
                or knobs.channel_policy is not None)
    if not rebucket:
        # same plan, scaled rates: per-server busy shrinks uniformly,
        # reassembled as max_c (global + max_z zone)
        g: Dict[int, np.ndarray] = {}
        z: Dict[str, np.ndarray] = {}
        for ev in evs:
            head = ev.track.split("/", 1)[0]
            if ev.track.endswith("/g"):
                g.setdefault(int(head[2:]), np.zeros(L))[ev.layer] += ev.dur
            else:
                z.setdefault(ev.track, np.zeros(L))[ev.layer] += ev.dur
        per_ch: Dict[int, np.ndarray] = {}
        for track, b in z.items():
            c = int(track.split("/", 1)[0][2:])
            per_ch[c] = np.maximum(per_ch.get(c, np.zeros(L)), b)
        t = np.zeros(L)
        for c in sorted(set(g) | set(per_ch)):
            t = np.maximum(t, g.get(c, np.zeros(L))
                           + per_ch.get(c, np.zeros(L)))
        return t / knobs.wireless_scale
    # re-bucket each transmission under the new plan
    for key in ("n_nodes", "grid", "bandwidth", "n_channels",
                "reuse_zones", "channel_policy", "node_coords"):
        if key not in meta:
            raise ValueError(f"trace lacks {key!r} metadata needed to "
                             "re-bucket the wireless plane")
    old_plan = ChannelPlan(meta["n_channels"], meta["channel_policy"],
                           reuse_zones=meta["reuse_zones"])
    new_plan = ChannelPlan(
        knobs.n_channels if knobs.n_channels is not None
        else meta["n_channels"],
        knobs.channel_policy if knobs.channel_policy is not None
        else meta["channel_policy"],
        reuse_zones=knobs.reuse_zones if knobs.reuse_zones is not None
        else meta["reuse_zones"])
    bw = meta["bandwidth"]
    rate = (old_plan.channel_bandwidth(bw)
            / new_plan.channel_bandwidth(bw * knobs.wireless_scale))
    n_nodes, grid = meta["n_nodes"], tuple(meta["grid"])
    coords = np.asarray(meta["node_coords"], np.int64)
    ch_of = new_plan.assign(n_nodes).numpy()
    Z = new_plan.reuse_zones
    if Z > 1:
        zone_of, rd = new_plan.assign_spatial(grid, coords)
        zone_of = zone_of.numpy()
    else:
        zone_of, rd = np.zeros(n_nodes, np.int64), None
    C = new_plan.n_channels
    g = np.zeros((L, C))
    zb = np.zeros((L, C, Z))
    for ev in evs:
        src = ev.args.get("src")
        if src is None:
            raise ValueError("wireless event lacks the src arg needed "
                             "to re-bucket (trace predates deps?)")
        c = int(ch_of[src])
        dur = ev.dur * rate
        if Z > 1 and ev.args.get("hops", 0) > rd:
            g[ev.layer, c] += dur
        else:
            zb[ev.layer, c, int(zone_of[src]) if Z > 1 else 0] += dur
    return (g + zb.max(axis=2)).max(axis=1)


def project(st: SimTrace, knobs: WhatIf) -> Projection:
    """Replay the recorded layer terms under ``knobs``.

    A degenerate (empty) trace projects to a zero-time run rather than
    raising, matching the repo-wide empty-structure convention.
    """
    times = st.meta.get("layer_times") or []
    L = len(times)
    base = float(sum(times))
    if L == 0:
        return Projection(knobs, 0.0, np.zeros(0), base, [])
    coarse = _coarse_terms(st, L)
    stack = np.stack([coarse[0],
                      coarse[1] / knobs.dram_scale,
                      coarse[2],
                      _wired_term(st, knobs, L),
                      _wireless_term(st, knobs, L)])
    layer_times = stack.max(axis=0)
    which = stack.argmax(axis=0)
    return Projection(knobs, float(layer_times.sum()), layer_times, base,
                      [TERMS[i] for i in which])


def project_grid(st: SimTrace,
                 knob_sets: List[WhatIf]) -> List[Projection]:
    """One projection per knob set (ordering preserved)."""
    return [project(st, k) for k in knob_sets]


# ---------------------------------------------------------------------------
# validation harness: projection vs actual re-simulation
# ---------------------------------------------------------------------------

def apply_to_network(net, knobs: WhatIf):
    """The `NetworkConfig` a re-simulation of ``knobs`` should use.

    Only the wireless knobs map onto a network config; DRAM / wired
    scaling and link-model changes alter the *accelerator* geometry and
    are selected on the `PacketSim` itself (``link_model=``) or are not
    re-simulable from a config change — those raise here.
    """
    from repro_torch.net.config import as_network
    if knobs.dram_scale != 1.0 or knobs.wired_scale != 1.0:
        raise ValueError("dram/wired scaling changes the accelerator "
                         "config, not the network config; rebuild the "
                         "trace to validate those knobs")
    net = as_network(net)
    plan = net.channels
    new_plan = ChannelPlan(
        knobs.n_channels if knobs.n_channels is not None
        else plan.n_channels,
        knobs.channel_policy if knobs.channel_policy is not None
        else plan.policy,
        bandwidth_per_channel=plan.bandwidth_per_channel,
        reuse_zones=knobs.reuse_zones if knobs.reuse_zones is not None
        else plan.reuse_zones,
        reuse_distance=plan.reuse_distance)
    return dataclasses.replace(
        net, bandwidth=net.bandwidth * knobs.wireless_scale,
        channels=new_plan)


def validate(traffic, net, knobs: WhatIf, *, policy="static",
             link_model: str = "striped",
             dram_model: str = "pooled") -> Dict[str, float]:
    """Record a base run, project ``knobs``, re-simulate, compare (both
    simulations on ``traffic``'s device).

    Returns ``{"projected", "actual", "base", "error"}`` where
    ``error = |projected - actual| / actual``.  The re-simulation runs
    the SAME policy under the modified network, so for online policies
    the error includes genuine decision drift, not just model error.
    """
    from repro_torch.sim.engine import PacketSim
    base = PacketSim(traffic, net, link_model=link_model,
                     dram_model=dram_model, record=True).run(policy)
    proj = project(base.trace, knobs)
    actual = PacketSim(traffic, apply_to_network(net, knobs),
                       link_model=link_model,
                       dram_model=dram_model).run(policy)
    err = (abs(proj.total_time - actual.total_time) / actual.total_time
           if actual.total_time else 0.0)
    return {"projected": proj.total_time, "actual": actual.total_time,
            "base": base.total_time, "error": err}
