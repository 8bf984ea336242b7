"""The paper's technique at LM scale: hybrid plane scheduling for the
collectives of one sharded training or serving step.

A copy of the JAX package's `core/hybrid_schedule.py` for the port, fed
the port's dry-run counts (`launch/dryrun.py`): per (arch x shape x mesh)
cell, the payload bytes of each kind of collective the step issues on a
rank.  The wired plane is the NVLink fabric (`launch/roofline.py`); the
second, broadcast-natured plane is a shared-medium overlay with
single-hop semantics (in-package wireless on future parts).  This module

1. classifies each collective as *multicast-shaped* (all-gather,
   all-to-all's broadcast half, collective-permute fan-outs) or
   *reduction-shaped* (all-reduce, reduce-scatter),
2. applies the paper's decision function: multicast => eligible; ring
   radius (the analogue of NoP hop distance) over threshold => eligible;
   injection probability caps the steered fraction,
3. costs both planes:   wired: ring schedule over the NVLink links,
                        overlay: volume / shared broadcast bandwidth
   and reports the collective-term speedup plus the end-to-end effect on
   the cell's roofline step time,
4. `balance_cell` water-fills volume between the planes (closed-form,
   because both plane costs are linear in volume).

The overlay's bandwidth is the paper's assumed wireless plane, not a
measurement of any part.  The reference sets it to 100 GB/s, half its
wired plane's 200 GB/s (4 ICI links of 50 GB/s); the port keeps that
ratio to its own wired plane, 0.5 x 18 x 25 GB/s = 225 GB/s, so that the
decision function sees the same balance of the two planes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from ..launch.roofline import NVLINK_BW, NVLINK_LINKS

# B/s shared broadcast plane, per pod: half the wired plane, as in the
# reference
OVERLAY_BW = 0.5 * NVLINK_LINKS * NVLINK_BW
MULTICAST_OPS = ("all-gather", "all-gather-start", "all-to-all",
                 "collective-permute", "collective-permute-start")
REDUCTION_OPS = ("all-reduce", "all-reduce-start", "reduce-scatter")


@dataclasses.dataclass(frozen=True)
class PlaneConfig:
    overlay_bw: float = OVERLAY_BW
    distance_threshold: int = 1       # ring-radius hops
    injection_prob: float = 0.5
    ring_radius: int = 8              # 16-wide mesh axis => radius 8


@dataclasses.dataclass
class CollectiveFlow:
    op: str
    payload_bytes: float              # per device, per step
    multicast: bool
    hops: int

    @property
    def wired_link_bytes(self) -> float:
        # ring transfer factor (2x for AR: reduce + broadcast phases)
        f = 2.0 if self.op.startswith("all-reduce") else 1.0
        return self.payload_bytes * f


def flows_from_coll_per_op(coll_per_op: Dict[str, float],
                           ring_radius: int = 8) -> List[CollectiveFlow]:
    out = []
    for op, payload in coll_per_op.items():
        mc = op in MULTICAST_OPS
        out.append(CollectiveFlow(op, float(payload), mc, ring_radius))
    return out


def eligible_volume(flows: List[CollectiveFlow],
                    pcfg: PlaneConfig) -> float:
    """Paper decision criteria 1+2 at LM scale: multicast-shaped, or
    spanning more ring hops than the threshold.  All-reduce contributes
    its broadcast (all-gather) HALF when eligible by distance."""
    v = 0.0
    for f in flows:
        if f.multicast and f.hops >= pcfg.distance_threshold:
            v += f.payload_bytes
        elif not f.multicast and f.hops > pcfg.distance_threshold:
            v += 0.5 * f.wired_link_bytes     # the AG half of the AR ring
    return v


def wired_time(flows: List[CollectiveFlow], offloaded: float = 0.0) -> float:
    total = sum(f.wired_link_bytes for f in flows)
    return max(0.0, total - offloaded) / (NVLINK_LINKS * NVLINK_BW)


def overlay_time(volume: float, pcfg: PlaneConfig) -> float:
    return volume / pcfg.overlay_bw


@dataclasses.dataclass
class CellSchedule:
    t_coll_wired: float
    t_coll_hybrid: float
    offloaded_bytes: float
    injected_fraction: float
    coll_speedup: float
    step_speedup: float


def schedule_cell(coll_per_op: Dict[str, float], t_compute: float,
                  t_memory: float, pcfg: PlaneConfig) -> CellSchedule:
    """Paper decision function with fixed (threshold, injection)."""
    flows = flows_from_coll_per_op(coll_per_op, pcfg.ring_radius)
    elig = eligible_volume(flows, pcfg)
    off = elig * pcfg.injection_prob
    t_wired = wired_time(flows)
    t_hybrid = max(wired_time(flows, off), overlay_time(off, pcfg))
    base_step = max(t_compute, t_memory, t_wired)
    new_step = max(t_compute, t_memory, t_hybrid)
    return CellSchedule(
        t_coll_wired=t_wired, t_coll_hybrid=t_hybrid, offloaded_bytes=off,
        injected_fraction=pcfg.injection_prob,
        coll_speedup=t_wired / t_hybrid if t_hybrid else 1.0,
        step_speedup=base_step / new_step if new_step else 1.0)


def sweep_cell(coll_per_op: Dict[str, float], t_compute: float,
               t_memory: float,
               overlay_bw: float = OVERLAY_BW
               ) -> Tuple[CellSchedule, Tuple[int, float]]:
    """The paper's (threshold x injection) sweep on one LM cell."""
    best, best_cfg = None, (1, 0.1)
    for thr in (1, 2, 4, 8):
        for p in [0.1 + 0.05 * i for i in range(15)]:
            pcfg = PlaneConfig(overlay_bw, thr, round(p, 2))
            s = schedule_cell(coll_per_op, t_compute, t_memory, pcfg)
            if best is None or s.step_speedup > best.step_speedup:
                best, best_cfg = s, (thr, round(p, 2))
    return best, best_cfg


def balance_cell(coll_per_op: Dict[str, float], t_compute: float,
                 t_memory: float,
                 overlay_bw: float = OVERLAY_BW) -> CellSchedule:
    """Beyond-paper water-filling: both plane costs are linear in the
    offloaded volume v, so the balance point is closed-form:

        (L - v) / B_wired = v / B_wl  =>  v* = L * B_wl / (B_wired + B_wl)

    clipped to the eligible volume and to the point where compute/memory
    dominates anyway (no benefit past the roofline floor)."""
    pcfg = PlaneConfig(overlay_bw, 1, 1.0)
    flows = flows_from_coll_per_op(coll_per_op, pcfg.ring_radius)
    L = sum(f.wired_link_bytes for f in flows)
    elig = eligible_volume(flows, pcfg)
    b_wired = NVLINK_LINKS * NVLINK_BW
    v_star = L * overlay_bw / (b_wired + overlay_bw)
    v = min(v_star, elig)
    t_wired = wired_time(flows)
    t_hybrid = max(wired_time(flows, v), overlay_time(v, pcfg))
    base_step = max(t_compute, t_memory, t_wired)
    new_step = max(t_compute, t_memory, t_hybrid)
    return CellSchedule(
        t_coll_wired=t_wired, t_coll_hybrid=t_hybrid, offloaded_bytes=v,
        injected_fraction=v / elig if elig else 0.0,
        coll_speedup=t_wired / t_hybrid if t_hybrid else 1.0,
        step_speedup=base_step / new_step if new_step else 1.0)
