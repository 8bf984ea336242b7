"""The port's LM-scale hybrid plane schedule
(`repro_torch.core.hybrid_schedule`) against the JAX package's.

- On the same `coll_per_op` and times, with the wired plane's constants
  set equal to the reference's ICI ones and the overlay at the
  reference's 100 GB/s, every schedule equals the reference's exactly.
- The reference's properties (`tests/test_hybrid_schedule.py`) hold on
  the port's own constants: the paper's decision function, the overlay's
  saturation, the balancer's optimality.
"""

import dataclasses

import pytest
try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # offline container: deterministic smoke-subset fallback
    from _hypothesis_fallback import given, settings, strategies as st

import repro.core.hybrid_schedule as JHS
from repro.launch.roofline import ICI_BW, ICI_LINKS
from repro_torch.core import hybrid_schedule as HS
from repro_torch.launch.roofline import NVLINK_BW, NVLINK_LINKS

COLL = {"all-gather": 4e9, "all-reduce": 8e9, "reduce-scatter": 2e9,
        "all-to-all": 3e9}
CELLS = [COLL, {"all-gather": 1e6}, {"all-reduce": 5e10},
         {"all-gather": 7.5e8, "reduce-scatter": 2.5e8, "all-reduce": 3e7,
          "all-to-all": 1e9, "collective-permute": 4e6}]
TIMES = [(0.0, 0.0), (1e-3, 1e-3), (1e-4, 2e-2), (10.0, 0.0)]


def test_overlay_is_half_the_wired_plane_as_in_the_reference():
    assert HS.OVERLAY_BW == 0.5 * NVLINK_LINKS * NVLINK_BW
    assert JHS.OVERLAY_BW == 0.5 * ICI_LINKS * ICI_BW


@pytest.mark.parametrize("coll", CELLS)
@pytest.mark.parametrize("times", TIMES)
def test_schedules_equal_the_reference_under_equal_constants(
        coll, times, monkeypatch):
    monkeypatch.setattr(HS, "NVLINK_BW", ICI_BW)
    monkeypatch.setattr(HS, "NVLINK_LINKS", ICI_LINKS)
    bw = JHS.OVERLAY_BW
    for thr, p in ((1, 0.5), (8, 0.1), (2, 1.0)):
        port = HS.schedule_cell(coll, *times, HS.PlaneConfig(bw, thr, p))
        ref = JHS.schedule_cell(coll, *times, JHS.PlaneConfig(bw, thr, p))
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    (ps, pcfg), (rs, rcfg) = (HS.sweep_cell(coll, *times, bw),
                              JHS.sweep_cell(coll, *times, bw))
    assert dataclasses.asdict(ps) == dataclasses.asdict(rs) and pcfg == rcfg
    assert dataclasses.asdict(HS.balance_cell(coll, *times, bw)) == \
        dataclasses.asdict(JHS.balance_cell(coll, *times, bw))
    flows = HS.flows_from_coll_per_op(coll, 4)
    assert [dataclasses.asdict(f) for f in flows] == [
        dataclasses.asdict(f) for f in JHS.flows_from_coll_per_op(coll, 4)]
    assert HS.wired_time(flows, 1e6) == JHS.wired_time(
        JHS.flows_from_coll_per_op(coll, 4), 1e6)


def test_multicast_classification():
    mc = {f.op: f.multicast for f in HS.flows_from_coll_per_op(COLL)}
    assert mc["all-gather"] and mc["all-to-all"]
    assert not mc["all-reduce"] and not mc["reduce-scatter"]


def test_offload_reduces_collective_time():
    s = HS.schedule_cell(COLL, t_compute=1e-3, t_memory=1e-3,
                         pcfg=HS.PlaneConfig(injection_prob=0.5))
    assert s.t_coll_hybrid < s.t_coll_wired and s.coll_speedup > 1.0


def test_overlay_saturates_at_high_injection():
    """The reference's Fig. 5 mirror, with the overlay at the same share
    of the wired plane (60 of 200 GB/s there)."""
    bw = 0.3 * NVLINK_LINKS * NVLINK_BW
    times = [HS.schedule_cell(COLL, 0.0, 0.0, HS.PlaneConfig(
        overlay_bw=bw, injection_prob=p)).t_coll_hybrid
        for p in (0.1, 0.4, 1.0)]
    assert times[1] < times[0]            # more helps at first
    assert times[-1] > times[-2]          # then the overlay saturates


def test_no_speedup_when_compute_bound():
    s = HS.schedule_cell(COLL, t_compute=10.0, t_memory=0.0,
                         pcfg=HS.PlaneConfig(injection_prob=0.5))
    assert s.step_speedup == pytest.approx(1.0)


@given(st.floats(1e6, 1e11), st.floats(1e6, 1e11), st.floats(1e6, 1e11))
@settings(max_examples=30, deadline=None)
def test_balancer_dominates_sweep(ag, ar, a2a):
    coll = {"all-gather": ag, "all-reduce": ar, "all-to-all": a2a}
    swept, _ = HS.sweep_cell(coll, 1e-4, 1e-4)
    bal = HS.balance_cell(coll, 1e-4, 1e-4)
    assert bal.step_speedup >= swept.step_speedup - 1e-9


@given(st.floats(1e6, 1e12))
@settings(max_examples=30, deadline=None)
def test_balancer_never_degrades(vol):
    bal = HS.balance_cell({"all-gather": vol}, 0.0, 0.0)
    assert bal.step_speedup >= 1.0 - 1e-12


def test_threshold_filters_eligibility():
    flows = HS.flows_from_coll_per_op(COLL, ring_radius=4)
    v_lo = HS.eligible_volume(flows, HS.PlaneConfig(distance_threshold=1,
                                                    ring_radius=4))
    v_hi = HS.eligible_volume(flows, HS.PlaneConfig(distance_threshold=8,
                                                    ring_radius=4))
    assert v_lo > v_hi
