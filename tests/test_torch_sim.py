"""The port's event-driven plane (`repro_torch.sim`) against the JAX
package's (`repro.sim`), on the CPU.

The same traces, built from the same graphs (or by hand, for the golden
trace of `tests/test_sim.py`), go through both packages' simulators.
Integer arrays and injected masks must be equal; floats are held to
rtol 1e-12 (the port sums in the reference's order on the CPU; its
bin sums add zeros where the reference drops an entry, which is exact).
Bottleneck labels must be equal too: no tie has differed on the CPU.
"""

import numpy as np
import pytest
import torch

import repro.core as R
from repro.core.dse import policy_sweep_all as ref_policy_sweep_all
from repro.core.dse import scaled_config as ref_scaled_config
from repro.net import mac as RMAC
from repro.sim import FixedPolicy as RFixed
from repro.sim import PacketSim as RSim
from repro.sim import calendar as RCAL
from repro.sim import fidelity_report as ref_fidelity
from repro.sim import policy_report as ref_policy_report
from repro_torch import core as P
from repro_torch.core.dse import policy_sweep_all, scaled_config
from repro_torch.net import mac as PMAC
from repro_torch.sim import (EventResult, FixedPolicy, PacketSim,
                             fidelity_report, get_policy, policy_report)
from repro_torch.sim import calendar as PCAL

from _torch_event import NET96, RTOL, assert_same_event, close, golden_pair

POLICIES = ("static", "greedy", "adaptive", "oracle", "online-reshard")
WORKLOADS3 = ("resnet50", "zfnet", "transformer")


@pytest.fixture(scope="module")
def traces():
    return {w: (R.make_trace(w), P.make_trace(w, device="cpu"))
            for w in WORKLOADS3}


# ---------------------------------------------------------------------------
# calendar primitives and the per-packet MAC
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_segment_cumsum_and_first_occurrence_match_the_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 400))
    seg = np.sort(rng.integers(0, 12, n))
    vals = rng.random(n) * 1e-3
    got = PCAL.segment_cumsum(torch.from_numpy(vals), torch.from_numpy(seg))
    np.testing.assert_allclose(got.numpy(), RCAL.segment_cumsum(vals, seg),
                               rtol=RTOL, atol=0)
    keys = rng.integers(0, 30, n)
    flags = PCAL.first_occurrence(torch.from_numpy(keys))
    np.testing.assert_array_equal(flags.numpy(), RCAL.first_occurrence(keys))
    # integer values count exactly, in int64
    counts = PCAL.segment_cumsum(flags, torch.from_numpy(seg))
    assert counts.dtype == torch.int64
    np.testing.assert_array_equal(
        counts.numpy(), RCAL.segment_cumsum(flags.numpy(), seg))
    empty = torch.zeros(0, dtype=torch.int64)
    assert PCAL.segment_cumsum(empty, empty).numel() == 0
    assert PCAL.first_occurrence(empty).numel() == 0


@pytest.mark.parametrize("proto", ("ideal", "tdma", "token"))
def test_per_packet_mac_matches_the_reference_in_both_forms(proto):
    """The tensor form against the reference's NumPy, and the host-float
    form (the online loop's) against the tensor form, bit for bit."""
    rng = np.random.default_rng(1)
    nb = np.concatenate([rng.random(40) * 3e5, [65536.0, 131072.0, 1.0]])
    active = rng.integers(1, 7, len(nb))
    rmac, pmac = RMAC.MacConfig(proto), PMAC.MacConfig(proto)
    for bw in (12e9, rng.random(len(nb)) * 1e10 + 1e9):
        pbw = bw if np.isscalar(bw) else torch.from_numpy(bw)
        got = PMAC.mac_packet_times(pmac, torch.from_numpy(nb),
                                    torch.from_numpy(active), pbw)
        np.testing.assert_array_equal(
            got.numpy(), RMAC.mac_packet_times(rmac, nb, active, bw))
        host = [PMAC.mac_packet_time_host(
            pmac, v, int(a), bw if np.isscalar(bw) else bw[i])
            for i, (v, a) in enumerate(zip(nb, active))]
        np.testing.assert_array_equal(np.array(host), got.numpy())
    extra = PMAC.mac_packet_extra_bytes(pmac, torch.from_numpy(nb),
                                        torch.from_numpy(active))
    np.testing.assert_array_equal(
        extra.numpy(), RMAC.mac_packet_extra_bytes(rmac, nb, active))
    np.testing.assert_array_equal(
        np.array([PMAC.mac_packet_extra_host(pmac, v, int(a))
                  for v, a in zip(nb, active)]), extra.numpy())


# ---------------------------------------------------------------------------
# the golden trace of tests/test_sim.py, built in both packages
# ---------------------------------------------------------------------------

def test_golden_wired_and_fixed_injection():
    ref, port = golden_pair()
    rsim, psim = RSim(ref, NET96[0]), PacketSim(port, NET96[1])
    res = psim.run_wired()
    assert_same_event(rsim.run_wired(), res, "wired")
    assert res.total_time == pytest.approx(2e-3)      # the hand numbers
    assert res.bottleneck == ["nop"]
    res = psim.run(FixedPolicy([False, True, False]))
    assert_same_event(rsim.run(RFixed([False, True, False])), res, "fixed")
    assert res.total_time == pytest.approx(1e-3)
    assert res.bottleneck == ["compute"]
    np.testing.assert_allclose(res.channel_busy.numpy(), [4e6 / (96e9 / 8)])
    # a tensor mask replays the same
    again = psim.run(FixedPolicy(torch.tensor([False, True, False])))
    assert again.total_time == res.total_time


def test_golden_greedy_event_by_event_and_adaptive():
    ref, port = golden_pair()
    rsim, psim = RSim(ref, NET96[0]), PacketSim(port, NET96[1])
    res = psim.run("greedy")
    assert_same_event(rsim.run("greedy"), res, "greedy")
    assert res.injected.tolist() == [True, True, False]
    np.testing.assert_allclose(res.cut_busy.numpy(), [0.0, 0.5e-3])
    res = psim.run("adaptive")
    assert_same_event(rsim.run("adaptive"), res, "adaptive")
    assert res.total_time == pytest.approx(1e-3)


# ---------------------------------------------------------------------------
# every link model x DRAM model x policy on three paper traces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dram_model", ("pooled", "ports"))
@pytest.mark.parametrize("link_model", ("striped", "adaptive", "xy"))
@pytest.mark.parametrize("wl", WORKLOADS3)
def test_packet_sim_matches_the_reference(traces, wl, link_model,
                                          dram_model):
    ref, port = traces[wl]
    rsim = RSim(ref, NET96[0], link_model=link_model, dram_model=dram_model)
    psim = PacketSim(port, NET96[1], link_model=link_model,
                     dram_model=dram_model)
    what = f"{wl} {link_model} {dram_model}"
    assert_same_event(rsim.run_wired(), psim.run_wired(), what + " wired")
    for p in POLICIES:
        got = psim.run(p)
        assert isinstance(got, EventResult)
        assert_same_event(rsim.run(p), got, f"{what} {p}")
    assert close(psim.speedup("greedy"), rsim.speedup("greedy"))


def test_tdma_on_two_channels_matches_the_reference(traces):
    ref, port = traces["zfnet"]
    rnet = R.NetworkConfig(96e9 / 8, mac=R.MacConfig("tdma"),
                           channels=R.ChannelPlan(2, "interleaved"))
    pnet = P.NetworkConfig(96e9 / 8, mac=P.MacConfig("tdma"),
                           channels=P.ChannelPlan(2, "interleaved"))
    rsim, psim = RSim(ref, rnet), PacketSim(port, pnet)
    for p in ("static", "greedy", "adaptive"):
        assert_same_event(rsim.run(p), psim.run(p), f"tdma 2ch {p}")


def test_token_under_spatial_reuse_matches_the_reference():
    """The token MAC's active-station counts and the quiescing global
    class under a 4-zone plan on the 4x4 package."""
    ref = R.make_trace("zfnet", ref_scaled_config((4, 4)))
    port = P.make_trace("zfnet", scaled_config((4, 4)), device="cpu")
    plan = dict(n_channels=1, reuse_zones=4)
    rnet = R.NetworkConfig(96e9 / 8, mac=R.MacConfig("token"),
                           channels=R.ChannelPlan(**plan))
    pnet = P.NetworkConfig(96e9 / 8, mac=P.MacConfig("token"),
                           channels=P.ChannelPlan(**plan))
    rsim, psim = RSim(ref, rnet), PacketSim(port, pnet)
    np.testing.assert_array_equal(psim.pkt_zc.numpy(), rsim.pkt_zc)
    assert (psim.pkt_zc == psim.n_zones).any()      # a global class
    assert (psim.pkt_zc < psim.n_zones).any()       # and zone-local ones
    for p in ("static", "greedy", "adaptive"):
        assert_same_event(rsim.run(p), psim.run(p), f"token x4 {p}")
    assert_same_event(rsim.run_wired(), psim.run_wired(), "token x4 wired")


# ---------------------------------------------------------------------------
# the sweeps and reports, and the entry points' contracts
# ---------------------------------------------------------------------------

def test_policy_sweep_fidelity_and_policy_reports_match(traces):
    refs = {w: t[0] for w, t in traces.items()}
    ports = {w: t[1] for w, t in traces.items()}
    got = policy_sweep_all(ports)
    for g, w in zip(got, ref_policy_sweep_all(refs), strict=True):
        assert g.workload == w.workload
        assert {k: v for k, v in g.provenance.items()
                if k != "wall_time_s"} == \
            {k: v for k, v in w.provenance.items() if k != "wall_time_s"}
        for f in ("base_time", "grid_best_speedup"):
            assert close(getattr(g, f), getattr(w, f)), f
        for p in w.policy_times:
            assert close(g.policy_times[p], w.policy_times[p]), p
            assert close(g.policy_speedups[p], w.policy_speedups[p]), p
        assert g.best_policy()[0] == w.best_policy()[0]
        assert g.policy_speedups["adaptive"] >= g.grid_best_speedup - 1e-9
        assert g.policy_speedups["greedy"] >= 1.0
    fid, ref_fid = fidelity_report(ports), ref_fidelity(refs)
    assert fid.keys() == ref_fid.keys()
    for wl, row in ref_fid.items():
        for model, vals in row.items():
            for f, v in vals.items():
                tol = 1e-9 if f == "speedup_rel_err" else None
                g = fid[wl][model][f]
                assert (abs(g - v) <= tol if tol else close(g, v)), \
                    (wl, model, f, g, v)
    assert fid["_summary"]["striped"]["worst_speedup_rel_err"] <= 1e-9
    rep, ref_rep = policy_report(ports), ref_policy_report(refs)
    for wl in refs:
        for p in ("static", "greedy", "adaptive", "oracle"):
            for f in ("speedup", "time_ms", "wireless_mb"):
                assert close(rep[wl][p][f], ref_rep[wl][p][f]), (wl, p, f)
            assert rep[wl][p]["beats_grid"] == ref_rep[wl][p]["beats_grid"]
    assert rep["_summary"].keys() == ref_rep["_summary"].keys()


def test_sim_contracts(traces):
    _, port = traces["zfnet"]
    rec = PacketSim(port, NET96[1], record=True).run("static")
    assert rec.trace is not None and len(rec.trace) > 0
    assert rec.layer_terms.shape == (port.n_layers, 5)
    with pytest.raises(ValueError):
        PacketSim(port, NET96[1], link_model="mesh")
    with pytest.raises(ValueError):
        get_policy("nope")
    assert get_policy("greedy").name == "greedy"
    sim = PacketSim(port, NET96[1])
    res = sim.run("static")
    assert sim.eligible.device == port.device == res.layer_times.device
    assert set(res.bottleneck_share()) == set(P.simulator.BOTTLENECKS)
    # the lazy re-exports of repro_torch.core
    for name in ("PacketSim", "simulate_events", "policy_sweep",
                 "policy_sweep_all", "PolicySweepResult", "fidelity_report"):
        assert hasattr(P, name), name
    assert P.PacketSim is PacketSim
    with pytest.raises(AttributeError):
        P.not_an_export  # noqa: B018
