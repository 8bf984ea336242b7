"""The port's fault plane (`repro_torch.fault`) against the JAX package's
(`repro.fault`), on the CPU.

Both packages run the same scenarios (the port's classes built from the
reference's) on the same traces.  Integers and masks must be equal;
floats are held to rtol 1e-12, infinities to equality.  Covers the
goldens of `tests/test_fault_plane.py` (forced failover, the wired-only
infinity, the online path, derating, the emergency absorber, missing
metadata, an unknown link), the zero-degradation bit identity, the
fault arrays, the fault-aware balancer, the reshard controller, the
retained-speedup sweep and the two launchers.
"""

import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.core as R
import repro.fault as RF
from repro.core.workloads import WORKLOADS
from repro.fault.apply import link_fault_arrays as ref_link_arrays
from repro.fault.apply import wireless_bw_matrix as ref_bw_matrix
from repro.obs.provenance import config_hash as ref_config_hash
from repro.sim import FixedPolicy as RFixed
from repro.sim import PacketSim as RSim
from repro_torch import core as P
from repro_torch import fault as PF
from repro_torch.fault.apply import link_fault_arrays, wireless_bw_matrix
from repro_torch.sim import FixedPolicy, PacketSim

from _torch_event import (NET96, RTOL, assert_same_event, close,
                          port_scenario, random_scenario, trace_pair)

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def zfnet():
    return R.make_trace("zfnet"), P.make_trace("zfnet", device="cpu")


# ---------------------------------------------------------------------------
# the golden trace of tests/test_fault_plane.py, in both packages
# ---------------------------------------------------------------------------

def golden_pair(with_exec=False):
    """Two chiplets, the same traffic in each of 2 layers: a 4 MB
    eligible multicast on link 0 (1 ms) and a 2 MB ineligible unicast
    on link 1 (0.5 ms); compute floor 1 ms a layer.  ``with_exec``: both
    chips split every layer 50/50, layer 1 holds 8 MB of weights."""
    meta = None
    if with_exec:
        meta = dict(exec_chips=[(0, 1), (0, 1)],
                    exec_shares=[np.array([0.5, 0.5])] * 2,
                    weight_bytes=np.array([0.0, 8e6]))
    return trace_pair(
        (1, 2), 1, 2, {((0, 0), (0, 1)): 0, ((0, 1), (0, 0)): 1},
        exec_meta=meta, layer=[0, 0, 1, 1], nbytes=[4e6, 2e6, 4e6, 2e6],
        src=[0, 1, 0, 1], is_multicast=[True, False, True, False],
        is_multichip=[True] * 4, max_hops=[1] * 4, dram_node=[-1] * 4,
        inc_msg=[0, 1, 2, 3], inc_link=[0, 1, 0, 1], t_compute=[1e-3, 1e-3],
        t_dram=[0.0, 0.0], t_noc=[0.0, 0.0], dram_bytes=[0.0, 0.0])


#: link 0 dies at layer 1 (one-way: the reverse link stays up)
LINK0_DOWN = RF.FaultScenario(link_failures=(
    RF.LinkFailure((0, 0), (0, 1), at_layer=1, both_directions=False),))


def test_golden_link_failure_forces_failover_and_wired_pays_infinity():
    ref, port = golden_pair()
    rsim = RSim(ref, NET96[0], faults=LINK0_DOWN)
    psim = PacketSim(port, NET96[1], faults=port_scenario(LINK0_DOWN))
    wired = [False] * 4
    res = psim.run(FixedPolicy(wired))
    assert_same_event(rsim.run(RFixed(wired)), res, "failover")
    assert res.injected.tolist() == [False, False, True, False]
    np.testing.assert_allclose(res.layer_times.numpy(), [1e-3, 1e-3])
    res = psim.run_wired()
    assert_same_event(rsim.run_wired(), res, "wired-only")
    assert np.isinf(res.total_time)
    assert res.layer_times[0].item() == pytest.approx(1e-3)
    # the per-packet (greedy) path agrees with the batched one
    res = psim.run("greedy")
    assert_same_event(rsim.run("greedy"), res, "online")
    assert res.total_time == pytest.approx(2e-3) and bool(res.injected[2])


@pytest.mark.parametrize("case", ("failure", "slowdown", "absorber"))
def test_golden_chip_derating_matches_the_reference(case):
    ref, port = golden_pair(with_exec=True)
    sc = {"failure": RF.FaultScenario(
              chip_failures=(RF.ChipFailure(1, at_layer=1),)),
          "slowdown": RF.FaultScenario(
              chip_slowdowns=(RF.ChipSlowdown(0, 2.0),)),
          "absorber": RF.FaultScenario(
              chip_failures=(RF.ChipFailure(0), RF.ChipFailure(1)))}[case]
    want = RF.derate_trace(ref, sc)
    got = PF.derate_trace(port, port_scenario(sc))
    assert got is not port and got.nbytes is port.nbytes
    for f in ("t_compute", "t_dram"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   getattr(want, f), rtol=RTOL, atol=0)
    hand = {"failure": [1e-3, 2e-3], "slowdown": [4e-3 / 3] * 2,
            "absorber": [2e-3, 2e-3]}[case]
    np.testing.assert_allclose(got.t_compute.numpy(), hand)
    assert_same_event(RSim(ref, NET96[0], faults=sc).run("static"),
                      PacketSim(port, NET96[1],
                                faults=port_scenario(sc)).run("static"),
                      case)


def test_missing_metadata_and_unknown_link_raise():
    _, port = golden_pair(with_exec=False)
    with pytest.raises(ValueError, match="exec_chips"):
        PF.derate_trace(port, PF.FaultScenario(
            chip_failures=(PF.ChipFailure(0),)))
    sc = PF.FaultScenario(link_failures=(PF.LinkFailure((0, 0), (5, 5)),))
    with pytest.raises(ValueError, match="no mesh link"):
        PacketSim(port, NET96[1], faults=sc)


def test_scenario_validation_and_refusals(zfnet):
    with pytest.raises(ValueError):
        PF.ChipSlowdown(0, 0.5)
    with pytest.raises(ValueError):
        PF.SnrFade(float("inf"))
    with pytest.raises(ValueError, match="fail-stops"):
        PF.default_scenario(zfnet[1], k=99)
    with pytest.raises(NotImplementedError, match="adaptive"):
        PacketSim(zfnet[1], NET96[1], link_model="adaptive",
                  faults=PF.FaultScenario(snr_fades=(PF.SnrFade(3.0),)))
    sim = PacketSim(zfnet[1], NET96[1], faults=PF.FaultScenario())
    assert sim.faults is None      # a null scenario keeps no fault state
    for k, fade in ((0, 0.0), (2, 3.0)):
        want = RF.default_scenario(zfnet[0], k=k, fade_db=fade)
        got = PF.default_scenario(zfnet[1], k=k, fade_db=fade)
        assert got == port_scenario(want)
        assert got.describe() == want.describe()


# ---------------------------------------------------------------------------
# zero-degradation differential pin: bit-identical to fault-free
# ---------------------------------------------------------------------------

ZERO = PF.FaultScenario(chip_slowdowns=(PF.ChipSlowdown(0, 1.0),),
                        snr_fades=(PF.SnrFade(0.0),))


@pytest.mark.parametrize("wl", sorted(WORKLOADS))
def test_zero_degradation_is_bit_identical(wl):
    tr = P.make_trace(wl, device="cpu")
    base = PacketSim(tr, NET96[1]).run("static")
    faulted = PacketSim(tr, NET96[1], faults=ZERO).run("static")
    assert PF.derate_trace(tr, ZERO) is tr
    assert faulted.total_time == base.total_time
    assert torch.equal(faulted.layer_times, base.layer_times)
    assert torch.equal(faulted.injected, base.injected)


# ---------------------------------------------------------------------------
# the fault arrays, the fault-aware balancer and policies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(2))
def test_link_fault_arrays_and_bw_matrix_match_the_reference(zfnet, seed):
    ref, port = zfnet
    rng = np.random.default_rng(seed)
    links = list(ref.link_index)
    sc = RF.FaultScenario(
        link_failures=tuple(RF.LinkFailure(*links[int(i)],
                                           at_layer=int(rng.integers(0, 4)))
                            for i in rng.choice(len(links), 4, False)),
        snr_fades=(RF.SnrFade(4.0, channel=1, at_layer=2),
                   RF.SnrFade(2.5)))
    rnet = R.NetworkConfig(96e9 / 8, channels=R.ChannelPlan(2))
    pnet = P.NetworkConfig(96e9 / 8, channels=P.ChannelPlan(2))
    cut_mat, cut_bw = ref.cut_matrix()
    col = cut_mat.argmax(axis=1)
    k_par = np.rint(cut_bw / ref.topo.config.nop_bw_per_side).astype(int)
    want = ref_link_arrays(ref, sc, cut_of_link=col, k_par=k_par,
                           n_cuts=cut_mat.shape[1])
    got = link_fault_arrays(port, port_scenario(sc),
                            cut_of_link=torch.from_numpy(col),
                            k_par=torch.from_numpy(k_par),
                            n_cuts=cut_mat.shape[1])
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_allclose(
        wireless_bw_matrix(port, pnet, port_scenario(sc)).numpy(),
        ref_bw_matrix(ref, rnet, sc), rtol=RTOL, atol=0)
    assert wireless_bw_matrix(port, pnet, PF.FaultScenario()) is None


@pytest.mark.parametrize("seed", range(3))
def test_balance_and_policies_under_faults_match_the_reference(zfnet, seed):
    """`balance(faults=)` and every policy under a seeded random
    scenario; online-reshard is never slower than static or adaptive."""
    ref, port = zfnet
    sc = random_scenario(ref, np.random.default_rng(seed))
    psc = port_scenario(sc)
    want = R.balance(RF.derate_trace(ref, sc), NET96[0], faults=sc)
    got = P.balance(PF.derate_trace(port, psc), NET96[1], faults=psc)
    np.testing.assert_array_equal(got.injected.numpy(), want.injected)
    assert close(got.speedup_vs_wired, want.speedup_vs_wired)
    rsim = RSim(ref, NET96[0], faults=sc)
    psim = PacketSim(port, NET96[1], faults=psc)
    assert_same_event(rsim.run_wired(), psim.run_wired(), "wired")
    times = {}
    for p in ("static", "greedy", "adaptive", "oracle", "online-reshard"):
        res = psim.run(p)
        assert_same_event(rsim.run(p), res, f"seed {seed} {p}")
        times[p] = res.total_time
    assert times["online-reshard"] <= times["static"] * (1 + 1e-12)
    assert times["online-reshard"] <= times["adaptive"] * (1 + 1e-12)


def test_xy_detours_match_the_reference(zfnet):
    ref, port = zfnet
    links = list(ref.link_index)
    sc = RF.FaultScenario(link_failures=(
        RF.LinkFailure(*links[0], at_layer=1),
        RF.LinkFailure(*links[3], at_layer=0)))
    rsim = RSim(ref, NET96[0], link_model="xy", faults=sc)
    psim = PacketSim(port, NET96[1], link_model="xy",
                     faults=port_scenario(sc))
    assert_same_event(rsim.run_wired(), psim.run_wired(), "xy wired")
    for p in ("static", "greedy"):
        assert_same_event(rsim.run(p), psim.run(p), f"xy {p}")


# ---------------------------------------------------------------------------
# the reshard controller and the retained-speedup sweep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", (1, 2))
def test_reshard_run_matches_the_reference(zfnet, k):
    sc = RF.default_scenario(zfnet[0], k=k, fade_db=9.0)
    want = RF.reshard_run("zfnet", NET96[0], sc)
    got = PF.reshard_run("zfnet", NET96[1], port_scenario(sc), device="cpu")
    for f in ("total_time", "degraded_time", "resharded_time",
              "migration_time"):
        assert close(getattr(got, f), getattr(want, f)), f
    assert got.resharded == want.resharded and got.eras == want.eras
    assert [(e.step, e.kind, e.workers, e.new_mesh) for e in got.events] == \
        [(e.step, e.kind, e.workers, e.new_mesh) for e in want.events]
    assert got.total_time == min(got.resharded_time, got.degraded_time)
    detected = sorted(w for e in got.events if e.kind == "failure"
                      for w in e.workers)
    assert detected == sorted(ev.chip for ev in sc.chip_failures)


def test_infeasible_reshard_stays_degraded():
    n = P.AcceleratorConfig().n_chiplets
    sc = PF.FaultScenario(chip_failures=tuple(
        PF.ChipFailure(c, at_layer=2) for c in range(n)))
    oc = PF.reshard_run("zfnet", NET96[1], sc, device="cpu")
    ref = RF.reshard_run("zfnet", NET96[0], RF.FaultScenario(
        chip_failures=tuple(RF.ChipFailure(c, at_layer=2)
                            for c in range(n))))
    assert not oc.resharded and oc.total_time == oc.degraded_time
    assert close(oc.total_time, ref.total_time)
    assert np.isinf(oc.resharded_time)


def test_resilience_sweep_matches_the_reference():
    want = RF.resilience_sweep(["resnet50"], NET96[0], ks=(0, 1),
                               fades=(3.0,))
    got = P.resilience_sweep_all(["resnet50"], NET96[1], ks=(0, 1),
                                 fades=(3.0,), device="cpu")
    prov = got.pop("provenance")
    assert prov["kind"] == "dse.resilience_sweep_all"
    assert prov["config_hash"] == ref_config_hash(
        {"workloads": ["resnet50"], "ks": [0, 1], "fades": [3.0],
         "policies": ["static", "adaptive", "online-reshard"],
         "net": NET96[0]})
    assert prov["points_evaluated"] == 1 * 2 * 1 * 3
    assert got.keys() == want.keys()
    row, ref_row = got["resnet50"], want["resnet50"]
    assert close(row["wired_ff"], ref_row["wired_ff"])
    for p, v in ref_row["speedup_ff"].items():
        assert close(row["speedup_ff"][p], v), p
    for cell, pols in ref_row["cells"].items():
        for p, d in pols.items():
            for f in ("time", "speedup", "retained"):
                assert close(row["cells"][cell][p][f], d[f]), (cell, p, f)
            assert row["cells"][cell][p]["resharded"] == d["resharded"]


def test_entry_points_need_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sc = PF.FaultScenario(snr_fades=(PF.SnrFade(3.0),))
    for call in (lambda: PF.reshard_run("zfnet", NET96[1], sc),
                 lambda: PF.resilience_sweep(["zfnet"], NET96[1]),
                 lambda: P.resilience_sweep_all(["zfnet"])):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------

def test_event_plane_run_on_the_cpu():
    """`launch/event_plane.run("cpu")` at a small size: every check holds
    and its numbers are the reference's."""
    from repro_torch.launch.event_plane import run
    out = run("cpu", workloads=("zfnet",), resilience_workloads=("resnet50",),
              ks=(0, 1), fades=(3.0,), fault_workload="zfnet", reps=1)
    assert out["failures"] == []
    assert out["policy_packets_differing_from_cpu"] == 0
    assert out["faulted"]["adaptive_refuses"]
    want = R.policy_sweep_all({"zfnet": R.make_trace("zfnet")})
    for p in ("static", "greedy", "adaptive", "oracle"):
        assert close(out["policy_mean_speedup"][p],
                     float(np.mean([r.policy_speedups[p] for r in want])))
    assert out["fidelity_worst"]["striped"] <= 1e-9
    oc = RF.reshard_run("resnet50", NET96[0], RF.default_scenario(
        R.make_trace("resnet50"), k=1, fade_db=3.0))
    got = out["reshard"]["reshard resnet50 k1_fade3"]
    for f in ("degraded_time", "resharded_time", "migration_time"):
        assert close(got[f], getattr(oc, f)), f
    assert got["eras"] == oc.eras and len(oc.eras) == 2
    assert len(out["seconds"]["policy_sweep_all"]) == 1
    assert out["profile"]["planned_static"]["host_ms_per_run"] > 0
    json.dumps(out)                        # chip_smoke prints it whole


def test_resilience_cli_prints_the_reference_grid():
    """`python -m repro_torch.launch.resilience --quick --device cpu`:
    acts 1 and 3 run, and the retained speedups it prints are the
    reference's `resilience_sweep` at ks (0, 1) and 3 dB."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.resilience", "zfnet",
         "--quick", "--device", "cpu"], capture_output=True, text=True,
        cwd=REPO, env={**os.environ, "PYTHONPATH": str(REPO / "src")},
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout
    for section in ("== inject", "== explain: critical-path shift",
                    "fault-free critical share", "faulted    critical share",
                    "== decide", "recovery event"):
        assert section in out, section
    want = RF.resilience_sweep(["zfnet"], NET96[0], ks=(0, 1),
                               fades=(3.0,))["zfnet"]["cells"]
    for cell, pols in want.items():
        line = next(x for x in out.splitlines()
                    if x.strip().startswith(cell))
        got = dict(re.findall(r"([\w-]+)=[\d.]+% \(([\d.e-]+)\)", line))
        assert {p: float(v) for p, v in got.items()} == \
            {p: d["retained"] for p, d in pols.items()}
