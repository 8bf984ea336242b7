"""The port's sweeps, scale-out frontier and balancer against the JAX
package's, on the CPU.

Tolerance rtol 1e-12 (the port's CPU route sums in the reference's
order, so its sweeps meet tests/test_golden.py's frozen speedups), and
the tie rule: a best (threshold, injection), network configuration,
reuse plan or balancer anchor that differs from the reference's is
accepted only where the reference's own value at the port's choice is
within the tolerance of the reference's best.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.core as R
from repro.core.dse import INJECTIONS, THRESHOLDS, grid_anchor as ref_anchor
from repro.core.workloads import WORKLOADS
from repro_torch import core as P
from repro_torch.launch import paper_plane
from test_golden import GOLDEN_3X3

RTOL = 1e-12
NETWORK_WORKLOADS = ("zfnet", "googlenet", "transformer_cell")
SCALING_WORKLOADS = ("zfnet", "gnmt", "googlenet")
BALANCE_WORKLOADS = ("zfnet", "lstm", "transformer_cell")


def close(a, b, rtol=RTOL):
    return abs(a - b) <= rtol * abs(b)


@pytest.fixture(scope="module")
def traces():
    return {w: (R.make_trace(w), P.make_trace(w, device="cpu"))
            for w in WORKLOADS}


def assert_sweeps_match(ref_list, port_list):
    assert len(ref_list) == len(port_list)
    for ref, got in zip(ref_list, port_list):
        assert (got.workload, got.bandwidth_gbps) == \
            (ref.workload, ref.bandwidth_gbps)
        np.testing.assert_allclose(got.grid.numpy(), ref.grid, rtol=RTOL,
                                   atol=0)
        assert close(got.best_speedup, ref.best_speedup), got.workload
        if (got.best_threshold, got.best_injection) != \
                (ref.best_threshold, ref.best_injection):
            at = ref.grid[THRESHOLDS.index(got.best_threshold),
                          INJECTIONS.index(got.best_injection)]
            assert close(at, ref.best_speedup), got.workload


def test_sweep_all_matches_the_reference_the_golden_and_the_paper(traces):
    ref = R.sweep_all({w: r for w, (r, _) in traces.items()})
    got = P.sweep_all({w: p for w, (_, p) in traces.items()})
    assert_sweeps_match(ref, got)
    for r in got:
        s64, s96, wired = GOLDEN_3X3[r.workload]
        assert close(r.best_speedup, s64 if r.bandwidth_gbps == 64 else s96)
        assert close(P.simulate_wired(traces[r.workload][1]).total_time,
                     wired)
        assert r.grid.device == torch.device("cpu")
    (mean64, _), (mean96, max96) = P.summary(got)[64], P.summary(got)[96]
    assert 1.04 <= mean64 <= 1.12 and 1.055 <= mean96 <= 1.145
    assert max96 >= 1.15 and mean96 >= mean64


@pytest.mark.parametrize("wl", ("zfnet", "googlenet"))
def test_loop_engine_matches_batched_and_the_reference_loop(wl, traces):
    ref, port = traces[wl]
    loop = P.sweep_all({wl: port}, engine="loop")
    assert_sweeps_match(R.sweep_all({wl: ref}, engine="loop"), loop)
    assert paper_plane.compare_sweeps(
        loop, P.sweep_all({wl: port}), 1e-12) == []
    with pytest.raises(ValueError, match="engine"):
        P.sweep_all({wl: port}, engine="vector")


def test_network_sweep_all_matches_the_reference(traces):
    ref = R.network_sweep_all({w: traces[w][0] for w in NETWORK_WORKLOADS})
    got = P.network_sweep_all({w: traces[w][1] for w in NETWORK_WORKLOADS})
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.result.speedup.numpy(),
                                   r.result.speedup, rtol=RTOL, atol=0)
        assert close(g.best_speedup, r.best_speedup)
        if g.best_config.describe() != r.best_config.describe():
            idx = paper_plane._grid_index(g.result.spec, g.best_config)
            assert close(r.result.speedup[idx], r.best_speedup)
        table, want = g.best_by_network(), r.best_by_network()
        assert table.keys() == want.keys()
        assert all(close(table[k], want[k]) for k in want)
    summary, want = P.network_summary(got), R.network_summary(ref)
    assert all(close(summary[k][0], want[k][0]) for k in want)


@pytest.mark.parametrize("grid", ((4, 4), (8, 8)))
def test_scaling_sweep_matches_the_reference(grid):
    ref = R.scaling_sweep(SCALING_WORKLOADS, [grid])
    got = P.scaling_sweep(SCALING_WORKLOADS, [grid], device="cpu")
    for r, g in zip(ref, got):
        assert (g.workload, g.grid, g.n_chiplets) == \
            (r.workload, r.grid, r.n_chiplets)
        for f in ("wired_time", "best_single", "best_reuse"):
            assert close(getattr(g, f), getattr(r, f)), (g.workload, f)
        if g.best_reuse_plan != r.best_reuse_plan:
            at = paper_plane.plan_bests(g.workload, grid, 96, "cpu")
            assert close(at[g.best_reuse_plan], r.best_reuse)
        assert g.best_reuse_plan.endswith("reuse")
    assert P.scaling_summary(got).keys() == R.scaling_summary(ref).keys()


def test_scaling_engines_agree_and_reuse_plans_match():
    loop = P.scaling_sweep(["googlenet"], [(4, 4)], engine="loop",
                           device="cpu")
    batched = P.scaling_sweep(["googlenet"], [(4, 4)], device="cpu")
    assert paper_plane.compare_scaling(loop, batched, 1e-12, 96,
                                       "cpu") == []
    for grid in ((3, 3), (4, 4), (6, 6), (16, 16), (2, 8)):
        assert [p.describe() for p in P.reuse_plans(grid)] == \
            [p.describe() for p in R.reuse_plans(grid)]
    cfg, ref = P.scaled_config((12, 12)), R.scaled_config((12, 12))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)


@pytest.mark.parametrize("mac", ("ideal", "tdma"))
@pytest.mark.parametrize("wl", BALANCE_WORKLOADS)
def test_balance_matches_the_reference(wl, mac, traces):
    ref, port = traces[wl]
    channels = 1 if mac == "ideal" else 2
    rnet = R.NetworkConfig(96e9 / 8, mac=R.MacConfig(mac),
                           channels=R.ChannelPlan(channels, "interleaved"))
    pnet = P.NetworkConfig(96e9 / 8, mac=P.MacConfig(mac),
                           channels=P.ChannelPlan(channels, "interleaved"))
    want, got = R.balance(ref, rnet), P.balance(port, pnet)
    (_, rt, rp), (_, pt, pp) = ref_anchor(ref, rnet), P.grid_anchor(port,
                                                                    pnet)
    if (rt, rp) == (pt, pp):
        np.testing.assert_array_equal(got.injected.numpy(), want.injected)
    for f in ("speedup_vs_wired", "injected_fraction"):
        assert close(getattr(got, f), getattr(want, f)), f
    for f in ("total_time", "wireless_bytes", "wireless_energy_j",
              "energy_j"):
        assert close(getattr(got.sim, f), getattr(want.sim, f)), f
    best = R.sweep(ref, wl, 96, R.MacConfig(mac),
                   R.ChannelPlan(channels, "interleaved")).best_speedup
    assert got.speedup_vs_wired >= best - 1e-9


def test_tie_rule_accepts_a_tie_and_rejects_a_worse_choice():
    grid = torch.ones(len(THRESHOLDS), len(INJECTIONS))
    grid[1, 2] = grid[0, 0] = 1.5
    base = P.SweepResult("x", 96, grid.double(), 1.5, THRESHOLDS[0],
                         INJECTIONS[0])
    tie = dataclasses.replace(base, best_threshold=THRESHOLDS[1],
                              best_injection=INJECTIONS[2])
    worse = dataclasses.replace(base, best_threshold=THRESHOLDS[3])
    assert paper_plane.compare_sweeps([tie], [base], 1e-12) == []
    assert paper_plane.compare_sweeps([worse], [base], 1e-12) != []


def test_paper_plane_phase_runs_on_the_cpu():
    """The chip phase's `run` end to end at a small size, the CPU
    against itself: every comparison holds and two runs are bit-equal."""
    out = paper_plane.run("cpu", workloads=["zfnet", "googlenet"],
                          llm=["smollm_360m:decode"], grids=[(4, 4)])
    assert out["failures"] == []
    assert all(out["bit_equal"].values())
    assert out["profile"]["paper_grid"]["host_ms_per_evaluate"] > 0
    assert set(out["seconds"]) >= {"sweep_all", "network_sweep_all",
                                   "scaling_sweep", "balance"}
