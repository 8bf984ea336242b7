"""The port's heterogeneous-package plane (`repro_torch.arch`) and
`dse.hetero_sweep` against the JAX package's, on the CPU.

The catalog, the mixes and each package's lowering to an
`AcceleratorConfig` and a topology must equal the reference's.  A
package of identical "standard" chiplets reproduces the paper platform
bit for bit, on the analytic and the event engine.  The search runs on
host NumPy randomness drawn in the reference's order, and the port's
CPU route costs each state bit for bit as the reference does, so the
same seed walks the same states: `anneal`, `exhaustive`, `codesign`
and `hetero_sweep` must return the reference's states, makespans,
spreads and evaluation counts EXACTLY (provenance compared without its
wall time).  Mirrors `tests/test_arch.py`.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.arch as RA
import repro.core as R
from repro.core.dse import hetero_summary as ref_hetero_summary
from repro.core.dse import hetero_sweep as ref_hetero_sweep
from repro.core.workloads import GraphBuilder as RGraph
from repro_torch import core as P
from repro_torch.arch import (CATALOG, MIXES, HeteroPackage, PlacementProblem,
                              anneal, balanced_stages, codesign, exhaustive,
                              greedy_seed)
from repro_torch.core.dse import hetero_summary, hetero_sweep
from repro_torch.core.mapper import pipeline_mapping, spatial_mapping
from repro_torch.core.simulator import (PJ_PER_BIT_NOC, PJ_PER_MAC,
                                        mac_energy_pj)
from repro_torch.core.topology import build_topology
from repro_torch.core.workloads import GraphBuilder, get_workload
from repro_torch.sim import PacketSim

UNIFORM_CFG = HeteroPackage.uniform().to_config()
PARITY_WORKLOADS = ("zfnet", "googlenet", "gnmt", "smollm_360m:prefill")
NET = (R.WirelessConfig(96e9 / 8, 1, 0.5), P.WirelessConfig(96e9 / 8, 1, 0.5))
NET96 = (R.NetworkConfig(bandwidth=96e9 / 8),
         P.NetworkConfig(bandwidth=96e9 / 8))
TINY_MIX = ("big", "big", "little", "little")


def _tiny_layers(builder):
    """8-layer synthetic graph for exhaustive-search validation."""
    g = builder()
    for i, (cin, cout, hw) in enumerate(
            [(3, 32, 64), (32, 64, 32), (64, 64, 32), (64, 128, 16),
             (128, 128, 16), (128, 256, 8), (256, 256, 8)]):
        g.conv(f"c{i}", cin, cout, 3, hw)
    g.fc("fc", 256, 100)
    return g.layers


def _tiny_problems():
    return (RA.PlacementProblem(_tiny_layers(RGraph), mix=TINY_MIX,
                                grid=(2, 2)),
            PlacementProblem(_tiny_layers(GraphBuilder), mix=TINY_MIX,
                             grid=(2, 2), device="cpu"))


def _plain(obj):
    """A result as nested dicts, provenance without its wall time."""
    def strip(x):
        if isinstance(x, dict):
            return {k: strip(v) for k, v in x.items() if k != "wall_time_s"}
        return x
    return strip(dataclasses.asdict(obj))


# ---------------------------------------------------------------------------
# the catalog, the mixes, the lowering
# ---------------------------------------------------------------------------

def test_catalog_mixes_and_lowering_match_the_reference():
    assert {k: dataclasses.asdict(v) for k, v in CATALOG.items()} == \
        {k: dataclasses.asdict(v) for k, v in RA.CATALOG.items()}
    assert MIXES == RA.MIXES
    std = CATALOG["standard"]
    assert (std.pj_per_mac, std.pj_per_bit_noc) == (PJ_PER_MAC,
                                                    PJ_PER_BIT_NOC)
    assert UNIFORM_CFG.grid == (3, 3) and UNIFORM_CFG.tops_total == 144e12
    assert UNIFORM_CFG.chiplet_tops == (16e12,) * 9
    for name in MIXES:
        for order in (None, (8, 7, 6, 5, 4, 3, 2, 1, 0)):
            pkg = HeteroPackage.from_mix(name, order=order)
            ref = RA.HeteroPackage.from_mix(name, order=order)
            assert pkg.n_slots == 9 and not pkg.is_uniform
            assert pkg.describe() == ref.describe()
            assert pkg.tops_total == ref.tops_total
            assert dataclasses.asdict(pkg.to_config()) == \
                dataclasses.asdict(ref.to_config())
            topo, ref_topo = pkg.build_topology(), ref.build_topology()
            for f in ("n_nodes", "chiplet_coords", "dram_coords"):
                assert getattr(topo, f) == getattr(ref_topo, f), f
    with pytest.raises(KeyError, match="big_little"):
        HeteroPackage.from_mix("big_litle")
    with pytest.raises(KeyError, match="standard"):
        HeteroPackage.uniform("standrd")
    with pytest.raises(ValueError):
        HeteroPackage.from_mix("big_little", order=(0, 0, 1, 2, 3, 4, 5, 6, 7))


# ---------------------------------------------------------------------------
# homogeneous parity
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pairs():
    """(default-platform trace, uniform-package trace) per workload."""
    return {wl: (P.make_trace(wl, device="cpu"),
                 P.make_trace(wl, acc=UNIFORM_CFG, device="cpu"))
            for wl in PARITY_WORKLOADS}


@pytest.mark.parametrize("wl", PARITY_WORKLOADS)
def test_homogeneous_parity(pairs, wl):
    """A uniform "standard" package is the paper platform, bit for bit:
    wired, hybrid, the batched sweep and the event engine; and equal to
    the reference's uniform package."""
    tr0, tr1 = pairs[wl]
    for run in (P.simulate_wired, lambda t: P.simulate_hybrid(t, NET[1])):
        r0, r1 = run(tr0), run(tr1)
        assert r0.total_time == r1.total_time
        assert torch.equal(r0.layer_times, r1.layer_times)
        assert r0.bottleneck == r1.bottleneck
        assert r0.energy_j == r1.energy_j
    ref = R.simulate_hybrid(R.make_trace(wl, acc=RA.HeteroPackage.uniform()
                                         .to_config()), NET[0])
    got = P.simulate_hybrid(tr1, NET[1])
    assert (got.total_time, got.energy_j) == (ref.total_time, ref.energy_j)
    a, b = P.sweep_all({wl: tr0}), P.sweep_all({wl: tr1})
    for x, y in zip(a, b):
        assert torch.equal(x.grid, y.grid)
    if wl in ("zfnet", "gnmt"):
        e0 = PacketSim(tr0, NET96[1]).run("adaptive")
        e1 = PacketSim(tr1, NET96[1]).run("adaptive")
        assert (e0.total_time, e0.energy_j) == (e1.total_time, e1.energy_j)


def test_hetero_energy_sram_and_mappings():
    tr_std = P.make_trace("zfnet", acc=UNIFORM_CFG, device="cpu")
    assert mac_energy_pj(tr_std) == tr_std.total_macs * PJ_PER_MAC
    tr_mix = P.make_trace("zfnet", acc=HeteroPackage.from_mix("aimc_edge")
                          .to_config(), device="cpu")
    assert mac_energy_pj(tr_mix) < mac_energy_pj(tr_std)
    tr_gnmt = P.make_trace("gnmt", acc=UNIFORM_CFG, device="cpu")
    tr_mem = P.make_trace("gnmt", acc=HeteroPackage.uniform("mem")
                          .to_config(), device="cpu")
    assert sum(m.kind == "wstream" for m in tr_mem.messages) < \
        sum(m.kind == "wstream" for m in tr_gnmt.messages)
    layers = get_workload("googlenet")
    m_het = spatial_mapping(layers, HeteroPackage.from_mix("big_little")
                            .build_topology())
    assert not np.allclose(m_het.shares[0], m_het.shares[0][0])
    m_uni = pipeline_mapping(layers, build_topology(UNIFORM_CFG))
    m_def = pipeline_mapping(layers, build_topology())
    assert [tuple(c) for c in m_uni.chiplets] == \
        [tuple(c) for c in m_def.chiplets]


# ---------------------------------------------------------------------------
# the search: the reference's states and makespans, exactly
# ---------------------------------------------------------------------------

def test_balanced_stages_and_greedy_seed_match_the_reference():
    macs = [lyr.macs for lyr in _tiny_layers(GraphBuilder)]
    for rates in ([2.0, 1.0, 1.0], [1.0] * 4, [3.0, 1.0, 0.5, 2.0]):
        assert balanced_stages(macs, rates) == RA.balanced_stages(macs,
                                                                  rates)
    assert balanced_stages([1.0] * 4, [1.0] * 4) == [0, 1, 2, 3]
    ref_p, p = _tiny_problems()
    assert dataclasses.asdict(greedy_seed(p)) == \
        dataclasses.asdict(RA.greedy_seed(ref_p))
    assert p.evaluate(greedy_seed(p)) == ref_p.evaluate(RA.greedy_seed(ref_p))


def test_anneal_returns_the_reference_state_and_makespans():
    """Seed 3, 80 steps, 2 restarts: the reference's state and
    makespans exactly, and deterministic."""
    ref_p, p = _tiny_problems()
    got = anneal(p, "hybrid", seed=3, steps=80, restarts=2)
    want = RA.anneal(ref_p, "hybrid", seed=3, steps=80, restarts=2)
    assert _plain(got) == _plain(want)
    assert got.provenance["kind"] == "arch.anneal"
    assert got.provenance["seed"] == 3
    again = anneal(_tiny_problems()[1], "hybrid", seed=3, steps=80,
                   restarts=2)
    assert again == got


def test_exhaustive_returns_the_reference_optimum():
    ref_p, p = _tiny_problems()
    for objective in ("hybrid", "wired"):
        got = exhaustive(p, objective)
        assert _plain(got) == _plain(RA.exhaustive(ref_p, objective))
        an = anneal(p, objective, seed=0, steps=150, restarts=2)
        assert an.makespan == got.makespan
        assert _plain(an) == _plain(RA.anneal(ref_p, objective, seed=0,
                                              steps=150, restarts=2))
    big = PlacementProblem("zfnet", device="cpu")
    with pytest.raises(ValueError, match="6-slot"):
        exhaustive(big)


def test_codesign_equals_the_reference():
    got = codesign("zfnet", "big_little", steps=40, restarts=1, n_samples=4,
                   device="cpu")
    want = RA.codesign("zfnet", "big_little", steps=40, restarts=1,
                       n_samples=4)
    assert _plain(got) == _plain(want)
    assert got.package.startswith("3x3[")
    assert got.speedup_codesigned >= 1.0 - 1e-12
    assert got.hybrid.t_hybrid <= got.greedy.t_hybrid + 1e-15


def test_hetero_sweep_and_summary_equal_the_reference():
    got = hetero_sweep(workloads=["zfnet", "googlenet"],
                       mixes=("big_little",), steps=30, restarts=1,
                       n_samples=3, device="cpu")
    want = ref_hetero_sweep(workloads=["zfnet", "googlenet"],
                            mixes=("big_little",), steps=30, restarts=1,
                            n_samples=3)
    assert [_plain(g) for g in got] == [_plain(w) for w in want]
    assert hetero_summary(got) == ref_hetero_summary(want)
    assert hetero_summary(got)["_overall"]["n"] == 2
    assert hetero_summary([]) == {}


def test_problem_device_and_core_exports(monkeypatch):
    """The evaluations land on the problem's device; with no card and no
    device the problem raises, as `make_trace` does."""
    p = PlacementProblem("zfnet", device="cpu")
    assert p.device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device"):
        PlacementProblem("zfnet")
    for name in ("ChipletSpec", "HeteroPackage", "CATALOG", "MIXES",
                 "PlacementProblem", "PlacementResult", "CodesignResult",
                 "codesign", "anneal", "exhaustive", "greedy_seed"):
        assert getattr(P, name) is getattr(__import__(
            "repro_torch.arch", fromlist=[name]), name)
