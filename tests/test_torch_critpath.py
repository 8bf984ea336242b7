"""The port's critical path and what-if projection (`repro_torch.obs
.critpath`, `.whatif`) and `dse.whatif_guided` against the JAX
package's, on the CPU.

The recorded traces equal the reference's bit for bit on the CPU
(`tests/test_torch_obs.py`), so the critical path's segments, the
critical-vs-busy shares and every projection are computed on equal
inputs by the same host code: they must equal the reference's within
1e-12 (sums over dicts run in one order in both).  `whatif_guided`'s
single-point evaluations sum a layer axis where NumPy may pair up the
additions (a one-point grid makes that axis contiguous) and the port
sums in order, so its lower band's best speedup may differ from the
reference's in the last bit: held at rtol 1e-12, with the same best
point.  Mirrors `tests/test_critpath.py`.
"""

import pytest

import repro.core as R
import repro.obs as RO
from repro.core.dse import whatif_guided as ref_whatif_guided
from repro.sim import FixedPolicy as RFixed
from repro.sim import PacketSim as RSim
from repro_torch import core as P
from repro_torch.core.dse import whatif_guided
from repro_torch.core.workloads import WORKLOADS
from repro_torch.obs import (SimTrace, WhatIf, busy_shares,
                             chrome_trace_events, critical_path,
                             critical_vs_busy, mark_critical, project,
                             project_grid, validate)
from repro_torch.sim import FixedPolicy, PacketSim

from _torch_event import NET96, golden_pair

REUSE = (R.NetworkConfig(bandwidth=96e9 / 8,
                         channels=R.ChannelPlan(n_channels=2, reuse_zones=4)),
         P.NetworkConfig(bandwidth=96e9 / 8,
                         channels=P.ChannelPlan(n_channels=2, reuse_zones=4)))
NETS = {"1ch": NET96, "2ch-reuse": REUSE}
KNOBS = (WhatIf(wireless_scale=2.0), WhatIf(wireless_scale=0.5),
         WhatIf(n_channels=2, reuse_zones=4),
         WhatIf(n_channels=1, reuse_zones=1, channel_policy="contiguous"),
         WhatIf(dram_scale=2.0), WhatIf(wired_scale=1.5))


@pytest.fixture(scope="module")
def traces_all():
    """Every paper workload in both packages, built once."""
    return {wl: (R.make_trace(wl), P.make_trace(wl, device="cpu"))
            for wl in WORKLOADS}


def segments(cp):
    return [(s.eid, s.track, s.name, s.cat, s.layer, s.ts, s.dur,
             s.crit_dur) for s in cp.segments]


def assert_close_dict(got, want, rtol=1e-12):
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=rtol, abs=1e-300), k


# ---------------------------------------------------------------------------
# golden DAG: the 2-chiplet/3-packet trace, chain built by hand
# ---------------------------------------------------------------------------

def test_golden_chains():
    """Wired: the two-event FIFO chain on cut 0, 1 ms each; offloading
    p1 ties the compute floor (one segment); greedy's path is the
    compute span."""
    ref, port = golden_pair()
    res = PacketSim(port, NET96[1], record=True).run_wired()
    cp = critical_path(res.trace)
    assert cp.makespan == pytest.approx(2e-3)
    assert [(s.track, s.name) for s in cp.segments] == [("cut0", "p0"),
                                                        ("cut0", "p1")]
    assert [s.crit_dur for s in cp.segments] == [pytest.approx(1e-3)] * 2
    p0, p1 = cp.segments
    by_eid = {ev.eid: ev for ev in res.trace.events}
    assert by_eid[p1.eid].deps == [p0.eid] and by_eid[p0.eid].deps == []
    assert cp.by_resource() == {"cut0": pytest.approx(2e-3)}
    assert cp.critical_shares() == {"wired": pytest.approx(1.0)}
    assert segments(cp) == segments(RO.critical_path(
        RSim(ref, NET96[0], record=True).run_wired().trace))
    fixed = critical_path(PacketSim(port, NET96[1], record=True).run(
        FixedPolicy([False, True, False])).trace)
    assert len(fixed.segments) == 1
    assert segments(fixed) == segments(RO.critical_path(
        RSim(ref, NET96[0], record=True).run(
            RFixed([False, True, False])).trace))
    greedy = critical_path(PacketSim(port, NET96[1], record=True)
                           .run("greedy").trace)
    assert [(s.track, s.plane) for s in greedy.segments] == \
        [("compute", "compute")]


# ---------------------------------------------------------------------------
# the critical path: sums to the makespan, the reference's segments
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("link_model", ["striped", "adaptive", "xy"])
@pytest.mark.parametrize("net", list(NETS))
def test_critpath_sums_to_makespan_and_matches_the_reference(
        traces_all, link_model, net):
    for wl in ("zfnet", "transformer"):
        ref_tr, tr = traces_all[wl]
        for policy in ("static", "greedy"):
            res = PacketSim(tr, NETS[net][1], record=True,
                            link_model=link_model).run(policy)
            cp = critical_path(res.trace)
            assert cp.makespan == pytest.approx(res.total_time, rel=1e-12)
            assert cp.total == pytest.approx(cp.makespan, rel=1e-12), \
                (wl, link_model, policy)
            ref_cp = RO.critical_path(RSim(
                ref_tr, NETS[net][0], record=True,
                link_model=link_model).run(policy).trace)
            assert segments(cp) == segments(ref_cp)
            assert cp.makespan == ref_cp.makespan


def test_critical_vs_busy_matches_the_reference(traces_all):
    for wl in ("resnet50", "gnmt"):
        ref_tr, tr = traces_all[wl]
        st = PacketSim(tr, NET96[1], record=True).run("static").trace
        ref_st = RSim(ref_tr, NET96[0], record=True).run("static").trace
        cvb, ref_cvb = critical_vs_busy(st), RO.critical_vs_busy(ref_st)
        for key in ("critical", "busy"):
            assert sum(cvb[key].values()) == pytest.approx(1.0)
            assert_close_dict(cvb[key], ref_cvb[key])
        assert cvb["divergence"] == pytest.approx(ref_cvb["divergence"],
                                                  rel=1e-12)
        assert 0.0 <= cvb["divergence"] <= 1.0
        assert_close_dict(busy_shares(st), RO.busy_shares(ref_st))


# ---------------------------------------------------------------------------
# what-if projection: the reference's, and within 10% of re-simulation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("net", list(NETS))
def test_projections_match_the_reference(traces_all, net):
    ref_tr, tr = traces_all["resnet50"]
    st = PacketSim(tr, NETS[net][1], record=True).run("static").trace
    ref_st = RSim(ref_tr, NETS[net][0], record=True).run("static").trace
    got, want = project_grid(st, list(KNOBS)), RO.project_grid(
        ref_st, [RO.WhatIf(**k.__dict__) for k in KNOBS])
    for g, w in zip(got, want, strict=True):
        assert g.total_time == pytest.approx(w.total_time, rel=1e-12)
        assert g.speedup == pytest.approx(w.speedup, rel=1e-12)
        assert g.bottleneck == w.bottleneck
        assert g.layer_times.tolist() == pytest.approx(
            w.layer_times.tolist(), rel=1e-12)
        assert g.knobs.describe() == w.knobs.describe()
    assert project(st, KNOBS[0]).speedup >= 1 - 1e-12
    assert project(st, KNOBS[1]).speedup <= 1 + 1e-12


def test_projection_within_10pct_on_every_workload(traces_all):
    """+-25% wireless bandwidth, projected from ONE recorded run,
    matches a from-scratch re-simulation on all paper workloads."""
    for wl, (_, tr) in traces_all.items():
        for scale in (0.75, 1.25):
            v = validate(tr, NET96[1], WhatIf(wireless_scale=scale))
            assert v["error"] <= 0.10, (wl, scale, v)


def test_projection_rebuckets_channels_and_zones(traces_all):
    _, tr = traces_all["resnet50"]
    v_up = validate(tr, NET96[1], WhatIf(n_channels=2, reuse_zones=4))
    v_dn = validate(tr, REUSE[1], WhatIf(n_channels=1, reuse_zones=1))
    assert v_up["error"] <= 0.10 and v_dn["error"] <= 0.10
    with pytest.raises(ValueError, match="dram"):
        validate(tr, NET96[1], WhatIf(dram_scale=2.0))


def test_striped_to_xy_projection_raises(traces_all):
    st = PacketSim(traces_all["zfnet"][1], NET96[1],
                   record=True).run("static").trace
    with pytest.raises(ValueError, match="striping"):
        project(st, WhatIf(link_model="xy"))


# ---------------------------------------------------------------------------
# whatif-guided DSE pruning
# ---------------------------------------------------------------------------

def test_whatif_guided_matches_exhaustive_and_the_reference(traces_all):
    golden = ("zfnet", "resnet50", "gnmt")
    guided = whatif_guided({w: traces_all[w][1] for w in golden})
    exhaustive = P.sweep_all({w: traces_all[w][1] for w in golden})
    want = ref_whatif_guided({w: traces_all[w][0] for w in golden})
    assert guided.points_evaluated < guided.points_exhaustive
    assert (guided.points_evaluated, guided.points_exhaustive) == \
        (want.points_evaluated, want.points_exhaustive)
    best = {(r.workload, r.bandwidth_gbps):
            (r.best_threshold, r.best_injection, r.best_speedup)
            for r in exhaustive}
    for r, w in zip(guided.results, want.results, strict=True):
        bt, bi, bs = best[(r.workload, r.bandwidth_gbps)]
        assert (r.best_threshold, r.best_injection) == (bt, bi)
        assert r.best_speedup == pytest.approx(bs, rel=1e-12)
        assert (r.workload, r.bandwidth_gbps, r.best_threshold,
                r.best_injection) == (w.workload, w.bandwidth_gbps,
                                      w.best_threshold, w.best_injection)
        assert r.best_speedup == pytest.approx(w.best_speedup, rel=1e-12)
        assert r.grid.isnan().numpy().tolist() == \
            [[v != v for v in row] for row in w.grid.tolist()]
    assert_close_dict(guided.projected_best, want.projected_best)
    assert {k: v for k, v in guided.provenance.items()
            if k != "wall_time_s"} == \
        {k: v for k, v in want.provenance.items() if k != "wall_time_s"}


# ---------------------------------------------------------------------------
# degenerate traces, marking, export
# ---------------------------------------------------------------------------

def test_empty_trace_conventions():
    st = SimTrace(label="empty")
    cp = critical_path(st)
    assert cp.segments == [] and cp.makespan == 0.0
    assert cp.critical_shares() == {} and busy_shares(st) == {}
    assert critical_vs_busy(st)["divergence"] == 0.0
    proj = project(st, WhatIf(wireless_scale=2.0))
    assert proj.total_time == 0.0 and proj.speedup == 1.0


def test_mark_critical_exports_distinct_track(traces_all):
    ref_tr, tr = traces_all["zfnet"]
    st = PacketSim(tr, REUSE[1], record=True).run("static").trace
    cp = mark_critical(st)
    events = chrome_trace_events(st)["traceEvents"]
    mirrors = [e for e in events if e.get("cat") == "critpath"]
    assert len(mirrors) == sum(1 for ev in st.events
                               if ev.args.get("critical"))
    assert len(mirrors) >= len([s for s in cp.segments if s.eid >= 0]) > 0
    crit_pids = {e["pid"] for e in mirrors}
    other_pids = {e["pid"] for e in events
                  if e.get("ph") == "X" and e.get("cat") != "critpath"}
    assert len(crit_pids) == 1 and not (crit_pids & other_pids)
    ref_st = RSim(ref_tr, REUSE[0], record=True).run("static").trace
    RO.mark_critical(ref_st)
    assert events == RO.chrome_trace_events(ref_st)["traceEvents"]


def test_whatif_cli_runs_on_the_cpu(tmp_path, capsys):
    """`python -m repro_torch.launch.whatif --quick --device cpu`: the
    critical path, the projections with their re-simulation errors,
    and a Perfetto JSON with a "critpath" process."""
    import json

    from repro_torch.launch import whatif

    assert whatif.main(["--quick", "--device", "cpu",
                        "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    for section in ("critical segments", "divergence", "wl x2",
                    "2ch x4reuse", "re-sim err", "dram x2",
                    "no network re-sim"):
        assert section in out, section
    with open(tmp_path / "zfnet_critpath.json") as f:
        procs = {e["args"]["name"] for e in json.load(f)["traceEvents"]
                 if e.get("name") == "process_name"}
    assert any(p.endswith("critpath") for p in procs), procs
