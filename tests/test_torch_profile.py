"""The port's phase profiler (`repro_torch.obs.profile`) against the JAX
package's, on the CPU: structural zero cost, nesting and attribution,
coverage of the instrumented hot paths, span integration, and the
"framework" Perfetto process.

A profile of the port and one of the reference line up phase for
phase: the same paths with the same call counts, for a `sweep_all`, a
`PacketSim` run and an `anneal` (whose ``arch.evaluate`` count is its
distinct evaluations).  Mirrors `tests/test_profile.py`.
"""

import numpy as np
import pytest
import torch

import repro.arch as RA
import repro.core as R
import repro.obs as RO
from repro.sim import PacketSim as RSim
from repro_torch import arch as PA
from repro_torch import core as P
from repro_torch.obs import (MetricsRegistry, chrome_trace_events, phase,
                             profile_report, profiling)
from repro_torch.obs import profile as profile_mod
from repro_torch.sim import PacketSim

from _torch_event import NET96


@pytest.fixture(scope="module")
def zfnet():
    return R.make_trace("zfnet"), P.make_trace("zfnet", device="cpu")


def calls(prof):
    return {p: a["calls"] for p, a in prof.aggregate().items()}


# ---------------------------------------------------------------------------
# core mechanics
# ---------------------------------------------------------------------------

def test_nested_phases_paths_parents_and_self_time():
    with profiling() as prof:
        with phase("outer"):
            with phase("inner"):
                pass
            with phase("inner"):
                pass
        with phase("outer2"):
            pass
    assert [r.path for r in prof.records] == ["outer/inner", "outer/inner",
                                              "outer", "outer2"]
    assert [r.depth for r in prof.records] == [1, 1, 0, 0]
    agg = prof.aggregate()
    assert agg["outer/inner"]["calls"] == 2 and agg["outer"]["calls"] == 1
    assert 0.0 <= agg["outer"]["self_s"] <= agg["outer"]["total_s"]
    assert agg["outer"]["self_s"] == pytest.approx(
        agg["outer"]["total_s"] - agg["outer/inner"]["total_s"])


def test_phase_error_outcome_and_unwind():
    with profiling() as prof:
        with pytest.raises(RuntimeError):
            with phase("outer"):
                with phase("bad"):
                    raise RuntimeError("boom")
        with phase("after"):
            pass
    by_path = {r.path: r for r in prof.records}
    assert by_path["outer/bad"].outcome == "error"
    assert by_path["outer"].outcome == "error"
    assert by_path["after"].outcome == "ok"
    assert prof._open == []
    assert prof.aggregate()["outer/bad"]["errors"] == 1


def test_note_ndarray_counts_tensors_and_arrays_and_propagates():
    a = torch.zeros(1000, dtype=torch.float64)      # 8000 bytes
    b = np.zeros(10)
    with profiling() as prof:
        with phase("outer"):
            profile_mod.note_ndarray(b)
            with phase("inner"):
                profile_mod.note_ndarray(a, b, None)
    by_path = {r.path: r for r in prof.records}
    assert by_path["outer/inner"].peak_bytes == a.nbytes + b.nbytes
    assert by_path["outer"].peak_bytes == a.nbytes + b.nbytes
    with phase("ignored"):
        profile_mod.note_ndarray(a)
    assert profile_mod.active_profiler() is None


def test_disabled_profiling_is_structurally_zero_cost(monkeypatch, zfnet):
    """With no profiler installed the hot paths never construct a
    `PhaseRecord` — nor a `PhaseProfiler` — the SimTrace pin, applied to
    self-profiling."""
    def boom(*a, **k):
        raise AssertionError("profiler object built while disabled")

    monkeypatch.setattr(profile_mod, "PhaseRecord", boom)
    monkeypatch.setattr(profile_mod, "PhaseProfiler", boom)
    _, tr = zfnet
    P.sweep_all({"zfnet": tr.to(tr.device)})       # dse + net.batched
    PacketSim(tr, NET96[1]).run("greedy")          # sim engine
    PA.anneal(PA.PlacementProblem("zfnet", net=NET96[1], device="cpu"),
              steps=3, seed=0)                     # arch
    with pytest.raises(AssertionError):
        with profiling():
            pass


def test_profiling_does_not_perturb_results(zfnet):
    _, tr = zfnet
    plain = P.sweep_all({"zfnet": tr.to(tr.device)})
    t_plain = PacketSim(tr, NET96[1]).run("greedy").total_time
    with profiling():
        profiled = P.sweep_all({"zfnet": tr.to(tr.device)})
        t_prof = PacketSim(tr, NET96[1]).run("greedy").total_time
    assert t_prof == t_plain
    for a, b in zip(plain, profiled):
        assert torch.equal(a.grid, b.grid)


# ---------------------------------------------------------------------------
# span integration
# ---------------------------------------------------------------------------

def test_span_opens_a_profiler_phase_and_records_errors():
    reg = MetricsRegistry()
    with profiling() as prof:
        with reg.span("work", stage="x"):
            pass
    assert [r.path for r in prof.records] == ["work"]
    with pytest.raises(ValueError):
        with reg.span("work", stage="x") as t:
            raise ValueError("boom")
    labels = [m["labels"] for m in reg.report()["work"]]
    assert {"outcome": "error", "stage": "x"} in labels
    assert {"stage": "x"} in labels
    assert t["seconds"] > 0.0


# ---------------------------------------------------------------------------
# the reference's phases, call for call; coverage
# ---------------------------------------------------------------------------

def test_phase_paths_and_calls_match_the_reference(zfnet):
    """A `sweep_all`, a greedy and a static `PacketSim` run and an
    `anneal`: the same phase paths with the same call counts in both
    packages, and ``arch.evaluate`` once per distinct evaluation."""
    ref_tr, tr = zfnet
    prob = PA.PlacementProblem("zfnet", net=NET96[1], device="cpu")
    with profiling() as prof:
        P.sweep_all({"zfnet": tr.to(tr.device)})
        PacketSim(tr, NET96[1]).run("greedy")
        PacketSim(tr, NET96[1]).run("static")
        PA.anneal(prob, steps=20, seed=0)
    ref_prob = RA.PlacementProblem("zfnet", net=NET96[0])
    with RO.profiling() as ref_prof:
        R.sweep_all({"zfnet": R.make_trace("zfnet")})
        RSim(ref_tr, NET96[0]).run("greedy")
        RSim(ref_tr, NET96[0]).run("static")
        RA.anneal(ref_prob, steps=20, seed=0)
    got = calls(prof)
    assert got == calls(ref_prof)
    evals = [p for p in got if p.endswith("arch.evaluate")]
    assert evals == ["arch.anneal/arch.evaluate"]
    assert got[evals[0]] == prob.evaluations == ref_prob.evaluations
    assert prof.coverage() >= 0.9, profile_report(prof)


def test_coverage_sweep_all_and_packetsim_run():
    """>= 0.9 of the wall in named phases, over calls long enough (tens
    of ms here) that a busy host's stall between phases stays a small
    share."""
    traces = {w: P.make_trace(w, device="cpu")
              for w in ("zfnet", "resnet50", "vgg", "googlenet")}
    with profiling() as prof:
        P.sweep_all(traces)
    assert prof.coverage() >= 0.9, profile_report(prof)
    with profiling() as prof:
        PacketSim(traces["resnet50"], NET96[1]).run("greedy")
    assert prof.coverage() >= 0.9, profile_report(prof)


# ---------------------------------------------------------------------------
# report + export
# ---------------------------------------------------------------------------

def test_profile_report_to_trace_and_framework_process(zfnet):
    _, tr = zfnet
    res = PacketSim(tr, NET96[1], record=True).run("static")
    with profiling() as prof:
        with phase("alpha"):
            with phase("beta"):
                profile_mod.note_ndarray(np.zeros(100))
        PacketSim(tr, NET96[1]).run("static")
    txt = profile_report(prof)
    assert "alpha/beta" in txt and "attributed" in txt and "% of" in txt
    st = prof.to_trace()
    assert st.meta["kind"] == "profile"
    assert 0.0 < st.meta["coverage"] <= 1.0
    assert st.meta["wall_s"] == prof.wall_s
    merged = chrome_trace_events({"sim": res.trace, "profile": st})
    procs = {e["pid"]: e["args"]["name"] for e in merged["traceEvents"]
             if e.get("name") == "process_name"}
    fw_pids = {p for p, n in procs.items() if "framework" in n}
    assert fw_pids and not fw_pids & {p for p, n in procs.items()
                                      if "framework" not in n}
    fw_events = [e for e in merged["traceEvents"]
                 if e.get("cat") == "framework" and e.get("ph") == "X"]
    assert fw_events and all(e["pid"] in fw_pids for e in fw_events)
    assert all("path" in e["args"] for e in fw_events)


def test_obs_plane_phase_runs_on_the_cpu():
    """`launch/obs_plane.run` (`chip_smoke.py` phase 13) on the CPU
    against itself, one co-design cell cut to 20 steps: no failure, and
    a JSON-serialisable report."""
    import json

    from repro_torch.launch.obs_plane import run

    out = run("cpu", codesign_cells=(("zfnet", "big_little"),),
              codesign_args=dict(steps=20, restarts=1, n_samples=3))
    assert out["failures"] == []
    assert out["recorded"]["greedy"]["events"] > 0
    assert out["codesign_states_differing"] == 0
    assert out["profile"]["coverage"] >= 0.9
    assert out["guided"]["points_evaluated"] < \
        out["guided"]["points_exhaustive"]
    json.dumps(out)
