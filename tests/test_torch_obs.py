"""The port's observability plane (`repro_torch.obs`) against the JAX
package's (`repro.obs`), on the CPU: the recorder, exports, metrics,
attribution and provenance.

The same traces go through both packages with the recorder on.  The
port's CPU route equals the reference bit for bit (its bin sums add in
the reference's order; the planned route's FIFO ends are the same
segmented cumsum over the same entries), so recorded events — track,
name, category, layer, id, dependencies, begin, duration, arguments —,
metadata and counters must be EQUAL, not close.  The attribution rows
are then equal too.  Mirrors `tests/test_obs.py` (its bench-history and
`--check` tests belong to the reference's `report`, not ported).
"""

import json

import numpy as np
import pytest
import torch

import repro.core as R
import repro.obs as RO
from repro.core.dse import policy_sweep_all as ref_policy_sweep_all
from repro.obs.provenance import config_hash as ref_config_hash
from repro.sim import FixedPolicy as RFixed
from repro.sim import PacketSim as RSim
from repro_torch import core as P
from repro_torch.core.dse import policy_sweep_all
from repro_torch.core.simulator import SimResult, simulate_wired
from repro_torch.obs import (SimTrace, attribution_report,
                             attribution_summary, chrome_trace_events,
                             config_hash, export_npz, format_attribution,
                             load_npz, make_provenance, recording,
                             utilization_timeline)
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.sim import EventResult, FixedPolicy, PacketSim

from _torch_event import NET96, golden_pair

REUSE = (R.NetworkConfig(bandwidth=96e9 / 8,
                         channels=R.ChannelPlan(n_channels=2, reuse_zones=4)),
         P.NetworkConfig(bandwidth=96e9 / 8,
                         channels=P.ChannelPlan(n_channels=2, reuse_zones=4)))
NETS = {"1ch": NET96, "2ch-reuse": REUSE}


@pytest.fixture(scope="module")
def traces():
    return {w: (R.make_trace(w), P.make_trace(w, device="cpu"))
            for w in ("zfnet", "smollm_360m:prefill")}


def events(st):
    return [(e.track, e.name, e.ts, e.dur, e.cat, e.layer, e.args, e.eid,
             e.deps) for e in st.events]


def assert_same_trace(port, ref):
    """A port `SimTrace` against the reference's: equal throughout."""
    assert port.label == ref.label
    assert events(port) == events(ref)
    assert port.meta == ref.meta
    assert port.counters == ref.counters


# ---------------------------------------------------------------------------
# golden hand-trace: exact event timestamps
# ---------------------------------------------------------------------------

def test_golden_wired_and_fixed_event_timestamps():
    """Wired: p0 then p1 FIFO on cut 0 (1 ms each), p2 alone on cut 1;
    [False, True, False]: p1 rides channel 0 for 4 MB / 12 GB/s."""
    ref, port = golden_pair()
    res = PacketSim(port, NET96[1], record=True).run_wired()
    st = res.trace
    assert st.label == "event:wired:striped" and st.meta["policy"] == "wired"
    c0 = [(e.name, e.ts, e.dur) for e in st.events if e.track == "cut0"]
    assert c0 == [("p0", 0.0, pytest.approx(1e-3)),
                  ("p1", pytest.approx(1e-3), pytest.approx(1e-3))]
    assert st.layer_windows() == {0: (0.0, pytest.approx(2e-3))}
    assert res.layer_terms.shape == (1, 5)
    assert_same_trace(st, RSim(ref, NET96[0], record=True).run_wired().trace)
    fixed = PacketSim(port, NET96[1], record=True).run(
        FixedPolicy([False, True, False])).trace
    wl = [ev for ev in fixed.events if ev.cat == "wireless"]
    assert [(e.track, e.name, e.ts) for e in wl] == [("ch0", "p1", 0.0)]
    assert wl[0].dur == pytest.approx(4e6 / (96e9 / 8))
    assert fixed.layer_windows()[0][1] == pytest.approx(1e-3)
    assert_same_trace(fixed, RSim(ref, NET96[0], record=True).run(
        RFixed([False, True, False])).trace)


# ---------------------------------------------------------------------------
# every link model, both networks: the reference's events, and the busy
# invariant against the engine's aggregates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("net", list(NETS))
@pytest.mark.parametrize("link_model", ["striped", "adaptive", "xy"])
@pytest.mark.parametrize("workload", ["zfnet", "smollm_360m:prefill"])
def test_recorded_runs_match_the_reference_and_the_busy_invariant(
        traces, workload, link_model, net):
    ref_tr, tr = traces[workload]
    ref_net, port_net = NETS[net]
    sim = PacketSim(tr, port_net, link_model=link_model, record=True)
    ref_sim = RSim(ref_tr, ref_net, link_model=link_model, record=True)
    for run, ref_run in ((sim.run_wired(), ref_sim.run_wired()),
                         (sim.run("static"), ref_sim.run("static")),
                         (sim.run("greedy"), ref_sim.run("greedy"))):
        st = run.trace
        assert_same_trace(st, ref_run.trace)
        np.testing.assert_array_equal(run.layer_terms.numpy(),
                                      ref_run.layer_terms)
        if link_model == "xy":
            link = st.busy_by_resource("wired", len(run.link_busy), "link")
            np.testing.assert_allclose(link, run.link_busy.numpy(),
                                       rtol=1e-12, atol=0.0)
            wired = np.bincount(sim.cut_of_link.numpy(), weights=link,
                                minlength=sim.n_cuts)
        else:
            wired = st.busy_by_resource("wired", sim.n_cuts, "cut")
        np.testing.assert_allclose(wired, run.cut_busy.numpy(), rtol=1e-12,
                                   atol=0.0)
        np.testing.assert_allclose(
            st.busy_by_resource("wireless", sim.n_channels, "ch"),
            run.channel_busy.numpy(), rtol=1e-12, atol=0.0)
        np.testing.assert_allclose(
            st.busy_by_resource("dram", len(run.dram_busy), "dram"),
            run.dram_busy.numpy(), rtol=1e-12, atol=0.0)


def test_recording_does_not_change_results(traces):
    _, tr = traces["zfnet"]
    for policy in ("static", "greedy"):
        off = PacketSim(tr, REUSE[1]).run(policy)
        on = PacketSim(tr, REUSE[1], record=True).run(policy)
        assert off.trace is None and on.trace is not None
        assert off.layer_terms is None
        assert off.total_time == on.total_time
        assert torch.equal(off.layer_times, on.layer_times)
        assert torch.equal(off.injected, on.injected)


def test_disabled_mode_is_structurally_zero_cost(monkeypatch):
    """record=False never constructs a SimTrace (the port's class
    patched to raise); the analytic engines with no recorder installed
    neither."""
    from repro_torch.sim import engine

    def boom(*a, **k):
        raise AssertionError("SimTrace built with record=False")

    monkeypatch.setattr(engine.obs_trace, "SimTrace", boom)
    _, port = golden_pair()
    sim = PacketSim(port, NET96[1])
    assert sim.run("greedy").trace is None
    assert sim.run("static").trace is None
    assert sim.run_wired().trace is None
    P.balance(port, NET96[1])
    P.simulate_hybrid(port, NET96[1])
    with pytest.raises(AssertionError):
        PacketSim(port, NET96[1], record=True).run("greedy")


# ---------------------------------------------------------------------------
# exports
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def recorded(traces):
    return PacketSim(traces["zfnet"][1], REUSE[1], record=True).run("static")


def test_chrome_trace_schema(traces, recorded):
    st_an = SimTrace(label="analytic")
    with recording(st_an):
        simulate_wired(traces["zfnet"][1])
    obj = chrome_trace_events({"event": recorded.trace, "analytic": st_an})
    assert obj["displayTimeUnit"] == "ms"
    assert json.loads(json.dumps(obj)) is not None   # serialisable
    phases = {"M": 0, "X": 0, "C": 0}
    for ev in obj["traceEvents"]:
        phases[ev["ph"]] += 1
        assert isinstance(ev["pid"], int)
        if ev["ph"] == "X":
            assert {"name", "ts", "dur", "tid", "cat", "args"} <= set(ev)
            assert ev["ts"] >= 0.0 and ev["dur"] >= 0.0
        elif ev["ph"] == "M":
            assert ev["name"] in ("process_name", "thread_name",
                                  "process_sort_index")
        else:
            assert "value" in ev["args"]
    assert phases["X"] > 0 and phases["M"] > 0 and phases["C"] > 0
    an_pids = {ev["pid"] for ev in obj["traceEvents"]
               if ev.get("cat", "").startswith("an:")}
    ev_pids = {ev["pid"] for ev in obj["traceEvents"]
               if ev.get("cat", "") in ("wired", "wireless", "dram")}
    assert not (an_pids & ev_pids)
    # the same object as the reference's exporter makes of its traces
    ref_an = RO.SimTrace(label="analytic")
    with RO.recording(ref_an):
        R.simulate_wired(traces["zfnet"][0])
    ref_ev = RSim(traces["zfnet"][0], REUSE[0], record=True).run("static")
    assert obj == RO.chrome_trace_events({"event": ref_ev.trace,
                                          "analytic": ref_an})


def test_npz_round_trip_is_lossless(tmp_path, recorded):
    st = recorded.trace
    path = tmp_path / "trace.npz"
    export_npz(st, str(path))
    back = load_npz(str(path))
    assert back.label == st.label and back.meta == st.meta
    assert [e.__dict__ for e in back.events] == \
        [e.__dict__ for e in st.events]
    assert back.counters == st.counters
    # the reference's reader reads the port's file to the same trace
    assert events(RO.load_npz(str(path))) == events(st)


def test_npz_string_labels_round_trip(tmp_path):
    st = SimTrace(label="unicode-λ:trace")
    st.add("ch0/z3", "p1,αβ", 0.0, 1e-3, "wireless", layer=0, note="x;y")
    st.add("dram(pooled)", "span", 0.0, 2e-3, "an:dram-agg", layer=0)
    st.add_counter("util/ch0 λ", 0.0, 0.5)
    path = tmp_path / "t.npz"
    export_npz(st, str(path))
    back = load_npz(str(path))
    assert back.label == "unicode-λ:trace"
    assert [(type(e.track), type(e.name), type(e.cat))
            for e in back.events] == [(str, str, str)] * 2
    assert back.__dict__ == st.__dict__


def _tiny_trace(cls, label, dur):
    st = cls(label=label)
    st.add("cut0", "p0", 0.0, dur, "wired", layer=0)
    st.add("compute", "span", 0.0, dur, "compute", layer=0)
    st.add_counter("queue/cut0", 0.0, 1.0)
    st.add_counter("queue/cut0", dur, 0.0)
    return st


def test_merge_keeps_colliding_tracks_separate():
    from repro_torch.obs.export import _PID_STRIDE
    obj = chrome_trace_events({"a": _tiny_trace(SimTrace, "a", 1e-3),
                               "b": _tiny_trace(SimTrace, "b", 2e-3)})
    evs = obj["traceEvents"]
    xs = [e for e in evs if e["ph"] == "X"]
    a_pids = {e["pid"] for e in xs if e["pid"] < _PID_STRIDE}
    b_pids = {e["pid"] for e in xs if e["pid"] >= _PID_STRIDE}
    assert a_pids and b_pids and not (a_pids & b_pids)
    assert {p + _PID_STRIDE for p in a_pids} == b_pids
    assert obj == RO.chrome_trace_events(
        {"a": _tiny_trace(RO.SimTrace, "a", 1e-3),
         "b": _tiny_trace(RO.SimTrace, "b", 2e-3)})


# ---------------------------------------------------------------------------
# degenerate convention, attribution, timelines, counters
# ---------------------------------------------------------------------------

def test_zero_time_bottleneck_share_is_empty():
    z = torch.zeros(0, dtype=torch.float64)
    ev = EventResult(
        total_time=0.0, layer_times=z, layer_finish=z, bottleneck=[],
        injected=torch.zeros(0, dtype=torch.bool), wireless_bytes=0.0,
        wireless_energy_j=0.0, energy_j=0.0, cut_busy=torch.zeros(2),
        channel_busy=torch.zeros(1), dram_busy=torch.zeros(1),
        link_busy=None, policy="static", link_model="striped",
        dram_model="pooled")
    assert ev.bottleneck_share() == {}
    assert SimResult(0.0, z, []).bottleneck_share() == {}
    assert attribution_report(SimTrace()) == []
    assert format_attribution([]) == "(empty trace)"
    with pytest.raises(ValueError, match="record=True"):
        attribution_report(ev)


def test_attribution_golden_wired():
    ref, port = golden_pair()
    res = PacketSim(port, NET96[1], record=True).run_wired()
    rows = {r["track"]: r for r in attribution_report(res)}
    c0 = rows["cut0"]
    assert c0["n_events"] == 2 and c0["why"] == "service"
    assert c0["service_s"] == pytest.approx(2e-3)
    assert c0["queue_s"] == pytest.approx(1e-3)
    assert rows["cut1"]["idle_s"] == pytest.approx(1.5e-3)
    summary = attribution_summary(res)
    assert summary["nop"]["share"] == pytest.approx(1.0)
    assert summary["nop"]["track"] == "cut0"
    ref_res = RSim(ref, NET96[0], record=True).run_wired()
    assert attribution_report(res) == RO.attribution_report(ref_res)
    assert summary == RO.attribution_summary(ref_res)


def test_attribution_reuse_quiesce_matches_the_reference(traces):
    ref_tr, tr = traces["smollm_360m:prefill"]
    res = PacketSim(tr, REUSE[1], record=True).run("greedy")
    rows = attribution_report(res)
    zone_rows = [r for r in rows if "/z" in r["track"]]
    assert zone_rows and any(r["quiesce_s"] > 0.0 for r in zone_rows)
    for r in zone_rows:
        assert 0.0 <= r["quiesce_s"] <= r["queue_s"] + 1e-15
    ref_res = RSim(ref_tr, REUSE[0], record=True).run("greedy")
    assert rows == RO.attribution_report(ref_res)
    assert attribution_summary(res) == RO.attribution_summary(ref_res)
    assert format_attribution(rows) == RO.format_attribution(rows)


def test_utilization_timeline_and_counters_golden():
    ref, port = golden_pair()
    st = PacketSim(port, NET96[1], record=True).run_wired().trace
    edges, util = utilization_timeline(st, "wired", n_bins=4)
    assert edges[-1] == pytest.approx(2e-3)
    np.testing.assert_allclose(util["cut0"], [1, 1, 1, 1])
    np.testing.assert_allclose(util["cut1"], [1, 0, 0, 0])
    q = dict(st.counters)["q:wired"]
    assert q[0] == (0.0, 3.0) and q[-1][1] == 0.0
    assert any(t.startswith("util:cut") for t in st.counters)
    ref_st = RSim(ref, NET96[0], record=True).run_wired().trace
    ref_edges, ref_util = RO.utilization_timeline(ref_st, "wired", n_bins=4)
    np.testing.assert_array_equal(edges, ref_edges)
    assert util.keys() == ref_util.keys()
    for k in util:
        np.testing.assert_array_equal(util[k], ref_util[k])


# ---------------------------------------------------------------------------
# analytic plane recording
# ---------------------------------------------------------------------------

def test_analytic_recorder_layer_windows(traces):
    ref_tr, tr = traces["zfnet"]
    st = SimTrace(label="analytic")
    with recording(st):
        res = simulate_wired(tr)
    windows = st.layer_windows()
    assert len(windows) == tr.n_layers
    assert sum(w[1] for w in windows.values()) == pytest.approx(
        res.total_time)
    assert st.tracks("an:compute") == ["compute"]
    ref_st = RO.SimTrace(label="analytic")
    with RO.recording(ref_st):
        R.simulate_wired(ref_tr)
    assert_same_trace(st, ref_st)


@pytest.mark.parametrize("net", list(NETS))
def test_balancer_emits_one_timeline(traces, net):
    """Trial evaluations are masked: one span per layer and one stitch
    decision per layer, the reference's events."""
    ref_tr, tr = traces["zfnet"]
    st = SimTrace(label="balancer")
    with recording(st):
        bal = P.balance(tr, NETS[net][1])
    layer_spans = [ev for ev in st.events if ev.cat == "layer"]
    decisions = [ev for ev in st.events if ev.track == "balance"]
    assert len(layer_spans) == len(decisions) == tr.n_layers
    assert {"t_grid", "t_greedy"} <= set(decisions[0].args)
    assert sum(w[1] for w in st.layer_windows().values()) == pytest.approx(
        bal.sim.total_time)
    ref_st = RO.SimTrace(label="balancer")
    with RO.recording(ref_st):
        R.balance(ref_tr, NETS[net][0])
    assert_same_trace(st, ref_st)


def test_recording_none_masks_outer_recorder():
    _, port = golden_pair()
    st = SimTrace()
    with recording(st), recording(None):
        simulate_wired(port)
        P.simulate_hybrid(port, NET96[1])
    assert len(st) == 0


def test_add_layer_matrix_takes_a_tensor():
    """A tensor goes to the host once and records as its array does."""
    mat = np.array([[0.0, 1e-3], [2e-3, 0.0]])
    a, b = SimTrace(), SimTrace()
    a.add_layer_matrix(torch.from_numpy(mat), "cut{}", "an:wired")
    b.add_layer_matrix(mat, "cut{}", "an:wired")
    a.place_layers(torch.tensor([1e-3, 2e-3], dtype=torch.float64))
    b.place_layers(np.array([1e-3, 2e-3]))
    assert events(a) == events(b) and a.meta == b.meta


# ---------------------------------------------------------------------------
# metrics registry + logger
# ---------------------------------------------------------------------------

def test_metrics_registry_kinds_and_report():
    reg = MetricsRegistry()
    reg.counter("hits", route="a").inc()
    reg.counter("hits", route="a").inc(2.0)
    reg.gauge("depth").set(7)
    reg.histogram("lat").observe(0.25)
    with reg.span("work", stage="x") as t:
        pass
    assert t["seconds"] >= 0.0
    rep = reg.report()
    assert rep["hits"][0]["value"] == 3.0
    assert rep["depth"][0]["value"] == 7.0
    assert rep["lat"][0]["count"] == 1
    assert rep["work"][0]["labels"] == {"stage": "x"}
    with pytest.raises(ValueError):
        reg.gauge("hits", route="a")
    reg.reset()
    assert reg.report() == {}


def test_metrics_logger(capsys):
    reg = MetricsRegistry()
    log = reg.logger("driver")
    log.info("step done", step=3, loss=1.5)
    log.warning("slow")
    out = capsys.readouterr().out
    assert "step done step=3 loss=1.5" in out
    assert "WARNING: slow" in out
    rep = reg.report()
    levels = {tuple(sorted(m["labels"].items())): m["value"]
              for m in rep["log.messages"]}
    assert levels[(("level", "info"), ("logger", "driver"))] == 1.0
    assert rep["driver.step"][0]["value"] == 3.0


# ---------------------------------------------------------------------------
# provenance
# ---------------------------------------------------------------------------

def test_config_hash_equals_the_reference():
    """The port's configs hash as the reference's; a tensor as an
    ndarray of its dtype and values."""
    cfg = {"net": NET96[1], "grid": torch.arange(4), "k": (1, 2),
           "mask": torch.tensor([True, False]), "f": np.float64(0.5)}
    ref_cfg = {"net": NET96[0], "grid": np.arange(4), "k": (1, 2),
               "mask": np.array([True, False]), "f": np.float64(0.5)}
    h = config_hash(cfg)
    assert h == config_hash(cfg) == ref_config_hash(ref_cfg)
    assert len(h) == 16 and config_hash({**cfg, "k": (1, 3)}) != h
    for port, ref in ((REUSE[1], REUSE[0]),
                      (P.AcceleratorConfig(), R.AcceleratorConfig()),
                      (P.MacConfig("tdma"), R.MacConfig("tdma"))):
        assert config_hash(port) == ref_config_hash(ref)


def test_provenance_stamped_on_sweeps_as_the_reference(traces):
    """Every sweep's provenance has the reference's keys, kind, hash and
    points (its wall time is not compared)."""
    def strip(prov):
        assert prov["wall_time_s"] > 0.0
        return {k: v for k, v in prov.items() if k != "wall_time_s"}

    ref, port = golden_pair()
    (r,) = policy_sweep_all({"golden": port}, NET96[1], policies=("static",))
    (w,) = ref_policy_sweep_all({"golden": ref}, NET96[0],
                                policies=("static",))
    assert r.provenance["kind"] == "dse.policy_sweep_all"
    assert r.provenance["points_evaluated"] == 2   # static + wired
    assert strip(r.provenance) == strip(w.provenance)
    ref_tr, tr = traces["zfnet"]
    for name, kwargs in (("sweep_all", {}), ("network_sweep_all", {})):
        got = getattr(P, name)({"zfnet": tr}, **kwargs)
        want = getattr(R, name)({"zfnet": ref_tr}, **kwargs)
        assert strip(got[0].provenance) == strip(want[0].provenance), name
        assert all(g.provenance is got[0].provenance for g in got)
    got = P.scaling_sweep(["zfnet"], grids=((4, 4),), device="cpu")
    want = R.scaling_sweep(["zfnet"], grids=((4, 4),))
    assert strip(got[0].provenance) == strip(want[0].provenance)
    assert make_provenance("x", {})["points_evaluated"] == 0


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_trace_inspect_cli_runs_on_the_cpu(tmp_path, capsys):
    """`python -m repro_torch.launch.trace_inspect --quick --device cpu`:
    every section runs; the Perfetto JSON holds both recorded planes,
    the npz reads back, and the printed makespan is the reference's."""
    from repro_torch.launch import trace_inspect

    assert trace_inspect.main(["--quick", "--device", "cpu",
                               "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    for section in ("recorder on", "busy-time invariant", "OK",
                    "analytic balancer", "== attribution", "queueing",
                    "== bottleneck summary", "metrics report"):
        assert section in out, section
    with open(tmp_path / "zfnet_trace.json") as f:
        procs = {e["args"]["name"] for e in json.load(f)["traceEvents"]
                 if e.get("name") == "process_name"}
    assert {"event: wireless", "analytic: layer"} <= procs
    back = load_npz(str(tmp_path / "zfnet_trace.npz"))
    want = RSim(R.make_trace("zfnet"), REUSE[0], record=True).run("greedy")
    assert events(back) == events(want.trace)
    assert f"({want.total_time!r} s)" in out
