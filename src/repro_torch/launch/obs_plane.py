"""The observability plane (`obs`) and the heterogeneous-package plane
(`arch`) on a device, timed, and held to the port's own CPU route of
every call.

    PYTHONPATH=src python -m repro_torch.launch.obs_plane [--device cuda]

On ``device`` (the card by default) it runs:

- a recorded greedy `PacketSim` run on smollm_360m:prefill at 96 Gb/s
  with 2 channels x 4 reuse zones (`launch/trace_inspect.py`'s
  configuration), and a recorded static (planned) run of the same: the
  events (track, name, category, layer, id, dependencies) equal the CPU
  route's, their times within ``RTOL`` (and ``RTOL`` of the makespan),
  the busy invariant at 1e-12 on each route, the attribution rows
  within ``RTOL`` (and ``RTOL`` of the makespan: a resource's idle time
  may be zero on one route and 4e-19 s on the other), and the Chrome
  and npz exports written to a temporary directory and read back;
- the critical path of the card's traces, which must sum to the
  makespan at 1e-12;
- `validate` on zfnet at ``wireless_scale`` 0.75 and 1.25, within 10%
  on each route and within ``RTOL`` of each other;
- `whatif_guided` on zfnet, resnet50 and gnmt: each band's best point
  is `sweep_all`'s (under the tie rule of `launch/paper_plane.py`) with
  fewer points evaluated, and the card's result the CPU route's;
- a profiled `sweep_all` of the 15 paper traces (coverage at least
  0.90), and the host syncs of an unprofiled, unrecorded `sweep_all` of
  the largest (torch's sync debug mode), which must equal
  ``expect_syncs`` where given (phase 11's count of the same call);
- `codesign` at `hetero_sweep`'s defaults (150 steps, 1 restart, 8
  samples) on four cells: each cell's chosen states, makespans,
  spreads and evaluation counts against the CPU route's.  A state may
  differ only under the tie rule (the CPU route's cost of the card's
  state within ``RTOL`` of its own best): the count of such states is
  reported, as the annealer's Metropolis test compares costs whose last
  bits may differ between the routes.  Each cell's wall time is taken
  on both routes; on the card `torch.profiler` counts the device
  operations, busy time and idle share of one `PlacementProblem
  .evaluate`, and torch's sync debug mode its host syncs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import Dict, List

import numpy as np
import torch

from ..arch import PlacementProblem, codesign, greedy_seed
from ..core import ChannelPlan, NetworkConfig, make_trace, sweep_all
from ..core.dse import INJECTIONS, THRESHOLDS, whatif_guided
from ..core.units import gbps_to_bytes_per_s
from ..core.workloads import WORKLOADS
from ..obs import (WhatIf, attribution_report, chrome_trace_events,
                   critical_path, export_chrome_trace, export_npz, load_npz,
                   profiling, validate)
from ..sim import PacketSim
from .paper_plane import CPU, _fresh, _host_syncs, _timed, close
from .profile import _trace

RTOL = 1e-9
CRIT_RTOL = 1e-12          # the critical path's telescoping sum
BUSY_RTOL = 1e-12          # the trace's busy against the engine's
VALIDATE_ERR = 0.10        # tests/test_critpath.py's bound
COVERAGE = 0.90
RECORD_WORKLOAD = "smollm_360m:prefill"
RECORD_NET = NetworkConfig(bandwidth=gbps_to_bytes_per_s(96),
                           channels=ChannelPlan(n_channels=2, reuse_zones=4))
NET96 = NetworkConfig(bandwidth=gbps_to_bytes_per_s(96))
GUIDED_WORKLOADS = ("zfnet", "resnet50", "gnmt")
CODESIGN_CELLS = (("zfnet", "big_little"), ("lstm", "compute_mem"),
                  ("gnmt", "aimc_edge"), ("googlenet", "big_little"))
CODESIGN_ARGS = dict(steps=150, restarts=1, n_samples=8)  # hetero_sweep's


# ---------------------------------------------------------------------------
# recorded runs
# ---------------------------------------------------------------------------

def compare_traces(a, b, what: str) -> List[str]:
    """Two recorded `SimTrace`s of one run on two routes: the same events
    in the same order with the same dependencies; times, durations and
    numeric arguments within ``RTOL`` (and ``RTOL`` of the makespan)."""
    if len(a.events) != len(b.events):
        return [f"{what}: {len(a.events)} vs {len(b.events)} events"]
    atol = RTOL * b.meta.get("total_time", 0.0)
    bad = []
    for x, y in zip(a.events, b.events):
        if (x.track, x.name, x.cat, x.layer, x.eid, x.deps) != \
                (y.track, y.name, y.cat, y.layer, y.eid, y.deps):
            bad.append(f"{what}: event {y.eid} {x.track}/{x.name} vs "
                       f"{y.track}/{y.name}")
        elif not (close(x.ts, y.ts, RTOL, atol)
                  and close(x.dur, y.dur, RTOL, atol)):
            bad.append(f"{what}: event {y.eid} at {x.ts!r}+{x.dur!r} vs "
                       f"{y.ts!r}+{y.dur!r}")
        elif x.args.keys() != y.args.keys() or not all(
                close(v, y.args[k], RTOL, atol) if isinstance(v, float)
                else v == y.args[k] for k, v in x.args.items()):
            bad.append(f"{what}: event {y.eid} args {x.args} vs {y.args}")
        if len(bad) >= 5:
            break
    if a.meta.keys() != b.meta.keys():
        bad.append(f"{what}: meta keys differ")
    if a.counters.keys() != b.counters.keys() or any(
            len(a.counters[k]) != len(v) for k, v in b.counters.items()):
        bad.append(f"{what}: counter tracks differ")
    return bad


def busy_invariant(res, sim, what: str) -> List[str]:
    """Per-resource trace busy against the engine's aggregates, 1e-12."""
    st = res.trace
    pairs = [("cut_busy", st.busy_by_resource("wired", sim.n_cuts, "cut")),
             ("channel_busy", st.busy_by_resource(
                 "wireless", sim.n_channels, "ch")),
             ("dram_busy", st.busy_by_resource("dram", sim.n_dram, "dram"))]
    if res.link_busy is not None:
        link = st.busy_by_resource("wired", len(res.link_busy), "link")
        pairs[0] = ("cut_busy", np.bincount(
            sim.cut_of_link.cpu().numpy(), weights=link,
            minlength=sim.n_cuts))
        pairs.append(("link_busy", link))
    bad = []
    for name, got in pairs:
        want = getattr(res, name).cpu().numpy()
        if not np.allclose(got, want, rtol=BUSY_RTOL, atol=0.0):
            bad.append(f"{what}: trace busy differs from {name}")
    return bad


def compare_attribution(a: List[dict], b: List[dict], atol: float,
                        what: str) -> List[str]:
    """Two routes' attribution rows: equal labels and counts, seconds
    within ``RTOL`` and ``atol``."""
    if len(a) != len(b):
        return [f"{what}: {len(a)} vs {len(b)} attribution rows"]
    for x, y in zip(a, b):
        for k, v in y.items():
            ok = (close(x[k], v, RTOL, atol) if isinstance(v, float)
                  else x[k] == v)
            if not ok:
                return [f"{what}: attribution {y['layer']} {y['track']} "
                        f"{k} {x[k]!r} vs {v!r}"]
    return []


def export_round_trip(st, what: str) -> List[str]:
    """Chrome JSON and npz written to a temporary directory, read back."""
    bad = []
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        export_chrome_trace(st, path)
        with open(path) as f:
            obj = json.load(f)
        phases = {e["ph"] for e in obj["traceEvents"]}
        if not {"M", "X", "C"} <= phases:
            bad.append(f"{what}: Chrome trace phases {sorted(phases)}")
        n_x = sum(e["ph"] == "X" and e.get("cat") != "critpath"
                  for e in obj["traceEvents"])
        if n_x != len(st.events):
            bad.append(f"{what}: {n_x} Chrome events for {len(st.events)}")
        path = os.path.join(d, "trace.npz")
        export_npz(st, path)
        back = load_npz(path)
        if not (back.label == st.label and back.meta == st.meta
                and back.counters == st.counters
                and [e.__dict__ for e in back.events]
                == [e.__dict__ for e in st.events]):
            bad.append(f"{what}: the npz round trip is not lossless")
    return bad


def recorded_checks(trace, trace_cpu) -> tuple:
    """The recorded greedy and static runs on both routes:
    ``(failures, summary)``."""
    bad, out = [], {}
    for policy in ("greedy", "static"):
        what = f"recorded {policy}"
        sim = PacketSim(trace, RECORD_NET, record=True)
        sim_cpu = PacketSim(trace_cpu, RECORD_NET, record=True)
        res, res_cpu = sim.run(policy), sim_cpu.run(policy)
        bad += compare_traces(res.trace, res_cpu.trace, what)
        bad += busy_invariant(res, sim, what + " (device)")
        bad += busy_invariant(res_cpu, sim_cpu, what + " (cpu)")
        bad += compare_attribution(attribution_report(res),
                                   attribution_report(res_cpu),
                                   RTOL * res_cpu.total_time, what)
        bad += export_round_trip(res.trace, what)
        cp = critical_path(res.trace)
        if not (close(cp.makespan, res.total_time, CRIT_RTOL)
                and close(cp.total, cp.makespan, CRIT_RTOL)):
            bad.append(f"{what}: critical path {cp.total!r} for a "
                       f"makespan of {cp.makespan!r} ({res.total_time!r})")
        out[policy] = {"events": len(res.trace.events),
                       "tracks": len(res.trace.tracks()),
                       "total_time": res.total_time,
                       "critical_segments": len(cp.segments),
                       "critical_shares": cp.critical_shares()}
    return bad, out


# ---------------------------------------------------------------------------
# what-if
# ---------------------------------------------------------------------------

def validate_checks(trace, trace_cpu) -> tuple:
    bad, out = [], {}
    for scale in (0.75, 1.25):
        k = WhatIf(wireless_scale=scale)
        v, v_cpu = validate(trace, NET96, k), validate(trace_cpu, NET96, k)
        what = f"validate x{scale:g}"
        for key in ("projected", "actual", "base"):
            if not close(v[key], v_cpu[key], RTOL):
                bad.append(f"{what}: {key} {v[key]!r} vs {v_cpu[key]!r}")
        for route, e in (("device", v["error"]), ("cpu", v_cpu["error"])):
            if not e <= VALIDATE_ERR:
                bad.append(f"{what} ({route}): error {e!r} over 10%")
        out[f"x{scale:g}"] = v["error"]
    return bad, out


def _choice_ok(r, ref) -> bool:
    """``r``'s best point is ``ref``'s, or ties it in ``ref``'s grid."""
    if (r.best_threshold, r.best_injection) == (ref.best_threshold,
                                                ref.best_injection):
        return True
    at = float(ref.grid[THRESHOLDS.index(r.best_threshold),
                        INJECTIONS.index(r.best_injection)])
    return close(at, ref.best_speedup, RTOL)


def guided_checks(traces: Dict, traces_cpu: Dict) -> tuple:
    bad = []
    g, g_cpu = whatif_guided(_fresh(traces)), whatif_guided(
        _fresh(traces_cpu))
    full = {(r.workload, r.bandwidth_gbps): r
            for r in sweep_all(_fresh(traces))}
    full_cpu = {(r.workload, r.bandwidth_gbps): r
                for r in sweep_all(_fresh(traces_cpu))}
    for route, res, ref in (("device", g, full), ("cpu", g_cpu, full_cpu)):
        if not res.points_evaluated < res.points_exhaustive:
            bad.append(f"guided ({route}): {res.points_evaluated} of "
                       f"{res.points_exhaustive} points")
        for r in res.results:
            want = ref[(r.workload, r.bandwidth_gbps)]
            if not (close(r.best_speedup, want.best_speedup, RTOL)
                    and _choice_ok(r, want)):
                bad.append(f"guided ({route}) {r.workload}@"
                           f"{r.bandwidth_gbps}: {r.best_speedup!r} at "
                           f"{(r.best_threshold, r.best_injection)} vs "
                           f"sweep_all's {want.best_speedup!r}")
    for r, w in zip(g.results, g_cpu.results, strict=True):
        if not (close(r.best_speedup, w.best_speedup, RTOL)
                and _choice_ok(r, full_cpu[(w.workload,
                                            w.bandwidth_gbps)])):
            bad.append(f"guided {r.workload}@{r.bandwidth_gbps}: device "
                       f"{r.best_speedup!r} vs cpu {w.best_speedup!r}")
    for key, v in g.projected_best.items():
        if not close(v, g_cpu.projected_best[key], RTOL):
            bad.append(f"guided projection {key}: {v!r} vs "
                       f"{g_cpu.projected_best[key]!r}")
    return bad, {"points_evaluated": g.points_evaluated,
                 "points_evaluated_cpu": g_cpu.points_evaluated,
                 "points_exhaustive": g.points_exhaustive,
                 "projected_best": g.projected_best}


# ---------------------------------------------------------------------------
# co-design
# ---------------------------------------------------------------------------

def compare_codesign(a, b, cpu_problem, what: str) -> tuple:
    """A card `CodesignResult` against the CPU route's:
    ``(failures, states that differ)``.  Each differing state must cost
    the CPU route its own best within ``RTOL``."""
    bad, differing = [], 0
    for part in ("greedy", "wired", "hybrid"):
        x, y = getattr(a, part), getattr(b, part)
        if not (close(x.t_wired, y.t_wired, RTOL)
                and close(x.t_hybrid, y.t_hybrid, RTOL)):
            bad.append(f"{what} {part}: makespans {x.t_wired!r}, "
                       f"{x.t_hybrid!r} vs {y.t_wired!r}, {y.t_hybrid!r}")
        if x.state != y.state:
            differing += 1
            at = cpu_problem.cost(x.state, y.objective)
            if not close(at, y.makespan, RTOL):
                bad.append(f"{what} {part}: state {x.state} costs "
                           f"{at!r} on the CPU, not {y.makespan!r}")
    if differing == 0:
        for f in ("spread_wired", "spread_hybrid", "speedup_hybrid",
                  "speedup_codesigned"):
            if not close(getattr(a, f), getattr(b, f), RTOL):
                bad.append(f"{what}: {f} {getattr(a, f)!r} vs "
                           f"{getattr(b, f)!r}")
        if (a.n_evaluations, a.package) != (b.n_evaluations, b.package):
            bad.append(f"{what}: {a.n_evaluations} evaluations of "
                       f"{a.package} vs {b.n_evaluations} of {b.package}")
    return bad, differing


def codesign_checks(device, cells=CODESIGN_CELLS, args=None) -> tuple:
    args = dict(CODESIGN_ARGS if args is None else args)
    bad, out, differing = [], {}, 0
    for wl, mix in cells:
        what = f"codesign {wl}/{mix}"
        a, sec = _timed(lambda: codesign(wl, mix, NET96, device=device,
                                         **args), device)
        b, sec_cpu = _timed(lambda: codesign(wl, mix, NET96, device=CPU,
                                             **args), CPU)
        cpu_problem = PlacementProblem(wl, mix, net=NET96, device=CPU)
        c_bad, c_diff = compare_codesign(a, b, cpu_problem, what)
        bad += c_bad
        differing += c_diff
        out[f"{wl}/{mix}"] = {
            "seconds": sec, "seconds_cpu": sec_cpu,
            "evaluations": a.n_evaluations,
            "evaluations_cpu": b.n_evaluations,
            "states_differing": c_diff, "package": a.package,
            "speedup_codesigned": a.speedup_codesigned,
            "spread_wired": a.spread_wired,
            "spread_hybrid": a.spread_hybrid}
    return bad, out, differing


def evaluate_profile(device, on_card: bool, workload: str = "googlenet",
                     mix: str = "big_little") -> Dict:
    """One distinct `PlacementProblem.evaluate` (the memo cleared each
    call) of the greedy seed: device ops, busy, idle, host ms, syncs."""
    prob = PlacementProblem(workload, mix, net=NET96, device=device)
    state = greedy_seed(prob)

    def one():
        prob._memo.clear()
        return prob.evaluate(state)

    one()
    r = _trace(one, 3, on_card, "evaluate")
    for key in ("kernels_us", "plain_attention_bwd_ms_per_evaluate",
                "plain_attention_bwd_share_of_busy"):
        r.pop(key, None)
    if on_card:
        r["host_syncs_per_evaluate"] = _host_syncs(one)
    r["cell"] = f"{workload}/{mix}"
    return r


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def run(device="cuda", expect_syncs=None, codesign_cells=CODESIGN_CELLS,
        codesign_args=None) -> Dict:
    """Every call of the obs and arch planes on ``device`` and on the CPU.

    Returns ``{"failures": [...], "seconds": {...}, ...}``; an empty
    ``failures`` means every check held."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    secs, bad, out = {}, [], {"device": str(device)}
    if on_card:
        out["device_name"] = torch.cuda.get_device_name(0)

    def once(name, fn, d=device):
        res, sec = _timed(fn, d)
        secs[name] = sec
        return res

    # --- recorded runs, the critical path, exports ---
    rec = make_trace(RECORD_WORKLOAD, device=device)
    r_bad, out["recorded"] = once("recorded_checks", lambda: recorded_checks(
        rec, rec.to(CPU)))
    bad += r_bad

    # --- what-if: validation and the guided sweep ---
    z = make_trace("zfnet", device=device)
    v_bad, out["validate_error"] = once("validate_checks",
                                        lambda: validate_checks(z, z.to(CPU)))
    bad += v_bad
    guided = {w: make_trace(w, device=device) for w in GUIDED_WORKLOADS}
    g_bad, out["guided"] = once("guided_checks", lambda: guided_checks(
        guided, {w: t.to(CPU) for w, t in guided.items()}))
    bad += g_bad

    # --- the profiler: coverage, and no sync while it is off ---
    paper = {w: make_trace(w, device=device) for w in WORKLOADS}
    largest = max(paper, key=lambda w: len(paper[w].nbytes))
    sweep_all(_fresh(paper))
    with profiling() as prof:
        sweep_all(_fresh(paper))
    out["profile"] = {"trace": largest, "coverage": prof.coverage(),
                      "wall_s": prof.wall_s,
                      "phases": {p: a["calls"]
                                 for p, a in prof.aggregate().items()}}
    if not prof.coverage() >= COVERAGE:
        bad.append(f"profiled sweep_all of the {len(paper)} paper traces: "
                   f"coverage {prof.coverage()!r}")
    if on_card:
        syncs = _host_syncs(lambda: sweep_all(_fresh({largest:
                                                      paper[largest]})))
        out["profile"]["host_syncs_sweep_all_one_trace"] = syncs
        if expect_syncs is not None and syncs != expect_syncs:
            bad.append(f"unprofiled sweep_all of {largest}: {syncs} host "
                       f"syncs, phase 11 counted {expect_syncs}")
    fw = chrome_trace_events(prof.to_trace())["traceEvents"]
    if not any(e.get("cat") == "framework" for e in fw):
        bad.append("the profile's Perfetto export has no framework events")

    # --- co-design on four cells, and one evaluation profiled ---
    c_bad, out["codesign"], out["codesign_states_differing"] = once(
        "codesign_checks", lambda: codesign_checks(device, codesign_cells,
                                                   codesign_args))
    bad += c_bad
    out["evaluate_profile"] = evaluate_profile(device, on_card)

    out.update(seconds=secs, failures=bad)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(args.device)
    sys.stdout.write(json.dumps(out, indent=1) + "\n")
    return 1 if out["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
