"""The event-driven packet simulator and the fault plane on a device,
timed, and held to the port's own CPU route of every call.

    PYTHONPATH=src python -m repro_torch.launch.event_plane [--device cuda]

On ``device`` (the card by default) it builds the 15 Table-1 traces on
the paper's 3x3 package, nothing cut, and runs:

- `policy_sweep_all` at 96 Gb/s with all four policies (static, greedy,
  adaptive, oracle), and each policy's `PacketSim` run again for its
  injected mask; adaptive and oracle must reach the static grid's best
  less 1e-9, greedy a speedup of 1;
- `fidelity_report` over the three link models; striped's worst
  speedup error against the analytic model must be at most 1e-9;
- a faulted `PacketSim` on ``fault_workload`` (vgg) under
  `default_scenario(trace, k=1, fade_db=3.0)` plus link failures that
  kill every link of cut 0 from layer 1: the striped and xy models run
  every policy, the adaptive model refuses the faults, and `run_wired`
  is infinite on the dead cut;
- `resilience_sweep_all` on the resilience workloads over
  ``fig_resilience``'s grid (ks 0-2, fades 3 and 9 dB, three
  policies); online-reshard must never be slower than the others;
- `reshard_run` on each resilience workload at every nonzero k of the
  grid and its largest fade: the degraded projection, the rebuild on
  the derated accelerator, the migration, the eras and the recovery
  events must agree between the routes, and the rebuild must run.

Each call runs again on the CPU (on CPU copies of the same traces;
`resilience_sweep_all` builds its own) and the two are held together
within ``RTOL`` under the tie rule: a differing injected mask passes
only where the CPU route's time under the device's mask is within the
tolerance of its own.  `policy_sweep_all` and `fidelity_report` run
``reps`` times on each route, alternating device and CPU, each time on
fresh copies of the traces.  On the card, `torch.profiler` counts the
device operations, busy time and idle share of one planned
`PacketSim.run("static")` on vgg, torch's sync debug mode its host
syncs, and the host clock one greedy online run.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import sys
import time
from typing import Dict, List

import torch

from ..core import NetworkConfig, make_trace
from ..core.dse import policy_sweep_all, resilience_sweep_all
from ..core.units import gbps_to_bytes_per_s, s_to_ms
from ..core.workloads import WORKLOADS
from ..fault import (FaultScenario, LinkFailure, default_scenario,
                     reshard_run)
from ..sim import FixedPolicy, PacketSim, fidelity_report
from .paper_plane import (CPU, REPS, RTOL, _fresh, _host_syncs, _paired,
                          _timed, close)
from .profile import _trace

NET96 = NetworkConfig(bandwidth=gbps_to_bytes_per_s(96))
POLICIES = ("static", "greedy", "adaptive", "oracle")
FAULT_POLICIES = POLICIES + ("online-reshard",)
FAULT_WORKLOAD = "vgg"
RESILIENCE_WORKLOADS = ("zfnet", "smollm_360m:decode")
RESILIENCE_KS = (0, 1, 2)          # fig_resilience's grid
RESILIENCE_FADES = (3.0, 9.0)


def same(a: float, b: float, rtol: float = RTOL) -> bool:
    """`close`, with two infinities of one sign equal."""
    if math.isinf(a) or math.isinf(b):
        return a == b
    return close(a, b, rtol)


def mask_check(dev_res, cpu_res, cpu_sim, what: str) -> List[str]:
    """Two runs' injected masks: equal, or (the tie rule) the device's
    mask costs the CPU route what its own does, within ``RTOL``."""
    a, b = dev_res.injected.cpu(), cpu_res.injected.cpu()
    if torch.equal(a, b):
        return []
    at = cpu_sim.run(FixedPolicy(a)).total_time
    if same(at, cpu_res.total_time):
        return []
    return [f"{what}: masks differ in {int((a != b).sum())} packets and "
            f"the device's costs {at!r} on the CPU, not {cpu_res.total_time!r}"]


def compare_results(a, b, what: str) -> List[str]:
    """Two `EventResult`s' totals, layer times and busies."""
    bad = []
    for f in ("total_time", "wireless_bytes", "wireless_energy_j",
              "energy_j"):
        if not same(getattr(a, f), getattr(b, f)):
            bad.append(f"{what}: {f} {getattr(a, f)!r} vs {getattr(b, f)!r}")
    for f in ("layer_times", "cut_busy", "channel_busy", "dram_busy"):
        x, y = getattr(a, f).cpu(), getattr(b, f).cpu()
        if not torch.allclose(x, y, rtol=RTOL, atol=0.0, equal_nan=True):
            bad.append(f"{what}: {f} differ")
    return bad


def compare_policy_sweeps(a_list, b_list) -> List[str]:
    bad = []
    for a, b in zip(a_list, b_list, strict=True):
        what = f"policy_sweep {a.workload}"
        for f in ("base_time", "grid_best_speedup"):
            if not same(getattr(a, f), getattr(b, f)):
                bad.append(f"{what}: {f} {getattr(a, f)!r} vs "
                           f"{getattr(b, f)!r}")
        for p in a.policy_times:
            if not same(a.policy_times[p], b.policy_times[p]) or not same(
                    a.policy_speedups[p], b.policy_speedups[p]):
                bad.append(f"{what}: {p} {a.policy_times[p]!r} vs "
                           f"{b.policy_times[p]!r}")
    return bad


def policy_bounds(results) -> List[str]:
    """Adaptive and oracle reach the static grid's best; greedy >= 1."""
    bad = []
    for r in results:
        for p in ("adaptive", "oracle"):
            if r.policy_speedups[p] < r.grid_best_speedup - 1e-9:
                bad.append(f"{r.workload}: {p} {r.policy_speedups[p]!r} under "
                           f"the grid's best {r.grid_best_speedup!r}")
        if r.policy_speedups["greedy"] < 1.0:
            bad.append(f"{r.workload}: greedy slows the run down "
                       f"({r.policy_speedups['greedy']!r})")
    return bad


def compare_fidelity(a: Dict, b: Dict) -> List[str]:
    bad = []
    for wl, row in a.items():
        if wl == "_summary":
            continue
        for model, vals in row.items():
            for f, v in vals.items():
                w = b[wl][model][f]
                # a relative error is compared absolutely
                ok = (abs(v - w) <= RTOL if f == "speedup_rel_err"
                      else same(v, w))
                if not ok:
                    bad.append(f"fidelity {wl} {model}: {f} {v!r} vs {w!r}")
    return bad


def cut_killer(trace, at_layer: int = 1) -> FaultScenario:
    """One-way failures of every link of cut 0 from ``at_layer``."""
    cut_mat, _ = trace.cut_matrix()
    cut_of = cut_mat.argmax(dim=1).tolist()
    return FaultScenario(link_failures=tuple(
        LinkFailure(a, b, at_layer=at_layer, both_directions=False)
        for (a, b), li in trace.link_index.items() if cut_of[li] == 0))


def faulted_checks(trace, trace_cpu) -> tuple:
    """The faulted `PacketSim` on both routes: ``(failures, summary)``."""
    bad, out = [], {}
    base = default_scenario(trace, k=1, fade_db=3.0)
    sc = FaultScenario(chip_failures=base.chip_failures,
                       snr_fades=base.snr_fades,
                       link_failures=cut_killer(trace).link_failures)
    out["scenario"] = sc.describe()
    try:
        PacketSim(trace, NET96, link_model="adaptive", faults=sc)
        bad.append("faulted: the adaptive link model took the faults")
    except NotImplementedError:
        out["adaptive_refuses"] = True
    for model in ("striped", "xy"):
        sim = PacketSim(trace, NET96, link_model=model, faults=sc)
        sim_cpu = PacketSim(trace_cpu, NET96, link_model=model, faults=sc)
        wired, wired_cpu = sim.run_wired(), sim_cpu.run_wired()
        if not (math.isinf(wired.total_time)
                and math.isinf(wired_cpu.total_time)):
            bad.append(f"faulted {model}: run_wired {wired.total_time!r} "
                       f"on a dead cut")
        bad += compare_results(wired, wired_cpu, f"faulted {model} wired")
        row = {}
        for p in FAULT_POLICIES:
            res, res_cpu = sim.run(p), sim_cpu.run(p)
            what = f"faulted {model} {p}"
            bad += compare_results(res, res_cpu, what)
            bad += mask_check(res, res_cpu, sim_cpu, what)
            if not math.isfinite(res.total_time):
                bad.append(f"{what}: {res.total_time!r} despite failover")
            row[p] = res.total_time
        out[model] = row
    return bad, out


def compare_resilience(a: Dict, b: Dict) -> List[str]:
    bad = []
    for wl, row in a.items():
        if wl == "provenance":
            continue
        if not same(row["wired_ff"], b[wl]["wired_ff"]):
            bad.append(f"resilience {wl}: wired_ff differ")
        for p, v in row["speedup_ff"].items():
            if not same(v, b[wl]["speedup_ff"][p]):
                bad.append(f"resilience {wl}: speedup_ff {p} differ")
        for cell, pols in row["cells"].items():
            for p, d in pols.items():
                e = b[wl]["cells"][cell][p]
                for f in ("time", "speedup", "retained"):
                    if not same(d[f], e[f]):
                        bad.append(f"resilience {wl} {cell} {p}: {f} "
                                   f"{d[f]!r} vs {e[f]!r}")
                if d["resharded"] != e["resharded"]:
                    bad.append(f"resilience {wl} {cell}: resharded "
                               f"{d['resharded']} vs {e['resharded']}")
    return bad


def reshard_checks(workloads, ks, fade_db: float, device) -> tuple:
    """`reshard_run` on both routes at every nonzero k: the degraded
    projection, the era-stitched rebuild, the migration, the eras and
    the recovery events agree.  ``(failures, summary)``."""
    bad, out = [], {}
    for wl in workloads:
        trace = make_trace(wl, device=CPU)
        for k in ks:
            if k == 0:
                continue
            sc = default_scenario(trace, k=k, fade_db=fade_db)
            a = reshard_run(wl, NET96, sc, device=device)
            b = reshard_run(wl, NET96, sc, device=CPU)
            what = f"reshard {wl} k{k}_fade{fade_db:g}"
            for f in ("total_time", "degraded_time", "resharded_time",
                      "migration_time"):
                if not same(getattr(a, f), getattr(b, f)):
                    bad.append(f"{what}: {f} {getattr(a, f)!r} vs "
                               f"{getattr(b, f)!r}")
            if (a.resharded, a.eras) != (b.resharded, b.eras) or [
                    (e.step, e.kind, e.workers, e.new_mesh) for e in a.events
            ] != [(e.step, e.kind, e.workers, e.new_mesh) for e in b.events]:
                bad.append(f"{what}: eras or events differ")
            if len(a.eras) < 2 or not math.isfinite(a.resharded_time):
                bad.append(f"{what}: the rebuild never ran ({a.eras})")
            out[what] = {"degraded_time": a.degraded_time,
                         "resharded_time": a.resharded_time,
                         "migration_time": a.migration_time,
                         "resharded": a.resharded, "eras": a.eras}
    return bad, out


def reshard_dominates(grid: Dict, route: str) -> List[str]:
    """Online-reshard is never slower than any other policy a cell."""
    bad = []
    for wl, row in grid.items():
        if wl == "provenance":
            continue
        for cell, pols in row["cells"].items():
            t = pols["online-reshard"]["time"]
            for p, d in pols.items():
                if t > d["time"] * (1 + 1e-12):
                    bad.append(f"resilience {wl} {cell} ({route}): "
                               f"online-reshard {t!r} slower than {p} "
                               f"{d['time']!r}")
    return bad


def retained_means(grid: Dict) -> Dict[str, float]:
    by_policy: Dict[str, List[float]] = {}
    for wl, row in grid.items():
        if wl == "provenance":
            continue
        for pols in row["cells"].values():
            for p, d in pols.items():
                by_policy.setdefault(p, []).append(d["retained"])
    return {p: statistics.fmean(v) for p, v in by_policy.items()}


def run(device="cuda", workloads=None,
        resilience_workloads=RESILIENCE_WORKLOADS, ks=RESILIENCE_KS,
        fades=RESILIENCE_FADES, fault_workload=FAULT_WORKLOAD,
        reps: int = REPS) -> Dict:
    """Every call of the event and fault planes on ``device`` and on the
    CPU.  ``fault_workload`` must be one of ``workloads``.
    Returns ``{"failures": [...], "seconds": {...}, ...}``; an
    empty ``failures`` means every check held.  Each entry of
    ``seconds`` is a list: one wall time a run."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    workloads = list(WORKLOADS) if workloads is None else list(workloads)
    secs, bad, out = {}, [], {"device": str(device)}
    if on_card:
        out["device_name"] = torch.cuda.get_device_name(0)

    def paired(name, call, make_dev, make_cpu):
        res, res_cpu, secs[name], secs[name + "_cpu"] = _paired(
            call, make_dev, make_cpu, device, reps)
        return res, res_cpu

    def once(name, fn, d=device):
        res, sec = _timed(fn, d)
        secs[name] = [sec]
        return res

    paper = once("build_paper_traces",
                 lambda: {w: make_trace(w, device=device) for w in workloads})
    paper_cpu = {w: t.to(CPU) for w, t in paper.items()}
    out["packets"] = {w: len(t.nbytes) for w, t in paper.items()}
    small = min(paper, key=lambda w: len(paper[w].nbytes))
    once("first_calls", lambda: policy_sweep_all(_fresh({small:
                                                         paper[small]})))

    # --- the policy sweep: speedups, times, bounds, then the masks ---
    runs, runs_cpu = paired(
        "policy_sweep_all", lambda tr: policy_sweep_all(tr, NET96),
        lambda: _fresh(paper), lambda: _fresh(paper_cpu))
    ps, ps_cpu = runs[0], runs_cpu[0]
    bad += compare_policy_sweeps(ps, ps_cpu)
    bad += policy_bounds(ps) + policy_bounds(ps_cpu)
    out["policy_mean_speedup"] = {
        p: statistics.fmean(r.policy_speedups[p] for r in ps)
        for p in POLICIES}
    out["policy_mean_speedup_cpu"] = {
        p: statistics.fmean(r.policy_speedups[p] for r in ps_cpu)
        for p in POLICIES}
    out["grid_best_mean"] = statistics.fmean(r.grid_best_speedup for r in ps)
    differing = 0
    for w in workloads:
        sim, sim_cpu = PacketSim(paper[w], NET96), PacketSim(paper_cpu[w],
                                                             NET96)
        for p in POLICIES:
            a, b = sim.run(p), sim_cpu.run(p)
            differing += int((a.injected.cpu() != b.injected.cpu()).sum())
            bad += mask_check(a, b, sim_cpu, f"policy {w} {p}")
            bad += compare_results(a, b, f"policy {w} {p}")
    out["policy_packets_differing_from_cpu"] = differing

    # --- fidelity: event engine against the analytic model ---
    runs, runs_cpu = paired(
        "fidelity_report", lambda tr: fidelity_report(tr, NET96),
        lambda: _fresh(paper), lambda: _fresh(paper_cpu))
    fid = runs[0]
    bad += compare_fidelity(fid, runs_cpu[0])
    out["fidelity_worst"] = {m: v["worst_speedup_rel_err"]
                             for m, v in fid["_summary"].items()}
    if not fid["_summary"]["striped"]["worst_speedup_rel_err"] <= 1e-9:
        bad.append(f"fidelity: striped worst error "
                   f"{fid['_summary']['striped']['worst_speedup_rel_err']!r}")

    # --- the fault plane on one trace ---
    f_bad, out["faulted"] = once("faulted_checks", lambda: faulted_checks(
        paper[fault_workload], paper_cpu[fault_workload]))
    bad += f_bad

    # --- the retained-speedup grid, one run a route ---
    def grid(d):
        return resilience_sweep_all(list(resilience_workloads), NET96,
                                    ks=ks, fades=fades, device=d)
    res = once("resilience_sweep_all", lambda: grid(device))
    res_cpu = once("resilience_sweep_all_cpu", lambda: grid(CPU), CPU)
    bad += compare_resilience(res, res_cpu)
    bad += reshard_dominates(res, "device") + reshard_dominates(
        res_cpu, "cpu")
    out["retained_mean"] = retained_means(res)
    out["resharded_cells"] = sum(
        bool(d["resharded"]) for wl, row in res.items()
        if wl != "provenance"
        for pols in row["cells"].values() for d in pols.values())

    # --- the rebuild inside reshard_run, held to the CPU route ---
    r_bad, out["reshard"] = once("reshard_checks", lambda: reshard_checks(
        resilience_workloads, ks, max(fades), device))
    bad += r_bad

    # --- one planned run and one online run, profiled ---
    prof_wl = fault_workload
    sim = PacketSim(paper[prof_wl], NET96)
    sim.run("static")
    prof = {"trace": prof_wl}
    r = _trace(lambda: sim.run("static"), 3, on_card, "run")
    for key in ("kernels_us", "plain_attention_bwd_ms_per_run",
                "plain_attention_bwd_share_of_busy"):
        r.pop(key, None)
    if on_card:
        r["host_syncs_per_run"] = _host_syncs(lambda: sim.run("static"))
    prof["planned_static"] = r
    sim.run("greedy")                          # the host copies made
    t0 = time.perf_counter()
    sim.run("greedy")
    prof["online_greedy_host_ms"] = s_to_ms(time.perf_counter() - t0)
    out["profile"] = prof

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
