"""The paper's analytic plane on a device, timed, and held to the
port's own CPU route of every call.

    PYTHONPATH=src python -m repro_torch.launch.paper_plane [--device cuda]

On ``device`` (the card by default) it builds the 15 Table-1 traces and
the 12 LLM traces, then runs `sweep_all` (batched engine), the per-point
loop engine on zfnet against the batched one, `network_sweep_all` (3
MACs x 4 channel plans) on the 15, `scaling_sweep` over the five
`SCALING_GRIDS` at 96 Gb/s on the 15, and `balance` at 96 Gb/s with the
ideal MAC on the 15.  Each call runs again on the CPU (on CPU copies of
the same traces; `scaling_sweep` builds its own) and the two are held
together within ``RTOL`` (times also within ``ATOL_OF_BASE`` of the
wired base time) and under the tie rule: a choice that differs (the
best threshold and injection, a bottleneck label, a reuse plan, the
balancer's anchor) is accepted only where the CPU route's own value at
the device's choice is within the tolerance of the CPU route's best —
scatter sums run in another order on the card, so exact ties in the
CPU's values may break either way there.  `sweep_all`'s summary is also
held to the paper's band.  `sweep_all`, `network_sweep_all`,
`scaling_sweep` and `balance` run ``REPS`` times on each route,
alternating device and CPU, each time on fresh copies of the traces
(memoized design spaces dropped); every run's wall time is kept, and
the report says whether the device's runs are bit-equal.  Wall times
are the host's clock around calls that end with their results on the
host; trace building (host Python, then one copy of each array to the
device) is timed apart from evaluation.  On the card, `torch.profiler`
counts the device operations of one batched `evaluate` (the paper grid
and the network grid) on the largest paper trace, and torch's sync
debug mode counts the host syncs of one such `evaluate` with its best
point read, and of a whole `sweep_all` of that trace.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import warnings
from typing import Dict, List

import torch

from ..core import (LLM_WORKLOADS, SCALING_GRIDS, MacConfig, NetworkConfig,
                    balance, batched_design_space, grid_anchor, make_trace,
                    network_sweep_all, reuse_plans, scaled_config,
                    scaling_sweep, summary, sweep_all)
from ..core.dse import INJECTIONS, NETWORK_MACS, NETWORK_PLANS, THRESHOLDS
from ..core.simulator import BOTTLENECKS
from ..core.units import bytes_per_s_to_gbps, gbps_to_bytes_per_s
from ..core.workloads import WORKLOADS
from ..net import ChannelPlan, GridSpec
from ..net.batched import argmax_value
from .profile import _trace

RTOL = 1e-9
ATOL_OF_BASE = 1e-12
BANDWIDTH_GBPS = 96     # scaling_sweep's and the balancer's
LOOP_WORKLOAD = "zfnet"  # the per-point loop engine's trace
REPS = 3                # runs of each call a route
CPU = torch.device("cpu")
# tests/test_paper_repro.py's band around the paper's 7.5% / 10% / 20%
PAPER_BAND = {"mean64": (1.04, 1.12), "mean96": (1.055, 1.145),
              "max96_min": 1.15}


def close(a: float, b: float, rtol: float, atol: float = 0.0) -> bool:
    return abs(a - b) <= atol + rtol * abs(b)


def _allclose(a: torch.Tensor, b: torch.Tensor, rtol: float,
              atol: float = 0.0) -> bool:
    return torch.allclose(a.cpu(), b.cpu(), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# comparisons of one route (a) with another (b), under the tie rule
# ---------------------------------------------------------------------------

def compare_sims(a, b, rtol: float, atol: float, what: str) -> List[str]:
    """Two `SimResult`s: times, energies, and the bottleneck labels."""
    bad = []
    if not close(a.total_time, b.total_time, rtol, atol):
        bad.append(f"{what}: total_time {a.total_time!r} vs "
                   f"{b.total_time!r}")
    for f in ("wireless_bytes", "wireless_energy_j", "energy_j"):
        if not close(getattr(a, f), getattr(b, f), rtol):
            bad.append(f"{what}: {f} {getattr(a, f)!r} vs {getattr(b, f)!r}")
    if not _allclose(a.layer_times, b.layer_times, rtol, atol):
        bad.append(f"{what}: layer times differ")
    terms = b.layer_terms.cpu()
    for li, (la, lb) in enumerate(zip(a.bottleneck, b.bottleneck)):
        if la != lb and not close(
                float(terms[li, BOTTLENECKS.index(la)]),
                float(b.layer_times[li]), rtol, atol):
            bad.append(f"{what}: layer {li} bottleneck {la} vs {lb}")
    return bad


def compare_sweeps(a_list, b_list, rtol: float) -> List[str]:
    """Two `sweep_all` / `sweep` result lists, in the same order."""
    bad = []
    for a, b in zip(a_list, b_list, strict=True):
        what = f"sweep {a.workload}@{a.bandwidth_gbps}"
        if (a.workload, a.bandwidth_gbps) != (b.workload, b.bandwidth_gbps):
            bad.append(f"{what}: paired with {b.workload}@{b.bandwidth_gbps}")
            continue
        if not _allclose(a.grid, b.grid, rtol):
            bad.append(f"{what}: grids differ")
        if not close(a.best_speedup, b.best_speedup, rtol):
            bad.append(f"{what}: best {a.best_speedup!r} vs "
                       f"{b.best_speedup!r}")
        choice = (a.best_threshold, a.best_injection)
        if choice != (b.best_threshold, b.best_injection):
            ti = THRESHOLDS.index(a.best_threshold)
            ii = INJECTIONS.index(a.best_injection)
            if not close(float(b.grid[ti, ii]), b.best_speedup, rtol):
                bad.append(f"{what}: best point {choice} vs "
                           f"{(b.best_threshold, b.best_injection)}")
    return bad


def _grid_index(spec, cfg) -> tuple:
    bi = next(i for i, bw in enumerate(spec.bandwidths_gbps)
              if gbps_to_bytes_per_s(bw) == cfg.bandwidth)
    return (spec.macs.index(cfg.mac), spec.plans.index(cfg.channels), bi,
            spec.thresholds.index(cfg.distance_threshold),
            spec.injections.index(cfg.injection_prob))


def compare_network(a_list, b_list, rtol: float) -> List[str]:
    """Two `network_sweep_all` result lists."""
    bad = []
    for a, b in zip(a_list, b_list, strict=True):
        what = f"network {a.workload}"
        if not _allclose(a.result.speedup, b.result.speedup, rtol):
            bad.append(f"{what}: speedup grids differ")
        if not close(a.best_speedup, b.best_speedup, rtol):
            bad.append(f"{what}: best {a.best_speedup!r} vs "
                       f"{b.best_speedup!r}")
        if a.best_config != b.best_config:
            at = float(b.result.speedup[_grid_index(b.result.spec,
                                                    a.best_config)])
            if not close(at, b.best_speedup, rtol):
                bad.append(f"{what}: best {a.best_config.describe()} vs "
                           f"{b.best_config.describe()}")
    return bad


def plan_bests(workload: str, grid, bandwidth_gbps: float,
               device) -> Dict[str, float]:
    """Best speedup of each plan `scaling_sweep` tries at one point."""
    plans = (ChannelPlan(1),) + reuse_plans(tuple(grid))
    trace = make_trace(workload, scaled_config(tuple(grid)), device=device)
    spec = GridSpec(bandwidths_gbps=(bandwidth_gbps,), plans=plans)
    sp = batched_design_space(trace).evaluate(spec).speedup[0, :, 0]
    return dict(zip((p.describe() for p in plans),
                    sp.flatten(1).amax(dim=1).tolist()))


def compare_scaling(a_list, b_list, rtol: float, bandwidth_gbps: float,
                    b_device) -> List[str]:
    """Two `scaling_sweep` result lists; a differing reuse plan is
    re-evaluated on route b for the tie rule."""
    bad = []
    for a, b in zip(a_list, b_list, strict=True):
        what = f"scaling {a.workload}@{a.grid}"
        if not close(a.wired_time, b.wired_time, rtol):
            bad.append(f"{what}: wired {a.wired_time!r} vs {b.wired_time!r}")
        for f in ("best_single", "best_reuse"):
            if not close(getattr(a, f), getattr(b, f), rtol):
                bad.append(f"{what}: {f} {getattr(a, f)!r} vs "
                           f"{getattr(b, f)!r}")
        if a.best_reuse_plan != b.best_reuse_plan:
            at = plan_bests(a.workload, a.grid, bandwidth_gbps,
                            b_device)[a.best_reuse_plan]
            if not close(at, b.best_reuse, rtol):
                bad.append(f"{what}: plan {a.best_reuse_plan} vs "
                           f"{b.best_reuse_plan}")
    return bad


def compare_balance(a, b, trace_a, trace_b, net, rtol: float,
                    what: str) -> List[str]:
    """Two `BalancerResult`s of one trace on two routes; the anchors
    (`grid_anchor`) under the tie rule.  Differing packets are counted
    by `mask_diff`, not failed: the greedy pass compares float times, so
    a last-bit difference may move a packet of equal effect."""
    atol = ATOL_OF_BASE * (b.sim.total_time * b.speedup_vs_wired)
    bad = compare_sims(a.sim, b.sim, rtol, atol, what)
    for f in ("speedup_vs_wired", "injected_fraction"):
        if not close(getattr(a, f), getattr(b, f), rtol):
            bad.append(f"{what}: {f} {getattr(a, f)!r} vs {getattr(b, f)!r}")
    (_, ta, pa), (vb, tb, pb) = grid_anchor(trace_a, net), \
        grid_anchor(trace_b, net)
    if (ta, pa) != (tb, pb):
        spec = GridSpec(bandwidths_gbps=(bytes_per_s_to_gbps(net.bandwidth),),
                        macs=(net.mac,), plans=(net.channels,))
        sp = batched_design_space(trace_b).evaluate(spec).speedup
        at = float(sp[0, 0, 0, THRESHOLDS.index(ta), INJECTIONS.index(pa)])
        if not close(at, vb, rtol):
            bad.append(f"{what}: anchor {(ta, pa)} vs {(tb, pb)}")
    return bad


def mask_diff(a, b) -> int:
    return int((a.injected.cpu() != b.injected.cpu()).sum())


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def _timed(fn, device):
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, time.perf_counter() - t0


def _fresh(traces: Dict) -> Dict:
    """Copies of the traces without their memoized design spaces."""
    return {k: t.to(t.device) for k, t in traces.items()}


def _same_sweeps(a, b) -> bool:
    return all(torch.equal(x.grid, y.grid)
               and (x.best_speedup, x.best_threshold, x.best_injection)
               == (y.best_speedup, y.best_threshold, y.best_injection)
               for x, y in zip(a, b, strict=True))


def _paired(call, make_dev, make_cpu, device) -> tuple:
    """``call(make_dev())`` on ``device`` and ``call(make_cpu())`` on the
    CPU, REPS times each and alternating, so that the host's load falls
    on both routes alike; the arguments are made outside the clock.

    Returns ``(device results, CPU results, device s, CPU s)``."""
    runs = ([], [], [], [])
    for _ in range(REPS):
        for make, d, outs, secs in ((make_dev, device, runs[0], runs[2]),
                                    (make_cpu, CPU, runs[1], runs[3])):
            arg = make()
            out, sec = _timed(lambda: call(arg), d)
            outs.append(out)
            secs.append(sec)
    return runs


def _host_syncs(fn) -> int:
    """Synchronizing CUDA calls made by ``fn``, counted by torch's sync
    debug mode (a device-to-host copy, a host-to-device copy from
    pageable memory, a boolean selection)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def run(device="cuda", workloads=None, llm=None,
        grids=SCALING_GRIDS) -> Dict:
    """Every call of the analytic plane on ``device`` and on the CPU.

    Returns ``{"failures": [...], "seconds": {...}, "bit_equal": {...},
    "summary": {...}, "profile": {...}, ...}``; an empty ``failures``
    means every comparison held.  Each entry of ``seconds`` is a list:
    one wall time a run."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    workloads = list(WORKLOADS) if workloads is None else list(workloads)
    llm = list(LLM_WORKLOADS) if llm is None else list(llm)
    secs, bits, bad, out = {}, {}, [], {"device": str(device)}
    if on_card:
        out["device_name"] = torch.cuda.get_device_name(0)

    def paired(name, call, make_dev, make_cpu):
        res, res_cpu, secs[name], secs[name + "_cpu"] = _paired(
            call, make_dev, make_cpu, device)
        return res, res_cpu[0]

    def once(name, fn, d=device):
        res, sec = _timed(fn, d)
        secs[name] = [sec]
        return res

    # --- traces: host build + one copy of each array to the device ---
    paper = once("build_paper_traces",
                 lambda: {w: make_trace(w, device=device) for w in workloads})
    llm_tr = once("build_llm_traces",
                  lambda: {w: make_trace(w, device=device) for w in llm})
    out["packets"] = {w: len(t.nbytes) for w, t in {**paper,
                                                     **llm_tr}.items()}
    out["incidences"] = {w: len(t.inc_msg) for w, t in {**paper,
                                                         **llm_tr}.items()}
    paper_cpu = {w: t.to(CPU) for w, t in paper.items()}
    llm_cpu = {w: t.to(CPU) for w, t in llm_tr.items()}
    # first calls (the device's kernels loaded, allocator warmed) on a
    # copy of the smallest trace, timed apart from the calls below
    small = min(paper, key=lambda w: len(paper[w].nbytes))
    once("first_calls", lambda: (
        sweep_all(_fresh({small: paper[small]})),
        network_sweep_all(_fresh({small: paper[small]})),
        balance(paper[small].to(device), NetworkConfig())))

    # --- the paper's sweep, batched, and its summary against the band ---
    runs, ref = paired("sweep_all", sweep_all, lambda: _fresh(paper),
                       lambda: _fresh(paper_cpu))
    res = runs[0]
    bits["sweep_all"] = all(_same_sweeps(res, r) for r in runs[1:])
    bad += compare_sweeps(res, ref, RTOL)
    s = summary(res)
    out["summary"] = {str(bw): list(v) for bw, v in s.items()}
    if set(workloads) == set(WORKLOADS):   # the band is the paper's mean
        lo, hi = PAPER_BAND["mean64"]
        if not lo <= s[64][0] <= hi:
            bad.append(f"mean64 {s[64][0]!r} outside [{lo}, {hi}]")
        lo, hi = PAPER_BAND["mean96"]
        if not lo <= s[96][0] <= hi:
            bad.append(f"mean96 {s[96][0]!r} outside [{lo}, {hi}]")
        if not s[96][1] >= PAPER_BAND["max96_min"]:
            bad.append(f"max96 {s[96][1]!r} under {PAPER_BAND['max96_min']}")

    # --- the LLM traces' sweep ---
    res_llm = once("sweep_all_llm", lambda: sweep_all(llm_tr))
    bad += compare_sweeps(res_llm, sweep_all(llm_cpu), RTOL)
    out["llm_best"] = {f"{r.workload}@{r.bandwidth_gbps}": r.best_speedup
                       for r in res_llm}

    # --- the per-point loop engine against the batched one ---
    if LOOP_WORKLOAD in paper:
        loop = once("sweep_loop_" + LOOP_WORKLOAD, lambda: sweep_all(
            {LOOP_WORKLOAD: paper[LOOP_WORKLOAD]}, engine="loop"))
        bad += [f"loop vs batched: {m}" for m in compare_sweeps(
            loop, [r for r in res if r.workload == LOOP_WORKLOAD], RTOL)]
        bad += compare_sweeps(loop, sweep_all(
            {LOOP_WORKLOAD: paper_cpu[LOOP_WORKLOAD]}, engine="loop"), RTOL)

    # --- the network sweep (MAC x channel plan) ---
    runs, net_cpu = paired("network_sweep_all", network_sweep_all,
                           lambda: _fresh(paper), lambda: _fresh(paper_cpu))
    bits["network_sweep_all"] = all(
        torch.equal(x.result.speedup, y.result.speedup)
        for r in runs[1:] for x, y in zip(runs[0], r, strict=True))
    bad += compare_network(runs[0], net_cpu, RTOL)

    # --- the scale-out frontier ---
    if grids:
        built = once("build_scaling_traces", lambda: {
            (tuple(g), w): make_trace(w, scaled_config(tuple(g)),
                                      device=device)
            for g in grids for w in workloads})
        out["scaling_sizes"] = {
            f"{g[0]}x{g[1]}": {"nodes": t.topo.n_nodes,
                               "max_packets": max(
                                   len(built[g, w].nbytes) for w in workloads),
                               "max_incidences": max(
                                   len(built[g, w].inc_msg)
                                   for w in workloads)}
            for (g, _), t in built.items()}
        # what scaling_sweep evaluates on each trace, timed on the
        # traces built above
        specs = {tuple(g): GridSpec(
            bandwidths_gbps=(BANDWIDTH_GBPS,),
            plans=(ChannelPlan(1),) + reuse_plans(tuple(g))) for g in grids}
        once("scaling_evaluate", lambda: [
            argmax_value(batched_design_space(t).evaluate(specs[g]).speedup)
            for (g, _), t in built.items()])
        del built
        runs, sc_cpu = paired(
            "scaling_sweep",
            lambda d: scaling_sweep(workloads, grids, BANDWIDTH_GBPS,
                                    device=d),
            lambda: device, lambda: CPU)
        bits["scaling_sweep"] = all(r == runs[0] for r in runs[1:])
        bad += compare_scaling(runs[0], sc_cpu, RTOL, BANDWIDTH_GBPS, CPU)

    # --- the balancer at 96 Gb/s, ideal MAC ---
    bnet = NetworkConfig(gbps_to_bytes_per_s(BANDWIDTH_GBPS),
                         mac=MacConfig("ideal"))
    runs, bal_cpu = paired(
        "balance", lambda tr: {w: balance(t, bnet) for w, t in tr.items()},
        lambda: _fresh(paper), lambda: _fresh(paper_cpu))
    bal = runs[0]
    bits["balance"] = all(
        torch.equal(bal[w].injected, r[w].injected)
        and bal[w].speedup_vs_wired == r[w].speedup_vs_wired
        for r in runs[1:] for w in paper)
    diffs = {}
    for w in paper:
        bad += compare_balance(bal[w], bal_cpu[w], paper[w], paper_cpu[w],
                               bnet, RTOL, f"balance {w}")
        diffs[w] = mask_diff(bal[w], bal_cpu[w])
    out["balance_packets_differing_from_cpu"] = diffs
    out["balance_speedup"] = {w: b.speedup_vs_wired for w, b in bal.items()}

    # --- the device operations and host syncs of one batched evaluate ---
    largest = max(paper, key=lambda w: len(paper[w].nbytes))
    ds = batched_design_space(paper[largest])
    prof = {"trace": largest}
    for name, spec in (("paper_grid", GridSpec()),
                       ("network_grid", GridSpec(macs=NETWORK_MACS,
                                                 plans=NETWORK_PLANS))):
        ds.evaluate(spec)
        r = _trace(lambda: ds.evaluate(spec), 3, on_card, "evaluate")
        for key in ("kernels_us", "plain_attention_bwd_ms_per_evaluate",
                    "plain_attention_bwd_share_of_busy"):
            r.pop(key, None)
        if on_card:
            r["host_syncs_per_evaluate"] = _host_syncs(
                lambda: argmax_value(ds.evaluate(spec).speedup))
        prof[name] = r
    if on_card:   # a whole sweep of one trace, its design space built
        prof["host_syncs_sweep_all_one_trace"] = _host_syncs(
            lambda: sweep_all(_fresh({largest: paper[largest]})))
    out["profile"] = prof

    out.update(seconds=secs, bit_equal=bits, failures=bad)
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
