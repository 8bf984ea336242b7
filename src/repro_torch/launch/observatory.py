"""Meta-observability walkthrough: profile the framework, then audit
the bench ledger.

    PYTHONPATH=src python -m repro_torch.launch.observatory [--quick] \
        [--device cuda|cpu] [--out DIR]

The port's counterpart of the JAX package's `examples/observatory.py`,
on ``--device`` (the card by default; without one it raises, and
``--device cpu`` runs the CPU route).  Two halves, mirroring `obs`'s two
self-observation planes:

1. **Self-profiling** (`obs.profile`): the paper sweep (`sweep_all`
   over zfnet, resnet50 and vgg; zfnet alone with ``--quick``) and a
   recorded greedy `PacketSim` run of the first trace at 96 Gb/s, under
   ``with profiling() as prof:``; the hierarchical phase table (wall /
   calls / peak-ndarray-bytes, with the >=90%-attribution coverage
   footer), and the phases exported merged with the recorded sim trace
   — the "framework" process sits next to the simulated-time planes at
   https://ui.perfetto.dev.
2. **The observatory** (`obs.report`, stdlib only): the committed bench
   ledger (``experiments/bench_history.jsonl`` and
   ``bench_results.json``, the history CLI's defaults, read only)
   through the robust MAD drift detector over every (row, metric)
   series and into the self-contained HTML trend report.

Files go to ``--out`` (``build/repro_torch/traces`` by default).
`compare` holds a run on the card to the CPU route's (`chip_smoke.py`
phase 14).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List

import torch

from ..core import NetworkConfig, make_trace, sweep_all
from ..core.units import gbps_to_bytes_per_s
from ..obs import (build_html, detect_all, export_chrome_trace,
                   format_findings, profile_report, profiling)
from ..sim import PacketSim
from .history import RESULTS_FILE, history_path, load_history
from .obs_plane import COVERAGE, RTOL, compare_traces
from .paper_plane import compare_sweeps

# `examples/observatory.py` names "vgg16", which the workload table does
# not hold (its full run raises KeyError); "vgg" is Table 1's VGG
PROFILE_WORKLOADS = ("zfnet", "resnet50", "vgg")
QUICK_WORKLOADS = ("zfnet",)
NET96 = NetworkConfig(bandwidth=gbps_to_bytes_per_s(96))
OUT_DIR = os.path.join("build", "repro_torch", "traces")


def profile_half(workloads, device, out_dir: str) -> dict:
    """The paper sweep and one recorded greedy event run, profiled; the
    merged Chrome export written to ``out_dir``."""
    traces = {wl: make_trace(wl, device=device) for wl in workloads}
    with profiling() as prof:
        sweeps = sweep_all(traces)
        sim = PacketSim(traces[workloads[0]], NET96, record=True)
        res = sim.run("greedy")
    path = os.path.join(out_dir, "observatory_profile.json")
    export_chrome_trace({"sim": res.trace, "profile": prof.to_trace()}, path)
    return {"profiler": prof, "sweeps": sweeps, "result": res,
            "chrome": path}


def observatory_half(out_dir: str) -> dict:
    """The ledger's drift findings and its HTML report in ``out_dir``."""
    entries = load_history(history_path(RESULTS_FILE))
    results = {}
    if os.path.exists(RESULTS_FILE):
        with open(RESULTS_FILE) as f:
            results = json.load(f)
    findings = detect_all(entries)
    path = os.path.join(out_dir, "observatory.html")
    with open(path, "w", encoding="utf-8") as f:
        f.write(build_html(entries, results))
    return {"entries": len(entries), "findings": findings, "html": path}


def run(device="cuda", workloads=PROFILE_WORKLOADS,
        out_dir: str = OUT_DIR) -> dict:
    """Both halves on ``device``, each timed on the host's clock."""
    if torch.device(device).type == "cuda" and \
            not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the observatory profiles the "
                           "card by default; pass device=\"cpu\" to run "
                           "it on the CPU")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    out = profile_half(tuple(workloads), device, out_dir)
    t1 = time.perf_counter()
    out.update(observatory_half(out_dir))
    out["seconds"] = {"profile": t1 - t0,
                      "observatory": time.perf_counter() - t1}
    return out


def report_lines(out: dict) -> List[str]:
    """The walkthrough's printed lines for one `run`."""
    return ["== framework self-profile: paper sweep + one event run ==",
            profile_report(out["profiler"]),
            f"\nPerfetto export (sim planes + 'framework' process) -> "
            f"{out['chrome']}",
            f"\n== bench observatory: {out['entries']} ledger entries ==",
            format_findings(out["findings"])
            or "robust MAD detector: no series flagged",
            f"HTML trend report -> {out['html']}"]


def phase_calls(prof) -> dict:
    """Phase path -> call count of a profiler."""
    return {p: a["calls"] for p, a in prof.aggregate().items()}


def framework_processes(path: str) -> List[str]:
    """Names of the "framework" processes in a Chrome export."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e["args"]["name"] for e in events
            if e.get("name") == "process_name"
            and "framework" in e["args"]["name"]]


def compare(a: dict, b: dict) -> List[str]:
    """A `run` on one route against another (the card against the CPU):
    the same phases with the same call counts, coverage at least
    ``COVERAGE`` on each, `sweep_all`'s results and the recorded greedy
    run's events within ``RTOL`` (the tie rule of `launch/paper_plane`),
    each Chrome export read back with a "framework" process, and the
    same ledger findings."""
    bad = []
    if phase_calls(a["profiler"]) != phase_calls(b["profiler"]):
        bad.append(f"phase calls {phase_calls(a['profiler'])} vs "
                   f"{phase_calls(b['profiler'])}")
    for route, out in (("first", a), ("second", b)):
        cov = out["profiler"].coverage()
        if cov < COVERAGE:
            bad.append(f"{route} route: coverage {cov:.4f} < {COVERAGE}")
        if not framework_processes(out["chrome"]):
            bad.append(f"{route} route: no framework process in "
                       f"{out['chrome']}")
    bad += compare_sweeps(a["sweeps"], b["sweeps"], RTOL)
    bad += compare_traces(a["result"].trace, b["result"].trace,
                          "recorded greedy")
    if (a["entries"], a["findings"]) != (b["entries"], b["findings"]):
        bad.append("the ledger's findings differ")
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="profile the zfnet sweep alone")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)
    out = run(args.device, QUICK_WORKLOADS if args.quick
              else PROFILE_WORKLOADS, args.out)
    sys.stdout.write("\n".join(report_lines(out)) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
