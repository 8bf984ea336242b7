"""Trend printer + observatory CLI for the bench-history ledger.

    PYTHONPATH=src python -m repro_torch.launch.history --plot-text
    PYTHONPATH=src python -m repro_torch.launch.history --plot-text \
        --row fig_critpath_whatif --metric mean_div --last 20
    PYTHONPATH=src python -m repro_torch.launch.history --detect
    PYTHONPATH=src python -m repro_torch.launch.history --html \
        build/observatory.html          # into an existing directory

The port's counterpart of the JAX package's `benchmarks/history.py`,
with the same flags, output and exit codes.  `benchmarks/run.py`
appends one JSONL line per (run, row) to
``experiments/bench_history.jsonl``, which this tool only reads: it
renders the trajectory of any metric as a text sparkline per row — the
zero-dependency answer to "did that refactor move the benchmarks?" —
and fronts the `repro_torch.obs.report` observatory:

- ``--detect`` runs the robust MAD changepoint/drift detector over
  every (row, metric) series and **exits non-zero** when any series is
  flagged (the CI drift gate).  Wall-time series are excluded unless
  ``--include-wall`` — machine-to-machine wall noise must not fail CI.
- ``--html PATH`` writes the self-contained inline-SVG observatory
  report (trends per row/metric, wall-time trajectories, per-entry
  config-hash column, flagged points marked).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

BARS = "▁▂▃▄▅▆▇█"


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))


#: the committed results file; the ledger lives next to it
RESULTS_FILE = os.path.join(_repo_root(), "experiments",
                            "bench_results.json")


def history_path(results_file: str) -> str:
    """The history ledger lives next to the results file."""
    return os.path.join(os.path.dirname(results_file) or ".",
                        "bench_history.jsonl")


def load_history(path: str) -> list:
    """All parseable entries of the ledger, oldest first."""
    entries = []
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    entries.append(json.loads(line))
                except json.JSONDecodeError:
                    continue       # a torn tail line never blocks a gate
    return entries


def sparkline(values) -> str:
    if not values:
        return ""
    lo, hi = min(values), max(values)
    if hi == lo:
        return BARS[0] * len(values)
    return "".join(BARS[int((v - lo) / (hi - lo) * (len(BARS) - 1))]
                   for v in values)


def plot_text(entries, row=None, metric=None, last=30, file=None):
    """One line per (row, metric): sparkline + first/latest values."""
    file = file if file is not None else sys.stdout   # late-bound for capture
    series = {}
    for e in entries:
        if row and e.get("row") != row:
            continue
        for k, v in (e.get("metrics") or {}).items():
            if metric and k != metric:
                continue
            series.setdefault((e["row"], k), []).append(float(v))
    if not series:
        file.write("no matching history entries\n")
        return
    wid = max(len(f"{r}.{k}") for r, k in series)
    for (r, k), vals in sorted(series.items()):
        vals = vals[-last:]
        file.write(f"{f'{r}.{k}':{wid}s}  {sparkline(vals)}  "
                   f"{vals[0]:g} -> {vals[-1]:g}  (n={len(vals)})\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--plot-text", action="store_true",
                    help="render each metric's trajectory as a sparkline")
    ap.add_argument("--detect", action="store_true",
                    help="robust MAD drift/changepoint detection; exits "
                         "1 when any (row, metric) series is flagged")
    ap.add_argument("--include-wall", action="store_true",
                    help="also gate the us_per_call wall-time series in "
                         "--detect (off by default: wall noise across "
                         "machines must not fail CI)")
    ap.add_argument("--threshold", type=float, default=None,
                    help="robust z-score threshold for --detect/--html "
                         "(default: repro_torch.obs.report's)")
    ap.add_argument("--html", metavar="PATH", default=None,
                    help="write the self-contained observatory HTML "
                         "report to PATH")
    ap.add_argument("--file", default=history_path(RESULTS_FILE),
                    help="history ledger (default: %(default)s)")
    ap.add_argument("--results", default=RESULTS_FILE,
                    help="committed bench_results.json for the report's "
                         "reference lines (default: %(default)s)")
    ap.add_argument("--row", default=None, help="restrict to one row")
    ap.add_argument("--metric", default=None,
                    help="restrict to one metric key")
    ap.add_argument("--last", type=int, default=30,
                    help="plot at most the last N runs (default 30)")
    args = ap.parse_args(argv)
    entries = load_history(args.file)
    if not entries:
        sys.stderr.write(f"no history at {args.file}\n")
        return 1
    if args.row:
        entries = [e for e in entries if e.get("row") == args.row]

    rc = 0
    if args.detect or args.html:
        from ..obs import report as obs_report
        kw = {}
        if args.threshold is not None:
            kw["threshold"] = args.threshold
    if args.html:
        results = {}
        if os.path.exists(args.results):
            with open(args.results) as f:
                results = json.load(f)
        obs_report.write_html(args.html, entries, results, **kw)
        sys.stdout.write(f"observatory report -> {args.html}\n")
    if args.detect:
        findings = obs_report.detect_all(
            entries, include_wall=args.include_wall, **kw)
        if findings:
            sys.stderr.write(obs_report.format_findings(findings) + "\n")
            rc = 1
        else:
            sys.stdout.write(f"history detect OK ({len(entries)} entries, "
                             "no series flagged)\n")
    if args.plot_text:
        plot_text(entries, args.row, args.metric, args.last)
    elif not (args.detect or args.html):
        rows = sorted({e.get("row") for e in entries if "row" in e})
        sys.stdout.write(f"{len(entries)} entries, {len(rows)} rows: "
                         + ", ".join(rows) + "\n")
    return rc


if __name__ == "__main__":
    sys.exit(main())
