"""`python -m repro_torch.lint` — the analyzer's command line.

Exit status is the CI contract: 0 when no *new* findings (after inline
suppressions and the baseline file), 1 otherwise.  ``--format=github``
emits workflow-command annotations so findings land inline on the pull
request diff.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Optional, Sequence

from . import ALL_RULES, FAMILIES
from .base import (LintReport, iter_py_files, load_baseline, run_rules,
                   write_baseline)

DEFAULT_BASELINE = "lint_baseline.txt"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.lint",
        description="Domain-aware static analysis (units, determinism, "
                    "trace hygiene, config hygiene).")
    ap.add_argument("paths", nargs="*", default=["src"],
                    help="files/directories to scan (default: src)")
    ap.add_argument("--format", choices=("text", "github"),
                    default="text", help="finding output format")
    ap.add_argument("--baseline", default=None,
                    help=f"baseline file of accepted fingerprints "
                         f"(default: {DEFAULT_BASELINE} when present)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write current findings to the baseline file "
                         "and exit 0")
    ap.add_argument("--select", default=None,
                    help="comma-separated rule or family names to run "
                         "(default: all)")
    ap.add_argument("--list-rules", action="store_true",
                    help="list rules and exit")
    return ap


def select_rules(spec: Optional[str]):
    if not spec:
        return ALL_RULES
    wanted = {s.strip() for s in spec.split(",") if s.strip()}
    unknown = wanted - {r.name for r in ALL_RULES} - set(FAMILIES)
    if unknown:
        raise SystemExit(f"unknown rule/family: {', '.join(sorted(unknown))}")
    return tuple(r for r in ALL_RULES
                 if r.name in wanted or r.family in wanted)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_rules:
        for rule in ALL_RULES:
            print(f"{rule.name:28s} [{rule.family}] {rule.description}")
        return 0
    rules = select_rules(args.select)
    paths = [Path(p) for p in args.paths]
    missing = [p for p in paths if not p.exists()]
    if missing:
        print(f"error: no such path: "
              f"{', '.join(str(p) for p in missing)}", file=sys.stderr)
        return 2
    baseline_path = Path(args.baseline) if args.baseline else \
        Path(DEFAULT_BASELINE)
    baseline = load_baseline(baseline_path) \
        if (args.baseline or baseline_path.is_file()) else set()
    report = run_rules(rules, iter_py_files(paths),
                       baseline=set() if args.write_baseline else baseline,
                       search_roots=[p if p.is_dir() else p.parent
                                     for p in paths])
    if args.write_baseline:
        write_baseline(baseline_path, report.findings)
        print(f"wrote {len(report.findings)} fingerprint(s) to "
              f"{baseline_path}")
        return 0
    render = (lambda f: f.render_github()) if args.format == "github" \
        else (lambda f: f.render_text())
    for f in report.findings:
        print(render(f))
    summary = (f"repro_torch.lint: {len(report.findings)} finding(s) in "
               f"{report.files_scanned} file(s)"
               f" ({report.suppressed} suppressed,"
               f" {report.baselined} baselined)")
    print(summary, file=sys.stderr)
    return 1 if report.findings else 0


if __name__ == "__main__":          # pragma: no cover
    sys.exit(main())
