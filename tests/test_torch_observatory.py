"""The port's bench observatory against the JAX package's, on the CPU:
`repro_torch.obs.report` against `repro.obs.report`, the history CLI
`repro_torch.launch.history` against `benchmarks/history.py`, the
walkthrough `repro_torch.launch.observatory` against
`examples/observatory.py`, and `configs.paper_accel`.

The report and the CLI are deterministic stdlib, so they are held to
exact equality on synthetic ledgers made with numpy from a seed (an
injected drift, a level shift, an outlier, torn fields, a torn tail
line): the same findings, text, exit codes and HTML bytes, the HTML's
footer naming its own module aside.  The walkthrough's profile half is
held to the reference's phase for phase, and its `sweep_all` at rtol
1e-12 (`tests/test_torch_paper_sweeps.py`).
"""

import contextlib
import dataclasses
import importlib.util
import io
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import benchmarks.history as ref_hist
import repro.configs.paper_accel as ref_accel
from repro.obs import report as ref_report
from repro_torch.configs import paper_accel as port_accel
from repro_torch.launch import history as port_hist
from repro_torch.launch import observatory
from repro_torch.obs import report as port_report
from test_torch_paper_sweeps import assert_sweeps_match

REPO = pathlib.Path(__file__).resolve().parents[1]
FOOTER = ("generated by repro.obs.report", "generated by repro_torch.obs.report")


def synthetic_ledger(kind: str, seed: int = 0) -> list:
    """Entries of three rows, 14 runs each, from ``seed``: a clean noisy
    base, with ``kind``'s change injected into row ``fig_b``."""
    rng = np.random.default_rng(seed)
    entries = []
    for i in range(14):
        for row, level in (("fig_a", 1.0), ("fig_b", 2.5), ("fig_c", 40.0)):
            m = level * (1.0 + 0.002 * rng.standard_normal(2))
            wall = 1000.0 * level * (1.0 + 0.01 * rng.standard_normal())
            metrics = {"mean": float(m[0]), "max": float(m[1])}
            if row == "fig_b":
                if kind == "drift" and i == 13:
                    metrics["mean"] *= 1.5
                elif kind == "shift" and i >= 7:
                    metrics["mean"] *= 1.3
                    metrics["max"] *= 0.8
                elif kind == "outlier" and i == 3:
                    metrics["mean"] *= 20.0
                elif kind == "outlier" and i >= 8:
                    metrics["mean"] *= 2.0
                elif kind == "wall":
                    wall *= 2.0 ** (i // 4)
            e = {"row": row, "ts": 1700000000.0 + 3600.0 * i,
                 "us_per_call": round(wall, 1),
                 "derived": " ".join(f"{k}={v:g}" for k, v in
                                     metrics.items()),
                 "metrics": metrics,
                 "hash": f"{int(rng.integers(1 << 32)):08x}"}
            if kind == "torn" and i % 5 == 2:
                e["us_per_call"] = "nan"
                e["metrics"] = dict(metrics, bad="oops", inf=float("inf"),
                                    none=None)
                del e["hash"]
            if kind == "torn" and i == 6:
                e.pop("ts")
            entries.append(e)
    if kind == "torn":
        entries.append({"ts": 1.0, "metrics": {"mean": 9.0}})   # no row
        entries.append({"row": "", "metrics": {"mean": 9.0}})
    return entries


KINDS = ("clean", "drift", "shift", "outlier", "torn", "wall")
RESULTS = {"_bench_meta": {"fig_a": {"derived": "mean=1 max=1",
                                     "us_per_call": 1234.5},
                           "fig_c": {"derived": "mean=40"}}}


def _same_html(port_doc: str, ref_doc: str) -> bool:
    return port_doc == ref_doc.replace(*FOOTER)


def test_constants_match():
    for name in ("WALL_METRIC", "DEFAULT_THRESHOLD", "DEFAULT_MIN_POINTS",
                 "REL_FLOOR"):
        assert getattr(port_report, name) == getattr(ref_report, name)
    assert port_hist.BARS == ref_hist.BARS


@pytest.mark.parametrize("kind", KINDS)
def test_series_and_detection_match_the_reference(kind):
    entries = synthetic_ledger(kind)
    series = port_report.history_series(entries)
    assert series == ref_report.history_series(entries)
    for pts in series.values():
        values = [p["value"] for p in pts]
        for kw in ({}, {"threshold": 2.0}, {"min_points": 12},
                   {"min_segment": 5}):
            assert port_report.detect_series(values, **kw) == \
                ref_report.detect_series(values, **kw)
    for kw in ({}, {"include_wall": True}, {"threshold": 2.5},
               {"threshold": 1.0, "include_wall": True}):
        got = port_report.detect_all(entries, **kw)
        assert got == ref_report.detect_all(entries, **kw)
        assert port_report.format_findings(got) == \
            ref_report.format_findings(got)
    flagged = {(f["row"], f["metric"], f["kind"])
               for f in port_report.detect_all(entries, include_wall=True)}
    expect = {"clean": set(), "torn": set(),
              "drift": {("fig_b", "mean", "drift")},
              "shift": {("fig_b", "mean", "changepoint"),
                        ("fig_b", "max", "changepoint")},
              "outlier": {("fig_b", "mean", "changepoint")},
              "wall": {("fig_b", "us_per_call", "changepoint")}}[kind]
    assert expect <= flagged


@pytest.mark.parametrize("kind", KINDS)
def test_html_matches_the_reference_byte_for_byte(kind, tmp_path):
    entries = synthetic_ledger(kind, seed=1)
    for kw in ({}, {"threshold": 2.0, "min_points": 6, "title": "t<&>"}):
        doc = port_report.build_html(entries, RESULTS, **kw)
        assert _same_html(doc, ref_report.build_html(entries, RESULTS, **kw))
        assert doc == port_report.build_html(entries, RESULTS, **kw)
        assert "generated by repro_torch.obs.report" in doc
    path = tmp_path / "o.html"
    doc = port_report.write_html(str(path), entries)
    assert path.read_text(encoding="utf-8") == doc
    assert _same_html(doc, ref_report.build_html(entries))


def test_report_loads_by_path_with_numpy_and_torch_blocked():
    code = ("import importlib.util, sys\n"
            "for m in ('numpy', 'torch', 'jax', 'repro', 'repro_torch'):\n"
            "    sys.modules[m] = None\n"
            "spec = importlib.util.spec_from_file_location("
            "'obsreport', sys.argv[1])\n"
            "m = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(m)\n"
            "assert m.detect_series([1.0]*10 + [2.0])\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code, port_report.__file__],
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# ---------------------------------------------------------------------------
# the history CLI
# ---------------------------------------------------------------------------

def _write(path, entries, torn_tail=True):
    with open(path, "w") as f:
        for e in entries:
            f.write(json.dumps(e) + "\n")
        if torn_tail:
            f.write('{"row": "fig_a", "ts": 2.0, "metr')     # torn write


def _cli(main, argv):
    """Exit code (or the exception raised), stdout and stderr of a run:
    both CLIs' `--plot-text` raise on a non-numeric metric."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except ValueError as e:
            rc = (type(e), str(e))
    return rc, out.getvalue(), err.getvalue()


CLI_CASES = {
    "summary": [],
    "plot": ["--plot-text"],
    "plot-row-metric": ["--plot-text", "--row", "fig_b", "--metric", "mean",
                        "--last", "5"],
    "plot-nothing": ["--plot-text", "--metric", "nope"],
    "detect": ["--detect"],
    "detect-wall": ["--detect", "--include-wall"],
    "detect-threshold": ["--detect", "--threshold", "1.5"],
    "detect-row": ["--detect", "--row", "fig_b"],
    "html": ["--html", "{html}"],
    "html-detect-plot": ["--html", "{html}", "--detect", "--threshold", "3",
                         "--plot-text"],
}


@pytest.mark.parametrize("kind", ("clean", "shift", "torn", "wall"))
@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_history_cli_matches_the_reference(tmp_path, case, kind):
    ledger = tmp_path / "h.jsonl"
    _write(ledger, synthetic_ledger(kind, seed=3))
    results = tmp_path / "results.json"
    results.write_text(json.dumps(RESULTS))
    runs, docs = [], []
    for which, main in (("port", port_hist.main), ("ref", ref_hist.main)):
        html = tmp_path / f"{which}.html"
        argv = [a.format(html=html) for a in CLI_CASES[case]] + [
            "--file", str(ledger), "--results", str(results)]
        rc, out, err = _cli(main, argv)
        runs.append((rc, out.replace(str(html), "H"), err))
        docs.append(html.read_text(encoding="utf-8") if html.exists()
                    else None)
    assert runs[0] == runs[1]
    assert (docs[0] is None) == (docs[1] is None) == ("html" not in case)
    if docs[0] is not None:
        assert _same_html(docs[0], docs[1])
    if case == "detect":
        assert runs[0][0] == (kind == "shift")


def test_history_cli_empty_ledger_and_committed_defaults(tmp_path):
    """An empty ledger exits 1 with the same message; with no --file both
    read the repo's committed ledger, and agree on it."""
    empty = tmp_path / "none.jsonl"
    _write(empty, [], torn_tail=True)
    for argv in (["--detect", "--file", str(empty)], ["--detect"],
                 ["--plot-text"], [], ["--html", "{html}"]):
        runs, docs = [], []
        for which, main in (("port", port_hist.main), ("ref", ref_hist.main)):
            html = tmp_path / f"{which}.html"
            rc, out, err = _cli(main, [a.format(html=html) for a in argv])
            runs.append((rc, out.replace(str(html), "H"), err))
            docs.append(html.read_text() if html.exists() else None)
        assert runs[0] == runs[1], argv
        assert runs[0][0] == (1 if str(empty) in argv else 0), argv
        if docs[0] is not None:
            assert _same_html(docs[0], docs[1])
    assert pathlib.Path(port_hist.RESULTS_FILE) == \
        REPO / "experiments" / "bench_results.json"
    assert port_hist.load_history(str(empty)) == []
    assert port_hist.history_path(port_hist.RESULTS_FILE) == \
        str(REPO / "experiments" / "bench_history.jsonl")


def test_sparkline_plot_text_and_load_history_match(tmp_path):
    for values in ([], [5.0], [2.0] * 7, [0.0, 1.0], [3.0, 1.0, 2.0, 9.5]):
        assert port_hist.sparkline(values) == ref_hist.sparkline(values)
    entries = synthetic_ledger("drift", seed=3)
    for kw in ({}, {"row": "fig_a"}, {"metric": "max", "last": 3},
               {"row": "nope"}):
        a, b = io.StringIO(), io.StringIO()
        port_hist.plot_text(entries, file=a, **kw)
        ref_hist.plot_text(entries, file=b, **kw)
        assert a.getvalue() == b.getvalue()
    led = tmp_path / "h.jsonl"
    _write(led, entries)
    from benchmarks.run import history_path, load_history
    assert port_hist.load_history(str(led)) == load_history(str(led)) == \
        json.loads(json.dumps(entries))
    assert port_hist.history_path(str(tmp_path / "r.json")) == \
        history_path(str(tmp_path / "r.json"))


# ---------------------------------------------------------------------------
# paper_accel; the walkthrough on the CPU route
# ---------------------------------------------------------------------------

def test_paper_accel_configs_match():
    for name in ("CONFIG_64G", "CONFIG_96G"):
        assert dataclasses.asdict(getattr(port_accel, name)) == \
            dataclasses.asdict(getattr(ref_accel, name))


def _reference_walkthrough():
    spec = importlib.util.spec_from_file_location(
        "ref_observatory", REPO / "examples" / "observatory.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_observatory_cpu_route_matches_the_reference_walkthrough(
        tmp_path, monkeypatch, capsys):
    """`launch/observatory.run(device="cpu", workloads=("zfnet",))`
    against `examples/observatory.py`'s two halves on zfnet: the same
    phases with the same call counts, `sweep_all`'s results, the
    recorded run's events, the ledger's findings and the HTML."""
    ref = _reference_walkthrough()
    seen, ref_profiling, ref_sweep_all = {}, ref.profiling, ref.sweep_all

    @contextlib.contextmanager
    def profiling():
        with ref_profiling() as prof:
            seen["prof"] = prof
            yield prof

    def sweep_all(traces):
        seen["sweeps"] = ref_sweep_all(traces)
        return seen["sweeps"]

    monkeypatch.setattr(ref, "profiling", profiling)
    monkeypatch.setattr(ref, "sweep_all", sweep_all)
    (tmp_path / "ref").mkdir()
    ref.profile_half(["zfnet"], str(tmp_path / "ref"))
    ref.observatory_half(str(tmp_path / "ref"))
    capsys.readouterr()
    out = observatory.run("cpu", ("zfnet",), str(tmp_path / "port"))
    assert observatory.phase_calls(out["profiler"]) == \
        observatory.phase_calls(seen["prof"])
    assert_sweeps_match(seen["sweeps"], out["sweeps"])
    assert out["result"].trace.events and \
        observatory.framework_processes(out["chrome"])
    ref_doc = (tmp_path / "ref" / "observatory.html").read_text()
    assert _same_html(pathlib.Path(out["html"]).read_text(), ref_doc)
    from benchmarks.run import history_path, load_history
    entries = load_history(history_path(
        str(REPO / "experiments" / "bench_results.json")))
    assert out["entries"] == len(entries) > 0
    assert out["findings"] == ref.detect_all(entries) == []
    assert observatory.compare(out, out) == []
    lines = observatory.report_lines(out)
    assert "robust MAD detector: no series flagged" in lines


def test_observatory_cli_and_card_default(tmp_path, capsys):
    assert observatory.main(["--quick", "--device", "cpu", "--out",
                             str(tmp_path)]) == 0
    text = capsys.readouterr().out
    assert "attributed" in text and "'framework' process" in text
    assert (tmp_path / "observatory.html").is_file()
    assert (tmp_path / "observatory_profile.json").is_file()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            observatory.run(out_dir=str(tmp_path / "card"))
