"""The port's linter (`repro_torch.lint`) against the JAX package's
(`repro.lint`), on the CPU.

Everything here is deterministic stdlib, so the two are held to exact
equality: the same findings (rule, path, line, column) on every fixture
and on the repo's own trees, the same suppressed and baselined counts,
the same CLI exit codes and output, and the same registry data.  The
only difference by design is that the port's messages name its own
modules; `same_names` maps both sides before messages are compared.
"""

import contextlib
import io
import pathlib
import subprocess
import sys
from functools import lru_cache

import pytest

import repro.lint as RL
import repro_torch.lint as PL
from repro.lint import base as ref_base
from repro.lint import cli as ref_cli
from repro.lint import registry as ref_registry
from repro_torch.lint import base as port_base
from repro_torch.lint import cli as port_cli
from repro_torch.lint import registry as port_registry
from test_lint import FIXTURE_CASES, FIXTURES

REPO = pathlib.Path(__file__).resolve().parents[1]
SRC = REPO / "src"
LINTERS = {"ref": RL, "port": PL}
#: the trees both linters scan, as `python -m ... <roots>` is given them
TREES = (("src",), ("benchmarks",), ("examples",), ("chip_smoke.py",),
         ("src/repro",), ("src/repro_torch",))


def same_names(text: str) -> str:
    """The one map between the two linters' texts: the port's modules
    named as the reference's."""
    return text.replace("repro_torch.", "repro.")


def key(report):
    return ([(f.rule, f.path, f.line, f.col, same_names(f.message))
             for f in report.findings],
            report.suppressed, report.baselined, report.files_scanned)


def by_name(pkg):
    return {r.name: r for r in pkg.ALL_RULES}


@lru_cache(maxsize=None)
def tree_report(which: str, roots: tuple):
    """One linter over ``roots`` as its CLI scans them (cwd the repo)."""
    pkg = LINTERS[which]
    paths = [REPO / r for r in roots]
    return pkg.run_rules(pkg.ALL_RULES, pkg.iter_py_files(paths),
                         search_roots=[p if p.is_dir() else p.parent
                                       for p in paths], cwd=REPO)


# ---------------------------------------------------------------------------
# fixtures and real trees
# ---------------------------------------------------------------------------

def test_rules_names_families_and_order_match():
    assert [(r.name, r.family, same_names(r.description))
            for r in PL.ALL_RULES] == \
        [(r.name, r.family, r.description) for r in RL.ALL_RULES]
    assert PL.FAMILIES == RL.FAMILIES
    assert set(FIXTURE_CASES) == set(by_name(PL))


@pytest.mark.parametrize("side", ["bad", "good"])
@pytest.mark.parametrize("rule_name", sorted(FIXTURE_CASES))
def test_fixture_findings_match_the_reference(rule_name, side):
    rel = FIXTURE_CASES[rule_name][side == "good"]
    reports = [pkg.run_rules((by_name(pkg)[rule_name],), [FIXTURES / rel],
                             search_roots=[FIXTURES], cwd=FIXTURES)
               for pkg in (PL, RL)]
    assert key(reports[0]) == key(reports[1])
    if side == "bad":
        assert reports[0].findings
        assert {f.rule for f in reports[0].findings} == {rule_name}
    else:
        assert reports[0].findings == []


def test_all_rules_over_the_fixture_tree_match_the_reference():
    reports = [pkg.run_rules(pkg.ALL_RULES, pkg.iter_py_files([FIXTURES]),
                             search_roots=[FIXTURES], cwd=FIXTURES)
               for pkg in (PL, RL)]
    assert key(reports[0]) == key(reports[1])
    assert len(reports[0].findings) > len(FIXTURE_CASES)


@pytest.mark.parametrize("roots", TREES, ids=["+".join(t) for t in TREES])
def test_tree_findings_match_the_reference(roots):
    got, want = tree_report("port", roots), tree_report("ref", roots)
    assert key(got) == key(want)
    assert got.files_scanned > 0


def test_one_package_alone_reports_its_core_lazy_exports():
    """The reference's quirk, mirrored: module names resolve against the
    scanned root, so one package alone misses its `sim` and `arch`."""
    for pkg, line in (("repro", (35, 41)), ("repro_torch", (48, 54))):
        report = tree_report("port", (f"src/{pkg}",))
        assert [(f.rule, f.path, f.line) for f in report.findings] == [
            ("cfg-lazy-export-mismatch", f"src/{pkg}/core/__init__.py", n)
            for n in line]
        assert [f.message.split("`")[1] for f in report.findings] == [
            f"{pkg}.sim", f"{pkg}.arch"]


def test_src_is_clean_under_the_ports_own_gate():
    """`python -m repro_torch.lint src/` exits 0 with the checked-in
    baseline, which stays empty."""
    baseline = PL.load_baseline(REPO / "lint_baseline.txt")
    assert baseline == set()
    report = tree_report("port", ("src",))
    assert [f.render_text() for f in report.findings] == []
    assert report.files_scanned > 200


# ---------------------------------------------------------------------------
# registry data
# ---------------------------------------------------------------------------

def _data(mod):
    return {k: v for k, v in vars(mod).items() if k.isupper()}


def test_registry_data_equal_entry_for_entry():
    got, want = _data(port_registry), _data(ref_registry)
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        assert got[name] == value, name
        assert type(got[name]) is type(value), name


# ---------------------------------------------------------------------------
# mechanics: suppressions, baselines, unit tags, parse errors
# ---------------------------------------------------------------------------

SOURCES = {
    "suppressed": ("def report(x):\n"
                   "    print(x)  # lint: disable=obs-bare-print\n"
                   "    print(x)  # lint: disable\n"
                   "    print(x)  # lint: disable=det-wallclock\n"),
    "tagged": ("def f(configure, window):\n"
               "    return configure(bandwidth=window)  # unit: gbps\n"),
    "untagged": ("def f(configure, window):\n"
                 "    return configure(bandwidth=window)\n"),
    "broken": "def f(:\n",
    "mixed": ("import time\nimport numpy as np\n\n"
              "def f(wireless_bw, cut_gbps, nbytes):\n"
              "    t = time.time()\n"
              "    for k in {1, 2}:\n"
              "        print(k, np.random.rand())\n"
              "    return wireless_bw + cut_gbps, nbytes * 8, t * 1e9\n"),
}


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_suppressions_tags_and_parse_errors_match(tmp_path, name):
    f = tmp_path / "mod.py"
    f.write_text(SOURCES[name])
    reports = [pkg.run_rules(pkg.ALL_RULES, [f], cwd=tmp_path)
               for pkg in (PL, RL)]
    assert key(reports[0]) == key(reports[1])
    assert port_base.parse_suppressions(SOURCES[name].splitlines()) == \
        ref_base.parse_suppressions(SOURCES[name].splitlines())
    assert port_base.parse_unit_tags(SOURCES[name].splitlines()) == \
        ref_base.parse_unit_tags(SOURCES[name].splitlines())
    if name == "suppressed":
        assert reports[0].suppressed == 2
        assert [x.line for x in reports[0].findings] == [4]
    if name == "broken":
        assert [x.rule for x in reports[0].findings] == ["parse-error"]


def test_baseline_round_trip_matches(tmp_path):
    f = tmp_path / "mod.py"
    f.write_text(SOURCES["mixed"])
    texts, prints = [], []
    for pkg in (PL, RL):
        first = pkg.run_rules(pkg.ALL_RULES, [f], cwd=tmp_path)
        bl = tmp_path / f"baseline_{pkg.__name__}.txt"
        pkg.write_baseline(bl, first.findings)
        texts.append(bl.read_text())
        fingerprints = pkg.load_baseline(bl)
        prints.append(fingerprints)
        second = pkg.run_rules(pkg.ALL_RULES, [f], baseline=fingerprints,
                               cwd=tmp_path)
        assert second.findings == []
        assert second.baselined == len(first.findings) > 0
    assert same_names(texts[0]) == texts[1]
    assert prints[0] == prints[1]
    assert "mod.py:obs-bare-print:7" in prints[0]
    assert PL.load_baseline(tmp_path / "missing.txt") == set()


def test_rendered_findings_match(tmp_path):
    f = tmp_path / "mod.py"
    f.write_text(SOURCES["mixed"])
    got, want = (pkg.run_rules(pkg.ALL_RULES, [f], cwd=tmp_path)
                 for pkg in (PL, RL))
    got, want = list(got.findings), list(want.findings)
    assert [same_names(x.render_text()) for x in got] == \
        [x.render_text() for x in want]
    assert [same_names(x.render_github()) for x in got] == \
        [x.render_github() for x in want]
    assert [x.fingerprint() for x in got] == [x.fingerprint() for x in want]
    assert "title=repro_torch.lint obs-bare-print" in "".join(
        x.render_github() for x in got)


# ---------------------------------------------------------------------------
# CLI: exit codes, formats, selection, baselines
# ---------------------------------------------------------------------------

def _cli(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = ("exit", str(e.code))
    return rc, same_names(out.getvalue()), same_names(err.getvalue())


CLI_CASES = {
    "list-rules": ["--list-rules"],
    "text": ["mod.py"],
    "github": ["mod.py", "--format=github"],
    "clean": ["ok.py"],
    "missing": ["nope"],
    "select-family": ["mod.py", "--select=determinism"],
    "select-rule": ["mod.py", "--select", "obs-bare-print,units-magic-literal"],
    "select-unknown": ["mod.py", "--select=not-a-rule"],
    "directory": ["."],
    "no-baseline": ["mod.py", "--baseline=/dev/null"],
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_matches_the_reference(tmp_path, monkeypatch, case):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "mod.py").write_text(SOURCES["mixed"])
    (tmp_path / "ok.py").write_text("x = 1\n")
    got = _cli(port_cli.main, CLI_CASES[case])
    want = _cli(ref_cli.main, CLI_CASES[case])
    assert got == want
    expected_rc = {"list-rules": 0, "clean": 0, "missing": 2,
                   "select-unknown": ("exit", "unknown rule/family: "
                                      "not-a-rule")}.get(case, 1)
    assert got[0] == expected_rc


def test_cli_write_baseline_then_clean(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "mod.py").write_text(SOURCES["mixed"])
    for main in (port_cli.main, ref_cli.main):
        (tmp_path / port_cli.DEFAULT_BASELINE).unlink(missing_ok=True)
        assert main(["mod.py"]) == 1
        assert main(["mod.py", "--write-baseline"]) == 0
        assert main(["mod.py"]) == 0            # the default baseline
        assert main(["mod.py", "--baseline=/dev/null"]) == 1
    assert port_cli.DEFAULT_BASELINE == ref_cli.DEFAULT_BASELINE


def test_module_entrypoint_runs_with_numpy_torch_and_jax_blocked(tmp_path):
    """`python -m repro_torch.lint` in a bare interpreter: numpy, torch,
    jax and the JAX package poisoned, and no other module of the port
    imported on the way."""
    (tmp_path / "mod.py").write_text("print('hi')\n")
    (tmp_path / "ok.py").write_text("x = 1\n")
    guard = ("import runpy, sys\n"
             "for m in ('numpy', 'torch', 'jax', 'jaxlib', 'repro'):\n"
             "    sys.modules[m] = None\n"
             "from repro_torch.lint.cli import main\n"
             "assert main(['ok.py']) == 0\n"
             "assert not [m for m in sys.modules if m.startswith("
             "'repro_torch.') and not m.startswith('repro_torch.lint')]\n"
             "sys.argv = ['lint', 'mod.py', '--format=github']\n"
             "runpy.run_module('repro_torch.lint', run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", guard],
                          capture_output=True, text=True,
                          env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin"},
                          cwd=tmp_path)
    assert proc.returncode == 1, proc.stderr
    assert proc.stdout.startswith("::error file=mod.py,line=1,col=0,"
                                  "title=repro_torch.lint obs-bare-print")
    assert "repro_torch.lint: 1 finding(s) in 1 file(s)" in proc.stderr
