"""Analyzer core: findings, suppressions, baselines, module contexts.

Pure stdlib (``ast`` + ``re``) — the analyzer must be importable and
runnable in a bare CI container with no numpy, torch or jax installed,
which is why nothing under `repro_torch.lint` imports any other module
of `repro_torch` (nor anything of `repro`).
"""

from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Set


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""

    path: str          # posix path, relative to the invocation cwd
    line: int
    col: int
    rule: str
    message: str

    def fingerprint(self) -> str:
        """Baseline identity: stable across col/message tweaks."""
        return f"{self.path}:{self.rule}:{self.line}"

    def render_text(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"

    def render_github(self) -> str:
        # one GitHub Actions workflow-command annotation per finding
        return (f"::error file={self.path},line={self.line},"
                f"col={self.col},title=repro_torch.lint "
                f"{self.rule}::{self.message}")


# `# lint: disable=rule-a,rule-b`   suppresses those rules on the line
# `# lint: disable`                 suppresses every rule on the line
_SUPPRESS_RE = re.compile(r"#\s*lint:\s*disable(?:=([\w,\-\s]+))?")

# `x: float = ...  # unit: gbps`    tags every name bound on the line
_UNIT_TAG_RE = re.compile(r"#\s*unit:\s*([\w/]+)")


def parse_suppressions(lines: Sequence[str]) -> Dict[int, Optional[Set[str]]]:
    """line (1-based) -> suppressed rule names, or None for "all"."""
    out: Dict[int, Optional[Set[str]]] = {}
    for i, line in enumerate(lines, start=1):
        m = _SUPPRESS_RE.search(line)
        if not m:
            continue
        if m.group(1) is None:
            out[i] = None
        else:
            out[i] = {r.strip() for r in m.group(1).split(",") if r.strip()}
    return out


def parse_unit_tags(lines: Sequence[str]) -> Dict[int, str]:
    """line (1-based) -> unit tag from a ``# unit: <tag>`` comment."""
    return {i: m.group(1)
            for i, line in enumerate(lines, start=1)
            if (m := _UNIT_TAG_RE.search(line))}


class ModuleContext:
    """Everything a rule needs about one parsed source file."""

    def __init__(self, path: Path, relpath: str, source: str,
                 search_roots: Sequence[Path] = ()):
        self.path = path
        self.relpath = relpath            # posix, cwd-relative (reported)
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=str(path))
        self.suppressions = parse_suppressions(self.lines)
        self.unit_tags = parse_unit_tags(self.lines)
        #: roots against which dotted module names resolve (the scanned
        #: top-level directories) — used by cross-file rules
        self.search_roots = tuple(search_roots)
        self._parents: Optional[Dict[ast.AST, ast.AST]] = None

    # built lazily: only the rules that need upward navigation pay for it
    @property
    def parents(self) -> Dict[ast.AST, ast.AST]:
        if self._parents is None:
            self._parents = {
                child: parent
                for parent in ast.walk(self.tree)
                for child in ast.iter_child_nodes(parent)
            }
        return self._parents

    def finding(self, node: ast.AST, rule: str, message: str) -> Finding:
        return Finding(self.relpath, getattr(node, "lineno", 1),
                       getattr(node, "col_offset", 0), rule, message)

    def resolve_module(self, dotted: str) -> Optional[Path]:
        """Resolve ``a.b.c`` to a source file under the search roots."""
        rel = Path(*dotted.split("."))
        for root in self.search_roots:
            for cand in (root / rel / "__init__.py",
                         root / rel.parent / (rel.name + ".py")):
                if cand.is_file():
                    return cand
        return None


class Rule:
    """One named check.  Subclasses set ``name``/``family`` and
    implement `check`."""

    name: str = ""
    family: str = ""
    description: str = ""

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        raise NotImplementedError


def iter_py_files(paths: Iterable[Path]) -> Iterator[Path]:
    for p in paths:
        if p.is_dir():
            yield from sorted(q for q in p.rglob("*.py"))
        elif p.suffix == ".py":
            yield p


@dataclasses.dataclass
class LintReport:
    """The outcome of one analyzer run."""

    findings: List[Finding]            # new findings (reported, gate CI)
    suppressed: int                    # dropped by inline suppressions
    baselined: int                     # dropped by the baseline file
    files_scanned: int

    @property
    def clean(self) -> bool:
        return not self.findings


def load_baseline(path: Path) -> Set[str]:
    """Fingerprints from a baseline file (blank/# lines ignored)."""
    if not path.is_file():
        return set()
    out = set()
    for line in path.read_text().splitlines():
        line = line.strip()
        if line and not line.startswith("#"):
            out.add(line)
    return out


def write_baseline(path: Path, findings: Iterable[Finding]) -> None:
    prints = sorted({f.fingerprint() for f in findings})
    body = "\n".join(prints)
    path.write_text(
        "# repro_torch.lint baseline — one `path:rule:line` fingerprint per\n"
        "# line.  Policy: this file stays EMPTY; fix or inline-suppress\n"
        "# (with a justification comment) instead of baselining.\n"
        + (body + "\n" if body else ""))


def run_rules(rules: Sequence[Rule], files: Iterable[Path], *,
              baseline: Optional[Set[str]] = None,
              search_roots: Sequence[Path] = (),
              cwd: Optional[Path] = None) -> LintReport:
    """Run ``rules`` over ``files``; apply suppressions and baseline."""
    baseline = baseline if baseline is not None else set()
    cwd = cwd or Path.cwd()
    new: List[Finding] = []
    n_suppressed = n_baselined = n_files = 0
    for path in files:
        n_files += 1
        try:
            rel = path.resolve().relative_to(cwd.resolve()).as_posix()
        except ValueError:
            rel = path.as_posix()
        try:
            ctx = ModuleContext(path, rel, path.read_text(),
                                search_roots=search_roots)
        except (SyntaxError, UnicodeDecodeError) as err:
            new.append(Finding(rel, getattr(err, "lineno", 1) or 1, 0,
                               "parse-error", f"cannot parse: {err}"))
            continue
        for rule in rules:
            for f in rule.check(ctx):
                sup = ctx.suppressions.get(f.line, "missing")
                if sup != "missing" and (sup is None or f.rule in sup):
                    n_suppressed += 1
                elif f.fingerprint() in baseline:
                    n_baselined += 1
                else:
                    new.append(f)
    new.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return LintReport(new, n_suppressed, n_baselined, n_files)
