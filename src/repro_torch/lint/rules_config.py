"""Config hygiene rule family.

Config dataclasses are the contract between the planes: they must
fail fast on impossible values (`__post_init__`) or be explicitly
registered as unvalidated; provenance stamps must never leak into
equality; and the PEP 562 lazy re-export tables must stay in sync with
the submodules they proxy (a stale name raises only on first attribute
access — i.e. in user code, not in CI's import smoke).
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterator, List, Optional, Tuple

from .base import Finding, ModuleContext, Rule
from .registry import PROVENANCE_FIELD_NAMES, UNVALIDATED_CONFIGS

_CONFIG_SUFFIXES = ("Config", "Spec", "Plan", "Scenario", "Profile")
_EXPORTS_NAME_RE = re.compile(r"^_[A-Z0-9_]*EXPORTS$")


def _is_dataclass(node: ast.ClassDef) -> bool:
    for dec in node.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        name = (target.id if isinstance(target, ast.Name)
                else target.attr if isinstance(target, ast.Attribute)
                else None)
        if name == "dataclass":
            return True
    return False


class UnvalidatedDataclassRule(Rule):
    name = "cfg-unvalidated-dataclass"
    family = "config"
    description = ("public `*Config`/`*Spec`/`*Plan`/`*Scenario`/"
                   "`*Profile` dataclass without `__post_init__` "
                   "validation and not registered as intentionally "
                   "unvalidated")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.ClassDef)
                    and _is_dataclass(node)
                    and not node.name.startswith("_")
                    and node.name.endswith(_CONFIG_SUFFIXES)):
                continue
            if node.name in UNVALIDATED_CONFIGS:
                continue
            if any(isinstance(m, ast.FunctionDef)
                   and m.name == "__post_init__" for m in node.body):
                continue
            yield ctx.finding(
                node, self.name,
                f"config dataclass `{node.name}` neither validates in "
                f"`__post_init__` nor is registered in "
                f"`repro_torch.lint.registry.UNVALIDATED_CONFIGS`")


class ProvenanceCompareRule(Rule):
    name = "cfg-provenance-compare"
    family = "config"
    description = ("provenance field on a dataclass must be declared "
                   "with `field(..., compare=False)`")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for cls in ast.walk(ctx.tree):
            if not (isinstance(cls, ast.ClassDef) and _is_dataclass(cls)):
                continue
            for stmt in cls.body:
                if not (isinstance(stmt, ast.AnnAssign)
                        and isinstance(stmt.target, ast.Name)
                        and stmt.target.id in PROVENANCE_FIELD_NAMES):
                    continue
                if self._compare_false(stmt.value):
                    continue
                yield ctx.finding(
                    stmt, self.name,
                    f"`{cls.name}.{stmt.target.id}` is run metadata; "
                    f"declare it `dataclasses.field(default=None, "
                    f"compare=False)` so stamps never break equality")

    @staticmethod
    def _compare_false(value: Optional[ast.AST]) -> bool:
        if not isinstance(value, ast.Call):
            return False
        fn = value.func
        name = (fn.id if isinstance(fn, ast.Name)
                else fn.attr if isinstance(fn, ast.Attribute) else None)
        if name != "field":
            return False
        return any(kw.arg == "compare"
                   and isinstance(kw.value, ast.Constant)
                   and kw.value.value is False
                   for kw in value.keywords)


class LazyExportMismatchRule(Rule):
    name = "cfg-lazy-export-mismatch"
    family = "config"
    description = ("PEP 562 `_*_EXPORTS` entry that the target "
                   "submodule does not define/export")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        has_getattr = any(isinstance(n, ast.FunctionDef)
                          and n.name == "__getattr__"
                          for n in ctx.tree.body)
        if not has_getattr:
            return
        tables = self._export_tables(ctx)
        targets = self._export_targets(ctx)
        for var, (node, names) in tables.items():
            dotted = targets.get(var)
            if dotted is None:
                continue
            path = ctx.resolve_module(dotted)
            if path is None:
                yield ctx.finding(
                    node, self.name,
                    f"lazy-export target module `{dotted}` not found "
                    f"under the scanned roots")
                continue
            exported = self._module_exports(path)
            if exported is None:
                continue
            for missing in [n for n in names if n not in exported]:
                yield ctx.finding(
                    node, self.name,
                    f"`{var}` re-exports `{missing}` but `{dotted}` "
                    f"does not define/export it — the name raises "
                    f"AttributeError on first access")

    @staticmethod
    def _export_tables(ctx: ModuleContext
                       ) -> Dict[str, Tuple[ast.AST, List[str]]]:
        out: Dict[str, Tuple[ast.AST, List[str]]] = {}
        for node in ctx.tree.body:
            if not (isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and _EXPORTS_NAME_RE.match(node.targets[0].id)
                    and isinstance(node.value, (ast.Tuple, ast.List))):
                continue
            names = [e.value for e in node.value.elts
                     if isinstance(e, ast.Constant)
                     and isinstance(e.value, str)]
            out[node.targets[0].id] = (node, names)
        return out

    @staticmethod
    def _export_targets(ctx: ModuleContext) -> Dict[str, str]:
        """exports-table name -> dotted module, from the ``if name in
        _X_EXPORTS: import a.b; return getattr(a.b, name)`` pattern."""
        out: Dict[str, str] = {}
        for fn in ctx.tree.body:
            if not (isinstance(fn, ast.FunctionDef)
                    and fn.name == "__getattr__"):
                continue
            for branch in ast.walk(fn):
                if not (isinstance(branch, ast.If)
                        and isinstance(branch.test, ast.Compare)
                        and len(branch.test.ops) == 1
                        and isinstance(branch.test.ops[0], ast.In)
                        and isinstance(branch.test.comparators[0],
                                       ast.Name)):
                    continue
                var = branch.test.comparators[0].id
                for stmt in ast.walk(branch):
                    if isinstance(stmt, ast.Import) and stmt.names:
                        out[var] = stmt.names[0].name
                        break
        return out

    @staticmethod
    def _module_exports(path) -> Optional[set]:
        """Names the target module exports: its `__all__` when present,
        else every top-level binding."""
        try:
            tree = ast.parse(path.read_text(), filename=str(path))
        except (SyntaxError, UnicodeDecodeError):
            return None
        bound: set = set()
        for node in tree.body:
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        if (tgt.id == "__all__"
                                and isinstance(node.value,
                                               (ast.Tuple, ast.List))):
                            explicit = {e.value for e in node.value.elts
                                        if isinstance(e, ast.Constant)
                                        and isinstance(e.value, str)}
                            # `__all__` with starred pieces falls back
                            # to "all bindings" below
                            if len(explicit) == len(node.value.elts):
                                return explicit
                        bound.add(tgt.id)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.ClassDef)):
                bound.add(node.name)
            elif isinstance(node, ast.AnnAssign) and isinstance(
                    node.target, ast.Name):
                bound.add(node.target.id)
            elif isinstance(node, (ast.Import, ast.ImportFrom)):
                for alias in node.names:
                    bound.add(alias.asname
                              or alias.name.split(".")[0])
        return bound


RULES = (UnvalidatedDataclassRule(), ProvenanceCompareRule(),
         LazyExportMismatchRule())
