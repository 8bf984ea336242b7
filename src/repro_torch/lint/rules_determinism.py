"""Determinism rule family.

The golden/differential harnesses pin simulation outputs bit-for-bit,
which is only meaningful if every simulation path is a pure function of
its config: no global RNG streams, no wall-clock reads, no set-ordering
leaks into ordered outputs.
"""

from __future__ import annotations

import ast
from typing import Iterator, Set

from .base import Finding, ModuleContext, Rule
from .registry import (NP_RANDOM_LEGACY, STDLIB_RANDOM_FNS,
                       WALLCLOCK_ALLOWED_SEGMENTS,
                       WALLCLOCK_ALLOWED_SUFFIXES)

_WALLCLOCK_TIME_FNS = {
    "time", "time_ns", "perf_counter", "perf_counter_ns", "monotonic",
    "monotonic_ns", "process_time", "process_time_ns", "clock_gettime",
}
_WALLCLOCK_DATETIME_FNS = {"now", "utcnow", "today"}


def _module_aliases(tree: ast.Module, module: str) -> Set[str]:
    """Names the module is bound to (``import numpy as np`` -> {np})."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == module:
                    out.add(alias.asname or alias.name.split(".")[0])
    return out


def _imported_names(tree: ast.Module, module: str) -> Set[str]:
    """Names imported FROM ``module`` (``from random import choice``)."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module == module:
            for alias in node.names:
                out.add(alias.asname or alias.name)
    return out


class UnseededRngRule(Rule):
    name = "det-unseeded-rng"
    family = "determinism"
    description = ("global-stream RNG (`np.random.*` legacy functions, "
                   "stdlib `random.*`, argless `default_rng()`) in "
                   "simulation code")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        np_names = _module_aliases(ctx.tree, "numpy")
        random_names = _module_aliases(ctx.tree, "random")
        from_random = _imported_names(ctx.tree, "random") & STDLIB_RANDOM_FNS
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            # np.random.<legacy>(...) and np.random.default_rng()
            if (isinstance(fn, ast.Attribute)
                    and isinstance(fn.value, ast.Attribute)
                    and fn.value.attr == "random"
                    and isinstance(fn.value.value, ast.Name)
                    and fn.value.value.id in np_names):
                if fn.attr in NP_RANDOM_LEGACY:
                    yield ctx.finding(
                        node, self.name,
                        f"`np.random.{fn.attr}` draws from the global "
                        f"stream; use `np.random.default_rng(seed)`")
                elif fn.attr == "default_rng" and not (node.args
                                                       or node.keywords):
                    yield ctx.finding(
                        node, self.name,
                        "`default_rng()` without a seed is "
                        "entropy-seeded; thread an explicit seed")
            # random.<fn>(...) from the stdlib global stream
            elif (isinstance(fn, ast.Attribute)
                    and isinstance(fn.value, ast.Name)
                    and fn.value.id in random_names
                    and fn.attr in STDLIB_RANDOM_FNS):
                yield ctx.finding(
                    node, self.name,
                    f"stdlib `random.{fn.attr}` draws from the global "
                    f"stream; use a seeded `random.Random(seed)`")
            # from random import choice; choice(...)
            elif isinstance(fn, ast.Name) and fn.id in from_random:
                yield ctx.finding(
                    node, self.name,
                    f"`{fn.id}` (from stdlib random) draws from the "
                    f"global stream; use a seeded `random.Random(seed)`")


class WallclockRule(Rule):
    name = "det-wallclock"
    family = "determinism"
    description = ("wall-clock read (`time.time`, `perf_counter`, "
                   "`datetime.now`, ...) outside the sanctioned "
                   "timing surfaces")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if ctx.relpath.endswith(WALLCLOCK_ALLOWED_SUFFIXES):
            return
        parts = ctx.relpath.split("/")
        if any(seg in parts for seg in WALLCLOCK_ALLOWED_SEGMENTS):
            return
        time_names = _module_aliases(ctx.tree, "time")
        from_time = _imported_names(ctx.tree, "time") & _WALLCLOCK_TIME_FNS
        dt_mod_names = _module_aliases(ctx.tree, "datetime")
        dt_cls_names = _imported_names(ctx.tree, "datetime") & {"datetime",
                                                                "date"}
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if (isinstance(fn, ast.Attribute)
                    and isinstance(fn.value, ast.Name)
                    and fn.value.id in time_names
                    and fn.attr in _WALLCLOCK_TIME_FNS):
                yield ctx.finding(
                    node, self.name,
                    f"`time.{fn.attr}()` makes this path wall-clock "
                    f"dependent; time through "
                    f"`obs.metrics.DEFAULT_REGISTRY.span(...)` or move "
                    f"the read to an allowlisted driver")
            elif isinstance(fn, ast.Name) and fn.id in from_time:
                yield ctx.finding(
                    node, self.name,
                    f"`{fn.id}()` (from time) is a wall-clock read; "
                    f"time through `obs.metrics.DEFAULT_REGISTRY.span`")
            elif (isinstance(fn, ast.Attribute)
                    and fn.attr in _WALLCLOCK_DATETIME_FNS):
                base = fn.value
                if ((isinstance(base, ast.Name)
                     and base.id in dt_cls_names)
                        or (isinstance(base, ast.Attribute)
                            and isinstance(base.value, ast.Name)
                            and base.value.id in dt_mod_names)):
                    yield ctx.finding(
                        node, self.name,
                        f"`datetime .{fn.attr}()` is a wall-clock read; "
                        f"stamp timestamps in provenance/drivers only")


def _is_setish(node: ast.AST) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id in ("set", "frozenset")):
        return True
    if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)):
        return _is_setish(node.left) or _is_setish(node.right)
    return False


#: builtins whose result does not depend on argument order — a
#: comprehension consumed directly by one of these is order-safe
_ORDER_INSENSITIVE_CONSUMERS = {
    "sorted", "set", "frozenset", "sum", "min", "max", "len", "any",
    "all", "dict",
}


def _consumed_order_insensitively(comp: ast.AST,
                                  ctx: ModuleContext) -> bool:
    parent = ctx.parents.get(comp)
    return (isinstance(parent, ast.Call)
            and isinstance(parent.func, ast.Name)
            and parent.func.id in _ORDER_INSENSITIVE_CONSUMERS
            and comp in parent.args)


class SetIterationRule(Rule):
    name = "det-set-iteration"
    family = "determinism"
    description = ("iteration over an unordered set expression; wrap in "
                   "`sorted(...)` before feeding ordered outputs")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        iters = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.For, ast.AsyncFor)):
                iters.append(node.iter)
            elif isinstance(node, (ast.ListComp, ast.GeneratorExp,
                                   ast.DictComp, ast.SetComp)):
                # only the outermost generator feeds ordered output; a
                # SetComp's own iteration order is irrelevant, as is a
                # comprehension handed straight to sorted()/sum()/...
                if not (isinstance(node, ast.SetComp)
                        or _consumed_order_insensitively(node, ctx)):
                    iters.extend(g.iter for g in node.generators)
        for it in iters:
            if _is_setish(it):
                yield ctx.finding(
                    it, self.name,
                    "iterates a set in arbitrary order; wrap the set in "
                    "`sorted(...)` (or justify with a suppression) so "
                    "downstream output ordering is deterministic")


RULES = (UnseededRngRule(), WallclockRule(), SetIterationRule())
