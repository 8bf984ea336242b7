"""Units rule family: flag unit-mixing arithmetic and magic scale
literals that bypass `repro_torch.units`.

Unit inference is deliberately conservative — a finding requires the
unit to be *known* (suffix convention, exact-name registry, or a
``# unit: <tag>`` annotation comment), so untagged code is never
flagged.  Inference unwraps ``float(x)`` / ``int(x)`` / ``abs(x)`` and
reduction methods (``x.sum()`` ...), and propagates through ``+``/``-``
of same-unit operands; it does NOT propagate through ``*``/``/``
(a product has a new unit — that is the point of the family).
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from .base import Finding, ModuleContext, Rule
from .registry import (BYTEISH_UNITS, HELPER_RESULT_UNITS,
                       MAGIC_SCALE_LITERALS, NAME_UNITS, SUFFIX_UNITS,
                       UNITS_EXEMPT_SUFFIXES)

_UNWRAP_CALLS = {"float", "int", "abs", "round"}
_UNWRAP_METHODS = {"sum", "max", "min", "mean", "item", "tolist"}


def _name_unit(name: str, ctx: ModuleContext,
               lineno: int = 0) -> Optional[str]:
    if name in NAME_UNITS:
        return NAME_UNITS[name]
    if "_" in name:
        suffix = name.rsplit("_", 1)[1]
        if suffix in SUFFIX_UNITS:
            return SUFFIX_UNITS[suffix]
    return None


def infer_unit(node: ast.AST, ctx: ModuleContext) -> Optional[str]:
    """The unit tag of an expression, or None when unknown."""
    # `# unit: tag` annotation on the expression's own line wins
    tag = ctx.unit_tags.get(getattr(node, "lineno", -1))
    if tag is not None and isinstance(node, (ast.Name, ast.Attribute,
                                             ast.arg)):
        return tag
    if isinstance(node, ast.Name):
        return _name_unit(node.id, ctx, node.lineno)
    if isinstance(node, ast.Attribute):
        return _name_unit(node.attr, ctx, node.lineno)
    if isinstance(node, ast.Call):
        fn = node.func
        if isinstance(fn, ast.Name):
            if fn.id in HELPER_RESULT_UNITS:
                return HELPER_RESULT_UNITS[fn.id]
            if fn.id in _UNWRAP_CALLS and node.args:
                return infer_unit(node.args[0], ctx)
            return _name_unit(fn.id, ctx)       # e.g. mac_energy_pj(...)
        if isinstance(fn, ast.Attribute):
            if fn.attr in HELPER_RESULT_UNITS:
                return HELPER_RESULT_UNITS[fn.attr]
            if fn.attr in _UNWRAP_METHODS:
                return infer_unit(fn.value, ctx)
        return None
    if isinstance(node, ast.BinOp) and isinstance(node.op,
                                                  (ast.Add, ast.Sub)):
        left = infer_unit(node.left, ctx)
        right = infer_unit(node.right, ctx)
        if left is not None and left == right:
            return left
    if isinstance(node, ast.UnaryOp):
        return infer_unit(node.operand, ctx)
    if isinstance(node, ast.Subscript):        # nbytes[mask] stays bytes
        return infer_unit(node.value, ctx)
    return None


def _units_exempt(ctx: ModuleContext) -> bool:
    return ctx.relpath.endswith(UNITS_EXEMPT_SUFFIXES)


class MixedArithRule(Rule):
    name = "units-mixed-arith"
    family = "units"
    description = ("`a + b` / `a - b` between quantities with different "
                   "unit tags and no explicit conversion")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if _units_exempt(ctx):
            return
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.BinOp)
                    and isinstance(node.op, (ast.Add, ast.Sub))):
                continue
            left = infer_unit(node.left, ctx)
            right = infer_unit(node.right, ctx)
            if left is not None and right is not None and left != right:
                yield ctx.finding(
                    node, self.name,
                    f"adds `{left}` to `{right}`; convert one side "
                    f"through repro_torch.units first")


class MagicLiteralRule(Rule):
    name = "units-magic-literal"
    family = "units"
    description = ("inline scale-factor literal (1e9, 1e-12, `* 8` on a "
                   "byte quantity, ...) instead of a repro_torch.units "
                   "constant/helper")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if _units_exempt(ctx):
            return
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.BinOp)
                    and isinstance(node.op, (ast.Mult, ast.Div))):
                continue
            for const, other in ((node.left, node.right),
                                 (node.right, node.left)):
                if not (isinstance(const, ast.Constant)
                        and isinstance(const.value, (int, float))
                        and not isinstance(const.value, bool)):
                    continue
                val = float(const.value)
                if val in MAGIC_SCALE_LITERALS:
                    yield ctx.finding(
                        node, self.name,
                        f"magic scale literal {const.value!r}; use the "
                        f"named constant/helper from repro_torch.units")
                    break
                if val == 8.0 and infer_unit(other, ctx) in BYTEISH_UNITS:
                    yield ctx.finding(
                        node, self.name,
                        "bit<->byte conversion via bare `8`; use "
                        "repro_torch.units.BITS_PER_BYTE / "
                        "bytes_to_bits()")
                    break


class CallMixRule(Rule):
    name = "units-call-mix"
    family = "units"
    description = ("keyword argument whose unit tag differs from the "
                   "value passed (call-boundary unit mix)")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if _units_exempt(ctx):
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            for kw in node.keywords:
                if kw.arg is None:
                    continue
                want = _name_unit(kw.arg, ctx)
                if want is None:
                    continue
                got = infer_unit(kw.value, ctx)
                if got is not None and got != want:
                    yield ctx.finding(
                        kw.value, self.name,
                        f"passes `{got}` where parameter "
                        f"`{kw.arg}` expects `{want}`; convert through "
                        f"repro_torch.units")


RULES = (MixedArithRule(), MagicLiteralRule(), CallMixRule())
