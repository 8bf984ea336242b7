"""Trace/observability hygiene rule family.

Generalizes an ad-hoc "no bare prints" test into analyzer rules,
and adds the two `SimTrace` misuse modes that silently corrupt traces:
layer-relative events that are never placed on the absolute timeline,
and `recording(...)` called without `with` (which installs nothing).
"""

from __future__ import annotations

import ast
from typing import Iterator

from .base import Finding, ModuleContext, Rule
from .registry import PRINT_ALLOWED_SUFFIXES

_ADDERS = {"add_layer_event", "add_layer_matrix"}


class BarePrintRule(Rule):
    name = "obs-bare-print"
    family = "trace"
    description = ("`print(...)` outside the logger allowlist; report "
                   "through `obs.metrics.MetricsLogger`")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if ctx.relpath.endswith(PRINT_ALLOWED_SUFFIXES):
            return
        for node in ast.walk(ctx.tree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "print"):
                yield ctx.finding(
                    node, self.name,
                    "bare `print`; route output through "
                    "`obs.metrics.MetricsLogger` (the one allowed "
                    "`print` call site)")


class UnplacedLayerEventsRule(Rule):
    name = "obs-unplaced-layer-events"
    family = "trace"
    description = ("module builds a SimTrace and records layer-relative "
                   "events but never calls `place_layers`")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        constructs = adds = None
        places = False
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            name = (fn.id if isinstance(fn, ast.Name)
                    else fn.attr if isinstance(fn, ast.Attribute)
                    else None)
            if name == "SimTrace":
                constructs = constructs or node
            elif name in _ADDERS and isinstance(fn, ast.Attribute):
                adds = adds or node
            elif name == "place_layers" and isinstance(fn, ast.Attribute):
                places = True
        if constructs is not None and adds is not None and not places:
            yield ctx.finding(
                adds, self.name,
                "records layer-relative events on a SimTrace this module "
                "constructs, but never calls `place_layers(...)` — "
                "pending events would stay off the timeline")


class RecordingNoWithRule(Rule):
    name = "obs-recording-no-with"
    family = "trace"
    description = ("`recording(...)` used outside a `with` statement "
                   "(installs no recorder)")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call)
                    and ((isinstance(node.func, ast.Name)
                          and node.func.id == "recording")
                         or (isinstance(node.func, ast.Attribute)
                             and node.func.attr == "recording"))):
                continue
            parent = ctx.parents.get(node)
            if isinstance(parent, ast.withitem):
                continue
            yield ctx.finding(
                node, self.name,
                "`recording(...)` is a context manager; outside `with` "
                "it installs nothing (the block runs unrecorded)")


RULES = (BarePrintRule(), UnplacedLayerEventsRule(), RecordingNoWithRule())
