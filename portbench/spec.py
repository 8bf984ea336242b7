"""Finding a cell's pieces from `BENCHMARK.json`, by name.

A cell (`workloads` entry) names a configuration and a traffic mix.  The
configuration's file is the entry's `file`; the mix is
`traffic/<traffic>.json`; the limits that decide `correct` are
`limits/<cell>.json`; each per-layer metric is read by
`metrics/<metric>.py`'s `read(cell, outcome)`.  A later cell, mix or
metric is a new file and a new entry: nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
from typing import Callable, Dict, List

PKG = pathlib.Path(__file__).resolve().parent
ROOT = PKG.parent


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict            # the configuration file, as run
    traffic: dict           # the traffic mix's parameters
    limits: Dict[str, dict]  # number -> {"limit", "lower", "upper", ...}
    end_to_end: List[dict]  # the metric entries this cell reports
    per_layer: List[dict]


def load(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str, moved: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in moved


def cell(bench: dict, name: str, root: pathlib.Path = ROOT) -> Cell:
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        names = ", ".join(w["name"] for w in bench["workloads"])
        raise KeyError(f"no workload {name!r} (there are: {names})")
    w = found[0]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, set())]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _applies(m, name, moved)]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=json.loads((root / conf["file"]).read_text()),
        traffic=json.loads((PKG / "traffic" / f"{w['traffic']}.json")
                           .read_text()),
        limits=json.loads((PKG / "limits" / f"{name}.json").read_text()),
        end_to_end=e2e, per_layer=layer)


def reader(metric: str) -> Callable:
    """`read(cell, outcome)` of `metrics/<metric>.py`."""
    path = PKG / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
