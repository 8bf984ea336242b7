"""BENCHMARK.json and the files it names: every cell, configuration,
traffic mix, limit and metric found by name, within the contract's
limits."""

import json
import re

import pytest

from portbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
BENCH = spec.load()


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert all(not w.startswith("/") and ".." not in w
               for w in BENCH["command"])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(w):
    cell = spec.cell(BENCH, w["name"])
    assert cell.chips in (1, 4)
    assert cell.traffic["kind"] in ("train", "prefill")
    assert {"setup_s"} <= {m["name"] for m in cell.end_to_end}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    assert cell.limits and all(
        v["lower"] < v["limit"] < v["upper"] for v in cell.limits.values())
    for m in cell.per_layer:
        assert callable(spec.reader(m["name"]))
        assert m["moves"] in {e["name"] for e in cell.end_to_end}


def test_names_units_and_sources():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all("\n" not in x and 0 < len(x) <= 200 for x in layers)


def test_configs_are_used_and_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("portbench/configs/")
        data = json.loads((spec.ROOT / c["file"]).read_text())
        assert data["name"] == c["name"]
        assert sorted(data["reduced"]) == sorted(c["reduced"])
        widths = ("d_model", "head_dim", "d_ff", "moe_d_ff", "ssm_state",
                  "ssm_head_dim", "expand", "experts_per_token")
        assert not set(c["reduced"]) & set(widths)


def test_a_new_metric_is_found_by_its_file(tmp_path, monkeypatch):
    """A per-layer metric is a file and an entry, nothing more."""
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "x_share.train.py").write_text(
        "def read(cell, out):\n    return 42.0\n")
    monkeypatch.setattr(spec, "PKG", tmp_path)
    assert spec.reader("x_share.train")(None, None) == 42.0


def test_metric_applies_by_workloads_or_by_what_it_moves():
    bench = dict(BENCH, per_layer=BENCH["per_layer"] + [
        {"name": "every_train_cell", "unit": "%", "better": "higher",
         "source": "device_trace", "layer": "device",
         "moves": "train_tokens_per_s"}])
    names = {m["name"] for m in spec.cell(bench, "mamba2-train").per_layer}
    assert "every_train_cell" in names
    names = {m["name"] for m in spec.cell(bench, "mixtral-prefill").per_layer}
    assert "every_train_cell" not in names
