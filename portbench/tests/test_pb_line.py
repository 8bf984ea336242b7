"""The result's line: its keys, the cell's metrics, and the compared
numbers last, from whole runs of both cells cut to CPU sizes."""

import json

import pytest

from pb_small import context, small_cell
from portbench.harness import run_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("name", ["mamba2-train", "mixtral-prefill"])
def test_untraced_line(name):
    cell = small_cell(name)
    line = run_cell(context(cell))
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert "breakdown" not in line
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(v["unit"] and v["value"] > 0 for k, v in
               line["metrics"].items() if k != "peak_mem_gib")
    assert line["device"] == {"platform": "cpu", "kind": "cpu", "count": 1,
                              "memory_peak_bytes": 0}
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["checks"]) == set(cell.limits)
    assert line["correct"] is True
    json.dumps(line)


@pytest.mark.parametrize("name", ["mamba2-train", "mixtral-prefill"])
def test_traced_line(name):
    cell = small_cell(name)
    line = run_cell(context(cell, trace=True))
    assert list(line)[-1] == "checks"
    # on the CPU only the host times are reported: no share of the
    # card's peaks, no reading of the card's trace
    want = {m["name"] for m in cell.per_layer if "_ms_median." in m["name"]}
    assert set(line["metrics"]) == want
    assert line["device"]["busy_s"] > 0 and line["device"]["window_s"] > 0
    bd = line["breakdown"]
    assert set(bd) == {"device_ops", "idle_gaps"}
    assert 0 < len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10
    assert all(isinstance(n, str) and s >= 0 for n, s in bd["device_ops"])
