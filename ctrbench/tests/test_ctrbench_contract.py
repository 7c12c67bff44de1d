"""``BENCHMARK.json`` against the shape its checker takes, and every piece
of every cell present under ``ctrbench/`` by name."""

import json
import os
import re

import pytest

from conftest import ROOT
from ctrbench.cell import load_cell, reader

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["ctrbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_entries_and_names():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("ctrbench/") and os.path.exists(os.path.join(ROOT, c["file"]))
        assert json.load(open(os.path.join(ROOT, c["file"])))["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for x in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"]


def test_every_cell_reports_its_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", CELLS)
    for w in CELLS:
        cell = load_cell(ROOT, w)
        reported = [m["name"] for m in cell.metrics(False)]
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.metrics(True)


@pytest.mark.parametrize("workload", CELLS)
def test_every_piece_is_found_by_name(workload):
    cell = load_cell(ROOT, workload)
    assert cell.chips == 1
    assert cell.counts().forward_flops_per_example(cell.model) > 0
    limits = json.load(open(os.path.join(ROOT, "ctrbench", "limits", f"{workload}.json")))
    for number in ("loss_gap", "grad_gap", "change_gap"):
        assert limits[number]["lower"] < limits[number]["limit"]
    for m in cell.metrics(False) + cell.metrics(True):
        assert callable(reader(ROOT, m["name"]))
