"""A cell and everything it is made of, found by name: its entry in
``BENCHMARK.json``, its configuration (``ctrbench/configs/<config>.json``
and the counts beside it, ``<config>_counts.py``), its traffic mix
(``ctrbench/traffic/<mix>.json``), its limits
(``ctrbench/limits/<workload>.json``) and its metrics' readers
(``ctrbench/metrics/<metric>.py``, or that of the name before the first
dot)."""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

BENCH = "ctrbench"


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    root: str
    name: str
    chips: int
    config_name: str
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list

    @property
    def model(self) -> dict:
        return self.config["model"]

    @property
    def optimizer(self) -> dict:
        return self.config["optimizer"]

    def counts(self):
        """The configuration's counts module (``forward_flops_per_example``)."""
        return _module(os.path.join(self.root, BENCH, "configs",
                                    f"{self.config_name}_counts.py"),
                       f"ctrbench_counts_{self.config_name}")

    def metrics(self, trace: bool) -> list[dict]:
        """The metrics this cell reports in a run with or without the
        trace: those that list it, or list no cell and move a metric the
        cell reports."""
        mine = [m for m in self.end_to_end
                if self.name in m.get("workloads", [self.name])]
        if not trace:
            return mine
        moved = {m["name"] for m in mine}

        def reports(m: dict) -> bool:
            if "workloads" in m:
                return self.name in m["workloads"]
            return m["moves"] in moved

        return [m for m in self.per_layer if reports(m)]


def reader(root: str, metric: str):
    """The ``read(run)`` function of one metric: ``metrics/<metric>.py``,
    else that of the name before its first dot (``input_wait_pct.host_paced``
    reads as ``input_wait_pct`` does, in other cells)."""
    path = os.path.join(root, BENCH, "metrics", f"{metric}.py")
    if not os.path.exists(path):
        path = os.path.join(root, BENCH, "metrics", f"{metric.split('.')[0]}.py")
    return _module(path, f"ctrbench_metric_{metric.replace('.', '_')}").read


def load_cell(root: str, workload: str, *, config: dict | None = None,
              traffic: dict | None = None) -> Cell:
    """The cell ``workload`` of ``<root>/BENCHMARK.json``; ``config`` and
    ``traffic`` replace its files (the CPU tests' small sizes)."""
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    entry = {w["name"]: w for w in bench["workloads"]}.get(workload)
    if entry is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cfg_entry = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    return Cell(
        root=root, name=workload, chips=int(entry["chips"]), config_name=entry["config"],
        config=config or _load_json(os.path.join(root, cfg_entry["file"])),
        traffic=traffic or _load_json(os.path.join(root, BENCH, "traffic",
                                                   f"{entry['traffic']}.json")),
        end_to_end=bench["end_to_end"], per_layer=bench["per_layer"])
