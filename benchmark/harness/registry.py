"""Finds a cell's parts by name, each in its own file:

  BENCHMARK.json                  the cells, their metrics and bounds
  benchmark/workloads/<cell>.json the cell: configuration, traffic, chips,
                                  why, and the limits of its comparisons
  benchmark/configs/<config>.json a configuration as it is run
  benchmark/traffic/<traffic>.json a traffic mix: its kind and parameters
  benchmark/kinds/<kind>.py       the generator and driver of a kind
  benchmark/metrics/<metric>.py   the reader of one per-layer metric

so a later change adds a cell, a configuration, a mix or a metric by
adding files and entries, and edits none.
"""
from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType
from typing import Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
CELL_KEYS = ("config", "traffic", "chips", "why")


def _json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def spec(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def cell(name: str, root: str = ROOT) -> dict:
    """The cell `name`: its entry in BENCHMARK.json, which its own file
    must repeat, and the file's further keys (the limits of its
    comparisons, and what its kind reads)."""
    entries = {w["name"]: w for w in spec(root)["workloads"]}
    if name not in entries:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: "
                       f"{sorted(entries)}")
    own = _json(os.path.join(root, "benchmark", "workloads", f"{name}.json"))
    for key in CELL_KEYS:
        if own.get(key) != entries[name][key]:
            raise ValueError(f"benchmark/workloads/{name}.json gives {key} "
                             f"{own.get(key)!r}, BENCHMARK.json "
                             f"{entries[name][key]!r}")
    return {**own, **entries[name]}


def config(name: str, root: str = ROOT) -> dict:
    """The configuration `name` as it is run: its file, which must state
    every key its BENCHMARK.json entry lists under `reduced`."""
    entries = {c["name"]: c for c in spec(root)["configs"]}
    if name not in entries:
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")
    path = f"benchmark/configs/{name}.json"
    if entries[name]["file"] != path:
        raise ValueError(f"BENCHMARK.json gives {name!r} the file "
                         f"{entries[name]['file']!r}, not {path!r}")
    own = _json(os.path.join(root, path))
    missing = [k for k in entries[name]["reduced"] if k not in own]
    if missing:
        raise ValueError(f"{path} does not state the reduced keys {missing}")
    return own


def traffic(name: str, root: str = ROOT) -> dict:
    return _json(os.path.join(root, "benchmark", "traffic", f"{name}.json"))


def _module(path: str, label: str) -> ModuleType:
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    mod_spec = importlib.util.spec_from_file_location(label, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def kind(name: str, root: str = ROOT) -> ModuleType:
    return _module(os.path.join(root, "benchmark", "kinds", f"{name}.py"),
                   f"benchmark_kind_{name}")


def metric_reader(name: str, root: str = ROOT) -> ModuleType:
    return _module(os.path.join(root, "benchmark", "metrics", f"{name}.py"),
                   "benchmark_metric_" + name.replace(".", "_"))


def end_to_end(cell_name: str, root: str = ROOT) -> List[dict]:
    """The end-to-end metrics the cell reports: those that list it, and
    those that list no cells."""
    return [m for m in spec(root)["end_to_end"]
            if cell_name in m.get("workloads", [cell_name])]


def per_layer(cell_name: str, root: str = ROOT) -> List[dict]:
    """The per-layer metrics the cell reports: those that list it, and
    those without a list whose end-to-end metric the cell reports."""
    moved = {m["name"] for m in end_to_end(cell_name, root)}
    return [m for m in spec(root)["per_layer"]
            if cell_name in m.get("workloads", [])
            or ("workloads" not in m and m["moves"] in moved)]


def units(metrics: List[dict]) -> Dict[str, str]:
    return {m["name"]: m["unit"] for m in metrics}
