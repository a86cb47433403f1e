"""Where the harness finds each piece of a cell, by the names in BENCHMARK.json.

Everything that belongs to one cell, configuration, traffic driver or
per-layer metric is a file of its own, found by name, so that a later change
adds a cell, a configuration, a mix or a metric as new files and entries:

* ``BENCHMARK.json`` at the checkout's root: cells (``workloads``),
  configurations (``configs``, each with its ``file``) and metrics;
* ``h100_bench/workloads/<traffic>.json``: the mix a cell's ``traffic``
  names: its driver, the program's settings, the traffic's parameters and
  the limits of the correctness check;
* ``h100_bench/drivers/<driver>.py``: one general driver per kind of traffic;
* ``h100_bench/metrics/<metric>.py``: a reader with ``read(record)``, which
  returns the metric's value or None when the run has nothing to read.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re
from types import ModuleType
from typing import Dict, List, Optional

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
BENCH_DIR = "h100_bench"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: Dict            # the configuration file's dict
    workload: Dict          # the cell's file
    end_to_end: List[Dict]  # the end-to-end metrics the cell reports
    per_layer: List[Dict]   # the per-layer metrics the cell reports


def check_name(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"not a valid name: {name!r}")
    return name


def read_json(path: str) -> Dict:
    with open(path) as fh:
        return json.load(fh)


def _reports(metric: Dict, cell: str, moves_reported: Optional[set] = None) -> bool:
    """Whether a cell reports ``metric``: the cells its ``workloads`` lists,
    or without one, every cell that reports the end-to-end metric it moves
    (all cells for an end-to-end metric without a list)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if moves_reported is None:
        return True
    return metric.get("moves") in moves_reported


def load_cell(root: str, cell_name: str) -> Cell:
    """The cell ``cell_name`` of ``root``/BENCHMARK.json with its files."""
    bench = read_json(os.path.join(root, "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == cell_name), None)
    if entry is None:
        raise KeyError(f"no workload {cell_name!r} in BENCHMARK.json "
                       f"(has: {', '.join(w['name'] for w in bench['workloads'])})")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    workload = read_json(os.path.join(root, BENCH_DIR, "workloads",
                                      check_name(entry["traffic"]) + ".json"))
    if workload["config"] != entry["config"]:
        raise ValueError(f"{cell_name}: its file names config {workload['config']!r}, "
                         f"BENCHMARK.json {entry['config']!r}")
    e2e = [m for m in bench["end_to_end"] if _reports(m, cell_name)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _reports(m, cell_name, names)]
    return Cell(cell_name, int(entry["chips"]), entry["config"],
                read_json(os.path.join(root, conf["file"])), workload, e2e, layer)


def load_module(root: str, kind: str, name: str) -> ModuleType:
    """``h100_bench/<kind>/<name>.py`` as a module (a name may hold dots)."""
    path = os.path.join(root, BENCH_DIR, kind, check_name(name) + ".py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(f"h100_bench_{kind}_{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
