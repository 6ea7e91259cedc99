"""``BENCHMARK.json`` and the files its names point at.

A cell (``workloads`` entry) names a configuration and a traffic mix; a
metric is named in ``end_to_end`` or ``per_layer``. Each is found by name:

* the configuration at its entry's ``file``;
* the traffic mix at ``perfbench/traffic/<traffic>.json``;
* the reader of a metric at ``perfbench/metrics/<metric>.py``, a module
  with ``read(ctx)`` that returns a number, or ``None`` where it finds
  nothing to read.

So a later change adds a configuration, a mix, a metric or a cell by adding
files and entries, and edits none.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCHMARK_FILE = "BENCHMARK.json"
TRAFFIC_DIR = "perfbench/traffic"
METRICS_DIR = "perfbench/metrics"


@dataclass
class Metric:
    name: str
    unit: str
    entry: dict                    # its BENCHMARK.json entry
    read: Callable


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""
    name: str
    chips: int
    workload: dict
    config: dict
    traffic: dict
    end_to_end: List[Metric] = field(default_factory=list)
    per_layer: List[Metric] = field(default_factory=list)
    run_seconds: int = 10


@dataclass
class Ctx:
    """What a metric's reader reads: the cell, the set-up seconds, the
    window's host timings, the memory peak, the system's facts (batch,
    route, parameter count …) and, in a traced run, the trace and the
    number of calls whose kernels it holds (``whole``: the launches of the
    configuration's ``trace_marker`` kernel)."""
    cell: Cell
    setup_s: float
    window: object
    memory_peak_bytes: int
    facts: dict
    trace: object = None
    whole: Optional[int] = None

    @property
    def config(self) -> dict:
        return self.cell.config


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """The Python file at ``path`` as a module (a metric's name may hold
    dots, so it is no importable module name)."""
    spec = importlib.util.spec_from_file_location(f"perfbench_file.{name}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reader(root: Path, name: str) -> Callable:
    path = root / METRICS_DIR / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r} at {path}")
    read = getattr(load_module(path, name), "read", None)
    if read is None:
        raise AttributeError(f"{path} has no read(ctx)")
    return read


def _reports(entry: dict, cell: str, e2e_names: Optional[set] = None) -> bool:
    """Whether a metric entry is reported in ``cell``: listed under its
    ``workloads``, or, without that key, an end-to-end metric of every cell,
    or a per-layer one of every cell that reports the metric it moves."""
    if "workloads" in entry:
        return cell in entry["workloads"]
    if e2e_names is None:
        return True
    return entry.get("moves") in e2e_names


def load_cell(workload: str, root: Path = Path(".")) -> Cell:
    """The cell ``workload`` of ``<root>/BENCHMARK.json`` with its
    configuration, traffic and metric readers."""
    root = Path(root)
    bench = load_json(root / BENCHMARK_FILE)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {BENCHMARK_FILE}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = dict(load_json(root / configs[w["config"]]["file"]))
    traffic = load_json(root / TRAFFIC_DIR / f"{w['traffic']}.json")
    cell = Cell(name=workload, chips=int(w["chips"]), workload=w, config=config,
                traffic=traffic, run_seconds=int(bench["run_seconds"]))
    for entry in bench["end_to_end"]:
        if _reports(entry, workload):
            cell.end_to_end.append(Metric(entry["name"], entry["unit"], entry,
                                          _reader(root, entry["name"])))
    e2e = {m.name for m in cell.end_to_end}
    for entry in bench["per_layer"]:
        if _reports(entry, workload, e2e):
            cell.per_layer.append(Metric(entry["name"], entry["unit"], entry,
                                         _reader(root, entry["name"])))
    return cell


def read_metrics(metrics: List[Metric], ctx) -> Dict[str, dict]:
    """``{name: {"value", "unit"}}`` of each metric whose reader found
    something to read."""
    out = {}
    for m in metrics:
        value = m.read(ctx)
        if value is not None:
            out[m.name] = {"value": float(value), "unit": m.unit}
    return out
