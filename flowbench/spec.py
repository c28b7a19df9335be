"""Find a cell's definitions by name: ``BENCHMARK.json`` and the files under
``flowbench/`` that it names.

A cell ``<config>.<traffic>`` is one entry of ``workloads``.  Its pieces:

* ``configs/<config>.json``: the deployment (family, the port config's
  fields, frame size, source), named by the entry of ``configs``;
* ``traffic/<traffic>.json``: the loop kind and its parameters;
* ``loops/<kind>.py``: the loop that drives the port;
* ``reference/<family>.py``: the plain reference of the family;
* ``limits/<cell>.json``: the limits of the numbers compared;
* ``metrics/<metric>.py``: one reader per per-layer metric.

Everything is looked up under a root directory (the ``flowbench`` folder
by default), so a cell added as new files is found with no edit.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

__all__ = ["Cell", "ROOT", "load_benchmark", "load_cell", "module_at"]

ROOT = Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<traffic>.json
    limits: dict  # limits/<cell>.json
    end_to_end: list  # the metrics of BENCHMARK.json this cell reports, tracing off
    per_layer: list  # the metrics this cell reports in a --trace 1 run
    root: Path

    def loop(self) -> ModuleType:
        return module_at(self.root / "loops" / f"{self.traffic['loop']}.py")

    def reference(self) -> ModuleType:
        return module_at(self.root / "reference" / f"{self.config['family']}.py")

    def reader(self, metric: str) -> ModuleType:
        return module_at(self.root / "metrics" / f"{metric}.py")


def module_at(path: Path) -> ModuleType:
    """Import the file ``path`` as a module of its own."""
    name = "flowbench_dyn." + path.parent.name + "." + path.stem.replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def load_benchmark(path: Path | None = None) -> dict:
    return json.loads((path or ROOT.parent / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in e2e_names if "moves" in metric else True


def load_cell(name: str, bench: dict | None = None, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``bench`` (``BENCHMARK.json`` by default), its
    files read from ``root``."""
    bench = bench if bench is not None else load_benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; the benchmark has {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    conf_entry = configs[w["config"]]
    config = json.loads((root.parent / conf_entry["file"]).read_text())
    traffic = json.loads((root / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((root / "limits" / f"{name}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, set())]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, e2e_names)]
    return Cell(name, int(w["chips"]), config, traffic, limits, e2e, per_layer, root)
