"""A cell as the files name it: its entry in `BENCHMARK.json`, its
configuration's file, its traffic mix's file, its own file of limits, the
driver the traffic names, and the readers of its per-layer metrics.

Everything is found by name, so a later change adds a cell, a
configuration, a mix or a metric by adding files and an entry:

    bench_h100/configs/<config>.json      sizes, the program's settings
    bench_h100/traffic/<traffic>.json     the mix's parameters, its driver
    bench_h100/workloads/<cell>.json      the cell's limits and readings
    bench_h100/drivers/<driver>.py        setup, window, check of a path
    bench_h100/metrics/<metric>.py        one per-layer metric's reader
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent.parent      # bench_h100/
ROOT = HERE.parent


def _json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _module(path: Path, name: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict           # the workload's entry in BENCHMARK.json
    config: dict          # configs/<config>.json
    traffic: dict         # traffic/<traffic>.json
    limits: dict          # workloads/<cell>.json
    end_to_end: list      # the end-to-end metrics this cell reports
    per_layer: list       # the per-layer metrics this cell reports
    driver: ModuleType

    def reader(self, metric: str) -> ModuleType:
        return _module(HERE / "metrics" / f"{metric}.py",
                       "bench_metric_" + metric.replace(".", "_"))


def _reports(metric: dict, cell: str, e2e_of_cell: set | None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_of_cell is None or metric["moves"] in e2e_of_cell


def load(name: str) -> Cell:
    """The cell `name` of BENCHMARK.json; raises KeyError when there is
    none."""
    bench = _json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])
    traffic = _json(HERE / "traffic" / f"{entry['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, None)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    driver = _module(HERE / "drivers" / f"{traffic['driver']}.py",
                     "bench_driver_" + traffic["driver"])
    return Cell(name, entry, _json(ROOT / config["file"]), traffic,
                _json(HERE / "workloads" / f"{name}.json"), e2e, per_layer,
                driver)
