"""BENCHMARK.json and every file it names: they parse, keep to the
benchmark's rules on names and units, and each cell finds its
configuration, mix, driver, limits and metric readers by name."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "bench_h100"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def _reader(name: str):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_top_level_shape():
    assert set(BENCH) == TOP_KEYS
    assert BENCH["command"] == ["python3", "bench_h100/run.py"]
    assert BENCH["paths"] == ["bench_h100"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_unique_and_allowed(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names), names


def test_config_entries():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench_h100/configs/")
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"]
        assert body["reduced"] == c["reduced"] == []
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_workload_entries():
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert NAME.match(w["traffic"]) and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        traffic = json.loads((HERE / "traffic" /
                              f"{w['traffic']}.json").read_text())
        assert (HERE / "drivers" / f"{traffic['driver']}.py").is_file()
        limits = json.loads((HERE / "workloads" /
                             f"{w['name']}.json").read_text())["limits"]
        assert limits and all(v >= 0 for v in limits.values())


def _cell_e2e(cell: str) -> set:
    return {m["name"] for m in BENCH["end_to_end"]
            if cell in m.get("workloads", [cell])}


def test_metric_entries():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        for cell in m["workloads"]:       # each cell reports what it moves
            assert m["moves"] in _cell_e2e(cell)
        reader = _reader(m["name"])
        assert (reader.UNIT, reader.MOVES, reader.LAYER) == (
            m["unit"], m["moves"], m["layer"])


def test_every_cell_reports_enough():
    for w in BENCH["workloads"]:
        e2e = _cell_e2e(w["name"])
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in m["workloads"] for m in BENCH["per_layer"])


def test_check_budget_fits_full_benchmark():
    """24 cells at this run length fit the check's 43,200 s."""
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_open_half_traffic():
    """The open loop at half its knee: one submitter's Poisson arrivals at
    a rate on the grid of 4/s, batches of 64 within 5 ms, the batch cell's
    64-photo pool, and the process's malloc tunables."""
    traffic = json.loads((HERE / "traffic" / "open-half.json").read_text())
    assert set(traffic) == {"driver", "loop", "batch_size", "max_delay_ms",
                            "rate_per_s", "malloc", "pool"}
    assert traffic["driver"] == "serve_open"
    # large buffers stay in the heap: glibc's largest mmap threshold
    assert traffic["malloc"]["M_MMAP_THRESHOLD"] == 32 * 2 ** 20
    assert (traffic["batch_size"], traffic["max_delay_ms"]) == (64, 5.0)
    assert traffic["rate_per_s"] > 0 and traffic["rate_per_s"] % 4 == 0
    batch = json.loads((HERE / "traffic" / "batch256.json").read_text())
    assert traffic["pool"] == batch["pool"] and traffic["pool"]["count"] == 64
