"""Every definition file parses, the metrics are wired to the cells that
report what they move, and a cell added as new files alone is found."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from flowbench import spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["flowbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("flowbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_parse(cell):
    c = spec.load_cell(cell)
    assert c.config["name"] == cell.split(".")[0]
    assert set(c.limits) >= {"gap_median_px", "gap_p99_px"}
    assert hasattr(c.loop(), "Loop") and hasattr(c.reference(), "flow")
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    for m in c.per_layer:
        assert callable(c.reader(m["name"]).read)


def test_every_config_is_used():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_cells_report_what_it_moves(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    moved = next(x for x in BENCH["end_to_end"] if x["name"] == m["moves"])
    for cell in m["workloads"]:
        assert cell in CELLS
        assert cell in moved.get("workloads", CELLS)


def test_cell_added_as_new_files_is_found(tmp_path):
    root = tmp_path / "flowbench"
    shutil.copytree(spec.ROOT, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / "configs" / "lk_small.json").write_text(json.dumps(
        {**json.loads((spec.ROOT / "configs" / "lk_paper_1080p.json").read_text()),
         "name": "lk_small", "height": 480, "width": 640}))
    (root / "traffic" / "pairs_4.json").write_text(json.dumps(
        {**json.loads((spec.ROOT / "traffic" / "video_batch.json").read_text()),
         "pairs_per_call": 4}))
    (root / "limits" / "lk_small.pairs_4.json").write_text(
        json.dumps({"gap_median_px": 1.0, "gap_p99_px": 2.0}))
    (root / "metrics" / "calls_traced.pairs4.py").write_text(
        "def read(r):\n    return float(r.pairs)\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "lk_small", "source": "https://example.org",
                             "file": "flowbench/configs/lk_small.json", "reduced": [],
                             "why": "a fixture"})
    bench["workloads"].append({"name": "lk_small.pairs_4", "config": "lk_small",
                               "traffic": "pairs_4", "chips": 1, "why": "a fixture"})
    bench["end_to_end"][0]["workloads"].append("lk_small.pairs_4")
    bench["per_layer"].append({"name": "calls_traced.pairs4", "unit": "pairs", "better": "higher",
                               "source": "device_trace", "layer": "device",
                               "moves": "pairs_per_s", "workloads": ["lk_small.pairs_4"]})
    cell = spec.load_cell("lk_small.pairs_4", bench, root)
    assert cell.config["height"] == 480 and cell.traffic["pairs_per_call"] == 4
    assert [m["name"] for m in cell.end_to_end] == ["pairs_per_s", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["calls_traced.pairs4"]
    assert cell.reader("calls_traced.pairs4").read(type("R", (), {"pairs": 8})()) == 8.0
    assert cell.loop().__file__.startswith(str(root))
    assert cell.limits["gap_p99_px"] == 2.0
