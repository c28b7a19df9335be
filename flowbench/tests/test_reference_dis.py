"""The DIS reference: the fields it refuses, what it imports, its agreement
with the port's CPU path and its control at a tiny size; the reader of
``kernel_calls_per_replay.batch`` on stand-in counters, and the two DIS
roofline readers' least times."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from flowbench import compare, frames, spec
from flowbench.reference import dis

CONFIG = json.loads((spec.ROOT / "configs" / "dis_opencv_medium_1080p.json").read_text())
REF_TOL = 1e-5  # float order only: the reference is a frozen copy of the plain arithmetic
FORBIDDEN = {"jax", "jaxlib", "flax", "cuda_optical_flow_2_tpu", "cuda_optical_flow_2_torch"}


def _fields():
    return CONFIG["fields"]


@pytest.mark.parametrize("change", [
    {"prefilter": {"window": 9, "sigma_spatial": 3.0, "sigma_range": 25.0}},
    {"use_pallas": False},
    {"window_method": "cumsum"},
    {"finest_level": 2},
    {"not_a_field": 1},
])
def test_check_fields_refuses_what_it_does_not_cover(change):
    with pytest.raises(ValueError):
        dis.check_fields({**_fields(), **change})


def test_check_fields_takes_the_preset_and_the_defaults():
    f = dis.check_fields(_fields())
    assert (f["levels"], f["finest_level"], f["iterations"], f["refine_penalty"]) == (
        7, 1, 25, "charbonnier")
    assert dis.check_fields({})["iterations"] == 2


def test_reference_imports_neither_the_port_nor_jax():
    out = subprocess.run(
        [sys.executable, "-c", "import flowbench.reference.dis, sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, cwd=spec.ROOT.parent, check=True, timeout=300)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & FORBIDDEN


def test_reference_matches_port_cpu_path_and_control_fails():
    from flowbench.port import Port

    port = Port(CONFIG)
    clip = frames.video_clip(5, 3, 128, 192, "cpu")
    got = port.entry(clip[:-1], clip[1:], port.config)
    want = dis.flow(clip[:-1], clip[1:], _fields())
    assert got.shape == want.shape == (2, 128, 192, 2)
    assert float((got - want).abs().max()) <= REF_TOL
    gaps = compare.Gaps()
    gaps.add(dis.flow(clip[:-1], clip[1:], _fields(), dtype=compare.CONTROL_DTYPE), want)
    assert gaps.worst["gap_median_px"] > 100 * REF_TOL


def _reader(name):
    return spec.module_at(spec.ROOT / "metrics" / f"{name}.py")


def test_kernel_calls_reader_weights_graphs_by_replays(monkeypatch):
    reader = _reader("kernel_calls_per_replay.batch")
    stats = {"entries": [{"name": "e", "graphs": [
        {"replays": 3, "taken": [], "branch_launches": [],
         "launches": {"a.f.launches": 4, "a.f.launches_centered": 4, "b.g.launches": 2}},
        {"replays": 1, "taken": [[2, 1]], "launches": {"a.f.launches": 1},
         "branch_launches": [[{"b.g.launches": 5}, {"b.g.launches": 7}]]},
    ]}]}
    monkeypatch.setattr(reader, "stats", lambda: stats)
    assert reader.read(None) == (3 * 6 + 1 * 1 + 2 * 5 + 1 * 7) / 4
    stats["entries"][0]["graphs"][0].pop("launches")  # a program without the counter
    assert reader.read(None) is None
    monkeypatch.setattr(reader, "stats", lambda: None)
    assert reader.read(None) is None


def test_roofline_readers_count_each_solved_level():
    from flowbench import roofline
    from flowbench.layers import config_view, meta

    cfg = config_view(CONFIG)
    shapes = [(1080 >> k, 1920 >> k) for k in range(1, 7)]
    search = _reader("roofline_pct.dis_search.batch").least_ms_per_pair(CONFIG)
    step = sum(25 * roofline.bound("lk_level_step", (meta(s), None, None, cfg),
                                   {"centered": True})[0] for s in shapes)
    first = roofline.bound("lk_residual", (meta(shapes[-1]), None, cfg), {"centered": True})[0]
    last = roofline.bound("lk_level_step", (meta(shapes[-1]), None, None, cfg),
                          {"centered": True})[0]
    assert search == pytest.approx(step - last + first)
    refine = _reader("roofline_pct.dis_refine.batch").least_ms_per_pair(CONFIG)
    assert refine == pytest.approx(sum(roofline.bound(
        "hs_relax", (meta(s), meta(s), meta(s + (2,))),
        {"iterations": 5, "temporal_kernel": "dt3", "robust": (3.0, 0.1),
         "it_offset": meta(s)})[0] for s in shapes))
    assert torch.Size(shapes[-1]) == (16, 30)
