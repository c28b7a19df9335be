"""OpenCV's DIS PRESET_MEDIUM on the port (CPU): the benchmark's
``dis_opencv_medium_1080p`` configuration.

* The port's ``pyramidal_dis`` on its CPU plain path, at the preset's
  fields (7 levels fit 128x192: level 6 is 2x3), against the benchmark's
  plain reference ``flowbench/reference/dis.py``.  The reference is a frozen
  copy of the plain arithmetic, so the two may differ by float order only:
  ``REF_TOL`` (1e-5 px, as ``flowbench/tests/test_reference.py`` holds the
  LK and TV-L1 references).  The same reference run in bfloat16, the
  precision below the configuration's float32, misses it.
* The configuration file builds ``DISConfig`` with the preset's values.
* The spans ``dis.search`` and ``dis.refine``: once per solved level with
  their attributes while a profiler records, none otherwise.
* ``capture.stats()``'s per-graph ``launches`` through the stand-in graph
  (``tests/torch_capture_stand_in.py``), with spies that count a launch per
  wrapper call on CPU tensors: the eager call's counter changes, which are
  the preset's predicted launches (``chip_smoke.DIS_MEDIUM_LAUNCHES``, which
  phase 8r holds the card to).
"""

import json
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from chip_smoke import DIS_MEDIUM_LAUNCHES as PREDICTED
from cuda_optical_flow_2_torch import capture
from cuda_optical_flow_2_torch.kernels import (
    hs_sweep, lk_fused, lk_step_fused, pyr_down, upsample_flow, warp_select,
)
from cuda_optical_flow_2_torch.models import dis as tdis
from cuda_optical_flow_2_torch.utils import profiling

from flowbench.reference import dis as rdis

from torch_capture_stand_in import StandInGraph, stand_in  # noqa: F401  (a fixture)

CONFIG = Path(__file__).resolve().parents[1] / "flowbench" / "configs" / \
    "dis_opencv_medium_1080p.json"
REF_TOL = 1e-5
PRESET = {"levels": 7, "finest_level": 1, "iterations": 25, "window": 9,
          "mean_normalize": True, "refine_iterations": 5, "refine_alpha": 20.0,
          "refine_penalty": "charbonnier", "use_pallas": True}
SOLVED = [6, 5, 4, 3, 2, 1]


def _fields() -> dict:
    return json.loads(CONFIG.read_text())["fields"]


def _config() -> tdis.DISConfig:
    return tdis.DISConfig(**_fields())


def _pair(h=128, w=192, seed=24):
    g = torch.Generator().manual_seed(seed)
    prev = torch.randint(0, 256, (2, h, w), generator=g, dtype=torch.uint8)
    noise = torch.randint(-3, 4, (2, h, w), generator=g)
    nxt = (torch.roll(prev, (1, 2), dims=(-2, -1)).int() + noise).clamp(0, 255).to(torch.uint8)
    return prev, nxt


def _epe(a, b) -> torch.Tensor:
    return (a - b).pow(2).sum(-1).sqrt()


def test_config_file_is_the_preset():
    cfg = _config()
    for name, value in PRESET.items():
        assert getattr(cfg, name) == value, name
    other = {k: v for k, v in _fields().items() if k not in PRESET}
    assert other == {k: getattr(tdis.DISConfig(), k) for k in other}
    data = json.loads(CONFIG.read_text())
    assert data["reduced"] == [] and data["family"] == "dis"
    assert "PRESET_MEDIUM" in data["source"] and "Kroeger" in data["source"]
    assert len(data["departures"]) == 6 and len(data["assumed"]) == 3
    assert any("its own flow" in d for d in data["departures"])
    assert "supported" not in data and "drift" in data["accuracy"]


def test_port_matches_the_reference_and_bfloat16_does_not():
    prev, nxt = _pair()
    got = tdis.pyramidal_dis_jit(prev, nxt, _config())
    want = rdis.flow(prev, nxt, _fields())
    assert got.shape == want.shape == (2, 128, 192, 2)
    assert float(_epe(got, want).max()) <= REF_TOL
    inner = want[:, 16:-16, 16:-16].reshape(-1, 2).median(0).values
    assert abs(float(inner[0]) - 2.0) < 0.2 and abs(float(inner[1]) - 1.0) < 0.2
    control = rdis.flow(prev, nxt, _fields(), dtype=torch.bfloat16)
    assert float(_epe(control, want).max()) > 100 * REF_TOL


def _dis_spans(record: bool) -> list:
    prev, nxt = _pair()
    profiling.clear_spans()
    if record:
        with profile(activities=[ProfilerActivity.CPU]):
            tdis.pyramidal_dis(prev, nxt, _config())
    else:
        tdis.pyramidal_dis(prev, nxt, _config())
    return sorted((s for s in profiling.spans() if s.name.startswith("dis.")),
                  key=lambda s: s.start_ns)


def test_spans_once_per_solved_level_while_recording():
    spans = _dis_spans(record=True)
    assert [(s.name, s.attrs) for s in spans] == [
        pair for k in SOLVED for pair in (
            ("dis.search", {"level": k, "steps": 25}),
            ("dis.refine", {"level": k, "sweeps": 5, "penalty": "charbonnier"}))]
    for search, refine in zip(spans[::2], spans[1::2]):
        assert search.end_ns <= refine.start_ns and search.parent is None


def test_no_spans_without_a_profiler():
    assert _dis_spans(record=False) == []


def _spy(mp, module, name, centered_at=None):
    """A wrapper that counts one launch per call on CPU tensors (and a
    centered one when its ``centered`` argument is true), then runs it."""
    original = getattr(module, name)

    def spy(*args, **kwargs):
        original.launches += 1
        if centered_at is not None and args[centered_at]:
            original.launches_centered += 1
        return original(*args, **kwargs)

    mp.setattr(module, name, spy)


def test_stats_carry_each_graphs_launches(stand_in, monkeypatch):
    capture.counters()  # the registry holds the wrappers, not the spies
    prev, nxt = _pair()
    cfg = _config()
    start = capture.snapshot()
    try:
        with monkeypatch.context() as mp:
            _spy(mp, pyr_down, "pyr_down")
            _spy(mp, lk_fused, "lk_residual", centered_at=3)
            _spy(mp, lk_step_fused, "lk_level_step", centered_at=4)
            _spy(mp, warp_select, "warp_bilinear_select")
            _spy(mp, hs_sweep, "hs_relax")
            _spy(mp, upsample_flow, "upsample_flow")
            eager = tdis.pyramidal_dis(prev, nxt, cfg)
            one_call = capture.delta(start, capture.snapshot())
            flows = [tdis.pyramidal_dis_jit(prev, nxt, cfg) for _ in range(2)]
            two_calls = capture.delta(start, capture.snapshot())
        assert one_call == PREDICTED
        assert two_calls == {k: 3 * v for k, v in PREDICTED.items()}
        assert all(torch.equal(f, eager) for f in flows)
        (entry,) = [e for e in capture.stats()["entries"]
                    if e["name"].endswith("models.dis.pyramidal_dis")]
        (graph,) = entry["graphs"]
        assert graph["launches"] == PREDICTED
        assert graph["branch_launches"] == [] and graph["replays"] == 2
    finally:
        capture.restore(start)
