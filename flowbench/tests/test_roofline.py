"""The frozen roofline arithmetic equals ``chip_smoke.work`` at sample
shapes, and each roofline reader counts the stage's launches."""

from __future__ import annotations

import pytest
import torch

import chip_smoke
from flowbench import roofline
from flowbench.layers import level_shapes
from flowbench.spec import load_cell


def _lk(**kw):
    from cuda_optical_flow_2_torch.config import LKConfig

    return LKConfig(**kw)


SHAPES = [(1080, 1920), (135, 240), (479, 641), (2, 1080, 1920)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("case", [
    ("lk_residual", {}, "dt3"), ("lk_level_step", {}, "dt3"),
    ("lk_level_step", {"flow_half": True}, "delta"), ("lk_residual", {"centered": True}, "gauss3"),
])
def test_lk_work_matches_chip_smoke(shape, case):
    name, kw, temporal = case
    cfg = _lk(levels=5, window=15, temporal_kernel=temporal)
    args = (torch.empty(shape), None, None, cfg)
    assert roofline.work(name, args, kw) == chip_smoke.work(name, args, kw)
    assert roofline.bound(name, args, kw) == chip_smoke.bound(name, args, kw)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name,kw", [
    ("tvl1_relax", {"iterations": 30}), ("tvl1_relax_band", {"iterations": 8}),
    ("warp_bilinear_select", {}), ("pyr_down", {}), ("median_filter_kernel", {}),
    ("hs_relax", {"temporal_kernel": "dt3", "iterations": 100}),
    ("hs_relax", {"temporal_kernel": "dt3", "iterations": 100, "robust": "charbonnier"}),
])
def test_other_work_matches_chip_smoke(shape, name, kw):
    args = (torch.empty(shape), torch.empty(shape), None)
    assert roofline.work(name, args, kw) == chip_smoke.work(name, args, kw)
    assert roofline.bound(name, args, kw) == chip_smoke.bound(name, args, kw)


def test_peaks_match_chip_smoke():
    assert roofline.HBM_BYTES_PER_S == chip_smoke.HBM_BYTES_PER_S
    assert roofline.FP32_OPS_PER_S == chip_smoke.FP32_OPS_PER_S
    assert roofline.SFU_OPS_PER_S == chip_smoke.SFU_OPS_PER_S


def test_roofline_readers_count_the_stage():
    from flowbench.spec import module_at, ROOT

    lk = load_cell("lk_paper_1080p.video_batch").config
    cfg = _lk(levels=5, window=15, temporal_kernel="dt3")
    per_level = [chip_smoke.bound("lk_level_step", (torch.empty(s), None, None, cfg), {})[0]
                 for s in level_shapes(lk)]
    batch = module_at(ROOT / "metrics" / "roofline_pct.lk_level_step.batch.py")
    stream = module_at(ROOT / "metrics" / "roofline_pct.lk_level_step.stream.py")
    assert batch.least_ms_per_pair(lk) == pytest.approx(sum(per_level[:-1]))
    assert stream.least_ms_per_pair(lk) == pytest.approx(sum(per_level))
    tv = load_cell("tvl1_opencv_1080p.video_batch").config
    relax = module_at(ROOT / "metrics" / "roofline_pct.tvl1_relax.batch.py")
    want = 5 * sum(chip_smoke.bound("tvl1_relax", (torch.empty(s),), {"iterations": 30})[0]
                   for s in level_shapes(tv))
    assert relax.least_ms_per_pair(tv) == pytest.approx(want)
