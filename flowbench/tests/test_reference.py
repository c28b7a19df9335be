"""The reference matches the port's plain CPU path at a tiny size, and its
control (bfloat16) does not."""

from __future__ import annotations

import pytest
import torch

from flowbench import compare, frames, spec
from flowbench.reference import lk, tvl1

H, W = 64, 96


def _pairs(n=3, seed=11):
    clip = frames.video_clip(seed, n + 1, H, W, "cpu")
    return clip[:-1], clip[1:]


def _port(config_name):
    from flowbench.port import Port

    return Port(spec.load_cell(next(
        w["name"] for w in spec.load_benchmark()["workloads"] if w["config"] == config_name
    )).config)


@pytest.mark.parametrize("config,ref", [("lk_paper_1080p", lk), ("tvl1_opencv_1080p", tvl1)])
def test_reference_matches_port_cpu_path(config, ref):
    port = _port(config)
    prev, nxt = _pairs()
    got = port.entry(prev, nxt, port.config)
    fields = spec.load_cell(next(w["name"] for w in spec.load_benchmark()["workloads"]
                                 if w["config"] == config)).config["fields"]
    want = ref.flow(prev, nxt, fields)
    assert got.shape == want.shape == (3, H, W, 2)
    assert float((got - want).abs().max()) <= 1e-5


@pytest.mark.parametrize("config,ref", [("lk_paper_1080p", lk), ("tvl1_opencv_1080p", tvl1)])
def test_bfloat16_control_moves_the_numbers(config, ref):
    cell = next(w["name"] for w in spec.load_benchmark()["workloads"] if w["config"] == config)
    fields = spec.load_cell(cell).config["fields"]
    prev, nxt = _pairs()
    gaps = compare.Gaps()
    gaps.add(ref.flow(prev, nxt, fields, dtype=compare.CONTROL_DTYPE), ref.flow(prev, nxt, fields))
    ok, failed, _ = compare.judge(gaps, spec.load_cell(cell).limits)
    assert not ok and failed >= 1


def test_stream_reference_matches_port_steps():
    from cuda_optical_flow_2_torch.models import streaming

    cell = spec.load_cell("lk_paper_1080p.camera_streams")
    fields, rec = cell.config["fields"], cell.traffic["recovery"]
    port = _port("lk_paper_1080p")
    clip = frames.stream_clips(3, 6, 2, H, W, "cpu", period_px=32)
    recovery = streaming.RecoveryConfig(**rec)
    state = streaming._init_state(clip[0], port.config, recovery)
    prev_flow = None
    decisions = []
    for t in range(1, 6):
        state, flow = streaming._step(state, clip[t], port.config, True, recovery)
        ok = prev_flow is not None and lk.seed_ok(clip[t - 1], clip[t], prev_flow, fields, rec)
        decisions.append(ok)
        for s in range(2):
            pf = None if prev_flow is None else prev_flow[s]
            want = lk.stream_flow(clip[t - 1][s], clip[t][s], pf, ok, fields, rec)
            assert float((flow[s] - want).abs().max()) <= 1e-5
        prev_flow = flow
    assert decisions[0] is False


def test_seed_ok_sees_a_cut():
    cell = spec.load_cell("lk_paper_1080p.camera_streams")
    fields, rec = cell.config["fields"], cell.traffic["recovery"]
    a = frames.stream_clips(3, 40, 2, 512, 768, "cpu")
    b = frames.stream_clips(9, 40, 2, 512, 768, "cpu")
    flow = lk.stream_flow(a[0], a[1], None, False, fields, rec)
    assert lk.seed_ok(a[1], a[2], flow, fields, rec)
    assert not lk.seed_ok(a[1], b[2], torch.full_like(flow, 8.0), fields, rec)
