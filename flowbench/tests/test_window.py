"""The window arithmetic: a rate over all the work and all the time, and a
tail over every call, so one stalled call moves them."""

from __future__ import annotations

import pytest
import torch

from flowbench.stats import percentile, rate
from tests_helpers import FakePort

STALL_S = 1.0


def test_percentile_is_nearest_rank():
    values = list(range(1, 101))
    assert percentile(values, 95) == 95
    assert percentile(values, 50) == 50
    assert percentile([3.0], 95) == 3.0
    with pytest.raises(ValueError):
        percentile([], 95)


def test_rate_counts_the_whole_window():
    assert rate(100, 2.0) == 50.0
    with pytest.raises(ValueError):
        rate(1, 0.0)


def _batch_window(stall_at, pairs_per_call=1, seconds=0.12):
    from conftest import tiny

    cell = tiny("tvl1_opencv_1080p.single_pair", pairs_per_call=pairs_per_call)
    port = FakePort(cell, call_s=0.01, stall_at=stall_at, stall_s=STALL_S)
    loop = cell.loop().Loop(cell, 5, torch.device("cpu"), port)
    loop.warm_up()
    return loop.run(seconds)["values"]


def test_batch_rate_and_tail_move_when_one_call_stalls():
    # set-up makes 4 calls; the stall is the window's second call
    calm, stalled = _batch_window(None), _batch_window(5)
    assert stalled["pairs_per_s"] < 0.5 * calm["pairs_per_s"]
    # one call of the window's few is more than the 5 % beyond the 95th
    # percentile (the margin leaves room for the host's own hiccups)
    assert stalled["pair_ms_p95"] > calm["pair_ms_p95"] + 500 * STALL_S


def _stream_window(stall_at):
    from conftest import tiny

    cell = tiny("lk_paper_1080p.camera_streams", fps=50, check_ticks=1)
    port = FakePort(cell, call_s=0.005, stall_at=stall_at, stall_s=STALL_S)
    loop = cell.loop().Loop(cell, 5, torch.device("cpu"), port)
    loop.warm_up()
    return loop.run(1.0)


def test_open_loop_tail_counts_the_ticks_behind_a_stall():
    calm, stalled = _stream_window(None), _stream_window(20)
    # the stall holds up the ticks due during it: far more than 5 % of 50
    assert stalled["values"]["frame_ms_p95"] > calm["values"]["frame_ms_p95"] + 500 * STALL_S
    assert stalled["load"]["late_ms_max"] > 800 * STALL_S
