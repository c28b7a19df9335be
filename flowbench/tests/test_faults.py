"""The harness, run on the CPU past its look for a card, finds the sound
port correct and a broken one not: the faults a cell can have, each planted
where the answer is produced.  (One card per cell: no exchange between
cards to leave out.)"""

from __future__ import annotations

import time

import pytest
import torch

from conftest import tiny
from flowbench.run import run_cell

CELLS = ["lk_paper_1080p.video_batch", "tvl1_opencv_1080p.video_batch",
         "lk_paper_1080p.camera_streams", "tvl1_opencv_1080p.single_pair"]
BATCHED = CELLS[:2]
STREAMS = CELLS[2:3]


def _run(cell_name, hook=None, seconds=0.2):
    cell = tiny(cell_name)
    return run_cell(cell, 2**31 + 99, seconds, False, torch.device("cpu"),
                    started=time.perf_counter(), port_hook=hook)


class Broken:
    """The port with one entry replaced."""

    def __init__(self, port, **fns):
        self._port = port
        for name, fn in fns.items():
            setattr(self, name, fn)

    def __getattr__(self, name):
        return getattr(self._port, name)


def half_batch(port):
    def entry(prev, nxt, config):
        n = prev.shape[0] // 2
        done = port.entry(prev[:n], nxt[:n], config)
        mean = done.mean(0, keepdim=True).expand((prev.shape[0] - n,) + done.shape[1:])
        return torch.cat([done, mean])
    return Broken(port, entry=entry)


def altered_answer(port):
    def entry(prev, nxt, config):
        out = port.entry(prev, nxt, config).clone()
        out[..., 0] += 0.5
        return out
    return Broken(port, entry=entry)


def state_unchanged(port):
    def step(state, frames, config, warm, recovery):
        _, flow = port.step(state, frames, config, warm, recovery)
        return state, flow
    return Broken(port, step=step)


def altered_stream(port):
    def step(state, frames, config, warm, recovery):
        state, flow = port.step(state, frames, config, warm, recovery)
        flow = flow.clone()
        flow[..., 1] += 0.5
        return state, flow
    return Broken(port, step=step)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_port_is_correct(cell):
    out = _run(cell)
    assert out["correct"] and out["failed"] == 0
    assert out["checks"]["answers"]["value"] >= 1
    assert set(out["metrics"]) == {m["name"] for m in tiny(cell).end_to_end}


@pytest.mark.parametrize("cell", BATCHED)
def test_half_batch_left_out_is_caught(cell):
    assert not _run(cell, half_batch)["correct"]


@pytest.mark.parametrize("cell", BATCHED + CELLS[3:])
def test_altered_answer_is_caught(cell):
    assert not _run(cell, altered_answer)["correct"]


@pytest.mark.parametrize("cell", STREAMS)
def test_state_left_unchanged_is_caught(cell):
    assert not _run(cell, state_unchanged)["correct"]


@pytest.mark.parametrize("cell", STREAMS)
def test_altered_stream_answer_is_caught(cell):
    out = _run(cell, altered_stream)
    assert not out["correct"]
