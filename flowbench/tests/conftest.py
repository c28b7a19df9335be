"""Fixtures of the benchmark's CPU tests: cells cut to a tiny frame size, so
the harness, the port's CPU path and the reference run in seconds.

Tests that need the card carry the ``card`` marker and skip, inside the
test, where ``torch.cuda.is_available()`` is false.  Run them on the card
with ``python3 -m pytest flowbench/tests -m card``.
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY = {"height": 64, "width": 96}
TINY_TRAFFIC = {
    "batch": {"clip_frames": 9},
    "streams": {"streams": 3, "clip_frames": 8, "check_streams": 2, "check_ticks": 2, "fps": 100},
}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


def tiny(name: str, **traffic):
    """The cell ``name`` of BENCHMARK.json at 64x96 with a short clip."""
    from flowbench import spec

    cell = spec.load_cell(name)
    cell.config = {**cell.config, **TINY}
    cell.traffic = {**cell.traffic, **TINY_TRAFFIC[cell.traffic["loop"]], **traffic}
    return cell


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
