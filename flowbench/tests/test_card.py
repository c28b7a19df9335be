"""On the card: each cell through the command, a short window, correct."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from flowbench import spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(card, cell):
    out = subprocess.run([sys.executable, "-m", "flowbench.run", "--workload", cell,
                          "--seed", "4294967311", "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, cwd=spec.ROOT.parent, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"
