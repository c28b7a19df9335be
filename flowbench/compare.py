"""The comparison that decides ``correct``.

Each answer is one dense flow (H, W, 2) of one pair.  Its gap to the plain
reference's flow of the same frames is the per-pixel end-point distance
|program - reference|, in px; a non-finite program value counts as an
infinite gap.  Two numbers are compared, each the worst over the answers of
a run:

* ``gap_median_px``: the median pixel's gap of an answer;
* ``gap_p99_px``: the 99th percentile pixel's gap of an answer.

Their limits are per cell, in ``flowbench/limits/<cell>.json``, with the
readings they were set from (``PERF.md``).  The control (:func:`control`)
puts the reference computed in bfloat16, the precision below the
configuration's float32, in the program's place.
"""

from __future__ import annotations

import math
import sys

import torch

__all__ = ["NUMBERS", "Gaps", "answer_gaps", "judge", "print_checks"]

NUMBERS = ("gap_median_px", "gap_p99_px")
CONTROL_DTYPE = torch.bfloat16


def _quantile(x: torch.Tensor, q: float) -> float:
    """The q-quantile of a flat tensor, by rank (no interpolation)."""
    k = min(x.numel(), max(1, math.ceil(q * x.numel())))
    return float(x.kthvalue(k).values)


def answer_gaps(got: torch.Tensor, want: torch.Tensor) -> dict:
    """The two numbers of one answer (H, W, 2) against its reference."""
    if got.shape != want.shape:
        raise ValueError(f"answer shape {tuple(got.shape)} vs reference {tuple(want.shape)}")
    d = (got.float() - want.float()).pow(2).sum(-1).sqrt().flatten()
    d = torch.where(torch.isfinite(d), d, torch.full_like(d, math.inf))
    return {"gap_median_px": _quantile(d, 0.5), "gap_p99_px": _quantile(d, 0.99)}


class Gaps:
    """The worst of each number over the answers compared so far."""

    def __init__(self):
        self.worst = {name: 0.0 for name in NUMBERS}
        self.answers = 0
        self.per_answer: list[dict] = []

    def add(self, got: torch.Tensor, want: torch.Tensor) -> None:
        """Add a batch of answers (..., H, W, 2)."""
        got = got.reshape((-1,) + tuple(got.shape[-3:]))
        want = want.reshape((-1,) + tuple(want.shape[-3:]))
        for g, w in zip(got, want):
            gaps = answer_gaps(g, w)
            self.per_answer.append(gaps)
            self.answers += 1
            for name in NUMBERS:
                self.worst[name] = max(self.worst[name], gaps[name])


def judge(gaps: Gaps, limits: dict) -> tuple[bool, int, dict]:
    """(correct, answers out of limits, {number: {"value", "limit"}})."""
    checks = {name: {"value": gaps.worst[name], "limit": float(limits[name])} for name in NUMBERS}
    failed = sum(any(a[n] > float(limits[n]) for n in NUMBERS) for a in gaps.per_answer)
    ok = gaps.answers > 0 and failed == 0
    checks["answers"] = {"value": gaps.answers, "limit": 1}
    return ok, failed, checks


def print_checks(checks: dict) -> None:
    """Each number compared beside its limit, as the last lines on stderr."""
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
