"""Host-clock arithmetic of the end-to-end metrics, and the card's marks."""

from __future__ import annotations

import math

import torch

__all__ = ["Clock", "percentile", "rate"]


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile (0 < q <= 100) of every value: one
    slow value moves it as soon as more than (100 - q) % of them are slow."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    return float(ordered[max(0, math.ceil(q / 100 * len(ordered)) - 1)])


def rate(count: float, seconds: float) -> float:
    """Work per second over the whole window."""
    if seconds <= 0:
        raise ValueError(f"window of {seconds} s")
    return count / seconds


class Clock:
    """Marks on the device's queue: on a card a CUDA event, awaited by the
    host; on the CPU, where every call has finished when it returns,
    nothing."""

    def __init__(self, device: torch.device):
        self.cuda = torch.device(device).type == "cuda"

    def mark(self):
        if not self.cuda:
            return None
        event = torch.cuda.Event()
        event.record()
        return event

    @staticmethod
    def wait(mark) -> None:
        if mark is not None:
            mark.synchronize()

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()
