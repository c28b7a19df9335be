"""What the per-layer readers share: the reading of a traced run, and the
arithmetic of host spans, idle share, device time by kernel name and
roofline share.  Each reader (``flowbench/metrics/<metric>.py``) holds its
own kernel name pattern and work function and returns a number, or None
when its run has nothing for it to read (never 0 for a share)."""

from __future__ import annotations

import re
from dataclasses import dataclass
from types import SimpleNamespace

import torch

from flowbench import roofline
from flowbench.trace import Slice

__all__ = [
    "Reading", "config_view", "device_ms", "host_ms", "idle_pct", "level_shapes",
    "least_ms", "other_ops_ms_per_pair", "roofline_pct",
]

PORT_KERNELS = "of2_"  # the prefix of every kernel the port compiles


@dataclass
class Reading:
    slice: Slice  # the traced slice
    pairs: int  # flow pairs computed in the traced slice
    host_s: list  # host seconds of each call of the window inside the entry
    config: dict  # the configuration file


def host_ms(r: Reading) -> float | None:
    """Mean host ms inside the entry per call (key, copy-in, replay, clone)."""
    return sum(r.host_s) / len(r.host_s) * 1e3 if r.host_s else None


def idle_pct(r: Reading) -> float | None:
    """Share of the traced window in which no kernel or copy ran."""
    if r.slice.window_s <= 0 or r.slice.busy_s <= 0:
        return None
    return 100.0 * (1.0 - r.slice.busy_s / r.slice.window_s)


def device_ms(r: Reading, pattern: str, invert: bool = False) -> float:
    """Summed device ms, inside the window, of the ops whose names match the
    regex ``pattern`` (with ``invert``: do not match)."""
    rx = re.compile(pattern)
    t0, t1 = r.slice.window_us
    total = 0.0
    for s, e, name in r.slice.device:
        if bool(rx.search(name)) != invert:
            total += max(0.0, min(e, t1) - max(s, t0))
    return total / 1e3


def other_ops_ms_per_pair(r: Reading) -> float | None:
    """Device ms per pair of the ops that are not the port's kernels: plain
    torch between kernels, copies."""
    if r.pairs <= 0:
        return None
    return device_ms(r, PORT_KERNELS, invert=True) / r.pairs


def level_shapes(config: dict) -> list[tuple[int, int]]:
    """(h, w) of each pyramid level, level k floor-halved k times."""
    h, w = config["height"], config["width"]
    return [(h >> k, w >> k) for k in range(config["fields"]["levels"])]


def config_view(config: dict) -> SimpleNamespace:
    return SimpleNamespace(**config["fields"])


def least_ms(name: str, calls) -> float:
    """Summed least ms (``roofline.bound``) of calls ``(shape, kwargs)`` of
    the kernel ``name``, each shape a frame (h, w) of one pair."""
    total = 0.0
    for args, kw in calls:
        total += roofline.bound(name, args, kw)[0]
    return total


def meta(shape) -> torch.Tensor:
    return torch.empty(shape, device="meta")


def roofline_pct(r: Reading, pattern: str, least_ms_per_pair: float) -> float | None:
    """The least time for the stage's work over its measured device time."""
    t = device_ms(r, pattern)
    if t <= 0 or r.pairs <= 0:
        return None
    return 100.0 * least_ms_per_pair * r.pairs / t
