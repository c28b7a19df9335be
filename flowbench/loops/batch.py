"""Closed loop of pair calls into the configuration's captured entry.

Traffic parameters (``flowbench/traffic/<mix>.json``):

* ``pairs_per_call``: B consecutive pairs of the clip per call, frames
  (B, H, W) each; 1 sends single (H, W) frames, one request;
* ``in_flight``: calls issued before the host waits for the oldest (1: each
  call awaited before the next, so its latency is known);
* ``clip_frames``: N frames of a device-resident uint8 clip
  (``frames.video_clip``, its ``motion`` parameters); call j takes the pairs
  starting at frame (j B) mod (N - 1), so N - 1 must be a multiple of B;
* ``warm_calls``: calls of set-up after the capture;
* ``check_calls``: calls of the window whose every pair is compared with
  the reference, drawn from the seed (reservoir sampling);
* ``trace_calls``: calls in the traced slice of a ``--trace 1`` run.

Window values: ``pairs_per_s`` (pairs of the calls issued over the window,
which ends when the last has finished) and, with ``in_flight`` 1,
``pair_ms_p95`` (the 95th percentile over calls of call to flow ready).
"""

from __future__ import annotations

import collections
import random
import time

import torch

from flowbench import frames
from flowbench.stats import Clock, percentile, rate
from flowbench.trace import span

__all__ = ["Loop"]


class Loop:
    def __init__(self, cell, seed: int, device, port):
        t, c = cell.traffic, cell.config
        self.cell, self.port = cell, port
        self.b = int(t["pairs_per_call"])
        self.in_flight = int(t["in_flight"])
        n = int(t["clip_frames"])
        if (n - 1) % self.b:
            raise ValueError(f"clip_frames - 1 = {n - 1} is not a multiple of {self.b}")
        self.starts = list(range(0, n - 1, self.b))
        self.clip = frames.video_clip(seed, n, c["height"], c["width"], device,
                                      **t.get("motion", {}))
        self.clock = Clock(device)
        self.rng = random.Random(seed)
        self.calls = 0  # every call issued, set-up included
        self.pending: collections.deque = collections.deque()
        self.kept: list = []  # (first frame, flows) of the sampled calls
        self.sampling = False
        self.seen = 0  # window calls offered to the sample
        self.latency: list = []
        self.host: list = []

    # --- one call ---------------------------------------------------------

    def _pair(self, s: int):
        if self.b == 1:
            return self.clip[s], self.clip[s + 1]
        return self.clip[s:s + self.b], self.clip[s + 1:s + self.b + 1]

    def _await_oldest(self) -> None:
        issued, mark = self.pending.popleft()
        with span("wait"):
            self.clock.wait(mark)
        self.latency.append(time.perf_counter() - issued)

    def call(self) -> None:
        """Issue one call, then wait until fewer than ``in_flight`` remain."""
        s = self.starts[self.calls % len(self.starts)]
        with span("feed"):
            prev, nxt = self._pair(s)
        t0 = time.perf_counter()
        with span("entry"):
            out = self.port.entry(prev, nxt, self.port.config)
        t1 = time.perf_counter()
        self.pending.append((t0, self.clock.mark()))
        self.host.append(t1 - t0)
        self.calls += 1
        if self.sampling:
            self._offer(s, out)
        while len(self.pending) >= self.in_flight:
            self._await_oldest()

    def _offer(self, s: int, out) -> None:
        k = int(self.cell.traffic["check_calls"])
        self.seen += 1
        if len(self.kept) < k:
            self.kept.append((s, out))
        else:
            j = self.rng.randrange(self.seen)
            if j < k:
                self.kept[j] = (s, out)

    def drain(self) -> None:
        while self.pending:
            self._await_oldest()

    # --- the phases of a run ----------------------------------------------

    def warm_up(self) -> None:
        """Capture the one shape this mix sends, then a few calls more."""
        for _ in range(1 + int(self.cell.traffic.get("warm_calls", 2))):
            self.call()
        self.drain()
        self.clock.sync()

    def run(self, seconds: float) -> dict:
        """The measured window: calls back to back until ``seconds`` have
        passed, then the last awaited."""
        self.latency, self.host, self.sampling = [], [], True
        calls0 = self.calls
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.call()
        self.drain()
        self.clock.sync()
        window = time.perf_counter() - t0
        self.sampling = False
        calls = self.calls - calls0
        values = {"pairs_per_s": rate(calls * self.b, window)}
        if self.in_flight == 1:
            values["pair_ms_p95"] = percentile(self.latency, 95) * 1e3
        return {"values": values, "attempted": calls * self.b, "window_s": window,
                "calls": calls, "host_s": list(self.host)}

    def trace_unit(self):
        """(the function the traced slice calls, calls, pairs per call, calls
        issued before the slice opens): the window's own call, queue and
        all, the queue full when the slice opens."""
        return self.call, int(self.cell.traffic["trace_calls"]), self.b, self.in_flight

    def finish_trace(self) -> None:
        self.drain()

    def release(self) -> None:
        """Free the program's state: graphs and their pools.  The clip and
        the sampled flows stay for the check."""
        self.port.release()
        self.pending.clear()

    # --- the check ------------------------------------------------------

    def check(self, reference, gaps, dtype=None) -> dict:
        """Compare every pair of each sampled call with the reference; with
        ``dtype``, the control: the reference computed in ``dtype`` in the
        program's place."""
        fields = self.cell.config["fields"]
        for s, out in self.kept:
            prev, nxt = self._pair(s)
            with torch.no_grad():
                want = reference.flow(prev, nxt, fields)
                got = out if dtype is None else reference.flow(prev, nxt, fields, dtype=dtype)
            gaps.add(got, want)
            del want, got
        return {"calls": len(self.kept), "pairs": len(self.kept) * self.b}
