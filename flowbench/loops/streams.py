"""Open loop of synchronised camera streams, batched into one serving step
per frame tick (as DeepStream's ``nvstreammux`` batches its sources).

Traffic parameters (``flowbench/traffic/<mix>.json``):

* ``streams``: S streams, frames (S, H, W) per tick;
* ``fps``: ticks per second; tick k is due k / fps after the window opens;
* ``clip_frames``: T frames per stream of a looping clip
  (``frames.stream_clips``, its ``texture`` parameters); tick k sends frame
  k mod T of every stream;
* ``warm_start``, ``recovery``: the arguments of the port's
  ``streaming.step`` (``recovery`` the fields of ``RecoveryConfig``);
* ``warm_ticks``: ticks of set-up after ``init_state`` (the cold key and the
  warm key's graphs are captured there);
* ``check_ticks``, ``check_streams``: window ticks, and streams of each,
  compared with the reference, drawn from the seed; ``start_ticks``: the
  first set-up ticks compared the same way (the cold step from
  ``init_state`` and the first warm steps);
* ``trace_ticks``: ticks in the traced slice of a ``--trace 1`` run.

Each tick: sleep until it is due, call ``step`` with the tick's frames, mark
the queue, wait for the mark.  A tick's time runs from when it was due to
when its flow is ready, so a late tick delays the ones after it and counts
there.  Window values: ``frame_ms_p95`` (95th percentile over the ticks,
every frame of a tick alike) and the generator's lateness (issue - due).

The check follows the program step by step: a warm step's reference is
seeded with the flow that the program returned for the tick before, and
works out the pyramids and the recovery decision again from the frames.
"""

from __future__ import annotations

import random
import time

import torch

from flowbench import frames
from flowbench.stats import Clock, percentile
from flowbench.trace import span

__all__ = ["Loop"]

SPIN_S = 0.0005  # sleep until this close to the due time, then spin


def _sleep_until(t: float) -> None:
    while True:
        left = t - time.perf_counter()
        if left <= 0:
            return
        if left > SPIN_S:
            time.sleep(left - SPIN_S)


class Loop:
    def __init__(self, cell, seed: int, device, port):
        t, c = cell.traffic, cell.config
        self.cell, self.port = cell, port
        self.s = int(t["streams"])
        self.period = 1.0 / float(t["fps"])
        self.t_frames = int(t["clip_frames"])
        self.clip = frames.stream_clips(seed, self.t_frames, self.s, c["height"], c["width"],
                                        device, **t.get("texture", {}))
        self.recovery = port.recovery_config(**t["recovery"])
        self.warm = bool(t["warm_start"])
        self.clock = Clock(device)
        rng = random.Random(seed)
        self.check_streams = sorted(rng.sample(range(self.s), int(t["check_streams"])))
        self.rng = rng
        self.state = None
        self.tick = 0  # the tick whose frames the next step takes
        self.keep_ticks: set = set()
        self.flows: dict = {}  # tick -> the (S, H, W, 2) flow the program returned
        self.checked: list = []  # ticks compared with the reference
        self.next_due = None
        self.host: list = []  # host seconds in the entry per step

    def _frames(self, tick: int) -> torch.Tensor:
        return self.clip[tick % self.t_frames]

    def step(self) -> tuple[float, float]:
        """One tick's step, awaited: (host seconds in the entry, the time
        the flow was ready)."""
        issued = time.perf_counter()
        with span("entry"):
            self.state, flow = self.port.step(self.state, self._frames(self.tick),
                                              self.port.config, self.warm, self.recovery)
        host = time.perf_counter() - issued
        self.host.append(host)
        mark = self.clock.mark()
        with span("wait"):
            self.clock.wait(mark)
        ready = time.perf_counter()
        if self.tick in self.keep_ticks:
            self.flows[self.tick] = flow
        self.tick += 1
        return host, ready

    def warm_up(self) -> None:
        start = int(self.cell.traffic["start_ticks"])
        self.keep_ticks = set(range(1, start + 1))
        self.checked = list(range(1, start + 1))
        self.state = self.port.init_state(self._frames(0), self.port.config, self.recovery)
        self.tick = 1
        for _ in range(max(start, int(self.cell.traffic["warm_ticks"]))):
            self.step()
        self.clock.sync()

    def run(self, seconds: float) -> dict:
        """The measured window: ticks due every 1 / fps for ``seconds``."""
        n = int(round(seconds / self.period))
        first = self.tick
        k = int(self.cell.traffic["check_ticks"])
        picked = sorted(self.rng.sample(range(first + 1, first + n), min(k, n - 1)))
        self.checked += picked
        self.keep_ticks |= set(picked) | {p - 1 for p in picked}
        latency, late, self.host = [], [], []
        t0 = time.perf_counter() + self.period
        for i in range(n):
            due = t0 + i * self.period
            with span("sleep"):
                _sleep_until(due)
            late.append(time.perf_counter() - due)
            _, ready = self.step()
            latency.append(ready - due)
        self.clock.sync()
        window = time.perf_counter() - t0
        quarter = max(1, n // 4)
        values = {"frame_ms_p95": percentile(latency, 95) * 1e3}
        load = {
            "ticks": n, "streams": self.s,
            "late_ms_p95": percentile(late, 95) * 1e3, "late_ms_max": max(late) * 1e3,
            "late_ms_first_quarter": sum(late[:quarter]) / quarter * 1e3,
            "late_ms_last_quarter": sum(late[-quarter:]) / quarter * 1e3,
            "frame_ms_p50": percentile(latency, 50) * 1e3,
        }
        return {"values": values, "attempted": n * self.s, "window_s": window, "calls": n,
                "host_s": list(self.host), "load": load}

    def trace_unit(self):
        """(a paced tick, ticks, frames per tick, ticks before the slice
        opens) for the traced slice.  A tick that starts more than a period
        after it was due (the profiler's own set-up) starts the schedule
        again, so the slice keeps the loop's spacing."""
        self.next_due = None

        def paced():
            now = time.perf_counter()
            if self.next_due is None or now - self.next_due > self.period:
                self.next_due = now
            with span("sleep"):
                _sleep_until(self.next_due)
            self.next_due += self.period
            self.step()

        return paced, int(self.cell.traffic["trace_ticks"]), self.s, 1

    def finish_trace(self) -> None:
        self.clock.sync()

    def release(self) -> None:
        self.state = None
        self.port.release()

    # --- the check ------------------------------------------------------

    def check(self, reference, gaps, dtype=None) -> dict:
        """For each checked tick t: the recovery decision from frames t - 1
        and t and the program's flows of tick t - 1 (all streams), then each
        checked stream's flow against the reference's step.  Tick 1 is the
        cold step from ``init_state``.  With ``dtype``, the control: the
        reference in ``dtype`` in the program's place."""
        fields, rec = self.cell.config["fields"], self.cell.traffic["recovery"]
        cold = 0
        for t in self.checked:
            prev_frames, frames_t = self._frames(t - 1), self._frames(t)
            prev_flow = self.flows.get(t - 1) if t > 1 else None
            with torch.no_grad():
                ok = prev_flow is not None and reference.seed_ok(prev_frames, frames_t,
                                                                 prev_flow, fields, rec)
                cold += not ok
                if dtype is not None:
                    ok_c = prev_flow is not None and reference.seed_ok(
                        prev_frames, frames_t, prev_flow, fields, rec, dtype=dtype)
                for s in self.check_streams:
                    pf = None if prev_flow is None else prev_flow[s]
                    want = reference.stream_flow(prev_frames[s], frames_t[s], pf, ok, fields, rec)
                    if dtype is None:
                        got = self.flows[t][s]
                    else:
                        got = reference.stream_flow(prev_frames[s], frames_t[s], pf, ok_c,
                                                    fields, rec, dtype=dtype)
                    gaps.add(got, want)
        return {"ticks": len(self.checked), "streams": len(self.check_streams),
                "cold_decisions": cold}
