"""A bounded slice of a run under ``torch.profiler``: device events, busy and
idle time, and the breakdown.

:meth:`Tracer.traced` is a frozen copy of ``chip_smoke.traced``:
the profiler can lose the first device events of a trace, so the calls are
bracketed by two spin kernels, each with a run of tiny lead kernels on its
outer side, and a trace in which a spin or all the leads beside it are
missing is taken again with twice the leads.  Busy time is the union of the
device intervals (kernels and copies), as ``chip_smoke.profile_path`` merges
them.  Added here: the window is the host span ``flowbench.window`` on the
profiler's own clock, the device intervals are clipped to it, and each idle
gap is named by the innermost ``flowbench.*`` host span that covers its
middle (what the host was doing while the card waited).
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field

import torch

__all__ = ["Slice", "Tracer", "span"]

PAD_S = 0.05  # host wait at each end of a trace
MARK_CYCLES = 100_000  # about 50 us of SM clock
LEAD = 64  # the first run of lead kernels at each end
TRIES = 7  # leads up to 64 x 2**6
WINDOW = "flowbench.window"


def span(name: str):
    """A host span that the trace records (a no-op outside a profile)."""
    return torch.profiler.record_function("flowbench." + name)


@dataclass
class Slice:
    """What one traced slice gives the per-layer readers."""

    device: list  # (start_us, end_us, name) of every device op in the window
    spans: list  # (start_us, end_us, name) of the flowbench.* host spans
    window_us: tuple  # (start, end) of the window on the profiler's clock
    busy_s: float = 0.0
    gaps: list = field(default_factory=list)  # (seconds, host span) per idle gap

    def __post_init__(self):
        t0, t1 = self.window_us
        busy, end = 0.0, t0
        gaps = []
        for s, e, _ in sorted(self.device):
            s, e = max(s, t0), min(e, t1)
            if e <= s:
                continue
            if s > end:
                gaps.append((end, s))
            busy += max(0.0, e - max(s, end))
            end = max(end, e)
        if t1 > end:
            gaps.append((end, t1))
        self.busy_s = busy / 1e6
        self.gaps = sorted(((b - a) / 1e6, self._host_at((a + b) / 2)) for a, b in gaps)[::-1]

    @property
    def window_s(self) -> float:
        return (self.window_us[1] - self.window_us[0]) / 1e6

    def _host_at(self, t: float) -> str:
        inner = None
        for s, e, name in self.spans:
            if s <= t <= e and (inner is None or s >= inner[0]):
                inner = (s, e, name)
        return inner[2] if inner else "flowbench.other"

    def device_ops(self, n: int = 10) -> list:
        """The n device ops with the most time, [name, seconds]."""
        by_name: dict[str, float] = {}
        t0, t1 = self.window_us
        for s, e, name in self.device:
            by_name[name] = by_name.get(name, 0.0) + max(0.0, min(e, t1) - max(s, t0)) / 1e6
        return [[k[:120], v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]

    def breakdown(self) -> dict:
        return {"device_ops": self.device_ops(),
                "idle_gaps": [[name, s] for s, name in self.gaps[:10]]}


class Tracer:
    """Takes traces; keeps the lead count that the last good trace needed."""

    def __init__(self):
        self.lead = LEAD
        self.lost = 0

    def traced(self, fn, calls: int, prime: int = 0) -> Slice:
        """``calls`` calls of ``fn`` under the profiler (after one unprofiled
        call), awaited on the card at the end.  The window opens after
        ``prime`` more calls, so that it starts with the card as busy as the
        loop keeps it, not idle."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        lead = torch.zeros(1, device="cuda")
        for _ in range(TRIES):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                time.sleep(PAD_S)
                for _ in range(self.lead):
                    lead.add_(1)
                torch.cuda._sleep(MARK_CYCLES)
                torch.cuda.synchronize()
                for _ in range(prime):
                    fn()
                with torch.profiler.record_function(WINDOW):
                    for _ in range(calls):
                        fn()
                    torch.cuda.synchronize()
                torch.cuda._sleep(MARK_CYCLES)
                for _ in range(self.lead):
                    lead.add_(1)
                torch.cuda.synchronize()
                time.sleep(PAD_S)
            events = list(prof.events())
            # the flowbench.* spans also appear on the device's timeline as
            # annotations: they are not device work
            dev = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                         if e.device_type == DeviceType.CUDA
                         and not e.name.startswith("flowbench."))
            spins = [i for i, (_, _, name) in enumerate(dev) if "spin_kernel" in name]
            if len(spins) == 2 and spins[0] > 0 and spins[1] < len(dev) - 1:
                host = [(e.time_range.start, e.time_range.end, e.name) for e in events
                        if e.device_type == DeviceType.CPU and e.name.startswith("flowbench.")]
                window = [(s, e) for s, e, name in host if name == WINDOW]
                spans = [h for h in host if h[2] != WINDOW]
                return Slice(dev[spins[0] + 1:spins[1]], spans, window[0])
            self.lost += 1
            print(f"profiler trace lost events ({len(dev)} device events, spins at {spins}, "
                  f"{self.lead} lead kernels at each end); tracing again with twice the leads",
                  file=sys.stderr)
            self.lead *= 2
        raise RuntimeError(f"the profiler lost events in {TRIES} traces in a row")
