"""What the port records about itself, for the per-layer readers: its spans
and its capture counters.

The port keeps its spans in memory while the profiler is active
(``cuda_optical_flow_2_torch.utils.profiling.spans``: records with ``name``,
``start_ns``, ``end_ns``, ``parent``, ``call_id``, on its own clock) and
its capture counters always (``cuda_optical_flow_2_torch.capture.stats``).
Both are taken through :func:`flowbench.port.attr`; a program that has
neither gives None, and its readers return None.

:func:`calls` places the spans on a traced slice's clock.  The slice's
``flowbench.entry`` spans and the recorder's last ``capture.call`` roots
are the same calls in the same order, so one offset puts every root inside
its entry span: the middle of the range of offsets that do.  The calls whose
root lies inside the window are kept.
"""

from __future__ import annotations

from dataclasses import dataclass

from flowbench import port

__all__ = ["Call", "calls", "capture_seconds", "cold_step_pct", "fit", "idle_before_launch_pct",
           "idle_gaps", "ms_before_launch", "spans", "stats"]

ENTRY = "flowbench.entry"
ROOT = "capture.call"
LAUNCH = "capture.launch"
STEP = "cuda_optical_flow_2_torch.models.streaming._step"  # the serving step's entry


def _program(path: str):
    try:
        return port.attr(path)
    except (ImportError, AttributeError):
        return None


def spans() -> list | None:
    """The port's recorded spans; None when it records none."""
    fn = _program("cuda_optical_flow_2_torch.utils.profiling:spans")
    return fn() if fn is not None else None


def stats() -> dict | None:
    """``capture.stats()`` of the port; None when it has none."""
    fn = _program("cuda_optical_flow_2_torch.capture:stats")
    return fn() if fn is not None else None


@dataclass
class Call:
    """One captured call on the slice's clock (microseconds)."""

    start_us: float
    end_us: float
    launch_us: float | None  # the start of its first ``capture.launch``


def fit(entries: list, roots: list) -> float | None:
    """The offset that puts each root (start, end) inside its entry span
    (start, end): the middle of the range that does, None if none does."""
    lo = max(es - rs for (es, _), (rs, _) in zip(entries, roots, strict=True))
    hi = min(ee - re for (_, ee), (_, re) in zip(entries, roots, strict=True))
    return (lo + hi) / 2 if lo <= hi else None


def calls(r) -> list[Call] | None:
    """The port's captured calls inside the window of the reading ``r``;
    None when the port recorded none or no offset fits."""
    recorded = spans()
    entries = sorted((s, e) for s, e, name in r.slice.spans if name == ENTRY)
    if not recorded or not entries:
        return None
    roots = sorted((s for s in recorded if s.name == ROOT and s.parent is None),
                   key=lambda s: s.start_ns)
    if len(roots) < len(entries):
        return None
    roots = roots[-len(entries):]
    base = roots[0].start_ns

    def us(ns: int) -> float:
        return (ns - base) / 1e3

    offset = fit(entries, [(us(s.start_ns), us(s.end_ns)) for s in roots])
    if offset is None:
        return None
    launch: dict = {}
    for s in recorded:
        if s.name == LAUNCH and s.start_ns < launch.get(s.call_id, s.start_ns + 1):
            launch[s.call_id] = s.start_ns
    t0, t1 = r.slice.window_us
    out = []
    for s in roots:
        a, b = us(s.start_ns) + offset, us(s.end_ns) + offset
        if t0 <= a and b <= t1:
            first = launch.get(s.call_id)
            out.append(Call(a, b, None if first is None else us(first) + offset))
    return out


def _before_launch(found: list[Call]) -> list[tuple[float, float]]:
    return [(c.start_us, c.launch_us) for c in found if c.launch_us is not None]


def ms_before_launch(r) -> float | None:
    """Mean ms, over the window's calls, from a call's start to its launch."""
    spans_ = _before_launch(calls(r) or [])
    return sum(b - a for a, b in spans_) / len(spans_) / 1e3 if spans_ else None


def idle_gaps(sl) -> list[tuple[float, float]]:
    """The slice's idle gaps (start, end): the window less the merged device
    intervals, as ``flowbench.trace.Slice`` merges them."""
    t0, t1 = sl.window_us
    gaps, end = [], t0
    for s, e, _ in sorted(sl.device):
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if t1 > end:
        gaps.append((end, t1))
    return gaps


def idle_before_launch_pct(r) -> float | None:
    """Share of the slice's idle time that lies between a call's start and
    its launch (the host inside the port before the card has the work)."""
    found = calls(r)
    gaps = idle_gaps(r.slice)
    idle = sum(b - a for a, b in gaps)
    if not found or idle <= 0:
        return None
    pre = _before_launch(found)
    inside = sum(max(0.0, min(b, e) - max(a, s)) for a, b in gaps for s, e in pre)
    return 100.0 * inside / idle


def cold_step_pct() -> float | None:
    """Share of the serving step's cond replays that took the false (cold,
    deep re-solve) branch, over the process."""
    st = stats()
    if st is None:
        return None
    taken = [t for e in st["entries"] if e["name"] == STEP for g in e["graphs"] for t in g["taken"]]
    n = sum(t + f for t, f in taken)
    return 100.0 * sum(f for _, f in taken) / n if n else None


def capture_seconds() -> float | None:
    """Seconds of warm-up and capture of the process's cached graphs."""
    st = stats()
    if st is None or not any(e["graphs"] for e in st["entries"]):
        return None
    return st["seconds"]
