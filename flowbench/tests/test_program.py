"""The port's spans placed on a traced slice's clock (``flowbench/program.py``),
and the readers of the metrics that read the port's spans and counters."""

from __future__ import annotations

from collections import namedtuple

import pytest
import torch

from flowbench import program
from flowbench.layers import Reading
from flowbench.spec import ROOT, module_at
from flowbench.trace import Slice

Span = namedtuple("Span", "name start_ns end_ns parent call_id attrs id tid")
SKEW_NS = 1_792_309_196_910_388_599  # the program's clock minus the slice's
READERS = ["host_ms_before_launch.batch", "host_ms_before_launch.pair",
           "host_ms_before_launch.stream", "idle_before_launch_pct.pair",
           "idle_before_launch_pct.stream", "cold_step_pct.stream", "capture_s.setup"]


def _ns(us: int) -> int:
    return SKEW_NS + us * 1000


def _synthetic(n: int = 5, early_roots: int = 2):
    """Calls i < n: entry span [1000 i + 100, 1000 i + 600] us on the
    slice's clock, the port's root 5 us inside each end, its launch at
    1000 i + 305, the card busy over [1000 i + 310, 1000 i + 900]; the
    window [1000, 4000] holds calls 1-3.  ``early_roots`` roots come before
    (a trace taken again), one nested ``capture.call`` is not a root."""
    entries, recorded, device = [], [], []
    ids = iter(range(1, 1000))
    for i in range(-early_roots, n):
        t = 1000 * i
        root = next(ids)
        recorded.append(Span("capture.launch", _ns(t + 305), _ns(t + 320), root, root, {},
                             next(ids), 1))
        recorded.append(Span("capture.call", _ns(t + 350), _ns(t + 360), root, root, {},
                             next(ids), 1))
        recorded.append(Span("capture.call", _ns(t + 105), _ns(t + 595), None, root, {}, root, 1))
        if i >= 0:
            entries.append((t + 100, t + 600, "flowbench.entry"))
            device.append((t + 310, t + 900, "of2_kernel"))
    return Slice(device, entries + [(0, 50, "flowbench.feed")], (1000, 4000)), recorded


STATS = {"entries": [
    {"name": program.STEP, "graphs": [{"taken": []}, {"taken": [[90, 10]]}, {"taken": [[0, 0]]}],
     "calls": 101},
    {"name": "other", "graphs": [{"taken": [[0, 50]]}], "calls": 1},
], "graphs_captured": 4, "seconds": 2.5, "pool_bytes": {0: 1 << 30}}


@pytest.fixture
def port_records(monkeypatch):
    sl, recorded = _synthetic()
    monkeypatch.setattr(program, "spans", lambda: recorded)
    monkeypatch.setattr(program, "stats", lambda: STATS)
    return Reading(sl, 3, [], {})


def test_offset_is_found_and_calls_outside_the_window_are_dropped(port_records):
    found = program.calls(port_records)
    assert [round(c.start_us, 6) for c in found] == [1105, 2105, 3105]
    assert [round(c.end_us, 6) for c in found] == [1595, 2595, 3595]
    assert [round(c.launch_us, 6) for c in found] == [1305, 2305, 3305]
    assert program.ms_before_launch(port_records) == pytest.approx(0.2)
    # idle gaps [1000, 1310], [1900, 2310], [2900, 3310], [3900, 4000]: 1230 us,
    # of which the three pre-launch spans cover 200 us each
    assert program.idle_before_launch_pct(port_records) == pytest.approx(100 * 600 / 1230)


def test_fit_is_the_middle_of_the_offsets_that_fit():
    assert program.fit([(10, 20), (30, 40)], [(1, 9), (22, 29)]) == pytest.approx(10.0)
    assert program.fit([(10, 20)], [(0, 15)]) is None  # a root longer than its span


def test_no_offset_fits_gives_none(monkeypatch):
    sl, recorded = _synthetic()
    moved = [s._replace(start_ns=s.start_ns + 400_000, end_ns=s.end_ns + 400_000)
             if s.name == "capture.call" and s.parent is None and s.id == recorded[-1].id else s
             for s in recorded]  # the last root shifted 400 us against the others
    monkeypatch.setattr(program, "spans", lambda: moved)
    r = Reading(sl, 3, [], {})
    assert program.calls(r) is None
    assert program.ms_before_launch(r) is None and program.idle_before_launch_pct(r) is None


def test_fewer_roots_than_entries_gives_none(monkeypatch):
    sl, recorded = _synthetic(early_roots=0)
    monkeypatch.setattr(program, "spans", lambda: recorded[3:])
    assert program.calls(Reading(sl, 3, [], {})) is None


def test_counter_readers(port_records):
    assert program.cold_step_pct() == pytest.approx(10.0)  # the serving step's conds only
    assert program.capture_seconds() == 2.5


@pytest.mark.parametrize("metric", READERS)
def test_each_reader_gives_a_number_or_none_on_an_empty_reading(metric, port_records,
                                                                monkeypatch):
    reader = module_at(ROOT / "metrics" / f"{metric}.py")
    value = reader.read(port_records)
    assert isinstance(value, float) and value >= 0
    for spans, stats in ((lambda: None, lambda: None), (list, lambda: {
            "entries": [], "graphs_captured": 0, "seconds": 0.0, "pool_bytes": {}})):
        monkeypatch.setattr(program, "spans", spans)
        monkeypatch.setattr(program, "stats", stats)
        assert reader.read(Reading(Slice([], [], (0.0, 0.0)), 0, [], {})) is None


def test_a_program_without_the_recorder_gives_none(monkeypatch):
    def missing(path):
        raise AttributeError(path)

    monkeypatch.setattr(program.port, "attr", missing)
    assert program.spans() is None and program.stats() is None
    assert program.cold_step_pct() is None and program.capture_seconds() is None


def test_the_ports_spans_fit_the_profilers_entry_spans_on_the_cpu():
    """Real clocks: a captured entry called (eagerly, on CPU tensors) inside
    the benchmark's ``flowbench.entry`` spans under ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cuda_optical_flow_2_torch.models.lucas_kanade import pyramidal_lk_jit
    from cuda_optical_flow_2_torch.config import LKConfig
    from flowbench.trace import WINDOW, span

    cfg = LKConfig(levels=2, window=5)
    prev, nxt = torch.rand(32, 48), torch.rand(32, 48)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("entry"):
            pyramidal_lk_jit(prev, nxt, cfg)
        with torch.profiler.record_function(WINDOW):
            for _ in range(4):
                with span("entry"):
                    pyramidal_lk_jit(prev, nxt, cfg)
    host = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
            if e.device_type == DeviceType.CPU and e.name.startswith("flowbench.")]
    (window,) = [(s, e) for s, e, name in host if name == WINDOW]
    sl = Slice([], [h for h in host if h[2] != WINDOW], window)
    found = program.calls(Reading(sl, 4, [], {}))
    entries = sorted((s, e) for s, e, name in sl.spans if name == "flowbench.entry")[1:]
    assert len(found) == 4
    for c, (s, e) in zip(found, entries):
        assert s <= c.start_us <= c.end_us <= e and c.launch_us is None
