"""The spans and counters of the captured entries, on the CPU.

``utils/profiling.span`` records while ``torch.profiler`` is active and
never otherwise; ``capture.py`` opens spans at the boundaries of a captured
call (``capture.call`` and under it ``key``, ``capture``, ``copy_in``,
``launch``, ``clone``, ``plain``, ``eager``).  Here, through the stand-in
graph of ``tests/torch_capture_stand_in.py`` (the buffers, the copy-in, the
swap, the conds' bookkeeping and the counters are ``capture``'s own code):
the span tree of a first call, a replay, a donating step's swap and its
plain fallback, and a CPU call; nothing recorded without a profiler; the
spans on the profiler's clock and absent from its events; the counters and
the recovery cond's taken counts through ``capture.stats()``; the spans in
``profiling.trace``'s Chrome trace.
"""

import json
import time
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import cuda_optical_flow_2_torch as tof
from cuda_optical_flow_2_torch import capture
from cuda_optical_flow_2_torch.models import streaming as tstream
from cuda_optical_flow_2_torch.utils import profiling
from cuda_optical_flow_2_torch.utils.io import synthetic_sequence

from torch_capture_stand_in import StandInGraph, stand_in  # noqa: F401  (a fixture)


def _scale(x, k: float = 2.0):
    return x * k, x.sum()


def _halve(x):
    return x / 2


def _accumulate(state, x):
    """A donating body: the new state has the donated argument's shape."""
    return state + x, state.sum()


def _recorded(fn):
    """``fn()`` under the profiler: (its result, the spans it recorded, the profile)."""
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, profiling.spans(), prof


def _calls(spans) -> list[tuple[profiling.Span, list[str]]]:
    """Each root ``capture.call`` and the names of its other spans, in order
    of their start."""
    roots = sorted((s for s in spans if s.name == "capture.call"), key=lambda s: s.start_ns)
    out = []
    for root in roots:
        assert root.parent is None and root.call_id == root.id
        inner = sorted((s for s in spans if s.call_id == root.call_id and s is not root),
                       key=lambda s: s.start_ns)
        for s in inner:
            assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
        out.append((root, [s.name for s in inner]))
    return out


def test_first_call_captures_then_replays_under_one_call_id(stand_in):
    jit = capture.captured(_scale)
    x = torch.arange(6.0)
    _, spans, _ = _recorded(lambda: [jit(x), jit(x + 1)])
    (first, names1), (second, names2) = _calls(spans)
    assert first.attrs == {"entry": "_scale", "path": "capture"}
    assert names1 == ["capture.key", "capture.capture", "capture.copy_in", "capture.launch",
                      "capture.clone"]
    assert second.attrs == {"entry": "_scale", "path": "replay"}
    assert names2 == ["capture.key", "capture.copy_in", "capture.launch", "capture.clone"]
    for root in (first, second):  # every piece hangs from the root
        assert {s.parent for s in spans if s.call_id == root.id and s is not root} == {root.id}


def test_donating_swap_and_its_plain_fallback(stand_in):
    jit = capture.captured(_accumulate, donate_argnums=(0,))
    x = torch.ones(4)

    def serve():
        s1, _ = jit(torch.zeros(4), x)  # caller's state: copied into set 0
        s2, _ = jit(s1, x)  # the swap: set 1 read, set 0 written
        s3, _ = jit(s2, x)  # s1 (set 1) is still held: the plain graph runs
        return s1, s2, s3

    (s1, s2, s3), spans, _ = _recorded(serve)
    assert [float(s[0]) for s in (s1, s2, s3)] == [1.0, 2.0, 3.0]
    calls = _calls(spans)
    assert [root.attrs["path"] for root, _ in calls] == ["capture", "replay", "plain"]
    assert calls[1][1] == ["capture.key", "capture.copy_in", "capture.launch", "capture.clone"]
    assert calls[2][1] == ["capture.key", "capture.plain", "capture.capture", "capture.copy_in",
                           "capture.launch", "capture.clone"]
    plain = next(s for s in spans if s.name == "capture.plain")
    assert {s.parent for s in spans if s.call_id == plain.call_id
            and s.name in ("capture.capture", "capture.copy_in", "capture.launch")} == {plain.id}
    (entry,) = [e for e in capture.stats()["entries"] if e["name"].endswith("._accumulate")]
    assert (entry["calls"], entry["plain"], entry["captures"], entry["replays"]) == (3, 1, 3, 3)


def test_a_cpu_call_runs_eagerly_under_its_root():
    jit = capture.captured(_scale)
    (out, _), spans, _ = _recorded(lambda: jit(torch.arange(3.0)))
    assert torch.equal(out, torch.arange(3.0) * 2)
    ((root, names),) = _calls(spans)
    assert root.attrs == {"entry": "_scale", "path": "eager"} and names == ["capture.key",
                                                                           "capture.eager"]


def test_nothing_is_recorded_without_a_profiler(stand_in):
    jit = capture.captured(_scale)
    profiling.clear_spans()
    x = torch.arange(4.0)
    for _ in range(50):
        jit(x)
    assert not profiling.recording() and profiling.spans() == []
    assert profiling.span("a") is profiling.span("b", entry="c")  # one shared null context


def test_the_off_path_keeps_no_memory():
    def calls(n):
        for _ in range(n):
            with profiling.span("capture.call", entry="e") as root:
                root.set("path", "replay")
                with profiling.span("capture.key"):
                    pass

    calls(10)
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        calls(10_000)
        after = tracemalloc.get_traced_memory()[0]
    finally:
        tracemalloc.stop()
    assert after == before and profiling.spans() == []


def test_span_buffer_is_a_bounded_ring(monkeypatch):
    monkeypatch.setattr(profiling, "_spans", profiling.collections.deque(maxlen=4))
    profiling.clear_spans()

    def many():
        for i in range(7):
            with profiling.span(f"s{i}"):
                pass

    _recorded(many)
    assert [s.name for s in profiling.spans()] == ["s3", "s4", "s5", "s6"]
    assert profiling.spans_dropped() == 3
    profiling.clear_spans()
    assert profiling.spans() == [] and profiling.spans_dropped() == 0


def test_a_span_lies_inside_its_record_function_range_on_the_profilers_clock():
    def ranges():
        for i in range(5):
            with torch.profiler.record_function(f"range{i}"):
                with profiling.span(f"span{i}"):
                    time.sleep(0.001)

    _, spans, prof = _recorded(ranges)
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    events = {e.name: e.time_range for e in prof.events()}
    assert len(spans) == 5
    for s in spans:
        rng = events["range" + s.name[4:]]
        assert rng.start <= (s.start_ns - start_ns) / 1e3 <= (s.end_ns - start_ns) / 1e3 <= rng.end


def test_no_program_span_is_a_profiler_event(stand_in):
    jit = capture.captured(_scale)
    x = torch.arange(4.0)
    _, spans, prof = _recorded(lambda: [jit(x) for _ in range(3)])
    assert {s.name for s in spans} >= {"capture.call", "capture.launch"}
    assert not [e.name for e in prof.events() if e.name.startswith("capture.")]


def test_counters_and_evictions_through_stats(stand_in, monkeypatch):
    monkeypatch.setattr(capture, "CACHE_SIZE", 2)
    jit = capture.captured(_halve)
    for n in (3, 4, 5, 5, 5):
        jit(torch.ones(n))
    jit.eager(torch.ones(2))  # the eager body is not the entry: not counted
    (entry,) = [e for e in capture.stats()["entries"] if e["name"] == f"{__name__}._halve"]
    assert (entry["calls"], entry["captures"], entry["evictions"], entry["eager"],
            entry["plain"]) == (5, 3, 1, 0, 0)
    assert entry["replays"] == 4  # the live graphs': shapes 4 (1) and 5 (3)
    assert [g["replays"] for g in entry["graphs"]] == [1, 3]
    assert all(g["pool_bytes"] == {} and g["seconds"] >= 0 for g in entry["graphs"])


def test_pool_bytes_sums_the_pools_segments_per_card():
    segments = [
        {"device": 0, "total_size": 2 << 20, "segment_pool_id": (0, 1)},
        {"device": 0, "total_size": 20 << 20, "segment_pool_id": (0, 0)},  # not a graph's
        {"device": 0, "total_size": 4 << 20, "segment_pool_id": [0, 7]},
        {"device": 1, "total_size": 8 << 20, "segment_pool_id": (1, 3)},
        {"device": 1, "total_size": 1 << 20, "segment_pool_id": (0, 1)},
    ]
    assert capture.pool_bytes(segments, {(0, 1), (0, 7), (1, 3)}) == {0: 6 << 20, 1: 9 << 20}
    assert capture.pool_bytes(segments, set()) == {}


def _frames(h=64, w=96):
    """Eight frames: a (2, 1) px/frame translation, then a cut at frame 5."""
    a = synthetic_sequence(5, h, w, velocity=(2.0, 1.0)).astype(np.float32)
    b = synthetic_sequence(3, h, w, velocity=(-1.0, 1.5), period=23, seed=1).astype(np.float32)
    return [torch.from_numpy(f) for f in (*a, *b)]


def test_recovery_step_cold_and_warm_counts_through_stats(stand_in, monkeypatch):
    """The serving loop over a cut: ``stats()`` gives the warm key's cond
    taken counts as the eager loop's checks, and the entry's counters."""
    cfg, rec = tof.LKConfig(levels=1, window=15), tof.RecoveryConfig(levels=3)
    frames = _frames()
    seed_ok, checks = tstream._seed_ok, []

    def spy(*args):
        ok = seed_ok(*args)
        checks.append(bool(ok))
        return ok

    with monkeypatch.context() as mp:
        mp.setattr(tstream, "_seed_ok", spy)
        state = tstream._init_state(frames[0], cfg, rec)
        for f in frames[1:]:
            state, _ = tstream._step(state, f, cfg, True, rec)

    def step_entry():
        return next(e for e in capture.stats()["entries"] if e["name"].endswith("streaming._step"))

    calls0 = next((e["calls"] for e in capture.stats()["entries"]
                   if e["name"].endswith("streaming._step")), 0)
    state = tof.init_state(frames[0], cfg, rec)
    for f in frames[1:]:
        state, _ = tof.step(state, f, cfg, True, rec)
    entry = step_entry()
    taken = [sum(g["taken"][0][b] for g in entry["graphs"] if g["taken"]) for b in (0, 1)]
    assert taken == [checks.count(True), checks.count(False)] and min(taken) > 0
    assert entry["calls"] - calls0 == len(frames) - 1
    # the cold key (flow None) one graph, the warm key G0 and G1; one replay per step
    assert len(entry["graphs"]) == 3 and entry["replays"] == len(frames) - 1


def test_trace_writes_the_spans_on_the_trace_clock(tmp_path):
    jit = capture.captured(_scale)
    with profiling.trace(str(tmp_path / "t")):
        with torch.profiler.record_function("around"):
            jit(torch.arange(3.0))
    with open(tmp_path / "t" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    (around,) = [e for e in events if e.get("name") == "around"]
    ours = {e["name"]: e for e in events if e.get("cat") == "program_span"}
    assert set(ours) == {"capture.call", "capture.key", "capture.eager"}
    root = ours["capture.call"]
    assert root["args"]["path"] == "eager" and root["args"]["parent"] is None
    assert around["ts"] <= root["ts"] <= root["ts"] + root["dur"] <= around["ts"] + around["dur"]
    assert ours["capture.key"]["args"]["parent"] == root["args"]["id"]
