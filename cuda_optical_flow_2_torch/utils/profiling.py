"""Timing and profiling helpers.

Counterpart of ``cuda_optical_flow_2_tpu.utils.profiling``:

* :func:`device_time` — seconds per call of a function on the device of its
  tensor arguments: CUDA events around ``iters`` back-to-back calls after
  warm-up on a CUDA device, ``time.perf_counter`` on the CPU.  Eager torch
  enqueues each call in order on the current stream, so the JAX module's
  chained ``fori_loop`` has no counterpart here (its ``perturb_arg`` is
  taken and ignored).
* :func:`trace` — context manager around ``torch.profiler`` that writes a
  Chrome trace of the kernels (open it in Perfetto or ``chrome://tracing``),
  with the program's own spans in it.
* :func:`span` — a span of the program's own (``capture.py`` records them
  at the boundaries of a captured call), kept in memory while
  ``torch.profiler`` is active and never otherwise; :func:`spans` returns
  them and :func:`clear_spans` empties the buffer.

A span is a :class:`Span` record: its name, its start and end on the clock
that ``torch.profiler`` stamps host events with (``time.time_ns()``: a
profiler event's time in microseconds is ``(ns - trace_start_ns) / 1e3``,
``trace_start_ns`` being the profiler's
``prof.profiler.kineto_results.trace_start_ns()``), the id of the span open
around it on its thread (None for a root), the id of its root (every span
of one captured call shares it), its attributes, its own id and its
thread's native id.  Spans are not ``record_function`` ranges: those also
appear on the device's timeline as annotations, where a reader of device
time would count them as work.  A span adds no device work and no host
sync; with no profiler active, :func:`span` returns one shared null context.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Any, Callable, NamedTuple

import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = ["WARMUP", "SPAN_BUFFER", "Span", "device_time", "trace", "span", "recording",
           "spans", "spans_dropped", "clear_spans"]

WARMUP = 2  # untimed calls before the timed ones (the first CUDA call builds the kernels)
SPAN_BUFFER = 65536  # spans kept, the oldest dropped first


def _device(args) -> torch.device:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device("cpu")


def device_time(fn: Callable, *args, iters: int = 20, perturb_arg: int = 0) -> float:
    """Seconds per call of ``fn(*args)``.

    ``WARMUP`` calls first, then ``iters`` calls back to back: between two
    CUDA events on the current stream when the first tensor argument lies
    on a CUDA device, else between two ``time.perf_counter`` reads.  ``fn``
    is called ``WARMUP + iters`` times in all.

    ``perturb_arg`` is the JAX signature's: there it names the argument
    nudged by each result to chain the iterations on the device.  The calls
    here are already in stream order, so there is no chain to perturb: the
    argument is accepted and ignored.
    """
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    dev = _device(args)
    for _ in range(WARMUP):
        fn(*args)
    if dev.type == "cuda":
        with torch.cuda.device(dev):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn(*args)
            end.record()
            end.synchronize()
            return max(start.elapsed_time(end) * 1e-3 / iters, 1e-9)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    return max((time.perf_counter() - t0) / iters, 1e-9)


# --- spans -------------------------------------------------------------------


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int | None  # the id of the enclosing span, None for a root
    call_id: int  # the id of the root: shared by every span of one call
    attrs: dict
    id: int
    tid: int  # the thread's native id, as the profiler's trace names threads


_spans: collections.deque = collections.deque(maxlen=SPAN_BUFFER)
_dropped = 0
_ids = itertools.count(1)


class _Thread(threading.local):
    """Per thread: the recording spans open on it and its native id."""

    def __init__(self):
        self.stack: list = []
        self.tid = threading.get_native_id()


_open = _Thread()


class _Recording:
    __slots__ = ("name", "attrs", "id", "parent", "call_id", "start_ns")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self) -> "_Recording":
        stack = _open.stack
        self.id = next(_ids)
        outer = stack[-1] if stack else None
        self.parent = outer.id if outer else None
        self.call_id = outer.call_id if outer else self.id
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        global _dropped
        end_ns = time.time_ns()
        _open.stack.pop()
        if len(_spans) == _spans.maxlen:
            _dropped += 1
        _spans.append(Span(self.name, self.start_ns, end_ns, self.parent, self.call_id,
                           self.attrs, self.id, _open.tid))

    def set(self, key: str, value: Any) -> None:
        """Set an attribute known only once the span is open."""
        self.attrs[key] = value


class _Off:
    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> None:
        pass

    def set(self, key: str, value: Any) -> None:
        pass


_OFF = _Off()


def recording() -> bool:
    """Whether spans are recorded: exactly while ``torch.profiler`` (or
    ``torch.autograd.profiler``) is active."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str, **attrs):
    """A context manager that records the span ``name`` with ``attrs``
    while a profiler is active (its ``set(key, value)`` adds an attribute
    from inside), and the shared null context otherwise."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Recording(name, attrs)


def spans() -> list[Span]:
    """The recorded spans, in the order they ended (a span ends after the
    spans inside it); at most ``SPAN_BUFFER``, the newest."""
    return list(_spans)


def spans_dropped() -> int:
    """Spans dropped from the full buffer since the last :func:`clear_spans`."""
    return _dropped


def clear_spans() -> None:
    """Empty the span buffer."""
    global _dropped
    _spans.clear()
    _dropped = 0


def _add_spans(path: str, recorded: list[Span]) -> None:
    """Write ``recorded`` into the Chrome trace at ``path`` as complete
    events on the trace's own clock (its ``baseTimeNanoseconds``)."""
    with open(path) as f:
        data = json.load(f)
    base = data.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    data["traceEvents"].extend(
        {"ph": "X", "cat": "program_span", "name": s.name, "pid": pid, "tid": s.tid,
         "ts": (s.start_ns - base) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
         "args": {**s.attrs, "id": s.id, "parent": s.parent, "call_id": s.call_id}}
        for s in recorded)
    with open(path, "w") as f:
        json.dump(data, f, default=str)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (host and, where a CUDA
    device is present, its kernels) and write ``log_dir/trace.json``, a
    Chrome trace that also holds the spans the program recorded in the
    block (``capture.call`` and its pieces above a replay's kernels)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    start_ns = time.time_ns()
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    _add_spans(path, [s for s in _spans if s.start_ns >= start_ns])
