"""Timing and profiling helpers.

Counterpart of ``cuda_optical_flow_2_tpu.utils.profiling``:

* :func:`device_time` — seconds per call of a function on the device of its
  tensor arguments: CUDA events around ``iters`` back-to-back calls after
  warm-up on a CUDA device, ``time.perf_counter`` on the CPU.  Eager torch
  enqueues each call in order on the current stream, so the JAX module's
  chained ``fori_loop`` has no counterpart here (its ``perturb_arg`` is
  taken and ignored).
* :func:`trace` — context manager around ``torch.profiler`` that writes a
  Chrome trace of the kernels (open it in Perfetto or ``chrome://tracing``).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch

__all__ = ["WARMUP", "device_time", "trace"]

WARMUP = 2  # untimed calls before the timed ones (the first CUDA call builds the kernels)


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


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (host and, where a CUDA
    device is present, its kernels) and write ``log_dir/trace.json``, a
    Chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
