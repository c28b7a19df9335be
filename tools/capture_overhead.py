"""Where the host time of a captured call goes; print one line per piece.

    python3 tools/capture_overhead.py

Run from the root of a checkout on a machine with one CUDA GPU.  For
``pyramidal_lk_jit`` at ``PAPER_1080P`` on a 1080x1920 pair, and for the
warm serving step with recovery (``step``, ``FBConfig(levels=1,
iterations=1)`` and ``LKConfig(levels=1, window=15)``,
``RecoveryConfig(levels=3)``; one replay per step, the state donated),
each piece of the captured call (the key; the graph's replay alone and
with the copy-in; for the step the frame's copy-in, the replay of the
graph that reads the passed state's buffer set, and the flow's clone) and
the eager call:

- host enqueue: wall time per call of 200 back-to-back calls, the device
  not awaited;
- with the device: the same loop ended by ``torch.cuda.synchronize()``;
- cuda_ms: ``chip_smoke.cuda_ms`` (CUDA events around one call, median of 30).

Then the Python functions that take the host's time in 200 captured calls,
by ``cProfile`` (total time of each function itself), and the card's name
and power limit.
"""

from __future__ import annotations

import cProfile
import io
import pstats
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def host_us(fn, n: int = 200) -> tuple[float, float]:
    """(host enqueue, with the device) in microseconds per call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return (t1 - t0) / n * 1e6, (t2 - t0) / n * 1e6


def top_functions(fn, n: int = 200, rows: int = 12) -> str:
    """cProfile of ``n`` calls of ``fn``: the functions with the most own time."""
    import torch

    prof = cProfile.Profile()
    prof.enable()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    prof.disable()
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(rows)
    return out.getvalue()


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("capture_overhead: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import cuda_optical_flow_2_torch as of
    from cuda_optical_flow_2_torch.models import streaming
    from cuda_optical_flow_2_torch.utils.io import synthetic_sequence

    dev = torch.device("cuda", 0)
    card = cs.smi_line()
    print(card)

    def report(label, fn):
        enq, total = host_us(fn)
        print(f"{label}: host enqueue {enq:.1f} us/call, with the device {total:.1f} us/call, "
              f"cuda_ms {1e3 * cs.cuda_ms(fn, 30):.1f} us [{card}]")

    fr = synthetic_sequence(2, 1080, 1920, velocity=(2.0, 1.0), period=48)
    p, n = (torch.as_tensor(f, device=dev).float() for f in fr)
    cfg = of.PAPER_1080P
    jit = of.pyramidal_lk_jit
    jit(p, n, cfg)
    graph = jit.cache.entries[jit.key(p, n, cfg)]
    for label, fn in {
        "pyramidal_lk_jit PAPER_1080P": lambda: jit(p, n, cfg),
        "  key": lambda: jit.key(p, n, cfg),
        "  graph.replay() alone": lambda: graph.replay(),
        "  replay with the copy-in": lambda: graph.replay([p, n]),
        "  clone of the flow": lambda: graph.outputs.clone(),
        "pyramidal_lk (eager)": lambda: of.pyramidal_lk(p, n, cfg),
    }.items():
        report(label, fn)
    print(top_functions(lambda: jit(p, n, cfg)))

    frames = [None if f is None else torch.as_tensor(f, device=dev).float()
              for f in cs.scene_frames(1080, 1920)]
    rec = of.RecoveryConfig(levels=3)
    for scfg in (of.FBConfig(levels=1, iterations=1), of.LKConfig(levels=1, window=15)):
        name = type(scfg).__name__
        state = of.init_state(frames[0], scfg, rec)
        state, _ = of.step(state, frames[1], scfg, True, rec)
        # the first warm step copies the state into set 0 and returns set 1
        state, _ = of.step(state, frames[2], scfg, True, rec)
        nxt = frames[3]
        entry = streaming._step_graphs.cache.entries[streaming._step_graphs.key(
            state, nxt, scfg, True, rec)]
        graph = entry.graphs[1]  # reads set 1, the passed state's
        frame_buffer = [t for t, donated in zip(graph.inputs, entry.mask) if not donated][0]
        for label, fn in {
            f"step {name} warm with recovery": lambda: of.step(state, nxt, scfg, True, rec),
            "  key": lambda: streaming._step_graphs.key(state, nxt, scfg, True, rec),
            "  frame copy-in": lambda: frame_buffer.copy_(nxt),
            "  replay (counters included)": lambda: graph.replay(),
            "  flow clone": lambda: graph.outputs[1].clone(),
            f"_step {name} (eager)": lambda: streaming._step(state, nxt, scfg, True, rec),
        }.items():
            report(label, fn)
        print(top_functions(lambda: of.step(state, nxt, scfg, True, rec)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
