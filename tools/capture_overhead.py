"""Where the host time of a captured call goes, from the program's own
spans; print one line per piece.

    python3 tools/capture_overhead.py

Run from the root of a checkout on a machine with one CUDA GPU.  For
``pyramidal_lk_jit`` at ``PAPER_1080P`` on a 1080x1920 pair, and for the
warm serving step with recovery (``step``, ``FBConfig(levels=1,
iterations=1)`` and ``LKConfig(levels=1, window=15)``,
``RecoveryConfig(levels=3)``; one replay per step, the state donated):
200 warm calls under ``utils/profiling.trace``, and per call the mean host
microseconds of each span the port records (``capture.call`` and its
pieces ``capture.key``, ``capture.copy_in``, ``capture.launch``,
``capture.clone``) and from the call's start to its launch; then the
entry's ``capture.stats()`` (calls, replays, captures, and per graph its
replays, pool MB per card, capture seconds and the cond's taken counts).
The profiler is on, so each piece reads longer than in an untraced call;
the pieces compare with each other.  Last, the card's name and power limit.
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PIECES = ("capture.call", "capture.key", "capture.copy_in", "capture.launch", "capture.clone")


def span_us(fn, n: int = 200) -> dict[str, float]:
    """Mean host microseconds per call of each piece of ``n`` calls of
    ``fn`` (one captured call each) under ``profiling.trace``."""
    import torch

    from cuda_optical_flow_2_torch.utils import profiling

    fn()
    torch.cuda.synchronize()
    profiling.clear_spans()
    with tempfile.TemporaryDirectory() as log_dir, profiling.trace(log_dir):
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    spans = profiling.spans()
    roots = {s.id: s for s in spans if s.name == "capture.call" and s.parent is None}
    total = dict.fromkeys(PIECES, 0)
    launch: dict[int, int] = {}
    for s in spans:
        if s.call_id in roots and s.name in total:
            total[s.name] += s.end_ns - s.start_ns
        if s.call_id in roots and s.name == "capture.launch":
            launch[s.call_id] = min(launch.get(s.call_id, s.start_ns), s.start_ns)
    out = {name: t / len(roots) / 1e3 for name, t in total.items()}
    out["start to launch"] = sum(launch[c] - roots[c].start_ns for c in launch) / len(launch) / 1e3
    return out


def entry_stats(name: str) -> str:
    from cuda_optical_flow_2_torch import capture

    (entry,) = [e for e in capture.stats()["entries"] if e["name"] == name]
    graphs = "; ".join(
        f"{g['replays']} replays, pool "
        + ", ".join(f"card {c} {b / 2**20:.1f} MB" for c, b in g["pool_bytes"].items())
        + f", capture {g['seconds']:.3f} s" + (f", taken {g['taken']}" if g["taken"] else "")
        for g in entry["graphs"])
    return (f"  stats: {entry['calls']} calls, {entry['replays']} replays, {entry['captures']} "
            f"captures, {entry['plain']} plain; graphs: {graphs}")


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("capture_overhead: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import cuda_optical_flow_2_torch as of
    from cuda_optical_flow_2_torch.utils.io import synthetic_sequence

    dev = torch.device("cuda", 0)
    card = cs.smi_line()

    def report(label, fn, entry):
        pieces = ", ".join(f"{name} {us:.1f}" for name, us in span_us(fn).items())
        print(f"{label} (us per call, traced): {pieces} [{card}]")
        print(entry_stats(entry))

    fr = synthetic_sequence(2, 1080, 1920, velocity=(2.0, 1.0), period=48)
    p, n = (torch.as_tensor(f, device=dev).float() for f in fr)
    cfg = of.PAPER_1080P
    report("pyramidal_lk_jit PAPER_1080P", lambda: of.pyramidal_lk_jit(p, n, cfg),
           "cuda_optical_flow_2_torch.models.lucas_kanade.pyramidal_lk")

    frames = [None if f is None else torch.as_tensor(f, device=dev).float()
              for f in cs.scene_frames(1080, 1920)]
    rec = of.RecoveryConfig(levels=3)
    for scfg in (of.FBConfig(levels=1, iterations=1), of.LKConfig(levels=1, window=15)):
        state = of.init_state(frames[0], scfg, rec)
        state, _ = of.step(state, frames[1], scfg, True, rec)
        box = [state]

        def warm_step(scfg=scfg, box=box):
            # each step passes the state the last one returned: one replay,
            # the frame copied in, the flow cloned
            box[0], _ = of.step(box[0], frames[2], scfg, True, rec)

        report(f"step {type(scfg).__name__} warm with recovery", warm_step,
               "cuda_optical_flow_2_torch.models.streaming._step")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
