"""The knee of an open-loop streams mix: the highest stream count whose
95th-percentile frame time stays under the frame period with no growing
lateness.

    python3 -m flowbench.sweep --workload lk_paper_1080p.camera_streams \\
        --streams 40,60,80,100 --seconds 10 [--out sweep.jsonl]

One process; for each S the cell's traffic with ``streams`` = S is set up
(inputs from ``--seed``, graphs captured) and run for ``--seconds``, then
its graphs are dropped.  Each line printed is one S: the window's
``frame_ms_p95``, the median, and the generator's lateness over the first
and the last quarter of the ticks (a last quarter later than the first by
more than a frame period is a growing backlog).  The cell then takes 4/5 of
the knee, written into its traffic file by hand.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from flowbench import spec
from flowbench.run import card_for


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m flowbench.sweep")
    p.add_argument("--workload", required=True)
    p.add_argument("--streams", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--out", type=Path)
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    device = card_for(cell)
    if device is None:
        return 2
    import torch

    from flowbench.port import Port

    port = Port(cell.config)
    period_ms = 1e3 / float(cell.traffic["fps"])
    lines = []
    for s in [int(x) for x in args.streams.split(",")]:
        cell.traffic = {**cell.traffic, "streams": s}
        loop = cell.loop().Loop(cell, args.seed, device, port)
        loop.warm_up()
        window = loop.run(args.seconds)
        load = window["load"]
        growing = load["late_ms_last_quarter"] - load["late_ms_first_quarter"] > period_ms
        line = {"workload": cell.name, "streams": s, **window["values"], **load,
                "holds": window["values"]["frame_ms_p95"] < period_ms and not growing,
                "memory_peak_bytes": torch.cuda.max_memory_reserved()}
        print(json.dumps(line), flush=True)
        lines.append(line)
        loop.release()
        del loop
        torch.cuda.empty_cache()
    knee = max((l["streams"] for l in lines if l["holds"]), default=None)
    print(json.dumps({"workload": cell.name, "knee_streams": knee,
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        with args.out.open("a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
