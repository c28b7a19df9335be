"""Readings for the limits of ``correct``: the program over many seeds and
the control over a few, in one process.

    python3 -m flowbench.calibrate --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 --seconds 3 [--out readings.jsonl]

For each seed it makes the cell's inputs, warms up, runs a short window of
the cell's own traffic and compares the sampled answers with the reference,
as ``flowbench.run`` does (the graphs captured for the first seed serve the
others).  For each control seed it does the same, then puts the reference
computed in bfloat16 in the program's place (``compare.CONTROL_DTYPE``).
The lower reading of a number is the largest over the program's seeds, the
upper the smallest over the control's; each line printed is one seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from flowbench import compare, spec
from flowbench.run import card_for, forbidden_modules


def _seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m flowbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_seeds, default=[])
    p.add_argument("--control-seeds", type=_seeds, default=[])
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", type=Path)
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    device = card_for(cell)
    if device is None:
        return 2
    import torch

    from flowbench.port import Port

    port = Port(cell.config)
    reference = cell.reference()
    lines, worst = [], {"program": {}, "control": {}}
    runs = [(s, None) for s in args.seeds] + [(s, compare.CONTROL_DTYPE) for s in args.control_seeds]
    for seed, dtype in runs:
        t0 = time.perf_counter()
        loop = cell.loop().Loop(cell, seed, device, port)
        loop.warm_up()
        window = loop.run(args.seconds)
        gaps = compare.Gaps()
        checked = loop.check(reference, gaps, dtype=dtype)
        side = "program" if dtype is None else "control"
        line = {"workload": cell.name, "side": side, "seed": seed, **gaps.worst,
                "answers": gaps.answers, "checked": checked, "load": window.get("load", {}),
                "values": window["values"], "s": time.perf_counter() - t0}
        for name in compare.NUMBERS:
            pick = max if side == "program" else min
            worst[side][name] = pick(worst[side].get(name, gaps.worst[name]), gaps.worst[name])
        print(json.dumps(line), flush=True)
        lines.append(line)
        del loop, gaps
        torch.cuda.empty_cache()
    summary = {"workload": cell.name, "lower": worst["program"], "upper": worst["control"],
               "program_seeds": args.seeds, "control_seeds": args.control_seeds,
               "card": torch.cuda.get_device_name(0)}
    print(json.dumps(summary), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        with args.out.open("a") as f:
            for line in lines + [summary]:
                f.write(json.dumps(line) + "\n")
    return 3 if forbidden_modules() else 0


if __name__ == "__main__":
    sys.exit(main())
