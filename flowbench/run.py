"""Run one cell of the port's benchmark once and print one JSON line.

    python3 -m flowbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  In order: set-up (import the port, make the
cell's inputs on the card from the seed, build the kernels where the
checkout has not, capture and warm up the one shape the mix sends); the
measured window of ``--seconds``; with ``--trace 1`` a bounded slice under
the profiler; the peak memory; the program's state freed; the comparison of
the window's sampled answers with the plain reference.  The last line of
standard output is the result: with ``--trace 0`` the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics and the breakdown; the
numbers compared, each beside its limit, come last there and as the last
lines of standard error.

It exits non-zero and prints no result when there is no CUDA device (or
fewer than the cell asks for), when the port cannot be imported, or when
JAX or the JAX package was loaded by the time the window closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from flowbench import compare, spec  # noqa: E402

__all__ = ["main", "run_cell"]

CHECKOUT = spec.ROOT.parent
# caches the program or torch may write, at fixed paths inside the checkout
CACHE_DIRS = {
    "TRITON_CACHE_DIR": ".flowbench_cache/triton",
    "TORCH_EXTENSIONS_DIR": ".flowbench_cache/torch_extensions",
    "CUDA_CACHE_PATH": ".flowbench_cache/cuda",
}
FORBIDDEN = ("jax", "jaxlib", "flax", "cuda_optical_flow_2_tpu")


def _parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m flowbench.run", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def run_cell(cell, seed: int, seconds: float, trace: bool, device, *, started: float,
             port_hook=None) -> dict:
    """Drive one cell once on ``device``; return the result line's dict.
    ``port_hook(port)``, when given, returns the port object the loop
    drives (the tests break it there)."""
    import torch

    from flowbench.layers import Reading
    from flowbench.port import Port

    port = Port(cell.config)
    if port_hook is not None:
        port = port_hook(port)
    loop = cell.loop().Loop(cell, seed, device, port)
    loop.warm_up()
    setup_s = time.perf_counter() - started
    window = loop.run(seconds)
    on_card = device.type == "cuda"
    out: dict = {"correct": False, "attempted": window["attempted"], "failed": 0}
    metrics, dev = {}, {}
    if trace:
        dev["busy_s"], dev["window_s"] = 0.0, 0.0
        if on_card:
            from flowbench.trace import Tracer

            fn, calls, pairs_per_call, prime = loop.trace_unit()
            before = len(loop.host)
            tracer = Tracer()
            sl = tracer.traced(fn, calls, prime)
            loop.finish_trace()
            traced_host = loop.host[before:]
            reading = Reading(sl, calls * pairs_per_call, window["host_s"], cell.config)
            for m in cell.per_layer:
                value = cell.reader(m["name"]).read(reading)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            dev["busy_s"], dev["window_s"] = sl.busy_s, sl.window_s
            out["breakdown"] = sl.breakdown()
            # what tracing costs the host: ms per call in the entry, traced
            # and in the window
            out["trace_cost"] = {
                "host_ms_traced": sum(traced_host) / max(1, len(traced_host)) * 1e3,
                "host_ms_window": sum(window["host_s"]) / max(1, len(window["host_s"])) * 1e3,
                "traces_taken_again": tracer.lost}
    else:
        for m in cell.end_to_end:
            value = setup_s if m["name"] == "setup_s" else window["values"][m["name"]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if on_card:
        torch.cuda.synchronize()
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
               "memory_peak_bytes": torch.cuda.max_memory_reserved(), **dev}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0, **dev}
    loop.release()
    if on_card:
        torch.cuda.empty_cache()
    gaps = compare.Gaps()
    t0 = time.perf_counter()
    checked = loop.check(cell.reference(), gaps)
    ok, failed, checks = compare.judge(gaps, cell.limits)
    out.update(correct=ok, failed=failed, metrics=metrics, device=dev)
    out["load"] = {**window.get("load", {}), "calls": window["calls"],
                   "window_s": window["window_s"], "checked": checked,
                   "check_s": time.perf_counter() - t0}
    out["checks"] = checks
    return out


def card_for(cell):
    """The cache directories set, TF32 off, and the first card; None (with
    the reason on stderr) when the machine has fewer cards than the cell."""
    for var, rel in CACHE_DIRS.items():
        os.environ.setdefault(var, str(CHECKOUT / rel))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA device(s); this machine has {have}",
              file=sys.stderr)
        return None
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    return torch.device("cuda", 0)


def main(argv=None) -> int:
    args = _parse(argv)
    cell = spec.load_cell(args.workload)
    device = card_for(cell)
    if device is None:
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, started=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"loaded by the time the window closed: {', '.join(bad)}", file=sys.stderr)
        return 3
    result["card"] = power_limit()
    checks = result.pop("checks")
    result["checks"] = checks  # last key of the line
    compare.print_checks(checks)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
