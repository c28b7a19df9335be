"""Per-stage A/B diff CLI — the reference's comment-swap debug workflow
(main.cu:199-261) as a command.

Counterpart of ``cuda_optical_flow_2_tpu.cli.diff``, with ``--device``
(default ``cuda``) in place of ``--cpu``.  Runs every stage of the chosen
model family through the requested backends from identical canonical
inputs and prints per-stage max/mean absolute differences (see
utils/debug.py).

    of2-torch-diff --model fb --size 256x64
    of2-torch-diff --model lk --backends kernel banded oracle --frames 'seq/*.ppm'
    of2-torch-diff --model hs --device cpu --backends banded
"""

from __future__ import annotations

import argparse
import glob

import numpy as np


def main(argv=None) -> None:
    from cuda_optical_flow_2_torch.cli import add_device_argument, device_from_flag

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument(
        "--model", choices=("lk", "hs", "fb", "tvl1", "dis"), default="lk"
    )
    ap.add_argument("--size", default="256x64", help="HxW for synthetic input")
    ap.add_argument("--velocity", type=float, nargs=2, default=(2.0, 1.0))
    ap.add_argument(
        "--frames", default=None,
        help="glob of two frames to diff on instead of synthetic input",
    )
    ap.add_argument("--levels", type=int, default=2)
    ap.add_argument("--iterations", type=int, default=None)
    ap.add_argument("--window", type=int, default=9)
    ap.add_argument(
        "--backends", nargs="+", default=("kernel", "banded"),
        help="backends to diff against the baseline (kernel banded oracle; "
        "the end-to-end flow stage also accepts 'sharded' for spatial TP "
        "over --n-bands shards of the device; 'kernel' needs a CUDA device)",
    )
    ap.add_argument("--baseline", default="plain")
    ap.add_argument(
        "--n-bands", type=int, default=4,
        help="bands of the banded backend, shards of the sharded one",
    )
    ap.add_argument(
        "--stages", nargs="+", default=None, help="restrict to these stages"
    )
    add_device_argument(ap)
    args = ap.parse_args(argv)
    device = device_from_flag(args.device)
    if "kernel" in (*args.backends, args.baseline) and device.type != "cuda":
        ap.error(
            f"the kernel backend needs a CUDA device, not --device {args.device} "
            "(diff the plain versions with --backends banded oracle)"
        )

    import cuda_optical_flow_2_torch as of
    from cuda_optical_flow_2_torch.utils import io
    from cuda_optical_flow_2_torch.utils.debug import format_report, stage_report

    if args.frames:
        paths = sorted(glob.glob(args.frames))
        if len(paths) < 2:
            raise SystemExit(f"need >= 2 frames, matched {len(paths)}")
        imgs = [io.read_image(p) for p in paths[:2]]
        imgs = [
            i.astype(np.float32).mean(-1) if i.ndim == 3 else i.astype(np.float32)
            for i in imgs
        ]
        prev, nxt = imgs
    else:
        h, w = (int(t) for t in args.size.split("x"))
        seq = io.synthetic_sequence(
            2, h, w, velocity=tuple(args.velocity), noise=0.0
        )
        prev, nxt = seq[0].astype(np.float32), seq[1].astype(np.float32)

    if args.model == "fb":
        if args.window % 2 == 0:
            # Same contract as the LK path (LKConfig raises): silently
            # bumping to window+1 would report diffs for a configuration
            # the user didn't ask for.
            ap.error(f"--window must be odd, got {args.window}")
        cfg = of.FBConfig(
            levels=args.levels,
            iterations=args.iterations if args.iterations is not None else 2,
            winsize=args.window,
        )
    elif args.model == "hs":
        it = args.iterations if args.iterations is not None else 20
        cfg = of.HSConfig(levels=args.levels, iterations=it)
    elif args.model == "tvl1":
        it = args.iterations if args.iterations is not None else 15
        cfg = of.TVL1Config(levels=args.levels, iterations=it)
    elif args.model == "dis":
        if args.window % 2 == 0:
            ap.error(f"--window must be odd, got {args.window}")
        cfg = of.DISConfig(
            levels=args.levels,
            window=args.window,
            iterations=args.iterations if args.iterations is not None else 2,
        )
    else:
        cfg = of.LKConfig(
            levels=args.levels,
            window=args.window,
            iterations=args.iterations if args.iterations is not None else 2,
        )

    report = stage_report(
        prev, nxt, cfg,
        backends=tuple(args.backends),
        baseline=args.baseline,
        n_bands=args.n_bands,
        stages=tuple(args.stages) if args.stages else None,
        device=device,
    )
    print(format_report(report))


if __name__ == "__main__":
    main()
