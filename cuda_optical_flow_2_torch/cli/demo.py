"""Demo CLI — the headless twin of the reference's webcam app (main.cu).

Counterpart of ``cuda_optical_flow_2_tpu.cli.demo``, with ``--device``
(default ``cuda``).  The reference's only executable is a webcam loop with
OpenCV debug windows; this demo consumes synthetic sequences, image files,
Y4M video or a V4L2 camera and writes PNG artifacts (flow color wheel,
arrow overlays, per-level gradient maps a la showTest, occlusion masks,
track overlays) and an optional Y4M flow video, plus an fps/EPE report to
stdout.

Examples:

    of2-torch-demo --synthetic 10 --out /tmp/flow
    of2-torch-demo --frames 'seq/*.png' --levels 4 --window 19 --out /tmp/flow \
        --debug-gradients
    of2-torch-demo --synthetic 4 --size 64x80 --levels 2 --device cpu
"""

from __future__ import annotations

import argparse
import glob
import os
import time

import numpy as np
import torch

import cuda_optical_flow_2_torch as of
from cuda_optical_flow_2_torch.cli import add_device_argument, device_from_flag
from cuda_optical_flow_2_torch.constants import DT_3X3_N, DX_3X3, DY_3X3
from cuda_optical_flow_2_torch.capture import captured
from cuda_optical_flow_2_torch.models import _jit_entry, streaming, tracking
from cuda_optical_flow_2_torch.ops.color import grayscale
from cuda_optical_flow_2_torch.ops.conv import conv2d
from cuda_optical_flow_2_torch.ops.pyramid import build_pyramid
from cuda_optical_flow_2_torch.ops.resize import upscale_nn
from cuda_optical_flow_2_torch.utils import io, native, viz

__all__ = ["main"]

# The render as a captured entry: one graph per flow shape and max_flow,
# shared by every run in the process (the JAX demo jits it, max_flow static).
_render = captured(viz.flow_to_color_device)


def _load_frames(args) -> np.ndarray:
    if args.frames:
        if args.frames.endswith(".y4m"):
            frames = [f.astype(np.float32) for f in io.read_y4m(args.frames)]
            if len(frames) < 2:
                raise SystemExit(f"need >= 2 frames in {args.frames}")
            return np.stack(frames)
        paths = sorted(glob.glob(args.frames))
        if len(paths) < 2:
            raise SystemExit(f"need >= 2 frames, matched {len(paths)}: {args.frames}")
        frames = []
        for p in paths:
            img = io.read_image(p)
            if img.ndim == 3:
                img = grayscale(torch.as_tensor(img)).numpy()
            frames.append(img.astype(np.float32))
        return np.stack(frames)
    h, w = (int(t) for t in args.size.split("x"))
    # noise=0.0 matches FrameStream.synthetic (native and fallback), so
    # --native-stream changes only the ingestion path, not the data — an
    # A/B of the prefetching pipeline must not be confounded by the input.
    return io.synthetic_sequence(
        args.synthetic, h, w, velocity=tuple(args.velocity), noise=0.0
    ).astype(np.float32)


def _dump_gradients(
    frame, prev_frame, levels: int, out_dir: str, idx: int, device, use_pallas: bool
) -> None:
    """showTest twin (main.cu:19-92): per-level Ix/Iy/It maps, binarized and
    upscaled to full resolution."""
    both = torch.as_tensor(np.stack([frame, prev_frame]).astype(np.float32), device=device)
    pyr2 = build_pyramid(both, levels, use_pallas=use_pallas)
    pyr = [lvl[0] for lvl in pyr2]
    prev_pyr = [lvl[1] for lvl in pyr2]
    for k, (lvl, plvl) in enumerate(zip(pyr, prev_pyr)):
        maps = {
            "x": conv2d(lvl, DX_3X3),
            "y": conv2d(lvl, DY_3X3),
            "t": conv2d(lvl, DT_3X3_N) - conv2d(plvl, DT_3X3_N),
        }
        for name, m in maps.items():
            u8 = m.abs().clamp(0, 255).cpu().numpy().astype(np.uint8)
            binz = viz.cleanup_outliers(u8)
            up = upscale_nn(torch.as_tensor(binz), k).numpy()
            viz.write_png(
                os.path.join(out_dir, f"frame{idx:04d}_L{k}_I{name}.png"), up
            )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    src = ap.add_mutually_exclusive_group()
    src.add_argument(
        "--frames",
        help="glob of input frames (png/ppm/npy), or a .y4m video file",
    )
    src.add_argument(
        "--synthetic", type=int, default=8, help="number of synthetic frames"
    )
    ap.add_argument("--size", default="480x640", help="synthetic frame size HxW")
    ap.add_argument(
        "--velocity", type=float, nargs=2, default=(2.0, 1.0),
        help="synthetic ground-truth velocity (vx vy) px/frame",
    )
    ap.add_argument(
        "--model", default="lk", choices=("lk", "hs", "fb", "tvl1", "dis"),
        help="flow model: pyramidal Lucas-Kanade (reference pipeline), "
        "Horn-Schunck (global variational), Farneback (polynomial "
        "expansion), TV-L1 (robust primal-dual) or DIS (mean-normalized "
        "inverse search + variational refinement) — extensions beyond lk",
    )
    ap.add_argument("--levels", type=int, default=4)
    ap.add_argument("--window", type=int, default=19)
    ap.add_argument(
        "--window-weights", default=None, choices=("box", "tri", "gauss"),
        help="integration-window weighting for lk/dis (default: the "
        "config's default, 'tri' for lk / 'box' for dis — see "
        "LKConfig.window_weights)",
    )
    ap.add_argument(
        "--iterations", type=int, default=None,
        help="LK solver iterations (default 1) / HS sweeps per level (default 100)",
    )
    ap.add_argument(
        "--alpha", type=float, default=10.0, help="HS smoothness weight"
    )
    ap.add_argument(
        "--temporal-kernel", default="gauss3", choices=("dt3", "gauss3")
    )
    ap.add_argument("--bilateral", action="store_true", help="enable pre-filter")
    ap.add_argument(
        "--median", type=int, default=None,
        help="TV-L1 flow median filter size (odd; 0 = off; default: the "
        "config default 5, matching OpenCV DualTVL1)",
    )
    ap.add_argument(
        "--no-pallas", action="store_true",
        help="run the plain PyTorch versions instead of the CUDA kernels",
    )
    ap.add_argument("--out", default=None, help="artifact output directory")
    ap.add_argument("--arrow-res", type=int, default=30)
    ap.add_argument(
        "--debug-gradients", action="store_true",
        help="dump per-level Ix/Iy/It maps (showTest twin)",
    )
    ap.add_argument(
        "--flo", action="store_true",
        help="also write Middlebury .flo flow files next to the PNGs",
    )
    ap.add_argument(
        "--occlusion", action="store_true",
        help="also estimate backward flow per pair and write the "
        "forward-backward occlusion mask (white = untrusted)",
    )
    ap.add_argument(
        "--warm-start", action="store_true",
        help="seed each pair's coarsest level with the previous pair's flow "
        "(serving mode: combine with a shallow --levels)",
    )
    ap.add_argument(
        "--recover-levels", type=int, default=None, metavar="N",
        help="with --warm-start: on-device scene-cut detection; invalid "
        "warm seeds re-acquire over an N-level pyramid "
        "(models.streaming.RecoveryConfig)",
    )
    ap.add_argument(
        "--native-stream", action="store_true",
        help="feed frames through the native prefetching FrameStream "
        "(C++ worker + ring buffer) instead of materializing the sequence",
    )
    src.add_argument(
        "--camera", default=None, metavar="DEV",
        help="capture live from a V4L2 camera device (e.g. /dev/video0) — "
        "the reference's webcam source; implies the native stream path",
    )
    ap.add_argument(
        "--camera-frames", type=int, default=64,
        help="frames to process from --camera before exiting (0 = until "
        "the stream ends)",
    )
    ap.add_argument(
        "--out-video", default=None, metavar="FLOW.y4m",
        help="write the flow-color frames as one Y4M video (play with "
        "`ffplay FLOW.y4m` — the headless twin of the reference's live "
        "imshow window); works for unbounded streams (constant memory)",
    )
    ap.add_argument(
        "--track", type=int, default=0, metavar="N",
        help="track an NxN grid of points through the stream (sparse "
        "pyramidal-LK tracker role) and write tracks####.png trajectory "
        "overlays to --out",
    )
    ap.add_argument(
        "--viz-max-flow", type=float, default=None, metavar="PX",
        help="fixed |flow| mapped to full color saturation in the PNG/video "
        "renders; default normalizes per frame, which flickers across a "
        "video when the peak motion varies",
    )
    add_device_argument(ap)
    args = ap.parse_args(argv)
    device = device_from_flag(args.device)
    recovery = None
    if args.recover_levels is not None:
        if not args.warm_start:
            ap.error("--recover-levels requires --warm-start")
        recovery = streaming.RecoveryConfig(levels=args.recover_levels)

    stream = None
    if args.native_stream or args.camera:
        if args.camera:
            # Live webcam capture — the reference's cv::VideoCapture(0)
            # source (main.cu:181-184), through the native V4L2 runtime.
            # Unbounded; --camera-frames caps the run.
            stream = native.FrameStream.from_v4l2(args.camera)
        elif args.frames and args.frames.endswith(".y4m"):
            stream = native.FrameStream.from_y4m(args.frames)
        elif args.frames:
            paths = sorted(glob.glob(args.frames))
            if len(paths) < 2:
                raise SystemExit(f"need >= 2 frames, matched {len(paths)}")
            stream = native.FrameStream.from_ppm(paths)
        else:
            h, w = (int(t) for t in args.size.split("x"))
            vx_, vy_ = args.velocity
            stream = native.FrameStream.synthetic(
                args.synthetic, h, w, vx=vx_, vy=vy_
            )
        recent: dict[int, np.ndarray] = {}

        def _record(src):
            # Keep the last two GOOD frames (None = decode failure, skipped
            # by process_sequence; the pair then spans the gap, so "prev"
            # is the last good index, not i-1).
            good: list[int] = []
            for i, (_, f) in enumerate(src):
                if f is not None:
                    recent[i] = f
                    good.append(i)
                    if len(good) > 2:
                        recent.pop(good.pop(0), None)
                yield f

        frames = None
        src = stream
        if args.camera and args.camera_frames:
            import itertools

            src = itertools.islice(iter(stream), args.camera_frames)
        frame_iter = _record(src)
    else:
        frames = _load_frames(args)
        frame_iter = iter(frames)
    prefilter = of.BilateralConfig() if args.bilateral else None
    if args.model == "tvl1":
        cfg = of.TVL1Config(
            levels=args.levels,
            iterations=args.iterations if args.iterations is not None else 30,
            **({} if args.median is None else {"median_filtering": args.median}),
            prefilter=prefilter,
            use_pallas=not args.no_pallas,
        )
    elif args.model == "dis":
        cfg = of.DISConfig(
            levels=args.levels,
            window=args.window if args.window % 2 else args.window + 1,
            iterations=args.iterations if args.iterations is not None else 2,
            **({} if args.window_weights is None
               else {"window_weights": args.window_weights}),
            prefilter=prefilter,
            use_pallas=not args.no_pallas,
        )
    elif args.model == "fb":
        cfg = of.FBConfig(
            levels=args.levels,
            iterations=args.iterations if args.iterations is not None else 3,
            winsize=args.window if args.window % 2 else args.window + 1,
            prefilter=prefilter,
            use_pallas=not args.no_pallas,
        )
    elif args.model == "hs":
        cfg = of.HSConfig(
            alpha=args.alpha,
            iterations=args.iterations if args.iterations is not None else 100,
            levels=args.levels,
            temporal_kernel=args.temporal_kernel,
            prefilter=prefilter,
            use_pallas=not args.no_pallas,
        )
    else:
        cfg = of.LKConfig(
            levels=args.levels,
            window=args.window,
            iterations=args.iterations if args.iterations is not None else 1,
            temporal_kernel=args.temporal_kernel,
            **({} if args.window_weights is None
               else {"window_weights": args.window_weights}),
            prefilter=prefilter,
            use_pallas=not args.no_pallas,
        )
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    # the backward flow of the occlusion masks: the family's captured entry,
    # a replay per frame shape (the JAX demo jits it once, config static)
    backward_flow = _jit_entry(cfg)

    def on_device(frame: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(frame.astype(np.float32), device=device)

    track_pts = track_alive = None
    track_hist: "deque[np.ndarray]" = None
    if args.track:
        from collections import deque

        track_hist = deque(maxlen=24)  # bounded trail on unbounded streams

    # Flow-color rendering runs on the device (viz.flow_to_color_device,
    # captured: a replay per flow shape and max_flow): the host fetches 3
    # B/px of uint8 RGB instead of running the colorize in the frame loop.
    def render(fl: torch.Tensor) -> np.ndarray:
        return _render(fl, args.viz_max_flow).cpu().numpy()

    vx, vy = args.velocity
    t0 = time.perf_counter()
    count = 0
    video = io.Y4MWriter(args.out_video) if args.out_video else None
    try:
        for i, flow in streaming.process_sequence(
            frame_iter, cfg, warm_start=args.warm_start, recovery=recovery, device=device
        ):
            flow_np = flow.cpu().numpy()
            count += 1
            msg = f"frame {i}: |flow| median {np.median(np.hypot(flow_np[...,0], flow_np[...,1])):.3f}"
            if args.frames is None:
                m = min(24, flow_np.shape[0] // 4, flow_np.shape[1] // 4)
                inner = flow_np[m : flow_np.shape[0] - m, m : flow_np.shape[1] - m]
                # After a decode failure the pair spans the gap, so the true
                # displacement is (frames skipped + 1) x the per-frame velocity.
                gap = 1 if frames is not None else i - max(k for k in recent if k < i)
                ex, ey = gap * vx, gap * vy
                epe = float(np.hypot(inner[..., 0] - ex, inner[..., 1] - ey).mean())
                msg += f"  EPE vs ({ex}, {ey}): {epe:.3f}"
            print(msg, flush=True)
            if video is not None:
                video.write(render(flow))
            if args.out:
                cur = frames[i] if frames is not None else recent[i]
                prv = (
                    frames[i - 1]
                    if frames is not None
                    else recent[max(k for k in recent if k < i)]
                )
                viz.write_png(
                    os.path.join(args.out, f"flow{i:04d}.png"), render(flow)
                )
                if args.flo:
                    io.write_flo(
                        os.path.join(args.out, f"flow{i:04d}.flo"), flow_np
                    )
                viz.write_png(
                    os.path.join(args.out, f"arrows{i:04d}.png"),
                    viz.draw_flow_arrows(cur.astype(np.uint8), flow_np, args.arrow_res),
                )
                if args.occlusion:
                    bw = backward_flow(on_device(cur), on_device(prv), cfg)
                    occ = of.occlusion_mask(flow, bw, use_pallas=cfg.use_pallas)
                    occ = occ.cpu().numpy()
                    viz.write_png(
                        os.path.join(args.out, f"occ{i:04d}.png"),
                        (occ * 255).astype(np.uint8),
                    )
                if args.debug_gradients:
                    _dump_gradients(
                        cur, prv, min(args.levels, 3), args.out, i, device, cfg.use_pallas
                    )
            if args.track:
                if track_pts is None:
                    h_, w_ = flow_np.shape[:2]
                    gy, gx = np.mgrid[1 : args.track + 1, 1 : args.track + 1]
                    track_pts = on_device(
                        np.stack(
                            [
                                gx.ravel() * w_ / (args.track + 1),
                                gy.ravel() * h_ / (args.track + 1),
                            ],
                            -1,
                        )
                    )
                track_pts, track_alive = tracking._advect_jit(flow, track_pts, track_alive)
                track_hist.append(track_pts.cpu().numpy())
                if args.out:
                    cur = frames[i] if frames is not None else recent[i]
                    viz.write_png(
                        os.path.join(args.out, f"tracks{i:04d}.png"),
                        viz.draw_tracks(
                            cur.astype(np.uint8), track_hist,
                            track_alive.cpu().numpy(),
                        ),
                    )
    finally:
        if video is not None:
            video.close()
        if stream is not None:
            stream.close()  # joins the C++ worker even on mid-loop errors
    dt = time.perf_counter() - t0
    print(f"{count} frames in {dt:.2f}s  ({count/dt:.1f} fps end-to-end incl. host IO)")


if __name__ == "__main__":
    main()
