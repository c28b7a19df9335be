#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It builds the CUDA kernels from
``cuda_optical_flow_2_torch/csrc`` and then, in order:

1. device: requires a CUDA device, prints its name and power limit, and
   turns TF32 off for cuDNN and matmul;
2. build: compiles the kernels and prints the build time;
3. kernels: each kernel against its plain PyTorch version at the main
   path's level-0 shapes;
4. main path: ``pyramidal_lk`` at ``PAPER_1080P`` on a 1080x1920 pair
   translating at (2, 1) px, against the plain path (``use_pallas=False``,
   the same plain ops without the budget clamp, which (2, 1) never reaches);
5. entry config: ``LKConfig(levels=4, window=19)`` on a random 480x640 pair;
6. serving loop: warm ``process_sequence`` with scene-cut recovery over
   eight 1080x1920 frames with a cut and a dropped frame;
7. timing with CUDA events, kernel and plain.

Each phase prints one line; any failed check raises and the script exits
non-zero.  The launch counters are zeroed before phase 4 and read after
phase 6: every kernel must have launched in that run.  The line before the
last is a JSON object with each kernel's numbers; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
package beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# (name, module, plain version, source, TPU kernel replaced)
KERNELS = [
    ("lk_residual", "lk_fused", "lk_residual_plain",
     "cuda_optical_flow_2_torch/csrc/lk_fused.cu",
     "cuda_optical_flow_2_tpu/kernels/lk_fused.py:327"),
    ("lk_level_step", "lk_step_fused", "lk_level_step_plain",
     "cuda_optical_flow_2_torch/csrc/lk_step_fused.cu",
     "cuda_optical_flow_2_tpu/kernels/lk_step_fused.py:278"),
    ("warp_bilinear_select", "warp_select", "warp_bilinear_select_plain",
     "cuda_optical_flow_2_torch/csrc/warp_select.cu",
     "cuda_optical_flow_2_tpu/kernels/warp_select.py:108"),
]

WARP_MAX_ERR = 1e-3      # intensities 0-255: float order of four taps
LK_MEDIAN_ERR = 1e-4     # px, kernel vs plain, per pixel
LK_P999_ERR = 1e-2       # px: ill-conditioned pixels amplify summation order
PATH_MEDIAN_ERR = 1e-3   # px, whole pipeline, kernel vs plain path
PATH_P99_ERR = 1e-2
TRANSLATION_TOL = 0.1    # px, inner median flow vs the true (2, 1)


class CheckFailed(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def err_stats(got, want) -> dict:
    a = got.detach().double().cpu().numpy()
    b = want.detach().double().cpu().numpy()
    require(a.shape == b.shape, f"shape {a.shape} vs {b.shape}")
    require(np.isfinite(a).all(), "kernel output not finite")
    require(np.isfinite(b).all(), "plain output not finite")
    d = np.abs(a - b)
    return {
        "max": float(d.max()),
        "median": float(np.median(d)),
        "p99": float(np.percentile(d, 99)),
        "p999": float(np.percentile(d, 99.9)),
    }


def textured_pair(h: int, w: int, seed: int):
    """Two frames of a textured scene plus a smooth flow field of up to
    ~20 px that sends border pixels out of the image."""
    from cuda_optical_flow_2_torch.utils.io import synthetic_sequence

    fr = synthetic_sequence(2, h, w, velocity=(3.0, -2.0), period=13, seed=seed)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    u = 20.0 * np.sin(2 * np.pi * ys / h) * np.cos(np.pi * xs / w)
    v = 15.0 * np.cos(2 * np.pi * xs / w) * np.sin(np.pi * ys / h) - 4.0
    flow = np.stack([u, v], -1).astype(np.float32)
    return fr[0].astype(np.float32), fr[1].astype(np.float32), flow


def scene_frames(h: int, w: int) -> list:
    """Eight serving-loop frames: a (2, 1) px/frame translation, a scene cut
    at frame 5 (another texture, seed and motion), a dropped frame at 7."""
    from cuda_optical_flow_2_torch.utils.io import synthetic_sequence

    a = synthetic_sequence(5, h, w, velocity=(2.0, 1.0), seed=0)
    b = synthetic_sequence(2, h, w, velocity=(-1.0, 1.5), period=23, seed=1)
    return [*a, *b, None]


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, inner: int = 1, warmup: int = 3) -> float:
    """Median over ``reps`` of the ms per call of ``inner`` back-to-back calls
    between two CUDA events (host enqueue time included where it exceeds
    the device's)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def main() -> int:
    if not (ROOT / "cuda_optical_flow_2_torch" / "csrc").is_dir():
        print("chip_smoke: cuda_optical_flow_2_torch/ not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke test needs a GPU",
              file=sys.stderr)
        return 2

    import cuda_optical_flow_2_torch as of
    from cuda_optical_flow_2_torch.kernels import _build, lk_fused, lk_step_fused, warp_select

    mods = {"lk_fused": lk_fused, "lk_step_fused": lk_step_fused, "warp_select": warp_select}
    wrappers = {name: getattr(mods[m], name) for name, m, *_ in KERNELS}
    plains = {name: getattr(mods[m], plain) for name, m, plain, *_ in KERNELS}

    # 1. device
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = smi_line()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"phase 1 device: {kind}; count {torch.cuda.device_count()}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}; TF32 off")
    print(card)

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    print(f"phase 2 build: {time.perf_counter() - t0:.1f} s (nvcc {_build.build_seconds():.1f} s)")

    def cuda(a):
        return torch.as_tensor(a, device=dev)

    # 3. kernels against their plain versions on the card
    max_err = {name: 0.0 for name, *_ in KERNELS}
    cases = [
        ((1080, 1920), of.PAPER_1080P),
        ((480, 640), of.LKConfig(levels=4, window=19)),
        ((480, 640), of.LKConfig(levels=4, window=19, window_weights="box")),
        ((480, 640), of.LKConfig(levels=4, window=19, window_weights="gauss")),
    ]
    for (h, w), cfg in cases:
        p, n, f = (cuda(a) for a in textured_pair(h, w, seed=h))
        checks = {
            "warp_bilinear_select": (p, f, cfg.max_displacement),
            "lk_residual": (p, n, cfg),
            "lk_level_step": (p, n, f, cfg),
        }
        parts = []
        for name, args in checks.items():
            got = wrappers[name](*args)
            torch.cuda.synchronize()
            e = err_stats(got, plains[name](*args))
            max_err[name] = max(max_err[name], e["max"])
            if name == "warp_bilinear_select":
                require(e["max"] <= WARP_MAX_ERR, f"{name} {h}x{w}: max |d| {e['max']}")
                parts.append(f"{name} max {e['max']:.3g}")
            else:
                require(e["median"] <= LK_MEDIAN_ERR and e["p999"] <= LK_P999_ERR,
                        f"{name} {h}x{w} {cfg.window_weights}: {e}")
                parts.append(f"{name} median {e['median']:.3g} p99.9 {e['p999']:.3g} "
                             f"max {e['max']:.3g}")
        print(f"phase 3 kernels {h}x{w} window {cfg.window} {cfg.window_weights}: "
              + "; ".join(parts))

    # 4. main path: PAPER_1080P at 1080x1920
    for fn in wrappers.values():
        fn.launches = 0
    from cuda_optical_flow_2_torch.utils.io import synthetic_sequence

    # Period 48 px: 3 px at the fifth level.  The default 16 px is 1 px there,
    # aliases, and sends any 5-level LK (the JAX package's too) off (2, 1).
    fr = synthetic_sequence(2, 1080, 1920, velocity=(2.0, 1.0), period=48)
    prev, nxt = cuda(fr[0]).float(), cuda(fr[1]).float()
    flow = of.pyramidal_lk(prev, nxt, of.PAPER_1080P)
    torch.cuda.synchronize()
    path_launches = {name: fn.launches for name, fn in wrappers.items()}
    plain_cfg = dataclasses.replace(of.PAPER_1080P, use_pallas=False)
    flow_plain = of.pyramidal_lk(prev, nxt, plain_cfg)
    require(tuple(flow.shape) == (1080, 1920, 2), f"flow shape {tuple(flow.shape)}")
    e = err_stats(flow, flow_plain)
    m = flow[64:-64, 64:-64].reshape(-1, 2).median(dim=0).values.cpu().numpy()
    require(abs(m[0] - 2.0) <= TRANSLATION_TOL and abs(m[1] - 1.0) <= TRANSLATION_TOL,
            f"inner median flow {m}, expected (2, 1)")
    require(e["median"] <= PATH_MEDIAN_ERR and e["p99"] <= PATH_P99_ERR,
            f"kernel path vs plain path: {e}")
    require(path_launches["lk_residual"] > 0 and path_launches["lk_level_step"] > 0,
            f"pyramidal_lk did not launch the LK kernels: {path_launches}")
    print(f"phase 4 pyramidal_lk PAPER_1080P 1080x1920: inner median flow ({m[0]:.4f}, "
          f"{m[1]:.4f}); vs plain path median {e['median']:.3g} p99 {e['p99']:.3g} "
          f"max {e['max']:.3g}; launches {path_launches}")

    # 5. entry config
    rng = np.random.default_rng(0)
    p5 = cuda(rng.integers(0, 256, (480, 640)).astype(np.float32))
    n5 = cuda(rng.integers(0, 256, (480, 640)).astype(np.float32))
    f5 = of.pyramidal_lk(p5, n5, of.LKConfig(levels=4, window=19))
    require(tuple(f5.shape) == (480, 640, 2), f"entry flow shape {tuple(f5.shape)}")
    require(bool(torch.isfinite(f5).all()), "entry flow not finite")
    print(f"phase 5 entry LKConfig(levels=4, window=19) 480x640: shape {tuple(f5.shape)}, "
          f"finite, mean |flow| {f5.abs().mean().item():.4f}")

    # 6. serving loop with warm start and scene-cut recovery
    frames = scene_frames(1080, 1920)
    serve_cfg = of.LKConfig(levels=1, window=15)
    recovery = of.RecoveryConfig(levels=3)
    warp_before = wrappers["warp_bilinear_select"].launches
    flows = dict(of.process_sequence(
        (None if f is None else cuda(f) for f in frames), serve_cfg,
        warm_start=True, recovery=recovery,
    ))
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    require(sorted(flows) == [1, 2, 3, 4, 5, 6], f"yielded frames {sorted(flows)}")
    require(all(bool(torch.isfinite(f).all()) for f in flows.values()), "serving flow not finite")
    require(launches["warp_bilinear_select"] > warp_before,
            "the serving loop did not launch the warp kernel")
    for name, n_launch in launches.items():
        require(n_launch > 0, f"{name} was not launched on the main path")
    cold = of.pyramidal_lk(cuda(frames[4]).float(), cuda(frames[5]).float(),
                           dataclasses.replace(serve_cfg, levels=recovery.levels))
    e_cut = err_stats(flows[5], cold)
    require(e_cut["median"] <= PATH_MEDIAN_ERR, f"flow at the cut vs cold levels=3: {e_cut}")
    m3 = flows[3][64:-64, 64:-64].reshape(-1, 2).median(dim=0).values.cpu().numpy()
    print(f"phase 6 serving loop levels=1 warm + RecoveryConfig(levels=3), 8 frames 1080x1920: "
          f"yielded {sorted(flows)}; cut vs cold median {e_cut['median']:.3g}; warm median "
          f"flow at 3 ({m3[0]:.4f}, {m3[1]:.4f}); launches {launches}")

    # 7. timing
    reps = 30
    pair_ms = cuda_ms(lambda: of.pyramidal_lk(prev, nxt, of.PAPER_1080P), reps)
    pair_plain_ms = cuda_ms(lambda: of.pyramidal_lk(prev, nxt, plain_cfg), reps)
    print(f"phase 7 timing [{card}] pyramidal_lk PAPER_1080P 1080x1920: kernel path "
          f"{pair_ms:.3f} ms/pair, plain path {pair_plain_ms:.3f} ms/pair (median of {reps})")
    p0, n0, f0 = (cuda(a) for a in textured_pair(1080, 1920, seed=7))
    args = {
        "lk_residual": (p0, n0, of.PAPER_1080P),
        "lk_level_step": (p0, n0, f0, of.PAPER_1080P),
        "warp_bilinear_select": (p0, f0, of.PAPER_1080P.max_displacement),
    }
    timing = {}
    for name, a in args.items():
        k_ms = cuda_ms(lambda: wrappers[name](*a), reps, inner=10)
        p_ms = cuda_ms(lambda: plains[name](*a), reps, inner=10)
        timing[name] = (k_ms, p_ms)
        print(f"phase 7 timing [{card}] {name} 1080x1920 window 15: kernel {k_ms:.4f} ms, "
              f"plain {p_ms:.4f} ms (median of {reps} runs of 10 calls)")

    record = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": max_err[name],
         "ms": timing[name][0], "plain_ms": timing[name][1]}
        for name, _m, _p, src, rep in KERNELS
    ]}
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
