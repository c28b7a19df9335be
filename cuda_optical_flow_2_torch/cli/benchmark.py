"""Benchmark CLI: throughput + accuracy across the BASELINE configurations.

Counterpart of ``cuda_optical_flow_2_tpu.cli.benchmark``.  Runs any of the
five BASELINE.json configs (the reference's implied operating points scaled
up) on one device and prints one JSON line per config: frames per second,
ms per call (the JAX tool's ``ms_per_frame``: one frame pair, or config
5's 64 pairs; CUDA events around back-to-back calls, see
``utils/profiling.py``) and the mean end-point error against the synthetic
translation.  Configs 1-4 time the family's captured entry
(``pyramidal_<family>_jit``), as the JAX tool times a jitted call; config 5,
the batch over the mesh, times ``parallel.sharded_flow``, whose shards
replay that entry on their devices.

    of2-torch-benchmark --configs 1 4 --iters 20
    of2-torch-benchmark --configs 4 --model tvl1 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Callable

import numpy as np
import torch

import cuda_optical_flow_2_torch as of
from cuda_optical_flow_2_torch.cli import add_device_argument, device_from_flag
from cuda_optical_flow_2_torch.models import _jit_entry
from cuda_optical_flow_2_torch.utils import io as uio
from cuda_optical_flow_2_torch.utils.profiling import device_time

__all__ = ["main", "CONFIGS"]

# BASELINE.json "configs" (1-based), scaled to concrete shapes.
CONFIGS = {
    1: dict(
        name="single-level 64x64 checkerboard, 5x5 window",
        shape=(64, 64), cfg=of.LKConfig(levels=1, window=5, temporal_kernel="gauss3"),
        velocity=(1.0, 0.0),
    ),
    2: dict(
        name="single-level 480x360, 9x9 window, 3 iterations",
        shape=(360, 480),
        cfg=of.LKConfig(levels=1, window=9, iterations=3, temporal_kernel="gauss3"),
        velocity=(2.0, 1.0),
    ),
    3: dict(
        name="3-level 720p, bilinear warp + flow upsampling",
        shape=(720, 1280),
        cfg=of.LKConfig(levels=3, window=11, temporal_kernel="gauss3"),
        velocity=(4.0, 2.0),
    ),
    4: dict(
        name="5-level 1080p, 15x15 window (paper config)",
        shape=(1080, 1920), cfg=of.PAPER_1080P, velocity=(6.0, 3.0),
    ),
    5: dict(
        name="64-frame 1080p batch over the device mesh",
        shape=(1080, 1920), cfg=of.PAPER_1080P, velocity=(6.0, 3.0), batch=True,
    ),
}


def batch_mesh(device: torch.device):
    """The mesh of config 5: every CUDA device, or the one CPU device."""
    if device.type == "cuda":
        return of.parallel.make_mesh()
    return of.parallel.make_mesh(devices=[device])


def config_call(spec: dict, device: torch.device) -> tuple[Callable, tuple, int]:
    """``(fn, args, frames per call)``: the call a config times, on its
    synthetic pair (config 5: the pair broadcast to a batch over the mesh)."""
    h, w = spec["shape"]
    cfg = spec["cfg"]
    frames = uio.synthetic_sequence(2, h, w, velocity=spec["velocity"], period=24)
    prev = torch.as_tensor(frames[0].astype(np.float32), device=device)
    nxt = torch.as_tensor(frames[1].astype(np.float32), device=device)
    if not spec.get("batch"):
        entry = _jit_entry(cfg)
        return (lambda p, n: entry(p, n, cfg)), (prev, nxt), 1
    mesh = batch_mesh(device)
    n_dev = mesh.shape["batch"]
    b = max(64 // n_dev * n_dev, n_dev)
    args = (prev.expand(b, h, w).contiguous(), nxt.expand(b, h, w).contiguous())
    return (lambda p, n: of.parallel.sharded_flow(p, n, cfg, mesh)), args, b


def _run_config(idx: int, spec: dict, iters: int, device: torch.device) -> dict:
    h, w = spec["shape"]
    vx, vy = spec["velocity"]
    fn, args, frames = config_call(spec, device)
    secs = device_time(fn, *args, iters=max(iters // 4, 2) if spec.get("batch") else iters)
    fps = frames / secs
    flow = fn(*args)
    flow = (flow[0] if spec.get("batch") else flow).cpu().numpy()
    m = max(min(h, w) // 8, 8)
    inner = flow[m:-m, m:-m]
    epe = float(np.hypot(inner[..., 0] - vx, inner[..., 1] - vy).mean())
    return {
        "config": idx,
        "name": spec["name"],
        "fps": round(fps, 2),
        "ms_per_frame": round(1e3 * secs, 3),
        "epe_vs_truth": round(epe, 4),
    }


def _model_cfg(model: str, lk_cfg, no_pallas: bool):
    """Map a BASELINE LK config onto the requested model family."""
    use_pallas = lk_cfg.use_pallas and not no_pallas
    odd = lk_cfg.window if lk_cfg.window % 2 else lk_cfg.window + 1
    if model == "hs":
        return of.HSConfig(levels=lk_cfg.levels, iterations=100, use_pallas=use_pallas)
    if model == "tvl1":
        return of.TVL1Config(levels=lk_cfg.levels, use_pallas=use_pallas)
    if model == "fb":
        return of.FBConfig(levels=lk_cfg.levels, winsize=odd, use_pallas=use_pallas)
    if model == "dis":
        return of.DISConfig(levels=lk_cfg.levels, window=odd, use_pallas=use_pallas)
    return dataclasses.replace(lk_cfg, use_pallas=use_pallas)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--configs", type=int, nargs="+", default=[1, 2, 3, 4])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument(
        "--no-pallas", action="store_true",
        help="run the plain PyTorch versions instead of the CUDA kernels",
    )
    ap.add_argument(
        "--model", default="lk", choices=("lk", "hs", "fb", "tvl1", "dis"),
        help="model family to run the configs with (pyramid depth and window "
        "carry over; HS uses its default 100 sweeps)",
    )
    add_device_argument(ap)
    args = ap.parse_args(argv)
    device = device_from_flag(args.device)

    for idx in args.configs:
        spec = dict(CONFIGS[idx])
        spec["cfg"] = _model_cfg(args.model, spec["cfg"], args.no_pallas)
        if args.model != "lk":
            spec["name"] = f'{spec["name"]} [{args.model}]'
        print(json.dumps(_run_config(idx, spec, args.iters, device)), flush=True)
        # each config runs once: its graphs' pools go back to the allocator
        # (config 5 captures a 64-pair batch)
        _jit_entry(spec["cfg"]).cache.clear()


if __name__ == "__main__":
    main()
