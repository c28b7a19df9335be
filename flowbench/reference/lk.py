"""Plain reference of pyramidal Lucas-Kanade as the port's kernel path runs it.

The semantics of ``LKConfig(use_pallas=True)`` on the card, written out in
plain PyTorch (a frozen copy of the arithmetic of the port's plain
versions ``lk_residual_plain`` and ``lk_level_step_plain`` and of its
coarse-to-fine loop): the coarsest level solves from zero flow with no
warp; each finer level upsamples the flow one octave, clips it to
+-``max_displacement``, warps the next frame by it, and adds the residual
solve to the clipped flow.  The streaming half (:func:`seed_ok`,
:func:`stream_flow`) follows the port's ``models.streaming`` step with
warm start and recovery.

Supported fields: those of ``LKConfig`` with ``warp_mode="bilinear"``, no
prefilter and ``use_pallas=True``; :func:`check_fields` refuses others.
"""

from __future__ import annotations

import numpy as np
import torch

from flowbench.reference.ops import (
    SOBEL_X, SOBEL_Y, TEMPORAL, clip, correlate, correlate_1d, downsample_flow, pyramid,
    upsample_flow, warp_bilinear,
)

__all__ = ["check_fields", "flow", "seed_ok", "stream_flow", "window_taps"]

_DEFAULTS = {
    "levels": 4, "window": 19, "iterations": 1, "temporal_kernel": "dt3",
    "warp_mode": "bilinear", "det_eps": 1e-8, "window_method": "sep_conv",
    "window_weights": "tri", "normalize_gradients": True, "max_displacement": 32,
    "prefilter": None, "use_pallas": True, "d_local": 7, "c_max": 1,
    "fused_half_upsample": False,
}


def check_fields(fields: dict) -> dict:
    """The config's fields over LKConfig's defaults; raises on a field or
    value this reference does not implement."""
    f = {**_DEFAULTS, **fields}
    unknown = set(f) - set(_DEFAULTS)
    if unknown:
        raise ValueError(f"fields the LK reference does not know: {sorted(unknown)}")
    if f["warp_mode"] != "bilinear" or f["prefilter"] is not None or not f["use_pallas"]:
        raise ValueError("the LK reference covers the kernel path: bilinear warp, no prefilter")
    if f["window"] > 65:
        raise ValueError("windows over 65 take the port's plain path, not covered here")
    return f


def window_taps(window: int, weights: str) -> np.ndarray:
    """1-D window taps summing to ``window``: box, tri (two odd boxes of radii
    r // 2 and r - r // 2 convolved) or gauss (sigma window / 6)."""
    if weights == "box":
        return np.ones((window,), np.float32)
    r = window // 2
    if weights == "tri":
        t = np.convolve(np.ones(2 * (r // 2) + 1), np.ones(2 * (r - r // 2) + 1))
    else:
        x = np.arange(window) - r
        t = np.exp(-0.5 * (x / (window / 6.0)) ** 2)
    return (t * (window / t.sum())).astype(np.float32)


def _residual(prev: torch.Tensor, nxt: torch.Tensor, f: dict) -> torch.Tensor:
    """Gradients, windowed structure-tensor sums, guarded 2x2 solve."""
    scale = 1.0 / 8.0 if f["normalize_gradients"] else 1.0
    ix = correlate(prev, SOBEL_X * scale)
    iy = correlate(prev, SOBEL_Y * scale)
    mask = TEMPORAL[f["temporal_kernel"]]
    it = correlate(nxt - prev, mask / mask.sum() if f["normalize_gradients"] else mask)
    taps = window_taps(f["window"], f["window_weights"])
    prods = torch.stack([ix * ix, iy * iy, ix * iy, ix * it, iy * it])
    a, b, c, d, e = correlate_1d(correlate_1d(prods, taps, -2), taps, -1).unbind(0)
    det = a * b - c * c
    if f["det_eps"] == 0.0:
        inv = 1.0 / det
        return torch.stack([(-b * inv) * d + (c * inv) * e, (c * inv) * d - (a * inv) * e], -1)
    safe = det.abs() >= f["det_eps"]
    inv = 1.0 / torch.where(safe, det, torch.ones_like(det))
    u = (-b * d + c * e) * inv
    v = (c * d - a * e) * inv
    zero = torch.zeros_like(u)
    return torch.stack([torch.where(safe, u, zero), torch.where(safe, v, zero)], dim=-1)


def _step(prev, nxt, flow, f) -> torch.Tensor:
    """Clip, warp, residual, add: one iteration of a level."""
    d = float(f["max_displacement"])
    fc = clip(flow, -d, d)
    return fc + _residual(prev, warp_bilinear(nxt, fc), f)


def _coarse_to_fine(prev_pyr, next_pyr, f, init=None) -> torch.Tensor:
    flow = init
    for k in range(f["levels"] - 1, -1, -1):
        p, n = prev_pyr[k], next_pyr[k]
        if flow is None:
            flow = _residual(p, n, f)
            iters = f["iterations"] - 1
        else:
            if tuple(flow.shape[-3:-1]) != tuple(p.shape[-2:]):
                flow = upsample_flow(flow, tuple(p.shape[-2:]))
            iters = f["iterations"]
        for _ in range(iters):
            flow = _step(p, n, flow, f)
    return flow


def flow(prev: torch.Tensor, nxt: torch.Tensor, fields: dict,
         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Flow (..., H, W, 2) float32 of frame pairs (..., H, W), computed in
    ``dtype``."""
    f = check_fields(fields)
    pp = pyramid(prev.to(dtype), f["levels"])
    npyr = pyramid(nxt.to(dtype), f["levels"])
    return _coarse_to_fine(pp, npyr, f).float()


def _carry_levels(f: dict, recovery: dict) -> int:
    return max(f["levels"], recovery["levels"])


def seed_ok(prev_frames: torch.Tensor, frames: torch.Tensor, prev_flow: torch.Tensor,
            fields: dict, recovery: dict, dtype: torch.dtype = torch.float32) -> bool:
    """The recovery check of a warm step over a batch of streams (S, H, W):
    at the deepest carried level, whether every stream's seed (the previous
    flow, downsampled) passes: its mean magnitude under ``seed_floor`` px, or
    the mean photometric residual after warping by it under ``ratio`` times
    the zero-flow residual.  The warp clips the seed to 32 px."""
    f = check_fields(fields)
    top = _carry_levels(f, recovery) - 1
    prev_c = pyramid(prev_frames.to(dtype), top + 1)[top]
    next_c = pyramid(frames.to(dtype), top + 1)[top]
    seed = downsample_flow(prev_flow.to(dtype), tuple(next_c.shape[-2:]))
    warped = warp_bilinear(next_c, clip(seed, -32.0, 32.0))
    r_seed = (warped - prev_c).abs().mean(dim=(-2, -1))
    r_zero = (next_c - prev_c).abs().mean(dim=(-2, -1))
    small = seed.abs().mean(dim=(-3, -2, -1)) < recovery["seed_floor"]
    return bool((small | (r_seed < recovery["ratio"] * r_zero)).all())


def stream_flow(prev_frame: torch.Tensor, frame: torch.Tensor, prev_flow: torch.Tensor | None,
                warm: bool, fields: dict, recovery: dict,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The flow of one warm serving step: with ``warm`` (a carried flow and
    a passing check) the tracking levels seeded by ``prev_flow``
    downsampled to the coarsest of them, else the cold solve over every
    carried level."""
    f = check_fields(fields)
    n = _carry_levels(f, recovery)
    pp = pyramid(prev_frame.to(dtype), n)
    npyr = pyramid(frame.to(dtype), n)
    if warm and prev_flow is not None:
        init = downsample_flow(prev_flow.to(dtype), tuple(pp[f["levels"] - 1].shape[-2:]))
        return _coarse_to_fine(pp[:f["levels"]], npyr[:f["levels"]], f, init).float()
    return _coarse_to_fine(pp, npyr, {**f, "levels": n}).float()
