"""Plain PyTorch operations shared by the references, in any float dtype.

A frozen copy of the arithmetic of the port's plain operations (its
``ops/conv``, ``ops/pyramid``, ``ops/resize`` and ``ops/warp``), written
here again so that the yardstick imports nothing of the program.  Every
operation computes in the dtype of its image input: float32 for the
reference, bfloat16 for the control (``flowbench/compare.py``).  Sample
coordinates of the warp stay float32 in both, as an index computation.

Correlations are sums of shifted slices of a zero-padded copy, never
``F.conv2d``, which cuDNN may run in TF32; images (..., H, W), flows
(..., H, W, 2) with u (x) first.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "BINOMIAL_1D", "SOBEL_X", "SOBEL_Y", "TEMPORAL", "clip", "correlate", "correlate_1d",
    "downsample_flow", "pyr_down", "pyramid", "upsample_flow", "warp_bilinear",
]

SOBEL_X = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32)
SOBEL_Y = np.array([[-1, -2, -1], [0, 0, 0], [1, 2, 1]], np.float32)
TEMPORAL = {
    "dt3": np.array([[1, 2, 1], [2, 3, 2], [1, 2, 1]], np.float32),
    "delta": np.array([[0, 0, 0], [0, 1, 0], [0, 0, 0]], np.float32),
    "gauss3": np.array([[0.0625, 0.125, 0.0625], [0.125, 0.25, 0.125],
                        [0.0625, 0.125, 0.0625]], np.float32),
}
BINOMIAL_1D = np.array([0.25, 0.5, 0.25], np.float32)


def _taps(values, dtype: torch.dtype) -> list:
    """The taps as ``dtype`` rounds them, as Python floats."""
    return torch.as_tensor(np.asarray(values, np.float64), dtype=dtype).tolist()


def clip(x: torch.Tensor, lo: float | None = None, hi: float | None = None) -> torch.Tensor:
    if lo is not None:
        x = torch.maximum(x, x.new_full((), lo))
    if hi is not None:
        x = torch.minimum(x, x.new_full((), hi))
    return x


def correlate(x: torch.Tensor, mask) -> torch.Tensor:
    """Zero-padded 2-D correlation (no flip) with a 3x3 or other odd mask,
    the nonzero taps summed in row-major order."""
    mask = np.asarray(mask)
    taps = _taps(mask, x.dtype)
    kh, kw = mask.shape
    h, w = x.shape[-2:]
    xp = F.pad(x, (kw // 2, (kw - 1) // 2, kh // 2, (kh - 1) // 2))
    out = torch.zeros_like(x)
    for i in range(kh):
        for j in range(kw):
            if taps[i][j] != 0.0:
                out = out + taps[i][j] * xp[..., i:i + h, j:j + w]
    return out


def correlate_1d(x: torch.Tensor, taps, axis: int) -> torch.Tensor:
    """Zero-padded 1-D correlation along ``axis`` (-2 rows, -1 columns)."""
    taps = _taps(np.asarray(taps).reshape(-1), x.dtype)
    k, n = len(taps), x.shape[axis]
    pad = (k // 2, (k - 1) // 2)
    xp = F.pad(x, pad if axis == -1 else (0, 0) + pad)
    out = torch.zeros_like(x)
    for j, tap in enumerate(taps):
        if tap != 0.0:
            out = out + tap * xp.narrow(axis, j, n)
    return out


def _down_axis(x: torch.Tensor, k, axis: int) -> torch.Tensor:
    k = _taps(k, x.dtype)
    r, n_out = len(k) // 2, x.shape[axis] // 2
    xp = F.pad(x, (r, r) if axis == -1 else (0, 0, r, r))
    out = None
    for j, tap in enumerate(k):
        t = tap * xp.narrow(axis, j, 2 * n_out).unflatten(axis, (n_out, 2)).select(axis, 0)
        out = t if out is None else out + t
    return out


def pyr_down(x: torch.Tensor) -> torch.Tensor:
    """Binomial blur + 2x subsample: output (i, j) centred on source
    (2i, 2j), zero outside the source cropped to even sizes."""
    oh, ow = x.shape[-2] // 2, x.shape[-1] // 2
    return _down_axis(_down_axis(x[..., :2 * oh, :2 * ow], BINOMIAL_1D, -2), BINOMIAL_1D, -1)


def pyramid(x: torch.Tensor, levels: int) -> list[torch.Tensor]:
    """Levels 0..levels-1, level k floor-halved k times."""
    out = [x]
    for _ in range(1, levels):
        out.append(pyr_down(out[-1]))
    return out


def _up2x_axis(x: torch.Tensor, axis: int) -> torch.Tensor:
    n = x.shape[axis]
    lo = torch.cat([x.narrow(axis, 0, 1), x.narrow(axis, 0, n - 1)], dim=axis)
    hi = torch.cat([x.narrow(axis, 1, n - 1), x.narrow(axis, n - 1, 1)], dim=axis)
    even = 0.75 * x + 0.25 * lo
    odd = 0.75 * x + 0.25 * hi
    ax = x.ndim + axis
    return torch.stack([even, odd], dim=ax + 1).flatten(ax, ax + 1)


def upsample_flow(flow: torch.Tensor, shape: tuple[int, int]) -> torch.Tensor:
    """One pyramid octave up: the half-pixel 2x bilinear stencil, edges
    clamped, an odd target taking one edge-replicated row or column, and
    the values doubled."""
    th, tw = shape
    h, w = flow.shape[-3:-1]
    if th not in (2 * h, 2 * h + 1) or tw not in (2 * w, 2 * w + 1):
        raise ValueError(f"{shape} is not one octave above {(h, w)}")
    out = _up2x_axis(_up2x_axis(flow, -3), -2)
    if th == 2 * h + 1:
        out = torch.cat([out, out[..., -1:, :, :]], dim=-3)
    if tw == 2 * w + 1:
        out = torch.cat([out, out[..., :, -1:, :]], dim=-2)
    return out * 2.0


def downsample_flow(flow: torch.Tensor, shape: tuple[int, int]) -> torch.Tensor:
    """Down to a coarser level's (h, w): per octave the image pyramid's
    blur and subsample of each component, and the values halved."""
    while tuple(flow.shape[-3:-1]) != tuple(shape):
        flow = torch.stack([pyr_down(flow[..., 0]), pyr_down(flow[..., 1])], dim=-1) * 0.5
    return flow


def _gather(img: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    h, w = img.shape[-2:]
    idx = (yi * w + xi).reshape(yi.shape[:-2] + (-1,))
    return torch.gather(img.reshape(img.shape[:-2] + (h * w,)), -1, idx).reshape(yi.shape)


def warp_bilinear(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """out(x) = img(x + flow(x)) by bilinear interpolation; a sample outside
    the image keeps the unwarped pixel."""
    h, w = img.shape[-2:]
    ys = torch.arange(h, dtype=torch.float32, device=img.device)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.float32, device=img.device)[None, :].expand(h, w)
    fx = xs + flow[..., 0].float()
    fy = ys + flow[..., 1].float()
    valid = (fx >= 0) & (fx <= w - 1) & (fy >= 0) & (fy <= h - 1)
    zero = torch.zeros_like(fx)
    fx_c = clip(torch.where(valid, fx, zero), 0.0, w - 1)
    fy_c = clip(torch.where(valid, fy, zero), 0.0, h - 1)
    x0, y0 = torch.floor(fx_c), torch.floor(fy_c)
    tx, ty = (fx_c - x0).to(img.dtype), (fy_c - y0).to(img.dtype)
    x0i, y0i = x0.long(), y0.long()
    x1i, y1i = (x0i + 1).clamp(max=w - 1), (y0i + 1).clamp(max=h - 1)
    img = img.expand(fx.shape)
    v00, v01 = _gather(img, y0i, x0i), _gather(img, y0i, x1i)
    v10, v11 = _gather(img, y1i, x0i), _gather(img, y1i, x1i)
    top = v00 + tx * (v01 - v00)
    bot = v10 + tx * (v11 - v10)
    return torch.where(valid, top + ty * (bot - top), img)
