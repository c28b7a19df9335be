"""Backward image warping by a flow field.

Counterpart of ``cuda_optical_flow_2_tpu.ops.warp``: sample the image at
``x + flow(x)``; out-of-bounds samples keep the unwarped pixel.

Non-finite flow (a ``det_eps=0`` solve can emit NaN) fails the in-bounds
test, so such pixels keep the unwarped value; their coordinates are replaced
before the integer cast, which would otherwise give an out-of-range index.
"""

from __future__ import annotations

import torch

__all__ = ["warp_bilinear", "warp_nearest"]


def _coords(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    h, w = img.shape[-2:]
    ys = torch.arange(h, dtype=torch.float32, device=img.device)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.float32, device=img.device)[None, :].expand(h, w)
    return ys, xs


def _gather_2d(img: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """img (..., H, W) read at integer maps yi, xi (same leading dims)."""
    h, w = img.shape[-2:]
    idx = (yi * w + xi).reshape(yi.shape[:-2] + (-1,))
    return torch.gather(img.reshape(img.shape[:-2] + (h * w,)), -1, idx).reshape(yi.shape)


def warp_bilinear(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Bilinear backward warp: out(x) = img(x + flow(x)).

    Args:
      img: (..., H, W) float image.
      flow: (..., H, W, 2) flow in pixels, channel 0 = u (x), 1 = v (y).
    """
    h, w = img.shape[-2:]
    ys, xs = _coords(img)
    fx = xs + flow[..., 0]
    fy = ys + flow[..., 1]
    valid = (fx >= 0) & (fx <= w - 1) & (fy >= 0) & (fy <= h - 1)
    zero = torch.zeros_like(fx)
    fx_c = torch.where(valid, fx, zero).clamp(0.0, w - 1)
    fy_c = torch.where(valid, fy, zero).clamp(0.0, h - 1)
    x0 = torch.floor(fx_c)
    y0 = torch.floor(fy_c)
    tx = fx_c - x0
    ty = fy_c - y0
    x0i = x0.long()
    y0i = y0.long()
    x1i = (x0i + 1).clamp(max=w - 1)
    y1i = (y0i + 1).clamp(max=h - 1)
    img = img.expand(fx.shape)
    v00 = _gather_2d(img, y0i, x0i)
    v01 = _gather_2d(img, y0i, x1i)
    v10 = _gather_2d(img, y1i, x0i)
    v11 = _gather_2d(img, y1i, x1i)
    top = v00 + tx * (v01 - v00)
    bot = v10 + tx * (v11 - v10)
    out = top + ty * (bot - top)
    return torch.where(valid, out, img)


def warp_nearest(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour backward warp with C trunc-toward-zero coordinates;
    out-of-bounds keeps the unwarped pixel."""
    h, w = img.shape[-2:]
    ys, xs = _coords(img)
    fx = torch.trunc(xs + flow[..., 0])
    fy = torch.trunc(ys + flow[..., 1])
    valid = (fx >= 0) & (fx < w) & (fy >= 0) & (fy < h)
    zero = torch.zeros_like(fx)
    xi = torch.where(valid, fx, zero).long()
    yi = torch.where(valid, fy, zero).long()
    img = img.expand(fx.shape)
    return torch.where(valid, _gather_2d(img, yi, xi), img)
