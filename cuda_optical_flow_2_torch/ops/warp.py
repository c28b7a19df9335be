"""Backward image warping by a flow field.

Counterpart of ``cuda_optical_flow_2_tpu.ops.warp``: sample the image at
``x + flow(x)``; out-of-bounds samples keep the unwarped pixel.

Non-finite flow (a ``det_eps=0`` solve can emit NaN) fails the in-bounds
test, so such pixels keep the unwarped value; their coordinates are replaced
before the integer cast, which would otherwise give an out-of-range index.
:func:`warp_bilinear_band` is the form spatial TP runs on a shard's band.
"""

from __future__ import annotations

import torch

from cuda_optical_flow_2_torch.ops.clip import clip

__all__ = ["warp_bilinear", "warp_bilinear_band", "warp_nearest"]


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
    fx_c = clip(torch.where(valid, fx, zero), 0.0, w - 1)
    fy_c = clip(torch.where(valid, fy, zero), 0.0, h - 1)
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


def warp_bilinear_band(
    img: torch.Tensor, flow: torch.Tensor, img_row0: int, out_row0: int, h_global: int
) -> torch.Tensor:
    """Bilinear backward warp of a horizontal band of a taller image.

    ``img`` holds global rows [img_row0, img_row0 + img.shape[-2]) of an
    ``h_global``-row image; ``flow`` covers output rows
    [out_row0, out_row0 + flow.shape[-3]), which must lie inside ``img``'s.
    A sample is valid against the GLOBAL image bounds, and out-of-image
    samples keep the band's own pixel, as :func:`warp_bilinear` does on the
    whole image.  The floor and fraction of the sample row are taken in
    global rows and the index is then shifted into the band by integer
    arithmetic: a band-local float coordinate rounds the fraction otherwise.
    Indices are clamped to the band, so a row whose sample leaves it (a
    band-edge row with too little overhang, cropped by the caller) reads
    the band's edge.  With img_row0 = out_row0 = 0 and h_global = img rows
    this is :func:`warp_bilinear`.
    """
    hi, w = img.shape[-2:]
    hf = flow.shape[-3]
    dev = img.device
    ys = torch.arange(hf, dtype=torch.float32, device=dev)[:, None].expand(hf, w) + out_row0
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(hf, w)
    fx = xs + flow[..., 0]
    fy = ys + flow[..., 1]
    valid = (fx >= 0) & (fx <= w - 1) & (fy >= 0) & (fy <= h_global - 1)
    zero = torch.zeros_like(fx)
    fx_c = clip(torch.where(valid, fx, zero), 0.0, w - 1)
    fy_c = clip(torch.where(valid, fy, zero), 0.0, h_global - 1)
    x0 = torch.floor(fx_c)
    y0 = torch.floor(fy_c)
    tx = fx_c - x0
    ty = fy_c - y0
    x0i = x0.long()
    y0g = y0.long()
    x1i = (x0i + 1).clamp(max=w - 1)
    y0i = (y0g - img_row0).clamp(0, hi - 1)
    y1i = ((y0g + 1).clamp(max=h_global - 1) - img_row0).clamp(0, hi - 1)
    img = img.expand(fx.shape[:-2] + (hi, w))
    v00 = _gather_2d(img, y0i, x0i)
    v01 = _gather_2d(img, y0i, x1i)
    v10 = _gather_2d(img, y1i, x0i)
    v11 = _gather_2d(img, y1i, x1i)
    top = v00 + tx * (v01 - v00)
    bot = v10 + tx * (v11 - v10)
    out = top + ty * (bot - top)
    own = img.narrow(-2, out_row0 - img_row0, hf)
    return torch.where(valid, out, own)


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
