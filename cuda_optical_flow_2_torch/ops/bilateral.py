"""Joint bilateral pre-filter.

Counterpart of ``cuda_optical_flow_2_tpu.ops.bilateral``: for each pixel, a
spatial Gaussian (``generate_gaussian_kernel``) times a range Gaussian on the
guide intensity, summed over the taps that lie inside the image and
normalized by the total weight.  Float32 throughout, with the JAX op's
expression order; the constant range normalization ``1/(2*pi*sigma_range^2)``
cancels in ``num / den`` and is kept for parity.  Each tap is a shifted
slice of a zero-padded copy.  :func:`bilateral_filter_band` is the form
spatial TP runs on a shard's band.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from cuda_optical_flow_2_torch.constants import generate_gaussian_kernel

__all__ = ["bilateral_filter", "bilateral_filter_band", "bilateral_constants"]


def bilateral_constants(
    window: int, sigma_spatial: float, sigma_range: float
) -> tuple[np.ndarray, np.float32, np.float32]:
    """(float32 spatial mask, range_norm, inv_2s2): the filter's constants."""
    spatial = generate_gaussian_kernel(sigma_spatial, window).astype(np.float32)
    sigma_b2 = float(sigma_range) ** 2
    return spatial, np.float32(1.0 / (2.0 * np.pi * sigma_b2)), np.float32(0.5 / sigma_b2)


def bilateral_filter(
    img: torch.Tensor,
    guide: torch.Tensor | None = None,
    window: int = 9,
    sigma_spatial: float = 2.0,
    sigma_range: float = 10.0,
) -> torch.Tensor:
    """Edge-preserving smoothing of (..., H, W) images; returns float32.

    Defaults are the reference's live operating point (9x9, sigma_spatial 2,
    sigma_range 10); ``guide`` defaults to ``img`` (self-guided).
    """
    return _tap_loop(img, img if guide is None else guide, window, sigma_spatial, sigma_range)


def bilateral_filter_band(
    img_band: torch.Tensor,
    row0: int,
    h_global: int,
    window: int = 9,
    sigma_spatial: float = 2.0,
    sigma_range: float = 10.0,
) -> torch.Tensor:
    """Self-guided bilateral on a row band of an ``h_global``-row image.

    ``row0`` is the global row of band row 0.  A tap counts when its GLOBAL
    row and its column lie in the image, so rows at least ``window // 2``
    from the band edges (where the caller's halo supplies real rows) match
    the whole-image filter; a counted tap outside the band reads zero, and
    a row outside the global image comes out zero.
    """
    return _tap_loop(
        img_band, img_band, window, sigma_spatial, sigma_range, row0, h_global
    )


def _tap_loop(
    img: torch.Tensor,
    guide: torch.Tensor,
    window: int,
    sigma_spatial: float,
    sigma_range: float,
    row0: int = 0,
    h_global: int | None = None,
) -> torch.Tensor:
    spatial, range_norm, inv_2s2 = bilateral_constants(window, sigma_spatial, sigma_range)
    wh, ww = spatial.shape
    ry, rx = wh >> 1, ww >> 1
    img = img.to(torch.float32)
    guide = guide.to(torch.float32)
    h, w = img.shape[-2:]
    hg = h if h_global is None else h_global
    img_p = F.pad(img, (rx, rx, ry, ry))
    guide_p = F.pad(guide, (rx, rx, ry, ry))
    ys = torch.arange(h, device=img.device)[:, None] + row0
    xs = torch.arange(w, device=img.device)[None, :]
    num = torch.zeros_like(img)
    den = torch.zeros_like(img)
    for m in range(wh):
        dy = m - ry
        for n in range(ww):
            dx = n - rx
            g_s = guide_p[..., m : m + h, n : n + w]
            i_s = img_p[..., m : m + h, n : n + w]
            inside = (ys + dy >= 0) & (ys + dy < hg) & (xs + dx >= 0) & (xs + dx < w)
            k = g_s - guide
            wgt = float(range_norm) * torch.exp(-(k * k) * float(inv_2s2)) * float(spatial[m, n])
            wgt = torch.where(inside, wgt, torch.zeros_like(wgt))
            num = num + i_s * wgt
            den = den + wgt
    if h_global is None:
        return num / den
    return torch.where((ys >= 0) & (ys < hg), num / den, 0.0)
