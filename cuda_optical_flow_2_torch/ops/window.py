"""Windowed structure-tensor sums.

Counterpart of ``cuda_optical_flow_2_tpu.ops.window``.  Three backends of the
box sum, zero outside the image, which differ only in float summation order:

* "sep_conv":      two separable 1-D passes with the taps of
                   :func:`window_weight_taps` (the default);
* "cumsum":        an integral image (two ``torch.cumsum``) with a leading
                   zero row and column, read at four clipped corners; in
                   float32 its box sums are differences of large prefix sums;
* "reduce_window": a zero-padded box sum, one shifted slice per tap.

Weighted windows ("tri", "gauss") always take the separable passes, as in
the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from cuda_optical_flow_2_torch.ops.clip import clip
from cuda_optical_flow_2_torch.ops.conv import sep_conv2d

__all__ = [
    "window_sum",
    "window_weight_taps",
    "structure_tensor_sums",
    "centered_structure_tensor_sums",
]


def window_weight_taps(window: int, weights: str) -> np.ndarray:
    """1-D window weight taps, scaled so each axis sums to ``window``.

    * "box":   all ones.
    * "tri":   trapezoid = convolution of two odd boxes of radii ``r//2`` and
               ``r - r//2`` (support = window).
    * "gauss": truncated Gaussian, sigma = window/6 (support = window).
    """
    if weights == "box":
        return np.ones((window,), np.float32)
    r = window // 2
    if weights == "tri":
        r1, r2 = r // 2, r - r // 2
        t = np.convolve(np.ones(2 * r1 + 1), np.ones(2 * r2 + 1))
    elif weights == "gauss":
        x = np.arange(window) - r
        t = np.exp(-0.5 * (x / (window / 6.0)) ** 2)
    else:
        raise ValueError(f"unknown window_weights {weights!r}")
    return (t * (window / t.sum())).astype(np.float32)


def _window_sum_cumsum(x: torch.Tensor, window: int) -> torch.Tensor:
    """Integral-image box sum with zero padding: ii[i, j] = sum(x[:i, :j])."""
    r = window // 2
    lead, (h, w) = x.shape[:-2], x.shape[-2:]
    ii = F.pad(torch.cumsum(torch.cumsum(x, dim=-2), dim=-1), (1, 0, 1, 0))
    # ii read at indices clipped to [0, h] x [0, w]: slices of an
    # edge-replicated copy, p = r + 1 on each side
    p = r + 1
    ii = F.pad(ii.reshape(1, -1, h + 1, w + 1), (p, p, p, p), mode="replicate")
    ii = ii.reshape(lead + (h + 1 + 2 * p, w + 1 + 2 * p))

    def corner(dy: int, dx: int) -> torch.Tensor:
        return ii[..., p + dy : p + dy + h, p + dx : p + dx + w]

    # sum over [i-r, i+r] x [j-r, j+r] clipped to the image
    return corner(r + 1, r + 1) - corner(-r, r + 1) - corner(r + 1, -r) + corner(-r, -r)


def _window_sum_box(x: torch.Tensor, window: int) -> torch.Tensor:
    """Zero-padded box sum, one shifted slice per tap in row-major order."""
    r = window // 2
    h, w = x.shape[-2:]
    xp = F.pad(x, (r, r, r, r))
    out = torch.zeros_like(x)
    for dy in range(window):
        for dx in range(window):
            out = out + xp[..., dy : dy + h, dx : dx + w]
    return out


def window_sum(
    x: torch.Tensor, window: int, method: str = "sep_conv", weights: str = "box"
) -> torch.Tensor:
    """Weighted sum of ``x`` over the window x window box at each pixel."""
    if window % 2 != 1:
        raise ValueError(f"window must be odd, got {window}")
    if weights == "box" and method != "sep_conv":
        if method == "cumsum":
            return _window_sum_cumsum(x, window)
        if method == "reduce_window":
            return _window_sum_box(x, window)
        raise ValueError(f"unknown window_sum method {method!r}")
    taps = window_weight_taps(window, weights)
    return sep_conv2d(x, taps, taps)


def structure_tensor_sums(
    ix: torch.Tensor,
    iy: torch.Tensor,
    it: torch.Tensor,
    window: int,
    method: str = "sep_conv",
    weights: str = "box",
) -> tuple[torch.Tensor, ...]:
    """The five windowed product sums of the LK normal equations:
    (sum_ix2, sum_iy2, sum_ixiy, sum_ixit, sum_iyit)."""
    prods = torch.stack([ix * ix, iy * iy, ix * iy, ix * it, iy * it])
    return tuple(window_sum(prods, window, method, weights).unbind(0))


def centered_structure_tensor_sums(
    ix: torch.Tensor,
    iy: torch.Tensor,
    it: torch.Tensor,
    window: int,
    method: str = "sep_conv",
    valid: torch.Tensor | None = None,
    weights: str = "box",
) -> tuple[torch.Tensor, ...]:
    """Mean-normalized ("centered") LK normal-equation sums, the DIS data term:
    every product sum becomes ``S_ab - S_a S_b / n``, ``n`` the window's
    in-image pixel count (``valid`` marks the pixels it may count; default
    all).  Nine planes, one window sum; returns the five sums of
    :func:`structure_tensor_sums`, centered."""
    ones = torch.ones_like(ix) if valid is None else valid.to(ix.dtype)
    planes = torch.stack([ix * ix, iy * iy, ix * iy, ix * it, iy * it, ix, iy, it, ones])
    s = window_sum(planes, window, method, weights)
    inv_n = 1.0 / clip(s[8], 1.0)
    return (
        s[0] - s[5] * s[5] * inv_n,
        s[1] - s[6] * s[6] * inv_n,
        s[2] - s[5] * s[6] * inv_n,
        s[3] - s[5] * s[7] * inv_n,
        s[4] - s[6] * s[7] * inv_n,
    )
