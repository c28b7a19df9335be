"""Windowed structure-tensor sums.

Counterpart of ``cuda_optical_flow_2_tpu.ops.window``.  Only the "sep_conv"
method is ported: the window is two separable 1-D passes with the taps of
:func:`window_weight_taps`, zero outside the image.  "cumsum" and
"reduce_window" change only the float summation order and are listed in
ROADMAP.md as still to port.
"""

from __future__ import annotations

import numpy as np
import torch

from cuda_optical_flow_2_torch.ops.conv import sep_conv2d

__all__ = ["window_sum", "window_weight_taps", "structure_tensor_sums"]


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


def window_sum(
    x: torch.Tensor, window: int, method: str = "sep_conv", weights: str = "box"
) -> torch.Tensor:
    """Weighted sum of ``x`` over the window x window box at each pixel."""
    if window % 2 != 1:
        raise ValueError(f"window must be odd, got {window}")
    if weights == "box" and method != "sep_conv":
        if method in ("cumsum", "reduce_window"):
            raise NotImplementedError(
                f"window_method={method!r} is not ported yet (ROADMAP.md queue 1); "
                "use 'sep_conv'"
            )
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
