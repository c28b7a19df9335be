"""Gaussian pyramid: binomial blur + 2x subsample.

Counterpart of ``cuda_optical_flow_2_tpu.ops.pyramid``.  Output pixel
(x, y) is centred on source (2x, 2y) with zero padding; odd sizes floor
(level k is (h >> k, w >> k), the trailing odd row/column is never read).

``kernel_1d`` is the separable factor of the smoothing mask (default the
binomial {1, 2, 1} / 4).  ``use_pallas=True`` (the default, as in the JAX
package) with the binomial routes through the hand-written kernel
``kernels.pyr_down``, which takes this module's plain version for CPU
tensors; any other ``kernel_1d`` takes the plain version on every device,
as the JAX package takes its banded-matmul form.  The plain version is
strided slices of a zero-padded copy, one separable pass per axis: exact
float32 on every device (no cuDNN, so no TF32).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from cuda_optical_flow_2_torch.constants import BINOMIAL_1D

__all__ = ["pyr_down", "build_pyramid"]


def _down_axis(x: torch.Tensor, k: np.ndarray, axis: int) -> torch.Tensor:
    """out[i] = sum_j k[j] * x[2i + j - r] along ``axis``, zero outside."""
    r = k.size // 2
    n_out = x.shape[axis] // 2
    xp = F.pad(x, (r, r) if axis == -1 else (0, 0, r, r))
    out = None
    for j in range(k.size):
        t = float(k[j]) * xp.narrow(axis, j, 2 * n_out).unflatten(axis, (n_out, 2)).select(
            axis, 0
        )
        out = t if out is None else out + t
    return out


def pyr_down(x: torch.Tensor, kernel_1d=BINOMIAL_1D, use_pallas: bool = True) -> torch.Tensor:
    """Blur + 2x downsample: (..., H, W) -> (..., H//2, W//2).

    ``kernel_1d`` (odd length, float32 taps as in the JAX package) is the
    separable factor of the smoothing mask; output row i is
    ``sum_j k[j] x[2i + j - r]``, zero outside the cropped source."""
    if use_pallas and kernel_1d is BINOMIAL_1D:
        from cuda_optical_flow_2_torch.kernels import pyr_down as kernel

        return kernel.pyr_down(x)
    k = np.asarray(kernel_1d, np.float32).reshape(-1)
    if k.size % 2 != 1:
        raise ValueError("pyramid kernel must have odd length")
    h, w = x.shape[-2:]
    oh, ow = h // 2, w // 2
    dtype = x.dtype if x.is_floating_point() else torch.float32
    xb = x[..., : 2 * oh, : 2 * ow].to(dtype)
    return _down_axis(_down_axis(xb, k, -2), k, -1)


def build_pyramid(
    x: torch.Tensor, levels: int, kernel_1d=BINOMIAL_1D, use_pallas: bool = True
) -> list[torch.Tensor]:
    """Level-0..levels-1 pyramid; level k shaped (..., h >> k, w >> k)."""
    pyr = [x]
    for _ in range(1, levels):
        # pyr_down crops the trailing odd row/column itself.
        pyr.append(pyr_down(pyr[-1], kernel_1d, use_pallas=use_pallas))
    return pyr
