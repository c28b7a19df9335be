"""Spatial and temporal image gradients (Ix, Iy, It).

Counterpart of ``cuda_optical_flow_2_tpu.ops.gradients``: Ix, Iy are Sobel
correlations of the previous frame; It is a temporal smoothing mask applied
to (next - prev).
"""

from __future__ import annotations

import torch

from cuda_optical_flow_2_torch.constants import MASKS
from cuda_optical_flow_2_torch.ops.conv import _float_dtype, conv2d

__all__ = ["SOBEL_GAIN", "gradient_magnitude", "spatial_gradients", "temporal_gradient"]

# Gain of a derivative stencil on a unit ramp (Sobel: (1+2+1)*(1+1) = 8).
SOBEL_GAIN = 8.0


def sobel_scale(normalize: bool) -> float:
    """Factor on the Sobel masks: 1/8 makes Ix the true derivative."""
    return 1.0 / SOBEL_GAIN if normalize else 1.0


def temporal_mask(kernel: str, normalize: bool):
    """The 3x3 temporal mask, scaled to unit sum when ``normalize``."""
    mask = MASKS[kernel]
    return mask / mask.sum() if normalize else mask


def spatial_gradients(
    prev: torch.Tensor, normalize: bool = True
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sobel Ix, Iy of the previous frame."""
    scale = sobel_scale(normalize)
    return conv2d(prev, MASKS["sobel_x"] * scale), conv2d(prev, MASKS["sobel_y"] * scale)


def temporal_gradient(
    prev: torch.Tensor, nxt: torch.Tensor, kernel: str = "dt3", normalize: bool = True
) -> torch.Tensor:
    """It = K (x) (next - prev); the correlation is linear, so one stencil."""
    dtype = _float_dtype(prev)
    return conv2d(nxt.to(dtype) - prev.to(dtype), temporal_mask(kernel, normalize))


def gradient_magnitude(gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """sqrt(gx^2 + gy^2), with a zero derivative where both are zero.

    sqrt's derivative is infinite at 0, so autograd, like ``jax.grad``
    through the JAX package's ``jnp.sqrt``, gives NaN wherever a flow is
    locally constant, which TV-L1's median between warps makes common at
    full width.  The values are sqrt's, bit for bit; the derivative differs
    from sqrt's only where sqrt's is not finite.
    """
    s2 = gx * gx + gy * gy
    zero = s2 == 0
    return torch.where(zero, 0.0, torch.sqrt(torch.where(zero, 1.0, s2)))
