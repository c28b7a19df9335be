"""Grayscale conversion of (..., H, W, 3) RGB frames.

Counterpart of ``cuda_optical_flow_2_tpu.ops.color``: the float mean for the
production path and the integer mean of the bug-exact profile.
"""

from __future__ import annotations

import torch

__all__ = ["grayscale", "grayscale_u8"]


def grayscale(rgb: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(..., H, W, 3) uint8/float -> (..., H, W) float mean (r + g + b) / 3."""
    x = rgb.to(dtype)
    return (x[..., 0] + x[..., 1] + x[..., 2]) * (1.0 / 3.0)


def grayscale_u8(rgb: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) -> (..., H, W) uint8 integer mean (r + g + b) // 3, the
    reference's truncating division."""
    s = rgb.to(torch.int32)
    return torch.div(s[..., 0] + s[..., 1] + s[..., 2], 3, rounding_mode="floor").to(torch.uint8)
