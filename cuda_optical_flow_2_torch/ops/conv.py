"""2-D stencil correlations over planar images.

Counterpart of ``cuda_optical_flow_2_tpu.ops.conv``: zero-padded
*correlation* (no mask flip) of ``(..., H, W)`` images with small masks.

Computed as sums of shifted slices of a zero-padded copy, never with
``F.conv2d``: on a CUDA tensor that routes through cuDNN, which runs float32
in TF32 by default and keeps about three digits.  Slices keep these plain
ops exact float32 on every device, so they serve as the reference the
hand-written kernels are held against.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["conv2d", "sep_conv2d", "stencil2d"]


def _float_dtype(x: torch.Tensor, dtype=None) -> torch.dtype:
    """``dtype``, else ``x``'s floating dtype, else float32."""
    if dtype is not None:
        return dtype
    return x.dtype if x.is_floating_point() else torch.float32


def _taps(values, dtype: torch.dtype) -> list[float]:
    """The mask's taps as ``dtype`` rounds them (the JAX package builds its
    kernel in the accumulation dtype), as Python floats."""
    return torch.as_tensor(np.asarray(values, np.float64), dtype=dtype).tolist()


def conv2d(x: torch.Tensor, mask, *, dtype=None) -> torch.Tensor:
    """Zero-padded 2-D correlation of ``x`` (..., H, W) with a (kh, kw) mask.

    ``dtype`` is the accumulation and output dtype (default: ``x``'s
    floating dtype, else float32); the taps are rounded to it."""
    mask = np.asarray(mask)
    if mask.ndim != 2:
        raise ValueError(f"mask must be 2-D, got shape {mask.shape}")
    dtype = _float_dtype(x, dtype)
    x = x.to(dtype)
    taps = _taps(mask, dtype)
    kh, kw = mask.shape
    h, w = x.shape[-2:]
    xp = F.pad(x, (kw // 2, (kw - 1) // 2, kh // 2, (kh - 1) // 2))
    out = torch.zeros_like(x)
    for i in range(kh):
        for j in range(kw):
            tap = taps[i][j]
            if tap != 0.0:
                out = out + tap * xp[..., i : i + h, j : j + w]
    return out


def stencil2d(x: torch.Tensor, mask, *, dtype=None) -> torch.Tensor:
    """The JAX package's shift-form twin of its ``conv2d``: the same zero-padded
    correlation, a sum of shifted slices that skips zero taps, in row-major
    tap order.  Here :func:`conv2d` already has that form.  ``dtype`` (default:
    ``x``'s floating dtype, else float32) is the dtype of the sum."""
    return conv2d(x, mask, dtype=dtype)


def _correlate1d(x: torch.Tensor, taps: list[float], axis: int) -> torch.Tensor:
    """Zero-padded 1-D correlation along ``axis`` (-2 rows, -1 columns)."""
    k = len(taps)
    n = x.shape[axis]
    pad = (k // 2, (k - 1) // 2)
    xp = F.pad(x, pad if axis == -1 else (0, 0) + pad)
    out = torch.zeros_like(x)
    for j, tap in enumerate(taps):
        if tap != 0.0:
            out = out + tap * xp.narrow(axis, j, n)
    return out


def sep_conv2d(x: torch.Tensor, col, row, *, dtype=None) -> torch.Tensor:
    """Separable zero-padded correlation with the rank-1 mask col (x) row:
    a column pass, then a row pass, in ``dtype`` as :func:`conv2d`."""
    dtype = _float_dtype(x, dtype)
    col = _taps(np.asarray(col).reshape(-1), dtype)
    row = _taps(np.asarray(row).reshape(-1), dtype)
    return _correlate1d(_correlate1d(x.to(dtype), col, -2), row, -1)
