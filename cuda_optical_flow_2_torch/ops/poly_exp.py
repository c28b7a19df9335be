"""Quadratic polynomial expansion (Farnebäck 2003), the basis of the FB model.

Counterpart of ``cuda_optical_flow_2_tpu.ops.poly_exp``.  Each pixel's
neighbourhood is fitted as f(o) ~ o^T A o + b^T o + c over offsets
o = (x, y), weighted by the Gaussian applicability w = g(y) g(x).  With an
applicability that does not vary over the image the weighted least-squares
solution is

    r = G^{-1} v,   G = B^T W B (6x6 constant),   v = B^T W f (per pixel),

and every component of v is a separable correlation of f with
{g, g*o, g*o^2} along each axis.  G is inverted in numpy (float64) and its
rows enter as float32 constants.  Boundary semantics: the frame is
zero-padded and the interior G is used at every pixel.

The correlations are shifted slices of a zero-padded copy in the JAX
function's order (three vertical passes, six horizontal moments, then the
5x6 mixing), never ``F.conv2d``, which runs float32 in TF32 on CUDA.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["gaussian_1d", "mixing_matrix", "poly_taps", "poly_expansion"]


def gaussian_1d(n: int, sigma: float) -> np.ndarray:
    """Normalized odd-length Gaussian applicability factor."""
    if n % 2 != 1 or n < 3:
        raise ValueError(f"poly_n must be odd and >= 3, got {n}")
    o = np.arange(n, dtype=np.float64) - n // 2
    g = np.exp(-(o * o) / (2.0 * sigma * sigma))
    return (g / g.sum()).astype(np.float64)


@functools.lru_cache(maxsize=32)
def mixing_matrix(n: int, sigma: float) -> np.ndarray:
    """Rows 1..5 of G^{-1}: maps v = (m00, m10, m01, m20, m02, m11) to the
    coefficients (bx, by, axx, ayy, axy*2) in basis order (x, y, x^2, y^2, xy)."""
    g = gaussian_1d(n, sigma)
    o = np.arange(n, dtype=np.float64) - n // 2
    yy, xx = np.meshgrid(o, o, indexing="ij")
    w = np.outer(g, g)
    basis = np.stack([np.ones_like(xx), xx, yy, xx * xx, yy * yy, xx * yy], axis=-1)
    G = np.einsum("yx,yxk,yxl->kl", w, basis, basis)
    return np.linalg.inv(G)[1:6, :]  # (5, 6); row order (x, y, x^2, y^2, xy)


@functools.lru_cache(maxsize=32)
def poly_taps(n: int, sigma: float) -> tuple[np.ndarray, np.ndarray]:
    """The constants of the expansion as the CUDA kernels take them: the
    (3, n) float32 taps {g, g*o, g*o^2} and the (5, 6) float32 mixing rows,
    entries with |c| < 1e-15 set to 0 (the plain version skips them) and the
    last row halved (axy, not 2 axy).  Cached, so read-only."""
    g = gaussian_1d(n, sigma)
    o = np.arange(n, dtype=np.float64) - n // 2
    taps = np.stack([g, g * o, g * o * o]).astype(np.float32)
    mix = mixing_matrix(n, float(sigma)).copy()
    mix[np.abs(mix) < 1e-15] = 0.0
    mix = mix.astype(np.float32)
    mix[4] *= np.float32(0.5)
    for a in (taps, mix):
        a.flags.writeable = False
    return taps, mix


def _corr1d(x: torch.Tensor, k: np.ndarray, axis: int) -> torch.Tensor:
    """Zero-padded 1-D correlation: out[i] = sum_j k[j] x[i + j - r], taps
    that are exactly 0 skipped (the JAX ``_corr1d``)."""
    r = k.size // 2
    size = x.shape[axis]
    xp = F.pad(x, (r, r) if axis == -1 else (0, 0, r, r))
    acc = None
    for j in range(k.size):
        c = float(k[j])
        if c == 0.0:
            continue
        piece = xp.narrow(axis, j, size) * c
        acc = piece if acc is None else acc + piece
    return acc


def poly_expansion(
    f: torch.Tensor, n: int = 7, sigma: float = 1.5
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-pixel quadratic expansion of (..., H, W) -> (bx, by, axx, ayy, axy).

    f(o) ~ o^T [[axx, axy], [axy, ayy]] o + (bx, by)^T o + c with o = (x, y)
    in (column, row) offsets, the flow convention (flow[..., 0] = u along
    the width).  The constant c is not returned (the solve never uses it).
    """
    if not f.is_floating_point():
        f = f.to(torch.float32)
    g = gaussian_1d(n, sigma)
    o = np.arange(n, dtype=np.float64) - n // 2
    g1, g2 = g * o, g * o * o

    # Row-axis (y) passes shared across the column-axis (x) taps.
    ty0 = _corr1d(f, g, -2)
    ty1 = _corr1d(f, g1, -2)
    ty2 = _corr1d(f, g2, -2)
    v = (
        _corr1d(ty0, g, -1),   # m00:  1
        _corr1d(ty0, g1, -1),  # m10:  x
        _corr1d(ty1, g, -1),   # m01:  y
        _corr1d(ty0, g2, -1),  # m20:  x^2
        _corr1d(ty2, g, -1),   # m02:  y^2
        _corr1d(ty1, g1, -1),  # m11:  xy
    )

    m = mixing_matrix(n, float(sigma))
    out = []
    for k in range(5):
        acc = None
        for l in range(6):
            c = float(m[k, l])
            if abs(c) < 1e-15:
                continue
            piece = v[l] * c
            acc = piece if acc is None else acc + piece
        out.append(acc)
    bx, by, axx, ayy, axy2 = out
    return bx, by, axx, ayy, axy2 * 0.5
