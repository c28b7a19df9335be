"""Convolution masks and the Gaussian-mask generator (numpy only).

Copies of every mask of ``cuda_optical_flow_2_tpu.constants``: those the
port's pipeline, its bug-exact profiles and its oracle read, and the
reference's tables that nothing runs (kept so the two modules hold the same
names); ``tests/test_torch_ops.py`` and ``tests/test_torch_compat.py`` hold
them equal to the originals.  Stencils are applied as correlations (no mask flip).
"""

from __future__ import annotations

import math

import numpy as np

__all__ = [
    "BINOMIAL_1D",
    "DELTA_3X3",
    "DT_3X3",
    "DT_3X3_N",
    "DX_2X2",
    "DX_3X3",
    "DX_3X3_T",
    "DX_5X5",
    "DX_DIAGONAL_2X2",
    "DY_2X2",
    "DY_3X3",
    "DY_DIAGONAL_2X2",
    "DZ_2X2",
    "GAUS_KERNEL_3X3",
    "GAUS_KERNEL_5X5",
    "MASKS",
    "generate_gaussian_kernel",
]

_f32 = np.float32

# Sobel derivatives (gain 8 on a unit ramp).
DX_3X3 = np.array([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]], _f32)
DY_3X3 = np.array([[-1.0, -2.0, -1.0], [0.0, 0.0, 0.0], [1.0, 2.0, 1.0]], _f32)
# Temporal smoothing, unnormalized (sum 15).
DT_3X3 = np.array([[1.0, 2.0, 1.0], [2.0, 3.0, 2.0], [1.0, 2.0, 1.0]], _f32)
# The reference's normalized temporal mask of its gradient viewer (showTest).
DT_3X3_N = np.array(
    [[0.0666, 0.1333, 0.0666], [0.1333, 0.2, 0.1333], [0.0666, 0.1333, 0.0666]], _f32
)
# Binomial {1,2,1}/4 (x) {1,2,1}/4.
GAUS_KERNEL_3X3 = np.array(
    [[0.0625, 0.125, 0.0625], [0.125, 0.25, 0.125], [0.0625, 0.125, 0.0625]], _f32
)
# Direct frame difference (DIS's temporal "mask").
DELTA_3X3 = np.array([[0.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 0.0]], _f32)

# The reference's tables that no path runs: a transposed, scaled Sobel-x, the
# 2x2 schemes zero-padded into 3x3, a 5x5 derivative and a 5x5 Gaussian.
DX_3X3_T = np.array(
    [[1.0 / 3.0, 0.0, -1.0 / 3.0], [2.0 / 3.0, 0.0, -2.0 / 3.0], [1.0 / 3.0, 0.0, -1.0 / 3.0]],
    _f32,
)
DY_DIAGONAL_2X2 = np.array([[1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, 0.0]], _f32)
DX_DIAGONAL_2X2 = np.array([[0.0, 1.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, 0.0]], _f32)
DX_2X2 = np.array([[-1.0, 1.0, 0.0], [-1.0, 1.0, 0.0], [0.0, 0.0, 0.0]], _f32)
DY_2X2 = np.array([[-1.0, -1.0, 0.0], [1.0, 1.0, 0.0], [0.0, 0.0, 0.0]], _f32)
DZ_2X2 = np.array([[1.0, 1.0, 0.0], [1.0, 1.0, 0.0], [0.0, 0.0, 0.0]], _f32)
DX_5X5 = np.array(
    [
        [-1.0, -2.0, 0.0, 1.0, 2.0],
        [-2.0, -3.0, 0.0, 2.0, 3.0],
        [-3.0, -5.0, 0.0, 3.0, 5.0],
        [-2.0, -3.0, 0.0, 3.0, 2.0],
        [-1.0, -2.0, 0.0, 2.0, 1.0],
    ],
    _f32,
)
GAUS_KERNEL_5X5 = np.array(
    [
        [0.00366, 0.01465, 0.02564, 0.01465, 0.00366],
        [0.01465, 0.05860, 0.09523, 0.05860, 0.01465],
        [0.02564, 0.09523, 0.15018, 0.09523, 0.02564],
        [0.01465, 0.05860, 0.09523, 0.05860, 0.01465],
        [0.00366, 0.01465, 0.02564, 0.01465, 0.00366],
    ],
    _f32,
)

# Name -> 3x3 mask, for the LKConfig string fields.
MASKS = {
    "sobel_x": DX_3X3,
    "sobel_y": DY_3X3,
    "dt3": DT_3X3,
    "delta": DELTA_3X3,
    "gauss3": GAUS_KERNEL_3X3,
}

# Separable factor of MASKS["gauss3"]; the pyramid's blur.
BINOMIAL_1D = np.array([0.25, 0.5, 0.25], dtype=_f32)


def generate_gaussian_kernel(sigma: float, size: int = -1) -> np.ndarray:
    """Normalized 2-D Gaussian mask, float64 (the bilateral's spatial taps).

    ``size == -1`` derives the side as ``int(2*pi*sigma)``; an even side is
    bumped to the next odd one; the four quadrants are filled from the same
    value and the mask is scaled to unit sum.
    """
    if size == -1:
        size = int(2.0 * math.pi * sigma)
    if size % 2 == 0:
        size += 1
    mask = np.zeros((size, size), dtype=np.float64)
    hk = size >> 1
    sigma2 = float(sigma) * float(sigma)
    for i in range(hk + 1):
        for j in range(hk + 1):
            value = 1.0 / (2.0 * math.pi * sigma2) * math.exp(-0.5 * (i * i + j * j) / sigma2)
            mask[hk + i, hk + j] = value
            mask[hk - i, hk - j] = value
            mask[hk + i, hk - j] = value
            mask[hk - i, hk + j] = value
    mask /= mask.sum()
    return mask
