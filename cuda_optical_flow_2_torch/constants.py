"""Convolution masks used by the LK slice (numpy only).

Copies of the entries of ``cuda_optical_flow_2_tpu.constants`` that the
port's pipeline reads; ``tests/test_torch_ops.py`` holds them equal to the
originals.  Stencils are applied as correlations (no mask flip).
"""

from __future__ import annotations

import numpy as np

__all__ = ["BINOMIAL_1D", "MASKS"]

_f32 = np.float32

# Name -> 3x3 mask, for the LKConfig string fields.
MASKS = {
    # Sobel derivatives (gain 8 on a unit ramp).
    "sobel_x": np.array([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]], _f32),
    "sobel_y": np.array([[-1.0, -2.0, -1.0], [0.0, 0.0, 0.0], [1.0, 2.0, 1.0]], _f32),
    # Temporal smoothing, unnormalized (sum 15).
    "dt3": np.array([[1.0, 2.0, 1.0], [2.0, 3.0, 2.0], [1.0, 2.0, 1.0]], _f32),
    # Direct frame difference.
    "delta": np.array([[0.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 0.0]], _f32),
    # Binomial {1,2,1}/4 (x) {1,2,1}/4.
    "gauss3": np.array(
        [[0.0625, 0.125, 0.0625], [0.125, 0.25, 0.125], [0.0625, 0.125, 0.0625]], _f32
    ),
}

# Separable factor of MASKS["gauss3"]; the pyramid's blur.
BINOMIAL_1D = np.array([0.25, 0.5, 0.25], dtype=_f32)
