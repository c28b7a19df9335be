"""NumPy twin of the reference's *live* CUDA hot path.

The port's copy of ``cuda_optical_flow_2_tpu.oracle.gpu_reference`` (numpy
only; ``tests/test_torch_compat.py`` holds the two equal).

Mirrors the GPU functions actually reachable from the reference's main loop
(see SURVEY.md section 2.1, "live" rows): float-accumulating gradient
convolutions, the 19x19 float windowed product sums, and the double-precision
2x2 solve (all four entries scaled, no det guard).  Unlike the CPU twin
(cpu_reference.py), the GPU path keeps gradients in float32 — no uchar
truncation after STEP 1 (OptFlowGpu.cu:1929-1940).

Float results are order-dependent; this oracle fixes tap-scan order (mask row
major) in float32, which is what the reference kernels do per thread.  Tests
compare the production paths against it with fp32 tolerances, and the int
stages (grayscale, pyramid) exactly.
"""

from __future__ import annotations

import numpy as np

from cuda_optical_flow_2_torch.constants import DT_3X3, DX_3X3, DY_3X3, GAUS_KERNEL_3X3
from cuda_optical_flow_2_torch.oracle.cpu_reference import (
    downscale_gaussian,
    grayscale_avg,
    shift_back_pyramid,
)

__all__ = [
    "conv_3ch_1ch_float",
    "srm_1ch_float",
    "inverse_matrix_float",
    "gauss_pyramid",
    "calc_opt_flow",
    "calc_opt_flow_pyramid",
    "grayscale_avg",
]


def conv_3ch_1ch_float(src: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Zero-padded 2-D correlation of channel 0, float32 accumulation.

    Twin of g_conv_3ch_1ch_constant_uchar_float (OptFlowGpu.cu:1041-1089), the
    kernel the "tiled" wrapper actually launches (OptFlowGpu.cu:1118).  Zero
    mask taps are skipped by the kernel (OptFlowGpu.cu:1076-1079) — numerically
    identical to adding zero, so the oracle just accumulates in tap order.
    """
    h, w = src.shape[:2]
    mh, mw = mask.shape
    hmh, hmw = mh >> 1, mw >> 1
    plane = src[..., 0].astype(np.float32)
    padded = np.zeros((h + mh - 1, w + mw - 1), dtype=np.float32)
    padded[hmh : hmh + h, hmw : hmw + w] = plane
    acc = np.zeros((h, w), dtype=np.float32)
    for i in range(mh):
        for j in range(mw):
            if float(mask[i, j]) == 0.0:
                continue
            acc = acc + padded[i : i + h, j : j + w] * np.float32(mask[i, j])
    return acc


def srm_1ch_float(
    arr1: np.ndarray, arr2: np.ndarray, ww: int, wh: int
) -> np.ndarray:
    """Windowed sum of float products with zero padding.

    Twin of g_srm_1ch_float (OptFlowGpu.cu:1549-1588): per pixel, float32 sum of
    arr1*arr2 over the ww x wh window, out-of-bounds taps skipped.
    """
    h, w = arr1.shape
    prod = (arr1.astype(np.float32) * arr2.astype(np.float32)).astype(np.float32)
    hww, hwh = ww >> 1, wh >> 1
    padded = np.zeros((h + wh - 1, w + ww - 1), dtype=np.float32)
    padded[hwh : hwh + h, hww : hww + w] = prod
    acc = np.zeros((h, w), dtype=np.float32)
    for p in range(wh):
        for q in range(ww):
            acc = acc + padded[p : p + h, q : q + w]
    return acc


def inverse_matrix_float(
    sum_ix2: np.ndarray,
    sum_iy2: np.ndarray,
    sum_ixiy: np.ndarray,
    sum_ixit: np.ndarray,
    sum_iyit: np.ndarray,
) -> np.ndarray:
    """Closed-form 2x2 LK solve, double precision, no det==0 guard.

    Twin of g_inv_matrix_float (OptFlowGpu.cu:1819-1846): all four scaled
    entries (unlike the CPU twin's unscaled-c bug), u/v assigned to float32.
    """
    a = sum_ix2.astype(np.float64)
    b = sum_ixiy.astype(np.float64)
    c = sum_ixiy.astype(np.float64)
    d = sum_iy2.astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        prefix = 1.0 / (a * d - b * c)
        a, b, c, d = a * prefix, b * prefix, c * prefix, d * prefix
        u = (-d * sum_ixit + b * sum_iyit).astype(np.float32)
        v = (c * sum_ixit - a * sum_iyit).astype(np.float32)
    return np.stack([u, v], axis=-1)


def gauss_pyramid(base: np.ndarray, levels: int) -> list[np.ndarray]:
    """Pyramid via the GPU downsample kernel semantics.

    Twin of gpu::gauss_pyramid (OptFlowGpu.cu:1262-1271).  The GPU device
    kernel hardcodes the 3x3 binomial mask and ignores the wrapper's mask
    argument (OptFlowGpu.cu:1193-1196); numerically it matches
    cpu::downscale_gaussian with that mask, so the CPU twin is reused.
    """
    h, w = base.shape[:2]
    pyr = [base]
    for k in range(1, levels):
        th, tw = h >> k, w >> k
        pyr.append(downscale_gaussian(pyr[-1][: 2 * th, : 2 * tw], GAUS_KERNEL_3X3))
    return pyr


def calc_opt_flow(
    prev: np.ndarray,
    nxt: np.ndarray,
    flow_pyramid: list[np.ndarray],
    level: int,
    max_level: int,
    window: int = 19,
) -> None:
    """One GPU-path LK level; writes flow_pyramid[level] in place.

    Twin of gpu::calc_opt_flow (OptFlowGpu.cu:1909-1979): CPU buggy warp
    (OptFlowGpu.cu:1920 calls cpu::shift_back_pyramid), float Sobel gradients,
    It = Dt(x)next - Dt(x)prev (unnormalized Dt_3x3, sum 15;
    OptFlowGpu.cu:1936-1940), five 19x19 float window sums, double solve.
    """
    if level != max_level - 1:
        nxt = shift_back_pyramid(nxt, level, max_level, flow_pyramid)

    ix = conv_3ch_1ch_float(prev, DX_3X3)
    iy = conv_3ch_1ch_float(prev, DY_3X3)
    it1 = conv_3ch_1ch_float(prev, DT_3X3)
    it2 = conv_3ch_1ch_float(nxt, DT_3X3)
    it = (it2 - it1).astype(np.float32)

    sum_ix2 = srm_1ch_float(ix, ix, window, window)
    sum_iy2 = srm_1ch_float(iy, iy, window, window)
    sum_ixiy = srm_1ch_float(ix, iy, window, window)
    sum_ixit = srm_1ch_float(ix, it, window, window)
    sum_iyit = srm_1ch_float(iy, it, window, window)

    flow_pyramid[level] = inverse_matrix_float(
        sum_ix2, sum_iy2, sum_ixiy, sum_ixit, sum_iyit
    )


def calc_opt_flow_pyramid(
    prev_pyramid: list[np.ndarray],
    next_pyramid: list[np.ndarray],
    window: int = 19,
) -> list[np.ndarray]:
    """Full coarse-to-fine GPU-path pass (main.cu:256-262 loop semantics)."""
    levels = len(prev_pyramid)
    flow_pyramid: list[np.ndarray] = [
        np.zeros(p.shape[:2] + (2,), dtype=np.float32) for p in prev_pyramid
    ]
    for k in range(levels - 1, -1, -1):
        calc_opt_flow(
            prev_pyramid[k], next_pyramid[k], flow_pyramid, k, levels, window
        )
    return flow_pyramid
