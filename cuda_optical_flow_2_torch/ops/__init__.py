"""Plain PyTorch ops: the reference path the kernels are held against.

The names of ``cuda_optical_flow_2_tpu.ops``.
"""

from cuda_optical_flow_2_torch.ops.bilateral import bilateral_filter
from cuda_optical_flow_2_torch.ops.color import grayscale, grayscale_u8
from cuda_optical_flow_2_torch.ops.conv import conv2d, sep_conv2d, stencil2d
from cuda_optical_flow_2_torch.ops.gradients import spatial_gradients, temporal_gradient
from cuda_optical_flow_2_torch.ops.median import median_filter
from cuda_optical_flow_2_torch.ops.pyramid import build_pyramid, pyr_down
from cuda_optical_flow_2_torch.ops.resize import upsample_flow, upscale_nn
from cuda_optical_flow_2_torch.ops.solve import solve_2x2, solve_2x2_unguarded
from cuda_optical_flow_2_torch.ops.warp import warp_bilinear, warp_nearest
from cuda_optical_flow_2_torch.ops.window import (
    structure_tensor_sums,
    window_sum,
    window_weight_taps,
)

__all__ = [
    "median_filter",
    "grayscale",
    "grayscale_u8",
    "conv2d",
    "sep_conv2d",
    "stencil2d",
    "build_pyramid",
    "pyr_down",
    "spatial_gradients",
    "temporal_gradient",
    "structure_tensor_sums",
    "window_sum",
    "window_weight_taps",
    "solve_2x2",
    "solve_2x2_unguarded",
    "warp_bilinear",
    "warp_nearest",
    "upsample_flow",
    "upscale_nn",
    "bilateral_filter",
]
