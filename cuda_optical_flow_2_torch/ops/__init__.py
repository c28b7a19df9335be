"""Plain PyTorch ops: the reference path the kernels are held against."""

from cuda_optical_flow_2_torch.ops.color import grayscale, grayscale_u8
from cuda_optical_flow_2_torch.ops.conv import stencil2d
from cuda_optical_flow_2_torch.ops.resize import upscale_nn

__all__ = ["grayscale", "grayscale_u8", "stencil2d", "upscale_nn"]
