"""Standalone bilinear backward warp with the displacement budget.

Replaces ``cuda_optical_flow_2_tpu/kernels/warp_select.py::warp_bilinear_select``
(whole image; the spatial-TP ``warp_bilinear_select_band`` is not ported
yet).  The module keeps the TPU name so the counterpart is easy to find, but
the select-loops are gone: the TPU had no per-element gather, so its kernel
emulated one with select-loops over a bounded displacement range, per-tile
recentering (``d_local``) and a row correction (``c_max``).  Here one thread
per pixel gathers the four bilinear taps directly (``csrc/warp_select.cu``,
``csrc/of2_common.cuh``), exact for any flow.  It computes::

    fc  = clip(flow, +-max_displacement)
    out = warp_bilinear(img, fc)   # out-of-bounds keeps the source pixel

What bounds it on an H100: bytes (one image plane and the flow read, four
mostly cached taps per pixel, one plane written).  The design reads the
flow as one 8-byte pair per thread and leaves tap reuse to the L1/L2 caches.

:func:`warp_bilinear_select` launches the kernel for CUDA tensors and takes
:func:`warp_bilinear_select_plain` for CPU tensors;
``warp_bilinear_select.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from cuda_optical_flow_2_torch.kernels import _build
from cuda_optical_flow_2_torch.kernels.lk_fused import planes
from cuda_optical_flow_2_torch.ops.warp import warp_bilinear

__all__ = ["warp_bilinear_select", "warp_bilinear_select_plain"]


def warp_bilinear_select_plain(
    img: torch.Tensor, flow: torch.Tensor, max_displacement: int = 32
) -> torch.Tensor:
    """The plain PyTorch version: warp_bilinear(img, clip(flow))."""
    d = float(max_displacement)
    return warp_bilinear(img, flow.clamp(-d, d))


def warp_bilinear_select(
    img: torch.Tensor, flow: torch.Tensor, max_displacement: int = 32
) -> torch.Tensor:
    """Bilinear backward warp of img (..., H, W) by flow (..., H, W, 2)
    clipped to +-max_displacement; returns (..., H, W) float32."""
    if img.device.type == "cpu" and flow.device.type == "cpu":
        return warp_bilinear_select_plain(img, flow, max_displacement)
    dev = _build.require_cuda(img, flow)
    lead, (h, w) = img.shape[:-2], img.shape[-2:]
    if flow.shape != img.shape + (2,):
        raise ValueError(f"flow {tuple(flow.shape)} does not match image {tuple(img.shape)}")
    x, f = planes(img.reshape(-1, h, w), flow.reshape(-1, h, w, 2))
    out = torch.empty_like(x)
    _build.launch(
        dev, "of2_warp_select", x.data_ptr(), f.data_ptr(), out.data_ptr(), x.shape[0], h, w,
        float(max_displacement),
    )
    warp_bilinear_select.launches += 1
    return out.reshape(lead + (h, w))


warp_bilinear_select.launches = 0
