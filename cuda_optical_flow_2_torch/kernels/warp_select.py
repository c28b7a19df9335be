"""Standalone bilinear backward warp with the displacement budget.

Replaces ``cuda_optical_flow_2_tpu/kernels/warp_select.py``: the whole-image
``warp_bilinear_select`` and the spatial-TP band entry
``warp_bilinear_select_band``.  The module keeps the TPU name so the
counterpart is easy to find, but the select-loops are gone: the TPU had no
per-element gather, so its kernel emulated one with select-loops over a
bounded displacement range, per-tile recentering (``d_local``) and a row
correction (``c_max``).  Here one thread per pixel gathers the four bilinear
taps directly (``csrc/warp_select.cu``, ``csrc/of2_common.cuh``), exact for
any flow.  It computes::

    fc  = clip(flow, +-max_displacement)
    out = warp_bilinear(img, fc)   # out-of-bounds keeps the source pixel

What bounds it on an H100: bytes (one image plane and the flow read, four
mostly cached taps per pixel, one plane written).  The design reads the
flow as one 8-byte pair per thread and leaves tap reuse to the L1/L2 caches.
The band entry passes the band's global row ``row0`` and the image height
``h_global``: the sample row and the out-of-bounds test are global (the
plain version is ``ops.warp.warp_bilinear_band``); the whole-image entry is
the band ``(0, H)``.

:func:`warp_bilinear_select` and :func:`warp_bilinear_select_band` launch
the kernel for CUDA tensors and take their plain versions for CPU tensors;
``.launches`` on each counts its kernel launches.
"""

from __future__ import annotations

import torch

from cuda_optical_flow_2_torch.kernels import _build
from cuda_optical_flow_2_torch.kernels.lk_fused import planes
from cuda_optical_flow_2_torch.ops.warp import warp_bilinear, warp_bilinear_band

__all__ = [
    "warp_bilinear_select",
    "warp_bilinear_select_band",
    "warp_bilinear_select_band_plain",
    "warp_bilinear_select_plain",
]


def warp_bilinear_select_plain(
    img: torch.Tensor, flow: torch.Tensor, max_displacement: int = 32
) -> torch.Tensor:
    """The plain PyTorch version: warp_bilinear(img, clip(flow))."""
    d = float(max_displacement)
    return warp_bilinear(img, flow.clamp(-d, d))


def warp_bilinear_select_band_plain(
    img_band: torch.Tensor,
    flow_band: torch.Tensor,
    row0: int,
    h_global: int,
    max_displacement: int = 32,
) -> torch.Tensor:
    """The plain PyTorch version of the band entry:
    warp_bilinear_band(img, clip(flow), row0, row0, h_global)."""
    d = float(max_displacement)
    return warp_bilinear_band(img_band, flow_band.clamp(-d, d), row0, row0, h_global)


def _launch(img, flow, max_displacement, row0, h_global) -> torch.Tensor:
    dev = _build.require_cuda(img, flow)
    lead, (h, w) = img.shape[:-2], img.shape[-2:]
    if flow.shape != img.shape + (2,):
        raise ValueError(f"flow {tuple(flow.shape)} does not match image {tuple(img.shape)}")
    x, f = planes(img.reshape(-1, h, w), flow.reshape(-1, h, w, 2))
    out = torch.empty_like(x)
    _build.launch(
        dev, "of2_warp_select", x.data_ptr(), f.data_ptr(), out.data_ptr(), x.shape[0], h, w,
        int(row0), int(h_global), float(max_displacement),
    )
    return out.reshape(lead + (h, w))


def warp_bilinear_select(
    img: torch.Tensor, flow: torch.Tensor, max_displacement: int = 32
) -> torch.Tensor:
    """Bilinear backward warp of img (..., H, W) by flow (..., H, W, 2)
    clipped to +-max_displacement; returns (..., H, W) float32."""
    if img.device.type == "cpu" and flow.device.type == "cpu":
        return warp_bilinear_select_plain(img, flow, max_displacement)
    out = _launch(img, flow, max_displacement, 0, img.shape[-2])
    warp_bilinear_select.launches += 1
    return out


def warp_bilinear_select_band(
    img_band: torch.Tensor,
    flow_band: torch.Tensor,
    row0: int,
    h_global: int,
    max_displacement: int = 32,
) -> torch.Tensor:
    """The warp on a row band holding global rows [row0, row0 + HB) of an
    ``h_global``-row image (the spatial-TP entry).  Rows at least
    ceil(max_displacement) + 2 from the band edges match
    :func:`warp_bilinear_select` on the whole image; band-edge rows are for
    the caller to crop."""
    if img_band.device.type == "cpu" and flow_band.device.type == "cpu":
        return warp_bilinear_select_band_plain(img_band, flow_band, row0, h_global,
                                               max_displacement)
    out = _launch(img_band, flow_band, max_displacement, row0, h_global)
    warp_bilinear_select_band.launches += 1
    return out


warp_bilinear_select.launches = 0
warp_bilinear_select_band.launches = 0
