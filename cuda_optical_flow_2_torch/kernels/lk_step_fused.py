"""Fused LK level step: clamp + warp + gradients + window sums + solve + update.

Replaces ``cuda_optical_flow_2_tpu/kernels/lk_step_fused.py``: the
whole-image ``lk_level_step`` with its DIS ``centered`` mode and its
in-kernel 2x flow upsample ``flow_half``, and the spatial-TP band entry
``lk_band_step``.  CUDA source: ``csrc/lk_step_fused.cu`` with the tile body
in ``csrc/of2_lk_tile.cuh`` and the clamp + warp and the upsample in
``csrc/of2_common.cuh``.  It computes::

    fc  = clip(flow, +-max_displacement)
    out = fc + residual(prev, warp_bilinear(next, fc))   # centered: DIS sums

What bounds it on an H100: bytes.  Per pixel it reads prev, next and the
(u, v) flow, gathers four next pixels near the displaced point, and writes
(u, v): about five or six f32 planes read and two written.  The design warps
each tile plus its halo straight into shared memory (every halo pixel with
its own flow, as the plain composition warps the whole image first), so the
warped frame never goes to device memory, and the solve adds the residual to
the budget-clamped flow in the same pass.  The TPU kernel's select-loops,
per-tile recentering (``d_local``) and row correction (``c_max``) existed
because the TPU has no gather; here the warp is a direct four-tap gather,
exact for any flow.

``flow_half``: the flow argument is the coarser level's, (..., H/2, W/2, 2),
and each read of the flow upsamples it at that pixel, bit for bit as
``ops/resize.upsample_flow`` does, so the step reads a quarter-size flow and
the separate upsample pass with its full-size flow plane goes.  The TPU
kernel needed a lane-interleave network for it (``kernels/updown.py``); here
it is index arithmetic over four coarse taps.  :func:`supported_half` gates
it: even H and W, a flow of exactly (H/2, W/2), and the kernel path.

The band entry is the same kernel with the band's global row ``row0`` and
the image height ``h_global``: the warp's sample row and bounds test, the
warped frame's zero outside the image and the gradient mask all act on
global rows, so the rows the caller keeps match the whole-image step; the
whole-image entry is the band ``(0, H)``.

:func:`lk_level_step` and :func:`lk_band_step` launch the kernel for CUDA
tensors and take their plain versions for CPU tensors; ``.launches`` on each
counts its kernel launches, ``.launches_centered`` those with
``centered=True`` and ``lk_level_step.launches_half`` those with
``flow_half=True``; ``.cells_staged`` and ``.cells_out`` add up the source
cells the launches warped and the output cells they wrote
(:func:`kernels.tile_geometry.lk_cells`, the kernel's halo factor).
"""

from __future__ import annotations

import torch

from cuda_optical_flow_2_torch.config import LKConfig
from cuda_optical_flow_2_torch.kernels import _build, tile_geometry
from cuda_optical_flow_2_torch.kernels.lk_fused import (
    count_cells,
    kernel_constants,
    lk_residual_plain,
    planes,
    supported,
)
from cuda_optical_flow_2_torch.ops.band import zero_outside_global
from cuda_optical_flow_2_torch.ops.resize import upsample_flow
from cuda_optical_flow_2_torch.ops.warp import warp_bilinear, warp_bilinear_band

__all__ = [
    "lk_band_step", "lk_band_step_plain", "lk_level_step", "lk_level_step_plain", "supported_half",
]


def supported_half(h: int, w: int, flow_shape, config: LKConfig) -> bool:
    """Whether the step at an (h, w) level may take the coarser flow of
    shape ``flow_shape`` (..., h/2, w/2, 2) with ``flow_half``: even h and
    w, a flow of exactly half the level, and the kernel path (``use_pallas``,
    the bilinear warp and a window the kernel takes).  The JAX package's
    power-of-two padded width and ``max_displacement <= 96`` are limits of
    its TPU kernel; this one has neither."""
    return (
        h % 2 == 0
        and w % 2 == 0
        and tuple(flow_shape[-3:-1]) == (h // 2, w // 2)
        and config.use_pallas
        and config.warp_mode == "bilinear"
        and supported(config)
    )


def lk_level_step_plain(
    prev: torch.Tensor,
    nxt: torch.Tensor,
    flow: torch.Tensor,
    config: LKConfig,
    centered: bool = False,
    flow_half: bool = False,
) -> torch.Tensor:
    """The plain PyTorch version: (``flow_half``: upsample_flow +) clip +
    warp_bilinear + residual + add."""
    if flow_half:
        flow = upsample_flow(flow, tuple(prev.shape[-2:]))
    d = float(config.max_displacement)
    fc = flow.clamp(-d, d)
    return fc + lk_residual_plain(prev, warp_bilinear(nxt, fc), config, centered)


def lk_band_step_plain(
    prev: torch.Tensor,
    nxt: torch.Tensor,
    flow: torch.Tensor,
    row0: int,
    config: LKConfig,
    h_global: int,
    centered: bool = False,
) -> torch.Tensor:
    """The plain PyTorch version of the band step: clip, the band warp in
    global rows, the warped frame zeroed outside the global image (the
    whole-image step's zero padding), the banded residual, add."""
    d = float(config.max_displacement)
    fc = flow.clamp(-d, d)
    warped = zero_outside_global(warp_bilinear_band(nxt, fc, row0, row0, h_global), row0, h_global)
    return fc + lk_residual_plain(prev, warped, config, centered, row0, h_global)


def _launch(prev, nxt, flow, config, centered, row0, h_global, flow_half=False) -> torch.Tensor:
    dev = _build.require_cuda(prev, nxt, flow)
    lead, (h, w) = prev.shape[:-2], prev.shape[-2:]
    fh, fw = (h // 2, w // 2) if flow_half else (h, w)
    if (
        nxt.shape != prev.shape
        or flow.shape != lead + (fh, fw, 2)
        or (flow_half and (h % 2 or w % 2))
    ):
        want = "(..., H/2, W/2, 2) of an even H and W" if flow_half else "(..., H, W, 2)"
        raise ValueError(
            f"shapes prev {tuple(prev.shape)}, next {tuple(nxt.shape)}, flow "
            f"{tuple(flow.shape)}: want (..., H, W) twice and {want}"
        )
    p, n = planes(prev.reshape(-1, h, w), nxt.reshape(-1, h, w))
    (f,) = planes(flow.reshape(-1, fh, fw, 2))
    out = torch.empty(p.shape + (2,), dtype=torch.float32, device=dev)
    r, taps, masks = kernel_constants(config)
    _build.launch(
        dev, "of2_lk_level_step", p.data_ptr(), n.data_ptr(), f.data_ptr(), out.data_ptr(),
        p.shape[0], h, w, int(row0), int(h_global), r,
        *tile_geometry.lk_launch(p.shape[0], h, w, r, centered), taps.ctypes.data,
        masks.ctypes.data, float(config.det_eps), float(config.max_displacement), int(centered),
        int(flow_half),
    )
    return out.reshape(lead + (h, w, 2))


def lk_level_step(
    prev: torch.Tensor,
    nxt: torch.Tensor,
    flow: torch.Tensor,
    config: LKConfig,
    centered: bool = False,
    flow_half: bool = False,
) -> torch.Tensor:
    """One warp + solve + update iteration of an LK level (``centered``:
    of a DIS level, with the mean-normalized sums).

    Args: prev/nxt (..., H, W), flow (..., H, W, 2), or with ``flow_half``
    the coarser level's flow (..., H/2, W/2, 2), upsampled in the kernel
    (callers gate on :func:`supported_half`).  Returns the updated flow
    (..., H, W, 2) float32.
    """
    if all(t.device.type == "cpu" for t in (prev, nxt, flow)):
        return lk_level_step_plain(prev, nxt, flow, config, centered, flow_half)
    out = _launch(prev, nxt, flow, config, centered, 0, prev.shape[-2], flow_half)
    count_cells(lk_level_step, prev, config, centered)
    lk_level_step.launches += 1
    lk_level_step.launches_centered += int(centered)
    lk_level_step.launches_half += int(flow_half)
    return out


def lk_band_step(
    prev: torch.Tensor,
    nxt: torch.Tensor,
    flow: torch.Tensor,
    row0: int,
    config: LKConfig,
    h_global: int,
    centered: bool = False,
) -> torch.Tensor:
    """One LK iteration on a row band of an ``h_global``-row image (the
    spatial-TP entry, ``parallel/spatial.py``).

    ``prev``/``nxt`` (..., HB, W) and ``flow`` (..., HB, W, 2) hold global
    rows [row0, row0 + HB); ``row0`` may be negative (a mesh-edge shard's
    zero halo).  Rows at least the warp halo (window // 2 + 2 +
    max_displacement + 2) from the band edges match :func:`lk_level_step`
    on the whole image; band-edge rows are for the caller to crop.
    """
    if all(t.device.type == "cpu" for t in (prev, nxt, flow)):
        return lk_band_step_plain(prev, nxt, flow, row0, config, h_global, centered)
    out = _launch(prev, nxt, flow, config, centered, row0, h_global)
    count_cells(lk_band_step, prev, config, centered)
    lk_band_step.launches += 1
    lk_band_step.launches_centered += int(centered)
    return out


lk_level_step.launches = 0
lk_level_step.launches_centered = 0
lk_level_step.launches_half = 0
lk_level_step.cells_staged = 0
lk_level_step.cells_out = 0
lk_band_step.launches = 0
lk_band_step.launches_centered = 0
lk_band_step.cells_staged = 0
lk_band_step.cells_out = 0
