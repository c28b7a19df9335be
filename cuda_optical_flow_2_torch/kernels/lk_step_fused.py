"""Fused LK level step: clamp + warp + gradients + window sums + solve + update.

Replaces ``cuda_optical_flow_2_tpu/kernels/lk_step_fused.py``: the
whole-image ``lk_level_step`` with its DIS ``centered`` mode and its
``flow_half`` mode, and the spatial-TP band entry ``lk_band_step``.  CUDA
source: ``csrc/lk_step_fused.cu`` with the tile body in
``csrc/of2_lk_tile.cuh`` and the clamp + warp in ``csrc/of2_common.cuh``.
It computes::

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
as in the JAX kernel's mode of that name.  Here it is upsampled first by the
handoff kernel (``kernels.upsample_flow``), then stepped: on an H100 that
pair of launches is faster than a step that upsamples at each flow read
(PERF.md), so the step kernel takes only a flow at its own resolution.

The band entry is the same kernel with the band's global row ``row0`` and
the image height ``h_global``: the warp's sample row and bounds test, the
warped frame's zero outside the image and the gradient mask all act on
global rows, so the rows the caller keeps match the whole-image step; the
whole-image entry is the band ``(0, H)``.

:func:`lk_level_step` and :func:`lk_band_step` launch the kernel for CUDA
tensors and take their plain versions for CPU tensors; ``.launches`` on each
counts its kernel launches and ``.launches_centered`` those with
``centered=True``.
"""

from __future__ import annotations

import torch

from cuda_optical_flow_2_torch.config import LKConfig
from cuda_optical_flow_2_torch.kernels import _build, tile_geometry
from cuda_optical_flow_2_torch.kernels.lk_fused import kernel_constants, lk_residual_plain, planes
from cuda_optical_flow_2_torch.kernels.upsample_flow import upsample_flow, upsample_flow_plain
from cuda_optical_flow_2_torch.ops.band import zero_outside_global
from cuda_optical_flow_2_torch.ops.warp import warp_bilinear, warp_bilinear_band

__all__ = ["lk_band_step", "lk_band_step_plain", "lk_level_step", "lk_level_step_plain"]


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
        flow = upsample_flow_plain(flow, tuple(prev.shape[-2:]))
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


def _launch(prev, nxt, flow, config, centered, row0, h_global) -> torch.Tensor:
    dev = _build.require_cuda(prev, nxt, flow)
    lead, (h, w) = prev.shape[:-2], prev.shape[-2:]
    if nxt.shape != prev.shape or flow.shape != lead + (h, w, 2):
        raise ValueError(
            f"shapes prev {tuple(prev.shape)}, next {tuple(nxt.shape)}, flow "
            f"{tuple(flow.shape)}: want (..., H, W) twice and (..., H, W, 2)"
        )
    p, n = planes(prev.reshape(-1, h, w), nxt.reshape(-1, h, w))
    (f,) = planes(flow.reshape(-1, h, w, 2))
    out = torch.empty(p.shape + (2,), dtype=torch.float32, device=dev)
    r, taps, masks = kernel_constants(config)
    _build.launch(
        dev, "of2_lk_level_step", p.data_ptr(), n.data_ptr(), f.data_ptr(), out.data_ptr(),
        p.shape[0], h, w, int(row0), int(h_global), r,
        *tile_geometry.lk_launch(p.shape[0], h, w, r, centered), taps.ctypes.data,
        masks.ctypes.data, float(config.det_eps), float(config.max_displacement), int(centered),
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
    the coarser level's flow (..., H/2, W/2, 2), upsampled first by
    :func:`kernels.upsample_flow.upsample_flow` (on CUDA tensors a launch of
    its own).  Returns the updated flow (..., H, W, 2) float32.
    """
    if flow_half:
        flow = upsample_flow(flow, tuple(prev.shape[-2:]))
    if all(t.device.type == "cpu" for t in (prev, nxt, flow)):
        return lk_level_step_plain(prev, nxt, flow, config, centered)
    out = _launch(prev, nxt, flow, config, centered, 0, prev.shape[-2])
    lk_level_step.launches += 1
    lk_level_step.launches_centered += int(centered)
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
    lk_band_step.launches += 1
    lk_band_step.launches_centered += int(centered)
    return out


lk_level_step.launches = 0
lk_level_step.launches_centered = 0
lk_band_step.launches = 0
lk_band_step.launches_centered = 0
