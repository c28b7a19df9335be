"""Fused LK level step: clamp + warp + gradients + window sums + solve + update.

Replaces ``cuda_optical_flow_2_tpu/kernels/lk_step_fused.py::lk_level_step``
(whole image, with the DIS ``centered`` mode; the spatial-TP
``lk_band_step`` and the in-kernel 2x upsample ``flow_half`` are not ported
yet).  CUDA source: ``csrc/lk_step_fused.cu`` with the tile body in
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

:func:`lk_level_step` launches the kernel for CUDA tensors and takes
:func:`lk_level_step_plain` for CPU tensors; ``lk_level_step.launches``
counts kernel launches and ``lk_level_step.launches_centered`` those with
``centered=True``.
"""

from __future__ import annotations

import torch

from cuda_optical_flow_2_torch.config import LKConfig
from cuda_optical_flow_2_torch.kernels import _build
from cuda_optical_flow_2_torch.kernels.lk_fused import kernel_constants, lk_residual_plain, planes
from cuda_optical_flow_2_torch.ops.warp import warp_bilinear

__all__ = ["lk_level_step", "lk_level_step_plain"]


def lk_level_step_plain(
    prev: torch.Tensor,
    nxt: torch.Tensor,
    flow: torch.Tensor,
    config: LKConfig,
    centered: bool = False,
) -> torch.Tensor:
    """The plain PyTorch version: clip + warp_bilinear + residual + add."""
    d = float(config.max_displacement)
    fc = flow.clamp(-d, d)
    return fc + lk_residual_plain(prev, warp_bilinear(nxt, fc), config, centered)


def lk_level_step(
    prev: torch.Tensor,
    nxt: torch.Tensor,
    flow: torch.Tensor,
    config: LKConfig,
    centered: bool = False,
) -> torch.Tensor:
    """One warp + solve + update iteration of an LK level (``centered``:
    of a DIS level, with the mean-normalized sums).

    Args: prev/nxt (..., H, W), flow (..., H, W, 2).  Returns the updated
    flow (..., H, W, 2) float32.
    """
    if all(t.device.type == "cpu" for t in (prev, nxt, flow)):
        return lk_level_step_plain(prev, nxt, flow, config, centered)
    dev = _build.require_cuda(prev, nxt, flow)
    lead, (h, w) = prev.shape[:-2], prev.shape[-2:]
    if nxt.shape != prev.shape or flow.shape != prev.shape + (2,):
        raise ValueError(
            f"shapes prev {tuple(prev.shape)}, next {tuple(nxt.shape)}, flow "
            f"{tuple(flow.shape)}: want (..., H, W) twice and (..., H, W, 2)"
        )
    p, n, f = planes(prev.reshape(-1, h, w), nxt.reshape(-1, h, w), flow.reshape(-1, h, w, 2))
    out = torch.empty_like(f)
    r, taps, masks = kernel_constants(config)
    _build.launch(
        dev, "of2_lk_level_step", p.data_ptr(), n.data_ptr(), f.data_ptr(), out.data_ptr(),
        p.shape[0], h, w, r, taps.ctypes.data, masks.ctypes.data, float(config.det_eps),
        float(config.max_displacement), int(centered),
    )
    lk_level_step.launches += 1
    lk_level_step.launches_centered += int(centered)
    return out.reshape(lead + (h, w, 2))


lk_level_step.launches = 0
lk_level_step.launches_centered = 0
