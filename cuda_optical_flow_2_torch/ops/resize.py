"""Flow upsampling (coarse-to-fine) and downsampling (warm-start seeding).

Counterpart of ``cuda_optical_flow_2_tpu.ops.resize``.  The pyramid's 2x step
uses the half-pixel bilinear convention (coarse pixel k at fine 2k + 0.5):
out[2k] = 0.75*in[k] + 0.25*in[k-1], out[2k+1] = 0.75*in[k] + 0.25*in[k+1],
edges clamped; see the JAX module for why the half-pixel grid is kept.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cuda_optical_flow_2_torch.ops.pyramid import pyr_down

__all__ = ["downsample_flow", "is_octave", "upsample_flow", "upscale_nn"]


def _up2x_axis(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Exact 2x bilinear upsample along ``axis`` (negative), edges clamped."""
    n = x.shape[axis]
    lo = torch.cat([x.narrow(axis, 0, 1), x.narrow(axis, 0, n - 1)], dim=axis)
    hi = torch.cat([x.narrow(axis, 1, n - 1), x.narrow(axis, n - 1, 1)], dim=axis)
    even = 0.75 * x + 0.25 * lo
    odd = 0.75 * x + 0.25 * hi
    ax = x.ndim + axis
    return torch.stack([even, odd], dim=ax + 1).flatten(ax, ax + 1)


def is_octave(flow_shape, shape: tuple[int, int]) -> bool:
    """Whether a (..., h, w, 2) flow goes to (H, W) = ``shape`` by one
    pyramid octave: H in (2h, 2h + 1) and W in (2w, 2w + 1)."""
    h, w = flow_shape[-3:-1]
    th, tw = shape
    return th in (2 * h, 2 * h + 1) and tw in (2 * w, 2 * w + 1)


def upsample_flow(flow: torch.Tensor, shape: tuple[int, int]) -> torch.Tensor:
    """Resize (..., h, w, 2) flow to (..., H, W, 2) and scale u by W/w, v by
    H/h.  One pyramid octave (H in (2h, 2h + 1), W in (2w, 2w + 1)) takes the
    exact 2x stencil and doubles the values, an odd target getting one
    edge-replicated row/column; any other size is a half-pixel bilinear
    resize with clamped edges (``jax.image.resize`` without antialiasing;
    DIS's ``finest_level`` > 1 reaches it)."""
    th, tw = shape
    h, w = flow.shape[-3:-1]
    if (th, tw) == (h, w):
        return flow
    if not is_octave(flow.shape, shape):
        lead = flow.shape[:-3]
        x = flow.reshape((-1, h, w, 2)).permute(0, 3, 1, 2)
        out = F.interpolate(x, size=(th, tw), mode="bilinear", align_corners=False)
        # Python-float scales: no host-to-device copy, so a CUDA graph can capture it
        out = torch.stack([out[:, 0] * (tw / w), out[:, 1] * (th / h)], dim=-1)
        return out.reshape(lead + (th, tw, 2))
    out = _up2x_axis(_up2x_axis(flow, -3), -2)
    if th == 2 * h + 1:
        out = torch.cat([out, out[..., -1:, :, :]], dim=-3)
    if tw == 2 * w + 1:
        out = torch.cat([out, out[..., :, -1:, :]], dim=-2)
    return out * 2.0


def downsample_flow(
    flow: torch.Tensor, shape: tuple[int, int], use_pallas: bool = True
) -> torch.Tensor:
    """Resize (..., H, W, 2) flow down to a coarser pyramid level's (h, w):
    per octave, the image pyramid's blur + decimation (``pyr_down``, kernel
    or plain per ``use_pallas``) and halved values.  ``shape`` must be
    reachable by floor-halving."""
    th, tw = shape
    h, w = flow.shape[-3:-1]
    while (h, w) != (th, tw):
        if h // 2 < th or w // 2 < tw:
            raise ValueError(f"{shape} is not a floor-halving of {tuple(flow.shape[-3:-1])}")
        h, w = h // 2, w // 2
        flow = torch.stack(
            [pyr_down(flow[..., 0], use_pallas=use_pallas),
             pyr_down(flow[..., 1], use_pallas=use_pallas)], dim=-1
        ) * 0.5
    return flow


def upscale_nn(img: torch.Tensor, n: int) -> torch.Tensor:
    """Replicate each pixel of (..., H, W) planes into a 2^n x 2^n block (debug
    visualization)."""
    f = 1 << n
    return img.repeat_interleave(f, dim=-2).repeat_interleave(f, dim=-1)
