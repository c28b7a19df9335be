"""Coarse-to-fine flow handoff kernel: one pyramid octave of the flow upsample.

Replaces no Pallas kernel: the JAX package leaves ``ops/resize.upsample_flow``
to XLA, which fuses it into one pass.  CUDA source: ``csrc/upsample_flow.cu``.
It computes ``ops.resize.upsample_flow`` for one octave, bit for bit:
(..., h, w, 2) -> (..., H, W, 2) with H in (2h, 2h + 1) and W in (2w,
2w + 1), the exact 2x stencil (rows, then columns, edges clamped), an odd
last row or column repeating the one before it, the values doubled.

What bounds it on an H100: bytes.  Each output pixel writes 8 bytes and
reads a quarter of a coarse pixel's 8; the plain version's cats, products,
sums and stack (about 19 launches) each write a whole tensor instead.  The
kernel is one thread per 2x2 block of output pixels: it reads the 3x3
coarse neighbourhood they share and writes each of its two rows as one
16-byte store (a float2 pair where W is odd).

:func:`upsample_flow` launches the kernel for CUDA tensors and takes
:func:`upsample_flow_plain` for CPU tensors; ``upsample_flow.launches``
counts kernel launches.  :func:`handoff` picks the route of a model's
coarse-to-fine handoff from ``use_pallas`` and the shapes.
"""

from __future__ import annotations

import torch

from cuda_optical_flow_2_torch.kernels import _build
from cuda_optical_flow_2_torch.ops.resize import is_octave
from cuda_optical_flow_2_torch.ops.resize import upsample_flow as upsample_flow_plain

__all__ = ["handoff", "upsample_flow", "upsample_flow_plain"]


def upsample_flow(flow: torch.Tensor, shape: tuple[int, int]) -> torch.Tensor:
    """One octave of the flow upsample: (..., h, w, 2) -> (..., H, W, 2)
    float32, ``shape`` = (H, W)."""
    if flow.device.type == "cpu":
        return upsample_flow_plain(flow, shape)
    dev = _build.require_cuda(flow)
    if not is_octave(flow.shape, shape) or flow.shape[-1] != 2:
        raise ValueError(f"upsample_flow kernel: {tuple(flow.shape)} -> {shape} is not one octave "
                         "of a (..., h, w, 2) flow")
    if flow.dtype != torch.float32:
        raise ValueError(f"upsample_flow kernel: float32 flow only, got {flow.dtype}")
    lead, (h, w) = flow.shape[:-3], flow.shape[-3:-1]
    th, tw = shape
    src = flow.reshape(-1, h, w, 2).contiguous()
    if src.data_ptr() % 8:  # the kernel reads (u, v) as one float2
        src = src.clone()
    out = torch.empty((src.shape[0], th, tw, 2), dtype=torch.float32, device=dev)
    _build.launch(dev, "of2_upsample_flow", src.data_ptr(), out.data_ptr(), src.shape[0], h, w,
                  th, tw)
    upsample_flow.launches += 1
    return out.reshape(lead + (th, tw, 2))


upsample_flow.launches = 0


def handoff(flow: torch.Tensor, shape: tuple[int, int], use_pallas: bool) -> torch.Tensor:
    """A coarse-to-fine handoff of ``flow`` to a level of ``shape``: the
    kernel (:func:`upsample_flow`) with ``use_pallas`` and a one-octave
    step; :func:`upsample_flow_plain` otherwise, which is the JAX package's
    XLA composition without ``use_pallas`` and the bilinear resize for a
    step that is no octave (DIS with ``finest_level`` > 1)."""
    if use_pallas and is_octave(flow.shape, shape):
        return upsample_flow(flow, shape)
    return upsample_flow_plain(flow, shape)
