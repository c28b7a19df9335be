"""Pyramid step kernel: 3x3 binomial blur + 2x subsample in one pass.

Replaces ``cuda_optical_flow_2_tpu/kernels/pyr_down.py::pyr_down_pallas``
(which the TPU never dispatched: Mosaic rejects its lane-strided slice).
CUDA source: ``csrc/pyr_down.cu``.  It computes::

    out[..., i, j] = sum_{p,q in 0..2} k[p] k[q] x[..., 2i+p-1, 2j+q-1]

with ``k = BINOMIAL_1D`` and zero outside the cropped ``2*oh x 2*ow``
source, the function of ``ops.pyramid.pyr_down``.

What bounds it on an H100: bytes.  Each output pixel reads a 3x3 patch
of which it owns four pixels and writes one: about 5 bytes moved per input
pixel against 17 flops per output.  The design is one thread per output
pixel, neighbouring threads on neighbouring outputs, the patch overlap left
to the L1 cache; the plain version's strided slices instead make eight
passes over the image.  The kernel takes element strides, so a flow
component (``flow[..., 0]``, stride 2) goes in without a copy.

:func:`pyr_down` launches the kernel for CUDA tensors and takes
:func:`pyr_down_plain` for CPU tensors; ``pyr_down.launches`` counts kernel
launches.
"""

from __future__ import annotations

import torch

from cuda_optical_flow_2_torch.kernels import _build
from cuda_optical_flow_2_torch.ops import pyramid

__all__ = ["pyr_down", "pyr_down_plain"]


def pyr_down_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: ``ops.pyramid.pyr_down`` without the kernel."""
    return pyramid.pyr_down(x, use_pallas=False)


def pyr_down(x: torch.Tensor) -> torch.Tensor:
    """Blur + 2x downsample: (..., H, W) -> (..., H//2, W//2) float32."""
    if x.device.type == "cpu":
        return pyr_down_plain(x)
    dev = _build.require_cuda(x)
    lead, (h, w) = x.shape[:-2], x.shape[-2:]
    oh, ow = h // 2, w // 2
    src = x.to(torch.float32).reshape(-1, h, w)
    out = torch.empty((src.shape[0], oh, ow), dtype=torch.float32, device=dev)
    _build.launch(dev, "of2_pyr_down", src.data_ptr(), out.data_ptr(), src.shape[0], oh, ow,
                  *src.stride())
    pyr_down.launches += 1
    return out.reshape(lead + (oh, ow))


pyr_down.launches = 0
