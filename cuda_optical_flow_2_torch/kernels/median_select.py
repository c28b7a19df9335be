"""k x k spatial median with edge-replicated borders: TV-L1's flow cleaning.

Replaces ``cuda_optical_flow_2_tpu/ops/median.py::_median_network``, which
has no ``pallas_call`` (a min/max elimination that XLA fuses).  CUDA source:
``csrc/median_select.cu``.  It computes ``ops.median.median_filter``, which
stays the plain version: the median of each pixel's k x k neighbourhood of
an edge-replicated (OpenCV BORDER_REPLICATE) copy of each (H, W) plane.

What bounds it on an H100: bytes, 4 in and 4 out per pixel, against the
selection network's 174 min/max operations per output at 5x5 (30 at 3x3).
A block stages a 16 x 64 tile and its halo in shared memory, each source
position clamped to the image; a thread owns four outputs down a column,
loads the values they span into registers once, and runs a compare-exchange
network (opt_med25 / opt_med9) on each.  A selection returns one of its
inputs, so the kernel is bit-equal to the plain version (``torch.equal``;
``torch.median`` may return either zero of a +-0 tie), and every exchange
propagates NaN as ``torch.median`` does.

The kernel takes element strides, so TV-L1's ``flow.movedim(-1, 0)`` goes in
without a copy, and the output takes the input's memory layout
(``torch.empty_like``), so ``.movedim(0, -1)`` of it is the contiguous
flow again.

:func:`median_filter_kernel` launches the kernel for CUDA tensors and takes
:func:`median_filter_plain` for CPU tensors; ``median_filter_kernel.launches``
counts kernel launches.  Sizes other than :data:`SIZES` raise on CUDA;
callers ask :func:`supported` from the config and take the plain filter.
"""

from __future__ import annotations

import torch

from cuda_optical_flow_2_torch.kernels import _build
from cuda_optical_flow_2_torch.ops.median import median_filter as median_filter_plain

__all__ = ["median_filter_kernel", "median_filter_plain", "supported", "SIZES"]

SIZES = (3, 5)  # the networks compiled into csrc/median_select.cu


def supported(size: int) -> bool:
    """Whether the CUDA kernel takes this median size (compiled in)."""
    return size in SIZES


def median_filter_kernel(x: torch.Tensor, size: int = 5) -> torch.Tensor:
    """k x k spatial median of (..., H, W) tensors, edge-replicated borders."""
    if x.device.type == "cpu":
        return median_filter_plain(x, size)
    if not supported(size):
        raise ValueError(f"the CUDA median kernel takes sizes {SIZES}, got {size}")
    dev = _build.require_cuda(x)
    lead, (h, w) = x.shape[:-2], x.shape[-2:]
    src = x.to(torch.float32).reshape(-1, h, w)  # a view where the layout allows
    out = torch.empty_like(src)
    _build.launch(dev, "of2_median", src.data_ptr(), out.data_ptr(), src.shape[0], h, w, size,
                  *src.stride(), *out.stride())
    median_filter_kernel.launches += 1
    return out.reshape(lead + (h, w))


median_filter_kernel.launches = 0
