"""Joint-bilateral prefilter kernel: the whole tap loop in one pass.

Replaces ``cuda_optical_flow_2_tpu/kernels/bilateral_tap.py::bilateral_kernel``
(whole image; the spatial-TP ``bilateral_kernel_band`` is not ported yet).
CUDA source: ``csrc/bilateral.cu``.  It computes ``ops.bilateral
.bilateral_filter``: for each pixel and each tap inside the image,
``wgt = range_norm * exp(-(k*k) * inv_2s2) * spatial[m, n]`` with ``k`` the
guide difference, and ``num / den`` of the weighted sums.

What bounds it on an H100: operations, not bytes.  Each pixel reads one
image and one guide value and writes one, but takes ``window**2`` range
weights, each an accurate ``expf`` (one special-function-unit instruction
plus FP32 range reduction) and about eight FP32 operations: 81 taps at the
reference's 9x9.  The design stages a 16 x 32 tile plus its ``r``-pixel halo
of image and guide in shared memory once, so the taps read shared memory
only, and takes the spatial taps precomputed on the host in the kernel
parameters.  A tap is masked by testing its position against the image
bounds; the TPU kernel's trick of a ``+inf`` guide outside the image (NaN at
out-of-image centres, cropped there) has no counterpart: this kernel writes
in-image pixels only.

:func:`bilateral_kernel` launches the kernel for CUDA tensors and takes
:func:`bilateral_kernel_plain` for CPU tensors; ``bilateral_kernel.launches``
counts kernel launches.
"""

from __future__ import annotations

import numpy as np
import torch

from cuda_optical_flow_2_torch.kernels import _build
from cuda_optical_flow_2_torch.kernels.lk_fused import planes
from cuda_optical_flow_2_torch.ops.bilateral import bilateral_constants, bilateral_filter

__all__ = ["bilateral_kernel", "bilateral_kernel_plain", "MAX_WINDOW"]

MAX_WINDOW = 31  # csrc/bilateral.cu OF2_BL_MAX_R = 15


def bilateral_kernel_plain(
    img: torch.Tensor,
    window: int = 9,
    sigma_spatial: float = 2.0,
    sigma_range: float = 10.0,
    guide: torch.Tensor | None = None,
) -> torch.Tensor:
    """The plain PyTorch version: ``ops.bilateral.bilateral_filter``."""
    return bilateral_filter(img, guide, window, sigma_spatial, sigma_range)


def bilateral_kernel(
    img: torch.Tensor,
    window: int = 9,
    sigma_spatial: float = 2.0,
    sigma_range: float = 10.0,
    guide: torch.Tensor | None = None,
) -> torch.Tensor:
    """Bilateral of (..., H, W) float32 or uint8 images (guide defaults to
    the image); returns (..., H, W) float32."""
    tensors = (img,) if guide is None else (img, guide)
    if all(t.device.type == "cpu" for t in tensors):
        return bilateral_kernel_plain(img, window, sigma_spatial, sigma_range, guide)
    spatial, range_norm, inv_2s2 = bilateral_constants(window, sigma_spatial, sigma_range)
    if spatial.shape[0] > MAX_WINDOW:
        raise ValueError(
            f"the CUDA bilateral kernel takes window <= {MAX_WINDOW}, got {spatial.shape[0]}"
        )
    dev = _build.require_cuda(*tensors)
    if guide is not None and guide.shape != img.shape:
        raise ValueError(f"guide {tuple(guide.shape)} does not match image {tuple(img.shape)}")
    lead, (h, w) = img.shape[:-2], img.shape[-2:]
    (x,) = planes(img.reshape(-1, h, w))
    g = x if guide is None else planes(guide.reshape(-1, h, w))[0]
    out = torch.empty_like(x)
    taps = np.ascontiguousarray(spatial.ravel())
    _build.launch(
        dev, "of2_bilateral", x.data_ptr(), g.data_ptr(), out.data_ptr(), x.shape[0], h, w,
        spatial.shape[0] // 2, taps.ctypes.data, float(range_norm), float(inv_2s2),
    )
    bilateral_kernel.launches += 1
    return out.reshape(lead + (h, w))


bilateral_kernel.launches = 0
