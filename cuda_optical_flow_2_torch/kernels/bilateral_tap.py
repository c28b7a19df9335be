"""Joint-bilateral prefilter kernel: the whole tap loop in one pass.

Replaces ``cuda_optical_flow_2_tpu/kernels/bilateral_tap.py``: the
whole-image ``bilateral_kernel`` and the spatial-TP band entry
``bilateral_kernel_band``.  CUDA source: ``csrc/bilateral.cu``.  It computes
``ops.bilateral.bilateral_filter``: for each pixel and each tap inside the
image, ``wgt = range_norm * exp(-(k*k) * inv_2s2) * spatial[m, n]`` with
``k`` the guide difference, and ``num / den`` of the weighted sums.

What bounds it on an H100: operations, not bytes.  Each pixel reads one
image and one guide value and writes one, but takes ``window**2`` range
weights: 81 at the reference's 9x9.  Each weight takes one exponential,
and the card's special-function units issue those 16 per clock per SM, an
eighth of the FP32 rate, so the design leaves each tap little more than
its exponential:

- the weight is one ``ex2.approx`` (about 2 ulp) of a pre-scaled argument,
  ``2^(k*k * nc + lw[m, n])`` with ``nc = -inv_2s2 * log2(e)`` and ``lw =
  log2(range_norm * spatial)`` computed on the host in float64.  The
  accurate ``expf`` would add a range reduction per tap; folding the
  constants into the exponent changes only rounding (``range_norm`` cancels
  in ``num / den``), which the card holds within ``chip_smoke.py``'s
  ``BILATERAL_MAX_ERR``;
- a thread owns four outputs along a row and reads each (guide, image) pair
  of a tap row once from shared memory, where a 32 x 32 tile and its
  ``r``-pixel halo are staged;
- no tap is tested against the image bounds: a position outside the global
  image is staged with a ``+inf`` guide, whose weight ``2^-inf`` is exactly
  ``+0`` and adds exactly nothing to ``num`` and ``den``, as the plain
  version's masked weight does.  Unlike the TPU kernel's ``+inf`` trick no
  centre is ever out of the image: such pixels are written as zero;
- the reference's window 9 runs a kernel compiled for its taps, any other
  window up to ``MAX_WINDOW`` a generic one (:func:`compiled_in` asks the
  C dispatch which).

The band entry passes the band's global row ``row0`` and the image height
``h_global``: positions are staged on global rows, a tap inside the image
but outside the band reads zero, and pixels outside the global image are
written as zero (the plain version is
``ops.bilateral.bilateral_filter_band``); the whole-image entry is the band
``(0, H)``.  Every tile runs the same loop, so band rows are bit-equal to
the whole image's rows.

:func:`bilateral_kernel` and :func:`bilateral_kernel_band` launch the
kernel for CUDA tensors and take their plain versions for CPU tensors;
``.launches`` on each counts its kernel launches.
"""

from __future__ import annotations

import numpy as np
import torch

from cuda_optical_flow_2_torch.kernels import _build
from cuda_optical_flow_2_torch.kernels.lk_fused import planes
from cuda_optical_flow_2_torch.ops.bilateral import (
    bilateral_constants,
    bilateral_filter,
    bilateral_filter_band,
)

__all__ = [
    "bilateral_kernel",
    "bilateral_kernel_band",
    "bilateral_kernel_band_plain",
    "bilateral_kernel_plain",
    "compiled_in",
    "supported",
    "MAX_WINDOW",
]

MAX_WINDOW = 31  # csrc/bilateral.cu OF2_BL_MAX_R = 15


def supported(window: int) -> bool:
    """Whether the CUDA bilateral kernel (both entries) takes this window:
    at most ``MAX_WINDOW``.  The config-only counterpart of the JAX
    ``supported``; past the limit the callers take the plain filter, and
    the wrappers raise when called directly."""
    return window <= MAX_WINDOW


def compiled_in(window: int) -> bool:
    """Whether the C entry launches ``window`` on the kernel compiled for its
    taps (else the generic one); builds the kernel library."""
    return bool(_build.library().of2_bilateral_compiled(window // 2))


def bilateral_kernel_plain(
    img: torch.Tensor,
    window: int = 9,
    sigma_spatial: float = 2.0,
    sigma_range: float = 10.0,
    guide: torch.Tensor | None = None,
) -> torch.Tensor:
    """The plain PyTorch version: ``ops.bilateral.bilateral_filter``."""
    return bilateral_filter(img, guide, window, sigma_spatial, sigma_range)


def bilateral_kernel_band_plain(
    img_band: torch.Tensor,
    row0: int,
    h_global: int,
    window: int = 9,
    sigma_spatial: float = 2.0,
    sigma_range: float = 10.0,
) -> torch.Tensor:
    """The plain PyTorch version of the band entry:
    ``ops.bilateral.bilateral_filter_band``."""
    return bilateral_filter_band(img_band, row0, h_global, window, sigma_spatial, sigma_range)


def _launch(img, guide, window, sigma_spatial, sigma_range, row0, h_global) -> torch.Tensor:
    spatial, range_norm, inv_2s2 = bilateral_constants(window, sigma_spatial, sigma_range)
    if spatial.shape[0] > MAX_WINDOW:
        raise ValueError(
            f"the CUDA bilateral kernel takes window <= {MAX_WINDOW}, got {spatial.shape[0]}"
        )
    dev = _build.require_cuda(*((img,) if guide is None else (img, guide)))
    if guide is not None and guide.shape != img.shape:
        raise ValueError(f"guide {tuple(guide.shape)} does not match image {tuple(img.shape)}")
    lead, (h, w) = img.shape[:-2], img.shape[-2:]
    (x,) = planes(img.reshape(-1, h, w))
    g = x if guide is None else planes(guide.reshape(-1, h, w))[0]
    out = torch.empty_like(x)
    taps = np.ascontiguousarray(spatial.ravel())
    _build.launch(
        dev, "of2_bilateral", x.data_ptr(), g.data_ptr(), out.data_ptr(), x.shape[0], h, w,
        int(row0), int(h_global), spatial.shape[0] // 2, taps.ctypes.data, float(range_norm),
        float(inv_2s2),
    )
    return out.reshape(lead + (h, w))


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
    out = _launch(img, guide, window, sigma_spatial, sigma_range, 0, img.shape[-2])
    bilateral_kernel.launches += 1
    return out


def bilateral_kernel_band(
    img_band: torch.Tensor,
    row0: int,
    h_global: int,
    window: int = 9,
    sigma_spatial: float = 2.0,
    sigma_range: float = 10.0,
) -> torch.Tensor:
    """Self-guided bilateral on a row band holding global rows
    [row0, row0 + HB) of an ``h_global``-row image (the spatial-TP entry).
    Rows at least ``window // 2`` from the band edges match
    :func:`bilateral_kernel` on the whole image; band-edge rows are for the
    caller to crop."""
    if img_band.device.type == "cpu":
        return bilateral_kernel_band_plain(img_band, row0, h_global, window, sigma_spatial,
                                           sigma_range)
    out = _launch(img_band, None, window, sigma_spatial, sigma_range, row0, h_global)
    bilateral_kernel_band.launches += 1
    return out


bilateral_kernel.launches = 0
bilateral_kernel_band.launches = 0
