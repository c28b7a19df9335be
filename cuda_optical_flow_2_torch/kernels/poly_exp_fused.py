"""Farnebäck polynomial-expansion kernel: the whole expansion in one pass.

Replaces ``cuda_optical_flow_2_tpu/kernels/poly_exp_fused.py::poly_expansion_kernel``.
CUDA source: ``csrc/poly_exp.cu`` with the two register-blocked passes of
``csrc/of2_poly.cuh``, which the fused FB step (``fb_step_fused``) runs too.
It computes ``ops.poly_exp.poly_expansion``: the zero-padded frame, three
vertical {g, g*o, g*o^2} correlations, six horizontal moments and the
constant G^-1 mixing, giving (bx, by, axx, ayy, axy).

What bounds it on an H100: bytes.  Per pixel it reads one float and writes
five (24 bytes) against 9 n + 30 multiply-adds of correlation and mixing
(186 FP32 operations at the default ``poly_n = 7``), under the card's 20
operations per byte.  The design keeps the memory pipe busy: a block owns
a tile of 20 x 128 outputs at every radius, stages it and its r-pixel halo
in shared memory with ``cp.async``, and runs both passes from registers (a
thread owns four cells of a pass), so it holds the staged rows only briefly
and several blocks stay resident on each SM, one block's loads and stores
overlapping another's passes.  A warp writes each output plane as 512
contiguous bytes, ``float4`` per thread.  ``poly_n = 7`` runs a kernel
compiled for its taps (:func:`compiled_in`); the plain version makes about
50 passes over device memory.  The taps and mixing rows are computed in
float64 on the host (``ops.poly_exp.poly_taps``) and passed as float32
kernel parameters.

:func:`poly_expansion_kernel` launches the kernel for CUDA tensors and takes
:func:`poly_expansion_plain` for CPU tensors; ``poly_expansion_kernel.launches``
counts kernel launches.  Over ``MAX_POLY_N`` the wrapper raises.
"""

from __future__ import annotations

import torch

from cuda_optical_flow_2_torch.kernels import _build
from cuda_optical_flow_2_torch.kernels.lk_fused import planes
from cuda_optical_flow_2_torch.ops.poly_exp import poly_expansion, poly_taps

__all__ = ["compiled_in", "poly_expansion_kernel", "poly_expansion_plain", "MAX_POLY_N"]

MAX_POLY_N = 31  # csrc/of2_poly.cuh OF2_POLY_MAX_R = 15


def compiled_in(n: int) -> bool:
    """Whether the C entry launches ``poly_n = n`` on the kernel compiled for
    its taps (else the generic one); builds the kernel library."""
    return bool(_build.library().of2_poly_exp_compiled(n // 2))


def poly_expansion_plain(
    f: torch.Tensor, n: int = 7, sigma: float = 1.5
) -> tuple[torch.Tensor, ...]:
    """The plain PyTorch version: ``ops.poly_exp.poly_expansion``."""
    return poly_expansion(f, n, sigma)


def checked_taps(n: int, sigma: float):
    """:func:`ops.poly_exp.poly_taps`, raising over the kernels' ``MAX_POLY_N``."""
    if n > MAX_POLY_N:
        raise ValueError(f"the CUDA expansion kernels take poly_n <= {MAX_POLY_N}, got {n}")
    return poly_taps(n, sigma)


def poly_expansion_kernel(
    f: torch.Tensor, n: int = 7, sigma: float = 1.5
) -> tuple[torch.Tensor, ...]:
    """(..., H, W) -> (bx, by, axx, ayy, axy), each (..., H, W) float32."""
    if f.device.type == "cpu":
        return poly_expansion_plain(f, n, sigma)
    taps, mix = checked_taps(n, sigma)
    dev = _build.require_cuda(f)
    lead, (h, w) = f.shape[:-2], f.shape[-2:]
    (x,) = planes(f.reshape(-1, h, w))
    out = torch.empty((5,) + x.shape, dtype=torch.float32, device=dev)
    _build.launch(
        dev, "of2_poly_exp", x.data_ptr(), out.data_ptr(), x.shape[0], h, w, n // 2,
        taps.ctypes.data, mix.ctypes.data,
    )
    poly_expansion_kernel.launches += 1
    return tuple(plane.reshape(lead + (h, w)) for plane in out.unbind(0))


poly_expansion_kernel.launches = 0
