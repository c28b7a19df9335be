"""TV-L1 relaxation kernel: every primal-dual iteration of one linearization
on the card.

Replaces ``cuda_optical_flow_2_tpu/kernels/tvl1_sweep.py::tvl1_relax``
(whole image; the spatial-TP ``tvl1_relax_band`` is not ported yet).  CUDA
source: ``csrc/tvl1_sweep.cu``.  It computes ``models.tvl1``'s plain scan:
from gx, gy = Sobel / 8 of ``warped`` (zero padding), ``th = lambda theta
|g|^2`` and ``it = warped - prev``, ``iterations`` steps of

    rho = it + (u - u0) . g
    u  <- u + threshold step(rho) + theta div(p1)     (v and p2 alike)
    p1 <- (p1 + tt grad u) / (1 + tt |grad u|)        (tt = tau / theta)

with Neumann forward differences and the duals starting at zero.  The JAX
kernel's chunk length ``MAX_ITERS`` does not change the result and the
kernel ignores it.

What bounds it on an H100: with the whole call counted once, operations:
eight divisions and square roots per pixel and iteration (about 0.055 ms
for 14 iterations at 1080x1920) against 32 bytes of frames and flows per
pixel for the call.  The design is the simple one, as ``hs_relax``'s: one
launch computes the constants (gx, gy, th, max(|g|^2, eps), it), then one
launch per iteration; each block stages the four duals of its 16 x 32 tile
and a one-pixel ring in shared memory, computes (u, v) over the tile plus
its right column and bottom row there, and writes the tile's new flow and
duals into ping-pong buffers.  Each iteration is therefore a pass over
device memory (about 76 bytes per pixel) and the kernel runs at the
bandwidth of that pass, not at its operation bound.  The TPU kernel's time
tiling (K iterations per band with a K-row halo) is the way to close the
gap, in a later change.  The C entry point issues every launch, so the
wrapper makes one ctypes call per warp.  The arithmetic is rounded step by
step in the plain version's order (no FMA), so near-ties of the threshold
step (``rho`` against ``+-th``) resolve as they do in the plain ops.

:func:`tvl1_relax` launches the kernels for CUDA tensors and takes
:func:`tvl1_relax_plain` for CPU tensors; ``tvl1_relax.launches`` counts
calls that launched (one per linearization, whatever its iteration count).
"""

from __future__ import annotations

import numpy as np
import torch

from cuda_optical_flow_2_torch.constants import MASKS
from cuda_optical_flow_2_torch.kernels import _build
from cuda_optical_flow_2_torch.kernels.lk_fused import planes
from cuda_optical_flow_2_torch.ops.gradients import SOBEL_GAIN

__all__ = ["tvl1_relax", "tvl1_relax_plain", "MAX_ITERS"]

# The JAX kernel's iterations per time-tiled chunk; the result does not
# depend on it (TVL1_REALTIME's 14 iterations fill one chunk there).
MAX_ITERS = 14

_MASKS = np.concatenate(
    [(MASKS["sobel_x"] / SOBEL_GAIN).ravel(), (MASKS["sobel_y"] / SOBEL_GAIN).ravel()]
).astype(np.float32)


def tvl1_relax_plain(
    prev: torch.Tensor,
    warped: torch.Tensor,
    u0: torch.Tensor,
    flow: torch.Tensor,
    *,
    iterations: int,
    lambda_: float,
    theta: float,
    tau: float,
    eps: float,
) -> torch.Tensor:
    """The plain PyTorch version: the primal-dual scan of ``models.tvl1``
    (the JAX package's XLA twin)."""
    from cuda_optical_flow_2_torch.models import tvl1

    return tvl1.primal_dual(
        prev, warped, u0, flow, iterations=iterations, lambda_=lambda_, theta=theta, tau=tau,
        eps=eps,
    )


def tvl1_relax(
    prev: torch.Tensor,
    warped: torch.Tensor,
    u0: torch.Tensor,
    flow: torch.Tensor,
    *,
    iterations: int,
    lambda_: float,
    theta: float,
    tau: float,
    eps: float,
) -> torch.Tensor:
    """``iterations`` TV-L1 primal-dual steps on (..., H, W) frames linearized
    at ``u0`` (..., H, W, 2), starting from ``flow``; returns the total flow
    (..., H, W, 2) float32."""
    tensors = (prev, warped, u0, flow)
    if all(t.device.type == "cpu" for t in tensors):
        return tvl1_relax_plain(
            prev, warped, u0, flow, iterations=iterations, lambda_=lambda_, theta=theta,
            tau=tau, eps=eps,
        )
    dev = _build.require_cuda(*tensors)
    lead, (h, w) = prev.shape[:-2], prev.shape[-2:]
    if warped.shape != prev.shape or u0.shape != prev.shape + (2,) or flow.shape != u0.shape:
        raise ValueError(
            f"shapes prev {tuple(prev.shape)}, warped {tuple(warped.shape)}, u0 "
            f"{tuple(u0.shape)}, flow {tuple(flow.shape)}: want (..., H, W) twice and "
            "(..., H, W, 2) twice"
        )
    if iterations <= 0:
        return flow.to(torch.float32)
    p, wp = planes(prev.reshape(-1, h, w), warped.reshape(-1, h, w))
    f0, f = planes(u0.reshape(-1, h, w, 2), flow.reshape(-1, h, w, 2))
    b = p.shape[0]
    out = torch.empty((b, h, w, 2), dtype=torch.float32, device=dev)
    scratch = torch.empty(15 * b * h * w, dtype=torch.float32, device=dev)
    _build.launch(
        dev, "of2_tvl1_relax", p.data_ptr(), wp.data_ptr(), f0.data_ptr(), f.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), b, h, w, int(iterations), _MASKS.ctypes.data,
        float(lambda_ * theta), float(theta), float(tau / theta), float(eps),
    )
    tvl1_relax.launches += 1
    return out.reshape(lead + (h, w, 2))


tvl1_relax.launches = 0
