"""TV-L1 relaxation kernel: every primal-dual iteration of one linearization
on the card.

Replaces ``cuda_optical_flow_2_tpu/kernels/tvl1_sweep.py``: the whole-image
``tvl1_relax`` and the spatial-TP band entry ``tvl1_relax_band``.  CUDA
source: ``csrc/tvl1_sweep.cu``.  It computes ``models.tvl1``'s plain scan:
from gx, gy = Sobel / 8 of ``warped`` (zero padding), ``th = lambda theta
|g|^2`` and ``it = warped - prev``, ``iterations`` steps of

    rho = it + (u - u0) . g
    u  <- u + threshold step(rho) + theta div(p1)     (v and p2 alike)
    p1 <- (p1 + tt grad u) / (1 + tt |grad u|)        (tt = tau / theta)

with Neumann forward differences and the duals starting at zero.  The JAX
kernel's chunk length ``MAX_ITERS`` does not change the whole image's
result and the whole-image entry ignores it.

What bounds it on an H100: with the whole call counted once, operations:
eight divisions and square roots per pixel and iteration (about 0.055 ms
for 14 iterations at 1080x1920) against 32 bytes of frames and flows per
pixel for the call.  The design is time tiling, the TPU kernel's K
iterations per resident band carried over to 64 x 64 tiles in shared
memory.  One launch computes the constants (gx, gy, th, max(|g|^2, eps),
it); then each launch runs up to ``ITERS_PER_LAUNCH`` (K) iterations on
each tile, with the six state planes in shared memory and each pixel's
constants and u0 in the registers of the thread that owns it, and writes
back only the tile's inner (64 - 2R)^2 pixels.  One iteration reaches one
cell up and left (the divergence) and one down and right (the forward
differences), so a ring of ``ring(k)`` = k cells keeps the written pixels
exact; the neighbouring tiles recompute the ring (64 % more cell updates
for a launch of 7).  A call of n iterations runs in ceil(n / K) tile
launches of near equal length, so the state makes one pass over device
memory per launch, not per iteration.  The C entry point issues every
launch, so the wrapper makes one ctypes call per warp.  The arithmetic is
rounded step by step in the plain version's order (no FMA, no reciprocal
multiply), and a pixel's arithmetic does not depend on its tile, so
near-ties of the threshold step (``rho`` against ``+-th``) resolve as they
do in the plain ops and the kernel is bit-equal to the plain version on
the card.

The band entry runs one chunk of at most ``MAX_ITERS`` iterations on a
band holding global rows [row0, row0 + HB) of an ``h_global``-row image,
with the six state planes (u, v, p1x, p1y, p2x, p2y) in and out, so spatial
TP can exchange them between chunks.  gx, gy and (u, v) are zero outside
the global image, and the forward differences are zero at its last row and
column, so with a caller halo of iterations + 2 rows the kept rows match
the whole image.  The whole-image entry is the band ``(0, H)`` with zero
duals.  The band's plain version rounds as ``models.tvl1.primal_dual``
(``rho = it + (u - u0) . g``; the JAX band twin folds ``u0`` into ``it``
first), so the kernel stays bit-equal to it on the card.

:func:`tvl1_relax` and :func:`tvl1_relax_band` launch the kernels for CUDA
tensors and take their plain versions for CPU tensors; ``.launches`` on
each counts calls that launched (one per call, whatever its iteration
count).
"""

from __future__ import annotations

import numpy as np
import torch

from cuda_optical_flow_2_torch.constants import MASKS
from cuda_optical_flow_2_torch.kernels import _build
from cuda_optical_flow_2_torch.kernels.lk_fused import planes
from cuda_optical_flow_2_torch.ops.band import rows_in_image
from cuda_optical_flow_2_torch.ops.gradients import SOBEL_GAIN, gradient_magnitude, spatial_gradients

__all__ = [
    "tvl1_relax",
    "tvl1_relax_band",
    "tvl1_relax_band_plain",
    "tvl1_relax_plain",
    "MAX_ITERS",
    "ITERS_PER_LAUNCH",
    "launch_iterations",
    "ring",
]

# The JAX kernel's iterations per time-tiled chunk: the band entry's limit
# per call; the whole image's result does not depend on it
# (TVL1_REALTIME's 14 iterations fill one chunk there).
MAX_ITERS = 14

# K: iterations per launch (each on 64 x 64 tiles with a ring of K cells);
# the result does not depend on it.
ITERS_PER_LAUNCH = 8

_MASKS = np.concatenate(
    [(MASKS["sobel_x"] / SOBEL_GAIN).ravel(), (MASKS["sobel_y"] / SOBEL_GAIN).ravel()]
).astype(np.float32)


def ring(k: int) -> int:
    """The tile ring, in cells, of a launch of ``k`` iterations: the
    kernel writes back the pixels at least this far from its tile's edge."""
    return k


def launch_iterations(iterations: int) -> list[int]:
    """The iterations of each tile launch of a call: ceil(iterations / K)
    launches of near equal length (``of2_part`` in ``csrc/of2_tile.cuh``)."""
    n = -(-iterations // ITERS_PER_LAUNCH)
    return [iterations // n + (j < iterations % n) for j in range(n)]


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


def tvl1_relax_band_plain(
    prev: torch.Tensor,
    warped: torch.Tensor,
    u0: torch.Tensor,
    state: tuple[torch.Tensor, ...],
    row0: int,
    h_global: int,
    *,
    iterations: int,
    lambda_: float,
    theta: float,
    tau: float,
    eps: float,
) -> tuple[torch.Tensor, ...]:
    """The plain PyTorch version of the band entry: :func:`band_constants`
    then :func:`primal_dual_band` on the whole band (the JAX package's
    ``_tvl1_constants`` and ``_tvl1_pd_band``)."""
    _check_chunk(iterations)
    consts = band_constants(prev, warped, u0, row0, h_global, lambda_=lambda_, theta=theta,
                            eps=eps)
    return primal_dual_band(consts, state, row0, h_global, iterations=iterations,
                            lambda_=lambda_, theta=theta, tau=tau)


def band_constants(
    prev: torch.Tensor,
    warped: torch.Tensor,
    u0: torch.Tensor,
    row0: int,
    h_global: int,
    *,
    lambda_: float,
    theta: float,
    eps: float,
) -> tuple[torch.Tensor, ...]:
    """One linearization's constant planes on a band, (gx, gy, it, th, g2s,
    u0u, u0v): gx, gy = Sobel / 8 of ``warped``, zero outside the global
    image; th = lambda theta |g|^2, g2s = max(|g|^2, eps), it = warped -
    prev.  Computed on a band 2 rows wider than the iterations' band, the
    Sobel ring's band-edge error never reaches the kept rows."""
    inside = rows_in_image(prev.shape[-2], row0, h_global, prev.device)
    warped = warped.to(torch.float32)
    gx, gy = (torch.where(inside, g, 0.0) for g in spatial_gradients(warped, normalize=True))
    g2 = gx * gx + gy * gy
    return (gx, gy, warped - prev.to(torch.float32), lambda_ * theta * g2,
            torch.clamp_min(g2, eps), u0[..., 0].to(torch.float32),
            u0[..., 1].to(torch.float32))


def primal_dual_band(
    consts: tuple[torch.Tensor, ...],
    state: tuple[torch.Tensor, ...],
    row0: int,
    h_global: int,
    *,
    iterations: int,
    lambda_: float,
    theta: float,
    tau: float,
) -> tuple[torch.Tensor, ...]:
    """``iterations`` primal-dual steps on a band from ``state`` (u, v, p1x,
    p1y, p2x, p2y), global-edge exact: the primal is zero outside the global
    image and the forward differences are zero at its last row and column,
    which keeps the duals zero there, so the zero-filled backward divergence
    gives the whole image's special cases.  Band-edge staleness advances one
    row per iteration, for the caller to crop."""
    gx, gy, it, th, g2s, u0u, u0v = consts
    state = tuple(x.to(torch.float32) for x in state)
    h, w = gx.shape[-2:]
    inside = rows_in_image(h, row0, h_global, gx.device)
    rows = torch.arange(h, device=gx.device)[:, None] + row0
    fd_ok_y = inside & (rows < h_global - 1)
    fd_ok_x = inside & (torch.arange(w, device=gx.device) < w - 1)
    lt = lambda_ * theta
    tt = tau / theta

    def fd(x, ok, dim):
        return torch.where(ok, _shift(x, 1, dim) - x, 0.0)

    def div(px, py):
        return (px - _shift(px, -1, -1)) + (py - _shift(py, -1, -2))

    u, v, p1x, p1y, p2x, p2y = state
    for _ in range(iterations):
        rho = it + (u - u0u) * gx + (v - u0v) * gy
        lo, hi = rho < -th, rho > th
        du = torch.where(lo, lt * gx, torch.where(hi, -lt * gx, -rho * gx / g2s))
        dv = torch.where(lo, lt * gy, torch.where(hi, -lt * gy, -rho * gy / g2s))
        u = torch.where(inside, u + du + theta * div(p1x, p1y), 0.0)
        v = torch.where(inside, v + dv + theta * div(p2x, p2y), 0.0)
        ux, uy = fd(u, fd_ok_x, -1), fd(u, fd_ok_y, -2)
        vx, vy = fd(v, fd_ok_x, -1), fd(v, fd_ok_y, -2)
        nu = 1.0 + tt * gradient_magnitude(ux, uy)
        nv = 1.0 + tt * gradient_magnitude(vx, vy)
        p1x, p1y = (p1x + tt * ux) / nu, (p1y + tt * uy) / nu
        p2x, p2y = (p2x + tt * vx) / nv, (p2y + tt * vy) / nv
    return u, v, p1x, p1y, p2x, p2y


def _shift(x: torch.Tensor, d: int, dim: int) -> torch.Tensor:
    """out[i] = x[i + d] along ``dim`` (d = +-1), zero past the edge."""
    n = x.shape[dim]
    zero = torch.zeros_like(x.narrow(dim, 0, 1))
    if d > 0:
        return torch.cat([x.narrow(dim, 1, n - 1), zero], dim=dim)
    return torch.cat([zero, x.narrow(dim, 0, n - 1)], dim=dim)


def _check_chunk(iterations: int) -> None:
    if iterations > MAX_ITERS:
        raise ValueError(f"tvl1_relax_band runs one chunk: {iterations} > {MAX_ITERS}")


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
    _check_shapes(prev, warped, u0, flow)
    if iterations <= 0:
        return flow.to(torch.float32)
    out, _ = _launch(prev, warped, u0, flow, None, 0, prev.shape[-2], iterations, lambda_,
                     theta, tau, eps)
    tvl1_relax.launches += 1
    return out


def tvl1_relax_band(
    prev: torch.Tensor,
    warped: torch.Tensor,
    u0: torch.Tensor,
    state: tuple[torch.Tensor, ...],
    row0: int,
    h_global: int,
    *,
    iterations: int,
    lambda_: float,
    theta: float,
    tau: float,
    eps: float,
) -> tuple[torch.Tensor, ...]:
    """ONE chunk of ``iterations`` (<= ``MAX_ITERS``) primal-dual steps on a
    row band holding global rows [row0, row0 + HB) of an ``h_global``-row
    image (the spatial-TP entry, ``parallel/spatial_models.py``).

    ``prev``/``warped`` are (..., HB, W) frame bands, ``u0`` the
    (..., HB, W, 2) warp point and ``state`` the six planes (u, v, p1x, p1y,
    p2x, p2y), each (..., HB, W); returns the six planes after the chunk.
    With a caller halo of ``iterations + 2`` real rows (the Sobel ring and
    one row of band-edge staleness per iteration) the kept rows match the
    whole image; band-edge rows are for the caller to crop.
    """
    _check_chunk(iterations)
    tensors = (prev, warped, u0, *state)
    if all(t.device.type == "cpu" for t in tensors):
        return tvl1_relax_band_plain(
            prev, warped, u0, state, row0, h_global, iterations=iterations, lambda_=lambda_,
            theta=theta, tau=tau, eps=eps,
        )
    if len(state) != 6 or any(x.shape != prev.shape for x in state):
        raise ValueError(f"state must be six planes of shape {tuple(prev.shape)}")
    flow = torch.stack(state[:2], dim=-1)
    _check_shapes(prev, warped, u0, flow)
    if iterations <= 0:
        return tuple(x.to(torch.float32) for x in state)
    duals = torch.stack(state[2:], dim=-1)
    out, duals = _launch(prev, warped, u0, flow, duals, row0, h_global, iterations, lambda_,
                         theta, tau, eps)
    tvl1_relax_band.launches += 1
    return (*out.unbind(-1), *duals.unbind(-1))


def _check_shapes(prev, warped, u0, flow) -> None:
    if warped.shape != prev.shape or u0.shape != prev.shape + (2,) or flow.shape != u0.shape:
        raise ValueError(
            f"shapes prev {tuple(prev.shape)}, warped {tuple(warped.shape)}, u0 "
            f"{tuple(u0.shape)}, flow {tuple(flow.shape)}: want (..., H, W) twice and "
            "(..., H, W, 2) twice"
        )


def _launch(prev, warped, u0, flow, duals, row0, h_global, iterations, lambda_, theta, tau,
            eps) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Launch the kernels: the flow (..., H, W, 2) and, when ``duals``
    (..., H, W, 4) came in, the duals after the last iteration."""
    tensors = (prev, warped, u0, flow) + (() if duals is None else (duals,))
    dev = _build.require_cuda(*tensors)
    lead, (h, w) = prev.shape[:-2], prev.shape[-2:]
    p, wp = planes(prev.reshape(-1, h, w), warped.reshape(-1, h, w))
    f0, f = planes(u0.reshape(-1, h, w, 2), flow.reshape(-1, h, w, 2))
    b = p.shape[0]
    out = torch.empty((b, h, w, 2), dtype=torch.float32, device=dev)
    d_in = d_out = None
    if duals is not None:
        (d_in,) = planes(duals.reshape(-1, h, w, 4))
        d_out = torch.empty_like(d_in)
    n2 = b * h * w + (b * h * w) % 2  # keeps the float4 scratch planes 16-byte aligned
    slots = min(len(launch_iterations(iterations)) - 1, 2)
    scratch = torch.empty((5 + 6 * slots) * n2, dtype=torch.float32, device=dev)
    _build.launch(
        dev, "of2_tvl1_relax", p.data_ptr(), wp.data_ptr(), f0.data_ptr(), f.data_ptr(),
        None if d_in is None else d_in.data_ptr(), out.data_ptr(),
        None if d_out is None else d_out.data_ptr(), scratch.data_ptr(), b, h, w, int(row0),
        int(h_global), int(iterations), ITERS_PER_LAUNCH, _MASKS.ctypes.data,
        float(lambda_ * theta), float(theta), float(tau / theta), float(eps),
    )
    out = out.reshape(lead + (h, w, 2))
    return out, None if d_out is None else d_out.reshape(lead + (h, w, 4))


tvl1_relax.launches = 0
tvl1_relax_band.launches = 0
