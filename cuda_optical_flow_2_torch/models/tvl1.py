"""TV-L1 dense optical flow: an L1 data term with total-variation
regularization (Zach, Pock & Bischof 2007; OpenCV's DualTVL1).

Counterpart of ``cuda_optical_flow_2_tpu.models.tvl1``.  Per warp, with u0
the flow the next frame was warped by and lt = lambda * theta:

    rho(u)  = It + (u - u0) . grad                    (linearized L1 residual)
    u      <- u + step + theta div(p_i) per component:
                 step = +lt grad    if rho < -lt |g|^2
                        -lt grad    if rho >  lt |g|^2
                        -rho grad / max(|g|^2, eps)   otherwise
    p_i    <- (p_i + tau/theta grad(u_i)) / (1 + tau/theta |grad(u_i)|)

with forward-difference gradients and the backward-difference divergence
(its negative adjoint), Neumann boundaries.

``config.use_pallas`` (default True) routes each warp's iterations through
the hand-written kernel ``kernels.tvl1_sweep.tvl1_relax`` and each warp
through ``kernels.warp_select`` (flow clipped to ``max_displacement``
first), and the per-warp median through ``kernels.median_select`` (sizes
3 and 5); for CPU tensors those wrappers take their plain versions.
``use_pallas=False`` is the plain composition (:func:`primal_dual`,
``ops.warp.warp_bilinear`` and ``ops.median.median_filter``), the JAX
package's XLA twin.  The pyramid and the optional prefilter are the LK
pipeline's.  Images (..., H, W), flows (..., H, W, 2).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from cuda_optical_flow_2_torch.config import BilateralConfig
from cuda_optical_flow_2_torch.kernels import median_select, tvl1_sweep, warp_select
from cuda_optical_flow_2_torch.models.horn_schunck import lk_preproc_config
from cuda_optical_flow_2_torch.models.lucas_kanade import preprocess
from cuda_optical_flow_2_torch.ops.clip import clip
from cuda_optical_flow_2_torch.ops.gradients import gradient_magnitude, spatial_gradients
from cuda_optical_flow_2_torch.ops.median import median_filter
from cuda_optical_flow_2_torch.ops.resize import upsample_flow
from cuda_optical_flow_2_torch.ops.warp import warp_bilinear

__all__ = [
    "TVL1Config",
    "TVL1_REALTIME",
    "primal_dual",
    "tvl1_level",
    "tvl1_coarse_to_fine",
    "tvl1_median",
    "tvl1_preprocess",
    "pyramidal_tvl1",
]


@dataclasses.dataclass(frozen=True)
class TVL1Config:
    """TV-L1 configuration: the JAX package's fields and defaults.

    Attributes:
      lambda_: data-term weight (larger = trust the data more, less smooth).
      theta: coupling between the data and regularization subproblems.
      tau: dual ascent step (<= 0.25 for stability).
      warps: re-linearizations (warps of the next frame) per level.
      iterations: primal-dual iterations per warp.
      levels: pyramid depth.
      epsilon: |grad|^2 floor in the threshold step's division.
      median_filtering: odd k applies a k x k median to the flow after each
        warp's iterations (OpenCV DualTVL1's medianBlur(5)); 0/1 disables.
      use_pallas: the hand-written kernel path (see the module docstring).
      max_displacement: warp budget of the kernel path, in pixels.
      d_local, c_max: TPU select-warp bounds; unused by the port.
      prefilter: optional joint-bilateral pre-smoothing, as in LKConfig.
    """

    lambda_: float = 0.15
    theta: float = 0.3
    tau: float = 0.25
    warps: int = 5
    iterations: int = 30
    levels: int = 5
    epsilon: float = 1e-6
    median_filtering: int = 5
    use_pallas: bool = True
    max_displacement: int = 32
    d_local: int = 7
    c_max: int = 1
    prefilter: Optional[BilateralConfig] = None

    def __post_init__(self) -> None:
        if self.levels < 1 or self.warps < 1 or self.iterations < 1:
            raise ValueError("levels, warps and iterations must be >= 1")
        if not (0.0 < self.tau <= 0.25):
            raise ValueError(f"tau must be in (0, 0.25], got {self.tau}")
        if self.lambda_ <= 0 or self.theta <= 0:
            raise ValueError("lambda_ and theta must be > 0")
        if self.epsilon <= 0:
            raise ValueError(f"epsilon must be > 0, got {self.epsilon}")
        if self.median_filtering not in (0, 1) and (
            self.median_filtering < 0 or self.median_filtering % 2 == 0
        ):
            raise ValueError(
                f"median_filtering must be 0/1 (off) or odd, got {self.median_filtering}"
            )


def _fwd_diff(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Forward difference with a Neumann (zero at the far edge) boundary."""
    n = x.shape[dim]
    d = x.narrow(dim, 1, n - 1) - x.narrow(dim, 0, n - 1)
    return torch.cat([d, torch.zeros_like(x.narrow(dim, 0, 1))], dim=dim)


def _div(px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """Backward-difference divergence, the negative adjoint of _fwd_diff."""

    def bwd(x: torch.Tensor, dim: int) -> torch.Tensor:
        # x[i] - x[i-1]; the first element keeps x[0], the last drops its own
        n = x.shape[dim]
        d = x.narrow(dim, 1, n - 2) - x.narrow(dim, 0, n - 2)
        return torch.cat([x.narrow(dim, 0, 1), d, -x.narrow(dim, n - 2, 1)], dim=dim)

    return bwd(px, -1) + bwd(py, -2)


def primal_dual(
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
    """The plain primal-dual scan of one linearization (the JAX package's
    XLA twin): ``warped`` is next warped by ``u0``, ``flow`` the start (the
    duals start at zero).  Returns the refined total flow (..., H, W, 2)."""
    gx, gy = spatial_gradients(warped.to(torch.float32), normalize=True)
    g2 = gx * gx + gy * gy
    g2s = clip(g2, eps)
    it = warped.to(torch.float32) - prev.to(torch.float32)
    lt = lambda_ * theta
    tt = tau / theta
    th = lt * g2
    flow = flow.to(torch.float32)
    u, v = flow[..., 0], flow[..., 1]
    u0u, u0v = u0[..., 0].to(torch.float32), u0[..., 1].to(torch.float32)
    p1x = p1y = p2x = p2y = torch.zeros_like(u)
    for _ in range(iterations):
        rho = it + (u - u0u) * gx + (v - u0v) * gy
        lo, hi = rho < -th, rho > th
        du = torch.where(lo, lt * gx, torch.where(hi, -lt * gx, -rho * gx / g2s))
        dv = torch.where(lo, lt * gy, torch.where(hi, -lt * gy, -rho * gy / g2s))
        u = u + du + theta * _div(p1x, p1y)
        v = v + dv + theta * _div(p2x, p2y)
        ux, uy = _fwd_diff(u, -1), _fwd_diff(u, -2)
        vx, vy = _fwd_diff(v, -1), _fwd_diff(v, -2)
        nu = 1.0 + tt * gradient_magnitude(ux, uy)
        nv = 1.0 + tt * gradient_magnitude(vx, vy)
        p1x, p1y = (p1x + tt * ux) / nu, (p1y + tt * uy) / nu
        p2x, p2y = (p2x + tt * vx) / nv, (p2y + tt * vy) / nv
    return torch.stack([u, v], dim=-1)


def tvl1_level(
    prev: torch.Tensor,
    warped: torch.Tensor,
    u0: torch.Tensor,
    flow: torch.Tensor,
    config: TVL1Config,
) -> torch.Tensor:
    """One linearization's primal-dual iterations: the kernel with
    ``use_pallas``, the plain scan without.  Returns the total flow."""
    relax = tvl1_sweep.tvl1_relax if config.use_pallas else tvl1_sweep.tvl1_relax_plain
    return relax(
        prev, warped, u0, flow, iterations=config.iterations, lambda_=config.lambda_,
        theta=config.theta, tau=config.tau, eps=config.epsilon,
    )


def tvl1_preprocess(frame: torch.Tensor, config: TVL1Config) -> list[torch.Tensor]:
    """Frame -> (optionally bilateral-filtered) Gaussian pyramid (shared with LK)."""
    return preprocess(frame, lk_preproc_config(config))


def tvl1_median(planes: torch.Tensor, config: TVL1Config) -> torch.Tensor:
    """The per-warp median of (..., H, W) flow planes: the CUDA kernel on the
    kernel path for a size it compiles, else the plain filter."""
    if config.use_pallas and median_select.supported(config.median_filtering):
        return median_select.median_filter_kernel(planes, config.median_filtering)
    return median_filter(planes, config.median_filtering)


def tvl1_coarse_to_fine(
    prev_pyr: list[torch.Tensor],
    next_pyr: list[torch.Tensor],
    config: TVL1Config,
    init_flow: torch.Tensor | None = None,
) -> torch.Tensor:
    """Coarse-to-fine TV-L1 over prebuilt pyramids; returns the finest flow.

    Every warp (the coarsest level's first one too, by zero flow) warps the
    next frame by the current total flow and runs ``config.iterations``
    primal-dual steps on the re-linearized residual, the duals from zero; the
    median filter then cleans the flow.  On the kernel path the flow is
    clipped to ``max_displacement`` before each warp.  ``init_flow``
    (coarsest-level resolution and units) warm-starts the coarsest level.
    """
    d = float(config.max_displacement)
    flow = init_flow
    for k in range(config.levels - 1, -1, -1):
        p, n = prev_pyr[k], next_pyr[k]
        if flow is None:
            flow = torch.zeros(p.shape + (2,), dtype=torch.float32, device=p.device)
        else:
            flow = upsample_flow(flow, tuple(p.shape[-2:]))
        for _ in range(config.warps):
            if config.use_pallas:
                flow = clip(flow, -d, d)
                warped = warp_select.warp_bilinear_select(n, flow, config.max_displacement)
            else:
                warped = warp_bilinear(n, flow)
            flow = tvl1_level(p, warped, flow, flow, config)
            if config.median_filtering > 1:
                flow = tvl1_median(flow.movedim(-1, 0), config).movedim(0, -1)
    return flow


def pyramidal_tvl1(prev: torch.Tensor, nxt: torch.Tensor, config: TVL1Config) -> torch.Tensor:
    """Dense TV-L1 flow (..., H, W, 2) from a planar grayscale pair.

    Both frames' pyramids are built in one stacked pass; the flow comes back
    on the frames' device.
    """
    if prev.shape != nxt.shape:
        raise ValueError(f"frame shapes differ: {tuple(prev.shape)} vs {tuple(nxt.shape)}")
    both = tvl1_preprocess(torch.stack([prev, nxt]).to(torch.float32), config)
    return tvl1_coarse_to_fine([lvl[0] for lvl in both], [lvl[1] for lvl in both], config)


# The JAX package's real-time operating point: 14 iterations fill one
# time-tile chunk of its TPU kernel; 4 warps over 4 levels.
TVL1_REALTIME = TVL1Config(levels=4, warps=4, iterations=14)
