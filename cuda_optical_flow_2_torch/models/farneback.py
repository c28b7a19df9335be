"""Farnebäck dense optical flow: the polynomial-expansion family.

Counterpart of ``cuda_optical_flow_2_tpu.models.farneback``.  Each frame is
approximated per pixel by a quadratic polynomial (``ops.poly_exp``), and the
displacement follows in closed form from how the coefficients move between
frames (Farnebäck 2003).  With the flow convention prev(x) = next(x + d),
B2 and A2 the coefficients of the next frame warped by the current flow:

    A(x)  = (A1(x) + A2(x)) / 2
    db(x) = (b1(x) - B2(x)) / 2 + A(x) d0
    d     = (sum_w A^T A)^{-1} (sum_w A^T db)       [total flow, not residual]

Two formulations of the per-iteration warp (``FBConfig.warp_planes``):
"image" (default) warps the next FRAME and re-expands it; "coeff" warps the
five expansion planes (cv::calcOpticalFlowFarneback's formulation).

``config.use_pallas`` (default True) routes the work through the
hand-written kernels: the expansion (``kernels.poly_exp_fused``), the
"image" iteration as one fused kernel (``kernels.fb_step_fused``), and in
the "coeff" form the five-plane warp (``kernels.warp_select``) and the window
solve (``kernels.win_solve``); the pyramid and the optional prefilter are the
LK pipeline's (``models.lucas_kanade.preprocess``).  Which kernel runs is
decided from the config alone, where the JAX package asks ``supported()``:
a Gaussian window, or a window or ``poly_n`` beyond a kernel's limit, takes
the plain composition for that stage.  For CPU tensors every wrapper takes
its plain version.  ``use_pallas=False`` is the plain composition, the JAX
package's XLA twin.  Both paths clip the flow to ``max_displacement`` before
each warp, as the JAX package's XLA path does.  Images (..., H, W), flows
(..., H, W, 2).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from cuda_optical_flow_2_torch.config import BilateralConfig
from cuda_optical_flow_2_torch.kernels import (
    fb_step_fused,
    poly_exp_fused,
    warp_select,
    win_solve,
)
from cuda_optical_flow_2_torch.models.horn_schunck import lk_preproc_config
from cuda_optical_flow_2_torch.models.lucas_kanade import preprocess
from cuda_optical_flow_2_torch.ops.clip import clip
from cuda_optical_flow_2_torch.ops.conv import sep_conv2d
from cuda_optical_flow_2_torch.ops.poly_exp import gaussian_1d, poly_expansion
from cuda_optical_flow_2_torch.ops.resize import upsample_flow
from cuda_optical_flow_2_torch.ops.warp import warp_bilinear
from cuda_optical_flow_2_torch.ops.window import window_sum

__all__ = [
    "FBConfig",
    "fb_level",
    "fb_level_image",
    "fb_normal_eq_products",
    "solve_normal_eqs",
    "fb_coarse_to_fine",
    "fb_preprocess",
    "pyramidal_farneback",
]


@dataclasses.dataclass(frozen=True)
class FBConfig:
    """Farnebäck configuration: the JAX package's fields and defaults.

    Defaults follow the classic operating point (cv::calcOpticalFlowFarneback
    with poly_n=7): 3 pyramid levels, 3 iterations per level, 15x15 window.

    Attributes:
      levels: pyramid depth (2x decimation per level).
      iterations: displacement refinements per level.
      poly_n / poly_sigma: expansion neighbourhood size and applicability
        sigma (classic pairs: 5/1.1, 7/1.5).
      winsize: averaging window of the normal equations.
      gaussian_window: weight the window by a Gaussian (sigma = winsize/4)
        instead of a flat box.
      det_eps: |det| guard of the 2x2 solve (0 flow where singular).
      use_pallas: the hand-written kernel path (see the module docstring).
      max_displacement: warp budget in pixels, both paths.
      d_local, c_max: TPU select-warp bounds; validated, unused by the port.
      warp_planes: "image" (warp the next frame and re-expand) or "coeff"
        (warp the five coefficient planes).
      prefilter: optional joint-bilateral pre-smoothing, as in LKConfig.
    """

    levels: int = 3
    iterations: int = 3
    poly_n: int = 7
    poly_sigma: float = 1.5
    winsize: int = 15
    gaussian_window: bool = False
    det_eps: float = 1e-6
    use_pallas: bool = True
    max_displacement: int = 32
    d_local: int = 7
    c_max: int = 1
    warp_planes: str = "image"
    prefilter: Optional[BilateralConfig] = None

    def __post_init__(self) -> None:
        if self.levels < 1 or self.iterations < 1:
            raise ValueError("levels and iterations must be >= 1")
        if self.poly_n % 2 != 1 or self.poly_n < 3:
            raise ValueError(f"poly_n must be odd >= 3, got {self.poly_n}")
        if self.winsize % 2 != 1:
            raise ValueError(f"winsize must be odd, got {self.winsize}")
        if self.poly_sigma <= 0:
            raise ValueError(f"poly_sigma must be > 0, got {self.poly_sigma}")
        if self.c_max < 0:
            raise ValueError(f"c_max must be >= 0, got {self.c_max}")
        if self.warp_planes not in ("image", "coeff"):
            raise ValueError(f"warp_planes must be 'image' or 'coeff', got {self.warp_planes}")


def _expand(frame: torch.Tensor, config: FBConfig) -> tuple[torch.Tensor, ...]:
    """Polynomial expansion, through the kernel when the config allows it."""
    if config.use_pallas and config.poly_n <= poly_exp_fused.MAX_POLY_N:
        return poly_exp_fused.poly_expansion_kernel(frame, config.poly_n, config.poly_sigma)
    return poly_expansion(frame, config.poly_n, config.poly_sigma)


def _window(x: torch.Tensor, config: FBConfig) -> torch.Tensor:
    """Normal-equation averaging window (normalization cancels in the solve)."""
    if config.gaussian_window:
        g = gaussian_1d(config.winsize, config.winsize / 4.0)
        return sep_conv2d(x, g, g)
    return window_sum(x, config.winsize)


def _warp(config: FBConfig):
    """The warp of the (already clipped) flow: kernel #3 or the plain gather."""
    if config.use_pallas:
        return functools.partial(
            warp_select.warp_bilinear_select, max_displacement=config.max_displacement
        )
    return warp_bilinear


def _clip(flow: torch.Tensor, config: FBConfig) -> torch.Tensor:
    d = float(config.max_displacement)
    return clip(flow, -d, d)


def fb_normal_eq_products(exp1, warped_exp, u, v):
    """Per-pixel Farnebäck normal-equation products for one iteration.

    ``exp1`` / ``warped_exp`` are the (bx, by, axx, ayy, axy) expansion
    planes of frame 1 and of the warped frame 2; ``u, v`` the flow the warp
    used.  Returns the 5 pre-window products (g11, g12, g22, h1, h2); the
    CUDA kernels carry the same algebra (``csrc/of2_poly.cuh``).
    """
    bx1, by1, axx1, ayy1, axy1 = exp1
    w_bx, w_by, w_axx, w_ayy, w_axy = warped_exp
    axx = 0.5 * (axx1 + w_axx)
    ayy = 0.5 * (ayy1 + w_ayy)
    axy = 0.5 * (axy1 + w_axy)
    db_x = 0.5 * (bx1 - w_bx) + axx * u + axy * v
    db_y = 0.5 * (by1 - w_by) + axy * u + ayy * v
    return (
        axx * axx + axy * axy,
        axy * (axx + ayy),
        axy * axy + ayy * ayy,
        axx * db_x + axy * db_y,
        axy * db_x + ayy * db_y,
    )


def solve_normal_eqs(sums: torch.Tensor, det_eps: float) -> torch.Tensor:
    """Guarded 2x2 solve of the windowed normal equations.

    ``sums`` stacks (g11, g12, g22, h1, h2); pixels with |det| < det_eps (or
    a NaN det) get zero flow; det_eps <= 0 divides by every other det.
    """
    g11, g12, g22, h1, h2 = sums.unbind(0)
    det = g11 * g22 - g12 * g12
    safe = det.abs() >= det_eps
    inv_det = 1.0 / torch.where(safe, det, torch.ones_like(det))
    zero = torch.zeros_like(det)
    u_new = torch.where(safe, (g22 * h1 - g12 * h2) * inv_det, zero)
    v_new = torch.where(safe, (g11 * h2 - g12 * h1) * inv_det, zero)
    return torch.stack([u_new, v_new], dim=-1)


def _window_solve(prods, config: FBConfig) -> torch.Tensor:
    """Window the products and solve: kernel #10 for a box window within its
    limit on the kernel path, else the plain window and solve."""
    if (config.use_pallas and not config.gaussian_window
            and config.winsize <= win_solve.MAX_WINDOW):
        return win_solve.window_solve(*prods, window=config.winsize, det_eps=config.det_eps)
    return solve_normal_eqs(_window(torch.stack(prods), config), config.det_eps)


def fb_level(
    exp1: tuple[torch.Tensor, ...],
    exp2: tuple[torch.Tensor, ...],
    flow: torch.Tensor | None,
    config: FBConfig,
) -> torch.Tensor:
    """``config.iterations`` refinements from two expansions ("coeff" form):
    each warps the five planes of ``exp2`` by the clipped total flow.
    ``flow`` is the prior total flow (or None).  Returns the total flow."""
    planes2 = torch.stack(exp2)  # (5, ..., H, W)
    warp = _warp(config)
    for _ in range(config.iterations):
        if flow is None:
            warped = exp2
            u = v = torch.zeros_like(exp1[0])
        else:
            flow = _clip(flow, config)
            warped = warp(planes2, flow.expand(planes2.shape + (2,))).unbind(0)
            u, v = flow[..., 0], flow[..., 1]
        flow = _window_solve(fb_normal_eq_products(exp1, warped, u, v), config)
    return flow


def fb_level_image(
    nxt: torch.Tensor,
    exp1: tuple[torch.Tensor, ...],
    flow: torch.Tensor | None,
    config: FBConfig,
) -> torch.Tensor:
    """``config.iterations`` refinements, image-warp formulation: each warps
    the next frame by the clipped total flow, re-expands it and solves.  On
    the kernel path with a box window each iteration is one launch of
    ``kernels.fb_step_fused``."""
    if config.use_pallas and fb_step_fused.supported(config):
        for _ in range(config.iterations):
            flow = fb_step_fused.fb_level_step(nxt, exp1, flow, config, first=flow is None)
        return flow
    warp = _warp(config)
    for _ in range(config.iterations):
        if flow is None:
            warped = _expand(nxt, config)
            u = v = torch.zeros_like(exp1[0])
        else:
            flow = _clip(flow, config)
            warped = _expand(warp(nxt, flow), config)
            u, v = flow[..., 0], flow[..., 1]
        flow = _window_solve(fb_normal_eq_products(exp1, warped, u, v), config)
    return flow


def fb_preprocess(frame: torch.Tensor, config: FBConfig) -> list[torch.Tensor]:
    """Frame -> (optionally bilateral-filtered) Gaussian pyramid (shared with LK)."""
    return preprocess(frame, lk_preproc_config(config))


def fb_coarse_to_fine(
    prev_pyr: list[torch.Tensor],
    next_pyr: list[torch.Tensor],
    config: FBConfig,
    init_flow: torch.Tensor | None = None,
) -> torch.Tensor:
    """Coarse-to-fine Farnebäck over prebuilt pyramids; returns the finest
    flow.  ``init_flow`` (coarsest-level resolution and units) warm-starts
    the coarsest level (streaming warm start)."""
    flow = init_flow
    for k in range(config.levels - 1, -1, -1):
        exp1 = _expand(prev_pyr[k], config)
        if flow is not None:
            flow = upsample_flow(flow, tuple(prev_pyr[k].shape[-2:]))
        if config.warp_planes == "image":
            flow = fb_level_image(next_pyr[k], exp1, flow, config)
        else:
            flow = fb_level(exp1, _expand(next_pyr[k], config), flow, config)
    return flow


def pyramidal_farneback(prev: torch.Tensor, nxt: torch.Tensor, config: FBConfig) -> torch.Tensor:
    """Dense Farnebäck flow (..., H, W, 2) from a planar grayscale pair.

    Both frames' pyramids are built in one stacked pass; the flow comes back
    on the frames' device.
    """
    if prev.shape != nxt.shape:
        raise ValueError(f"frame shapes differ: {tuple(prev.shape)} vs {tuple(nxt.shape)}")
    both = fb_preprocess(torch.stack([prev, nxt]).to(torch.float32), config)
    return fb_coarse_to_fine([lvl[0] for lvl in both], [lvl[1] for lvl in both], config)
