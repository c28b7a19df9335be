"""Pyramidal Lucas-Kanade dense optical flow — the production pipeline.

Counterpart of ``cuda_optical_flow_2_tpu.models.lucas_kanade``.  One dense
flow is carried down the pyramid: upsample x2 -> warp the next frame ->
solve for the residual -> add.  Everything runs on the device of the input
tensors.

``config.use_pallas`` (default True) routes the work through the
hand-written kernels: the bilateral prefilter (``kernels.bilateral_tap``)
and each pyramid step (``kernels.pyr_down``) in :func:`preprocess`, each
coarse-to-fine handoff of the flow (``kernels.upsample_flow.handoff``),
``kernels.lk_fused.lk_residual`` at the coarsest level and
``kernels.lk_step_fused.lk_level_step`` at each finer level, which clamp
the flow to ``max_displacement`` before warping and accumulate on the
clamped flow; ``config.fused_half_upsample`` is accepted and changes
nothing (``config.py``).  For CPU tensors those wrappers take their plain
versions.
``use_pallas=False`` is the plain ops composition without the clamp, the
JAX package's XLA twin.  A window past a kernel's limit
(``lk_fused.supported``, ``bilateral_tap.supported``) takes the plain
composition for that stage, decided from the config, as the JAX package
takes its XLA twin past its kernels' limits.

All entry points accept leading batch dims: images (..., H, W), flows
(..., H, W, 2).
"""

from __future__ import annotations

import dataclasses

import torch

from cuda_optical_flow_2_torch.capture import captured
from cuda_optical_flow_2_torch.config import LKConfig
from cuda_optical_flow_2_torch.kernels import bilateral_tap, lk_fused, lk_step_fused, upsample_flow
from cuda_optical_flow_2_torch.ops.bilateral import bilateral_filter
from cuda_optical_flow_2_torch.ops.pyramid import build_pyramid
from cuda_optical_flow_2_torch.ops.solve import solve_flow
from cuda_optical_flow_2_torch.ops.warp import warp_bilinear, warp_nearest

__all__ = [
    "coarse_to_fine",
    "compose_flow_pyramid",
    "lk_level",
    "preprocess",
    "pyramidal_lk",
    "pyramidal_lk_jit",
    "pyramidal_lk_pyramid",
    "solve_flow",
]


def _kernels(config: LKConfig) -> bool:
    """The LK kernels' dispatch, from the config alone: ``use_pallas`` and a
    window they take (``lk_fused.supported``)."""
    return config.use_pallas and lk_fused.supported(config)


def _lk_residual(prev: torch.Tensor, nxt: torch.Tensor, config: LKConfig) -> torch.Tensor:
    if _kernels(config):
        return lk_fused.lk_residual(prev, nxt, config)
    return lk_fused.lk_residual_plain(prev, nxt, config)


def lk_level(
    prev: torch.Tensor,
    nxt: torch.Tensor,
    flow_init: torch.Tensor | None,
    config: LKConfig,
    flow_init_half: bool = False,
) -> torch.Tensor:
    """One pyramid level: warp -> gradients -> window sums -> solve, repeated
    ``config.iterations`` times with the refined flow.

    ``flow_init_half``: ``flow_init`` is the coarser level's flow, handed
    over to this level first (``kernels.upsample_flow.handoff``).
    """
    if flow_init is None:
        # Coarsest level: no prior flow, so no warp.
        flow = _lk_residual(prev, nxt, config)
        if config.warp_mode == "none" or config.iterations == 1:
            return flow
        return lk_level(
            prev, nxt, flow, dataclasses.replace(config, iterations=config.iterations - 1)
        )
    flow = flow_init
    if flow_init_half:
        flow = upsample_flow.handoff(flow, tuple(prev.shape[-2:]), config.use_pallas)
    if _kernels(config) and config.warp_mode == "bilinear":
        for _ in range(config.iterations):
            flow = lk_step_fused.lk_level_step(prev, nxt, flow, config)
        return flow
    if config.warp_mode == "none":
        # Without warping, re-iterating recomputes the same residual.
        return flow + _lk_residual(prev, nxt, config)
    # The plain composition (use_pallas=False, or a window past the kernels'
    # limit) or the nearest warp: no displacement budget, as in the JAX
    # package.
    warp = warp_nearest if config.warp_mode == "nearest" else warp_bilinear
    for _ in range(config.iterations):
        flow = flow + _lk_residual(prev, warp(nxt, flow), config)
    return flow


def _validate(prev: torch.Tensor, nxt: torch.Tensor, config: LKConfig) -> None:
    if prev.shape != nxt.shape:
        raise ValueError(f"frame shapes differ: {tuple(prev.shape)} vs {tuple(nxt.shape)}")
    h, w = prev.shape[-2:]
    top = config.levels - 1
    if (h >> top) < 2 or (w >> top) < 2:
        raise ValueError(
            f"{config.levels} pyramid levels need an image of at least "
            f"{2 << top}x{2 << top}; got {h}x{w}"
        )


def preprocess(frame: torch.Tensor, config: LKConfig) -> list[torch.Tensor]:
    """Planar float frame -> (optionally bilateral-filtered) Gaussian pyramid
    (level 0 first): the per-frame half of the reference's live loop.  The
    prefilter and the pyramid take the kernels with ``use_pallas``, their
    plain versions without."""
    if config.prefilter is not None:
        pf = config.prefilter
        if config.use_pallas and bilateral_tap.supported(pf.window):
            frame = bilateral_tap.bilateral_kernel(
                frame, pf.window, pf.sigma_spatial, pf.sigma_range
            )
        else:
            frame = bilateral_filter(frame, None, pf.window, pf.sigma_spatial, pf.sigma_range)
    return build_pyramid(frame, config.levels, use_pallas=config.use_pallas)


def coarse_to_fine(
    prev_pyr: list[torch.Tensor],
    next_pyr: list[torch.Tensor],
    config: LKConfig,
    init_flow: torch.Tensor | None = None,
) -> list[torch.Tensor]:
    """Coarse-to-fine pass over prebuilt pyramids; returns the flow pyramid.

    ``init_flow`` (coarsest-level resolution and pixel units) warm-starts
    the coarsest level; the streaming layer passes the previous pair's flow.
    """
    flows: list[torch.Tensor | None] = [None] * config.levels
    flow = init_flow
    for k in range(config.levels - 1, -1, -1):
        if flow is not None:
            flow = upsample_flow.handoff(flow, tuple(prev_pyr[k].shape[-2:]), config.use_pallas)
        flow = lk_level(prev_pyr[k], next_pyr[k], flow, config)
        flows[k] = flow
    return flows  # type: ignore[return-value]


def pyramidal_lk_pyramid(
    prev: torch.Tensor, nxt: torch.Tensor, config: LKConfig
) -> list[torch.Tensor]:
    """Coarse-to-fine LK returning the full flow pyramid (finest first);
    level k flow is in level-k pixel units.  Both frames' pyramids are
    built in one stacked pass."""
    _validate(prev, nxt, config)
    both = preprocess(torch.stack([prev, nxt]).to(torch.float32), config)
    return coarse_to_fine([lvl[0] for lvl in both], [lvl[1] for lvl in both], config)


def pyramidal_lk(prev: torch.Tensor, nxt: torch.Tensor, config: LKConfig) -> torch.Tensor:
    """Dense flow (..., H, W, 2) from a frame pair — the flagship entry point.

    ``prev``/``nxt`` are planar grayscale images (any leading batch dims) on
    one device; the flow comes back on that device.
    """
    return pyramidal_lk_pyramid(prev, nxt, config)[0]


# The JAX package's jitted entry: on CUDA tensors a replay of a graph captured
# once per config and input shape, dtype and device (``capture.captured``);
# on CPU tensors, or under autograd, ``pyramidal_lk`` itself.
pyramidal_lk_jit = captured(pyramidal_lk)


def compose_flow_pyramid(flow_pyramid: list[torch.Tensor], level: int = 0) -> torch.Tensor:
    """Composition of a per-level flow pyramid at ``level``: at each pixel
    (i, j), total = sum over k >= level of
    2^(k-level) * flow[k][i >> (k-level), j >> (k-level)]."""
    target = flow_pyramid[level]
    h, w = target.shape[-3:-1]
    total = torch.zeros_like(target)
    for k in range(len(flow_pyramid) - 1, level - 1, -1):
        s = 1 << (k - level)
        up = flow_pyramid[k].repeat_interleave(s, dim=-3).repeat_interleave(s, dim=-2)
        uh, uw = up.shape[-3:-1]
        if uh < h:  # floor-halved odd dims: extend with edge pixels
            up = torch.cat([up, up[..., -1:, :, :].expand(*up.shape[:-3], h - uh, uw, 2)], dim=-3)
        if uw < w:
            up = torch.cat([up, up[..., :, -1:, :].expand(*up.shape[:-2], w - uw, 2)], dim=-2)
        total = total + up[..., :h, :w, :] * float(s)
    return total
