"""Sparse point tracking over dense flow.

Counterpart of ``cuda_optical_flow_2_tpu.models.tracking``: query points are
advected through each frame pair's dense flow with bilinear interpolation,
the dense-flow form of the sparse pyramidal-LK tracker.  The dense flow runs
the family's kernels; sampling N points is a gather of N elements.

Conventions: points are (N, 2) float ``(x, y)`` pixel coordinates;
``flow[..., 0]`` is the x-displacement and ``flow[..., 1]`` the y one, and a
pair's flow maps prev(x) = next(x + d), so a point at ``p`` in the previous
frame is at ``p + flow(p)`` in the next.  Points live on the frames' device.

As the JAX package jits ``track_sequence`` (its scan, with ``config`` and
``warm_start`` static) and the advection (``_advect_jit``), here both are
captured entries (``capture.captured``): on CUDA tensors
:func:`track_sequence` replays one graph over the whole clip per frames
shape, points shape, config and ``warm_start``, and ``_advect_jit`` one per
shape, which :func:`track_points` and the demo call.  The eager bodies stay
as ``.eager``; on CPU tensors both run eagerly.
"""

from __future__ import annotations

import torch

from cuda_optical_flow_2_torch.capture import captured
from cuda_optical_flow_2_torch.models.lucas_kanade import _validate
from cuda_optical_flow_2_torch.models.streaming import (
    _as_frame,
    _flow,
    _preprocess,
    _require_ported,
    process_sequence,
)
from cuda_optical_flow_2_torch.ops.clip import clip
from cuda_optical_flow_2_torch.ops.resize import downsample_flow

__all__ = ["sample_flow", "advect_points", "track_points", "track_sequence"]


def sample_flow(flow: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Bilinearly sample a (H, W, 2) flow field at (N, 2) ``(x, y)`` points.

    Sample positions are clamped to the image rectangle (border clamp, the
    dense warp's boundary rule).  A NaN position samples NaN.
    """
    h, w = flow.shape[-3:-1]
    x = clip(points[..., 0], 0.0, w - 1.0)
    y = clip(points[..., 1], 0.0, h - 1.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    # a NaN position reads pixel 0 (the weights are NaN): an index cast of
    # NaN is out of range
    x0i = torch.nan_to_num(x0).long()
    y0i = torch.nan_to_num(y0).long()
    x1i = (x0i + 1).clamp(max=w - 1)
    y1i = (y0i + 1).clamp(max=h - 1)
    f00 = flow[..., y0i, x0i, :]
    f01 = flow[..., y0i, x1i, :]
    f10 = flow[..., y1i, x0i, :]
    f11 = flow[..., y1i, x1i, :]
    return (
        f00 * (1 - fx) * (1 - fy)
        + f01 * fx * (1 - fy)
        + f10 * (1 - fx) * fy
        + f11 * fx * fy
    )


def advect_points(
    flow: torch.Tensor, points: torch.Tensor, alive: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """One tracking step: ``p -> p + flow(p)`` with liveness bookkeeping.

    Returns ``(new_points, new_alive)``.  A point whose advected position
    leaves the image rectangle dies on that step (the sparse tracker's
    ``status``), its position clamped to the border; dead points stay frozen.
    """
    if alive is None:
        alive = torch.ones(points.shape[:-1], dtype=torch.bool, device=points.device)
    h, w = flow.shape[-3:-1]
    new = points + sample_flow(flow, points)
    inside = (
        (new[..., 0] >= 0.0)
        & (new[..., 0] <= w - 1.0)
        & (new[..., 1] >= 0.0)
        & (new[..., 1] <= h - 1.0)
    )
    clamped = torch.stack(
        [clip(new[..., 0], 0.0, w - 1.0), clip(new[..., 1], 0.0, h - 1.0)], dim=-1
    )
    out = torch.where(alive[..., None], clamped, points)
    return out, alive & inside


# One stream's advection graph serves every later stream of the same shapes,
# as the JAX package's module-level jit does.
_advect_jit = captured(advect_points)


def _points(points, device: torch.device | None = None) -> torch.Tensor:
    pts = torch.as_tensor(points, dtype=torch.float32, device=device)
    if pts.ndim != 2 or pts.shape[-1] != 2:
        raise ValueError(f"points must be (N, 2) (x, y); got {tuple(pts.shape)}")
    return pts


def track_sequence(
    frames,
    points,
    config,
    warm_start: bool = True,
    device: torch.device | str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Track points through a stacked (T, H, W) frame array.

    Returns ``(positions, alive)`` of shapes (T-1, N, 2) and (T-1, N): entry
    ``t`` is each point's position after frame pair ``t -> t+1`` and whether
    it is still inside the image.  ``config`` selects the family (any of
    the five); ``warm_start`` seeds each pair with the previous pair's flow
    taken down to the coarsest level (the first pair with zero flow), as the
    JAX package's scan does.  A tensor keeps its device, an array goes to
    ``device`` (``models.streaming.resolve_device``: the card unless
    ``"cpu"``); the points follow the frames.

    For unbounded or iterable sources use :func:`track_points`.  On CUDA
    tensors a replay of one graph over the clip (module docstring).
    """
    _require_ported(config)
    frames = _as_frame(frames, device).to(torch.float32)
    _validate(frames[0], frames[0], config)
    pts = _points(points, frames.device)
    alive = torch.ones(pts.shape[:-1], dtype=torch.bool, device=frames.device)
    h, w = frames.shape[-2:]
    pyr_prev = _preprocess(frames[0], config)
    flow = torch.zeros((h, w, 2), dtype=torch.float32, device=frames.device)
    positions, alives = [], []
    for frame in frames[1:]:
        pyr = _preprocess(frame, config)
        init = (
            downsample_flow(flow, tuple(pyr[-1].shape[-2:]), config.use_pallas)
            if warm_start
            else None
        )
        flow = _flow(pyr_prev, pyr, config, init)
        pts, alive = advect_points(flow, pts, alive)
        positions.append(pts)
        alives.append(alive)
        pyr_prev = pyr
    if not positions:
        return pts.new_empty((0,) + pts.shape), alive.new_empty((0,) + alive.shape)
    return torch.stack(positions), torch.stack(alives)


def _track_inputs(frames, points, config, warm_start: bool = True,
                  device: torch.device | str | None = None):
    """The captured ``track_sequence``'s ``prepare``: the frames and points
    as float32 tensors on the frames' device, made outside the graph; a
    clip of fewer than two frames runs eagerly (nothing to capture)."""
    _require_ported(config)
    frames = _as_frame(frames, device).to(torch.float32)
    if frames.shape[0] < 2:
        return None
    return (frames, _points(points, frames.device), config, warm_start), {}


track_sequence = captured(track_sequence, _track_inputs)


def track_points(
    frames, points, config, warm_start: bool = True, device: torch.device | str | None = None
):
    """Generator twin of :func:`track_sequence` for iterable or unbounded
    sources: yields ``(frame_index, positions, alive)`` per consumed pair.

    Rides :func:`models.streaming.process_sequence` (``device`` as there), so
    a ``None`` frame (a decode failure) is skipped and the next good frame
    pairs across the gap: the trajectory stays continuous.  Each step's
    advection is the captured ``_advect_jit``.
    """
    pts = _points(points)
    alive = None
    for i, flow in process_sequence(frames, config, warm_start=warm_start, device=device):
        if alive is None:
            pts = pts.to(flow.device)
            alive = torch.ones(pts.shape[:-1], dtype=torch.bool, device=flow.device)
        pts, alive = _advect_jit(flow, pts, alive)
        yield i, pts, alive
