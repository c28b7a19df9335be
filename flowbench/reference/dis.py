"""Plain reference of DIS (dense inverse search) as the port's kernel path runs it.

The semantics of ``DISConfig(use_pallas=True)`` on the card, written out in
plain PyTorch: a frozen copy of the arithmetic of the port's plain versions
(``lk_residual_plain`` and ``lk_level_step_plain`` in their centered mode,
``models.dis._refine``, ``hs_relax_plain`` with the Charbonnier chunks) and
of its coarse-to-fine loop.  Per solved level, coarsest first:

* the coarsest level solves a centered residual from zero flow with no
  warp, then ``iterations - 1`` centered steps; each finer solved level
  upsamples the flow one octave and runs ``iterations`` centered steps.  A
  step clips the flow to +-``max_displacement``, warps the next frame by it,
  and adds the centered (mean-normalized) solve: every window sum S_ab of
  the LK normal equations becomes S_ab - S_a S_b / n, n the window's
  in-image count, then the 2x2 solve guarded by ``det_eps``;
* the refinement: clip, warp, Sobel gradients, the offset
  -(ix u0 + iy v0) minus the window mean (integral-image sums, the
  border-clipped count) of the ``dt3``-filtered warped difference, then
  ``refine_iterations`` Jacobi sweeps of the total flow, quadratic or
  Charbonnier with weights computed from the incoming flow once per chunk
  of ``_MAX_SWEEPS`` sweeps;

and below ``finest_level`` the octave upsample to the frame size.

Departures from Kroeger et al. (ECCV 2016) and OpenCV's ``DISOpticalFlow``,
which the port makes and this reference keeps: stride 1, so every pixel is
its own patch and there is no densification; an odd window in place of
the even patch; no spatial propagation; the temporal difference filtered by
``dt3``, not the raw patch difference; the refinement is Jacobi with
normalized Charbonnier weights lagged per chunk, not SOR, with no
gradient-constancy term and the data term weighted 1.

Supported fields: those of ``DISConfig`` with no prefilter,
``use_pallas=True``, the separable window sums and ``finest_level`` at
most 1 (a larger one takes a bilinear resize, not the octave);
:func:`check_fields` refuses others.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from flowbench.reference.lk import window_taps
from flowbench.reference.ops import (
    SOBEL_X, SOBEL_Y, TEMPORAL, clip, correlate, correlate_1d, pyramid, upsample_flow,
    warp_bilinear,
)

__all__ = ["check_fields", "flow", "refine"]

_DEFAULTS = {
    "levels": 5, "finest_level": 0, "iterations": 2, "window": 9, "mean_normalize": True,
    "refine_iterations": 5, "refine_alpha": 20.0, "refine_penalty": "quadratic",
    "refine_eps_data": 3.0, "refine_eps_smooth": 0.1, "temporal_kernel": "dt3",
    "det_eps": 1e-8, "window_method": "sep_conv", "window_weights": "box",
    "prefilter": None, "use_pallas": True, "max_displacement": 32, "d_local": 7, "c_max": 1,
    "fused_half_upsample": False,
}
_MAX_SWEEPS = 16  # the Charbonnier weights' refresh cadence (kernels/hs_sweep.MAX_SWEEPS)
_DXC = np.array([[0.5, 0.0, -0.5]], np.float32)  # central differences of the weights
_DYC = _DXC.T


def check_fields(fields: dict) -> dict:
    """The config's fields over DISConfig's defaults; raises on a field or
    value this reference does not implement."""
    f = {**_DEFAULTS, **fields}
    unknown = set(f) - set(_DEFAULTS)
    if unknown:
        raise ValueError(f"fields the DIS reference does not know: {sorted(unknown)}")
    if f["prefilter"] is not None or not f["use_pallas"]:
        raise ValueError("the DIS reference covers the kernel path with no prefilter")
    if f["window"] > 65 or f["window_method"] != "sep_conv":
        raise ValueError("the DIS reference covers the kernel path's separable window sums "
                         "(window <= 65)")
    if f["finest_level"] > 1:
        raise ValueError("finest_level > 1 resizes by a bilinear interpolation, not covered here")
    return f


def _gradients(prev: torch.Tensor, nxt: torch.Tensor, temporal_kernel: str):
    """Sobel / 8 of ``prev`` and the unit-sum temporal mask on the difference."""
    mask = TEMPORAL[temporal_kernel]
    return (correlate(prev, SOBEL_X / 8.0), correlate(prev, SOBEL_Y / 8.0),
            correlate(nxt - prev, mask / mask.sum()))


def _solve(s: tuple, det_eps: float) -> torch.Tensor:
    a, b, c, d, e = s
    det = a * b - c * c
    if det_eps == 0.0:
        inv = 1.0 / det
        return torch.stack([(-b * inv) * d + (c * inv) * e, (c * inv) * d - (a * inv) * e], -1)
    safe = det.abs() >= det_eps
    inv = 1.0 / torch.where(safe, det, torch.ones_like(det))
    u = (-b * d + c * e) * inv
    v = (c * d - a * e) * inv
    zero = torch.zeros_like(u)
    return torch.stack([torch.where(safe, u, zero), torch.where(safe, v, zero)], dim=-1)


def _residual(prev: torch.Tensor, nxt: torch.Tensor, f: dict) -> torch.Tensor:
    """The search's solve between ``prev`` and the (warped) ``nxt``: the nine
    window sums, centered with ``mean_normalize``, and the guarded solve."""
    ix, iy, it = _gradients(prev, nxt, f["temporal_kernel"])
    taps = window_taps(f["window"], f["window_weights"])

    def window(planes: torch.Tensor) -> torch.Tensor:
        return correlate_1d(correlate_1d(planes, taps, -2), taps, -1)

    if not f["mean_normalize"]:
        return _solve(window(torch.stack([ix * ix, iy * iy, ix * iy, ix * it, iy * it])).unbind(0),
                      f["det_eps"])
    s = window(torch.stack([ix * ix, iy * iy, ix * iy, ix * it, iy * it, ix, iy, it,
                            torch.ones_like(ix)]))
    inv_n = 1.0 / clip(s[8], 1.0)
    return _solve((s[0] - s[5] * s[5] * inv_n, s[1] - s[6] * s[6] * inv_n,
                   s[2] - s[5] * s[6] * inv_n, s[3] - s[5] * s[7] * inv_n,
                   s[4] - s[6] * s[7] * inv_n), f["det_eps"])


def _step(prev, nxt, flow, f) -> torch.Tensor:
    """Clip, warp, centered solve, add: one inverse-search step."""
    d = float(f["max_displacement"])
    fc = clip(flow, -d, d)
    return fc + _residual(prev, warp_bilinear(nxt, fc), f)


def _box_cumsum(x: torch.Tensor, window: int) -> torch.Tensor:
    """Integral-image box sum, zero outside the image: a leading zero row and
    column, the prefix sums read at four corners clipped to the image."""
    r = window // 2
    lead, (h, w) = x.shape[:-2], x.shape[-2:]
    ii = F.pad(torch.cumsum(torch.cumsum(x, dim=-2), dim=-1), (1, 0, 1, 0))
    p = r + 1
    ii = F.pad(ii.reshape(1, -1, h + 1, w + 1), (p, p, p, p), mode="replicate")
    ii = ii.reshape(lead + (h + 1 + 2 * p, w + 1 + 2 * p))

    def corner(dy: int, dx: int) -> torch.Tensor:
        return ii[..., p + dy:p + dy + h, p + dx:p + dx + w]

    return corner(r + 1, r + 1) - corner(-r, r + 1) - corner(r + 1, -r) + corner(-r, -r)


def _avg3x3(x: torch.Tensor) -> torch.Tensor:
    """Horn-Schunck's neighbour average, zero-padded: cross / 6 + diagonals / 12."""
    xp = F.pad(x, (1, 1, 1, 1))
    h, w = x.shape[-2:]

    def sh(dy: int, dx: int) -> torch.Tensor:
        return xp[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    cross = sh(-1, 0) + sh(1, 0) + sh(0, -1) + sh(0, 1)
    diag = sh(-1, -1) + sh(-1, 1) + sh(1, -1) + sh(1, 1)
    return cross * (1 / 6) + diag * (1 / 12)


def _quadratic(uv, ix, iy, it, sweeps: int, alpha: float) -> torch.Tensor:
    denom = alpha ** 2 + ix * ix + iy * iy
    u, v = uv[..., 0], uv[..., 1]
    for _ in range(sweeps):
        u_bar, v_bar = _avg3x3(u), _avg3x3(v)
        rate = (ix * u_bar + iy * v_bar + it) / denom
        u, v = u_bar - ix * rate, v_bar - iy * rate
    return torch.stack([u, v], dim=-1)


def _charbonnier_chunk(uv, ix, iy, it, sweeps: int, alpha: float, eps: tuple) -> torch.Tensor:
    """One chunk: the data and smoothness weights from the incoming flow,
    normalized by S = (ws + avg(ws)) / 2, frozen for ``sweeps`` sweeps."""
    ed, es = eps
    u, v = uv[..., 0], uv[..., 1]
    r = ix * u + iy * v + it
    wd = ed * torch.rsqrt(r * r + ed * ed)
    g2 = correlate(u, _DXC) ** 2 + correlate(v, _DXC) ** 2 + correlate(u, _DYC) ** 2 \
        + correlate(v, _DYC) ** 2
    ws = es * torch.rsqrt(g2 + es * es)
    s_plane = clip((ws + _avg3x3(ws)) * 0.5, 1e-12)
    inv_s = 1.0 / s_plane
    inv_denom = 1.0 / (alpha * alpha * s_plane + wd * (ix * ix + iy * iy))
    for _ in range(sweeps):
        u_bar = (ws * _avg3x3(u) + _avg3x3(ws * u)) * 0.5 * inv_s
        v_bar = (ws * _avg3x3(v) + _avg3x3(ws * v)) * 0.5 * inv_s
        rate = wd * (ix * u_bar + iy * v_bar + it) * inv_denom
        u, v = u_bar - ix * rate, v_bar - iy * rate
    return torch.stack([u, v], dim=-1)


def refine(prev: torch.Tensor, nxt: torch.Tensor, flow: torch.Tensor, f: dict) -> torch.Tensor:
    """The variational refinement of one level: relax the total flow around
    the clipped flow u0 that the warp applies."""
    d = float(f["max_displacement"])
    flow = clip(flow, -d, d)
    warped = warp_bilinear(nxt, flow)
    ix, iy, it = _gradients(prev, warped, f["temporal_kernel"])
    off = -(ix * flow[..., 0] + iy * flow[..., 1])
    if f["mean_normalize"]:
        counts = _box_cumsum(torch.ones_like(it), f["window"])
        off = off - _box_cumsum(it, f["window"]) / clip(counts, 1.0)
    it = it + off
    n, alpha = f["refine_iterations"], f["refine_alpha"]
    if f["refine_penalty"] != "charbonnier":
        return _quadratic(flow, ix, iy, it, n, alpha)
    eps = (f["refine_eps_data"], f["refine_eps_smooth"])
    k = min(_MAX_SWEEPS, n)
    for chunk in [k] * (n // k) + ([n % k] if n % k else []):
        flow = _charbonnier_chunk(flow, ix, iy, it, chunk, alpha, eps)
    return flow


def flow(prev: torch.Tensor, nxt: torch.Tensor, fields: dict,
         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Flow (..., H, W, 2) float32 of frame pairs (..., H, W), computed in
    ``dtype``."""
    f = check_fields(fields)
    pp = pyramid(prev.to(dtype), f["levels"])
    npyr = pyramid(nxt.to(dtype), f["levels"])
    out = None
    for k in range(f["levels"] - 1, f["finest_level"] - 1, -1):
        p, n = pp[k], npyr[k]
        if out is None:
            out = _residual(p, n, f)
            steps = f["iterations"] - 1
        else:
            out = upsample_flow(out, tuple(p.shape[-2:]))
            steps = f["iterations"]
        for _ in range(steps):
            out = _step(p, n, out, f)
        if f["refine_iterations"] > 0:
            out = refine(p, n, out, f)
    if f["finest_level"] > 0:
        out = upsample_flow(out, tuple(pp[0].shape[-2:]))
    return out.float()
