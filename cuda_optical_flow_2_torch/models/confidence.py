"""Per-pixel flow confidence from the structure tensor.

Counterpart of ``cuda_optical_flow_2_tpu.models.confidence``.  The smaller
eigenvalue of the windowed structure tensor G = [[sum Ix^2, sum IxIy],
[sum IxIy, sum Iy^2]] is the classic trackability measure (Shi-Tomasi, the
min-eigenvalue threshold of sparse LK): ~0 in flat or single-edge regions,
large on corners and texture where the 2x2 solve is well-conditioned.
:func:`good_features` picks its peaks as seeds for ``models.tracking``.

Plain torch on the device of the frame: Sobel gradients, one window sum over
the three stacked products, the eigenvalue, ``max_pool2d`` for the local
maxima, a stable sort for the candidates and a fixed-point form of the
greedy spacing pass.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cuda_optical_flow_2_torch.config import LKConfig
from cuda_optical_flow_2_torch.ops.gradients import spatial_gradients
from cuda_optical_flow_2_torch.ops.window import window_sum

__all__ = ["min_eigenvalue", "confidence_mask", "good_features"]


def min_eigenvalue(frame: torch.Tensor, config: LKConfig) -> torch.Tensor:
    """Smaller eigenvalue of the windowed structure tensor, per pixel.

    Args:
      frame: (..., H, W) float grayscale (the previous frame of a pair).
      config: supplies the window size and gradient normalization.
    Returns: (..., H, W) float32, divided by the window's pixel count (a
    per-pixel mean squared gradient, comparable across windows).
    """
    ix, iy = spatial_gradients(frame, normalize=config.normalize_gradients)
    sums = window_sum(torch.stack([ix * ix, iy * iy, ix * iy]), config.window)
    s11, s22, s12 = sums[0], sums[1], sums[2]
    half_tr = 0.5 * (s11 + s22)
    d = s11 - s22
    rad = torch.sqrt(0.25 * (d * d) + s12 * s12)
    return (half_tr - rad) / float(config.window * config.window)


def confidence_mask(
    frame: torch.Tensor, config: LKConfig, threshold: float = 1.0
) -> torch.Tensor:
    """Boolean mask: True where the LK solve is well-conditioned.

    ``threshold`` is in per-pixel mean-squared-gradient units (uint8-scale
    frames: ~1.0 keeps textured regions, drops flat sky and walls).
    """
    return min_eigenvalue(frame, config) >= threshold


def good_features(
    frame: torch.Tensor,
    config: LKConfig,
    n_points: int,
    min_distance: int = 7,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-``n_points`` trackable corners of an (H, W) frame: the local
    maxima of :func:`min_eigenvalue`, non-max suppressed over a
    ``(2*min_distance+1)``-pixel square, strongest first.  Pixels within the
    gradient and window margin of the border are excluded.

    Candidates are the ``4 * n_points`` largest peaks, equal scores in
    ascending pixel index (a stable sort; ``torch.topk`` orders ties
    otherwise).  Exact ties within one window survive the pooling, so a
    greedy pass keeps a candidate unless a kept, stronger one lies within
    ``min_distance`` (Chebyshev).  Its result is the unique solution of
    ``keep = valid & ~any_j(clash[:, j] & keep[j])`` with ``clash`` strictly
    lower-triangular, so iterating that equation from ``valid`` reaches it;
    each iteration is a few ops on the (cand, cand) clash matrix and one
    host sync, never one per candidate.

    Returns:
      points: (n_points, 2) float32 ``(x, y)``, strongest first.
      scores: (n_points,) float32 min-eigenvalue at each point; with fewer
        than ``n_points`` acceptable peaks the tail scores are 0.
    """
    score = min_eigenvalue(frame, config)
    h, w = score.shape[-2:]
    m = config.window // 2 + 2  # gradient + window zero-pad margin
    ys = torch.arange(h, device=score.device)[:, None]
    xs = torch.arange(w, device=score.device)[None, :]
    interior = (ys >= m) & (ys < h - m) & (xs >= m) & (xs < w - m)
    score = torch.where(interior, score, 0.0)
    k = 2 * min_distance + 1
    pooled = F.max_pool2d(score[None], kernel_size=k, stride=1, padding=k // 2)[0]
    peak = torch.where((score == pooled) & (score > 0.0), score, 0.0)
    cand = min(4 * n_points, h * w)
    vals, idx = torch.sort(peak.reshape(-1), descending=True, stable=True)
    vals, idx = vals[:cand], idx[:cand]
    pts = torch.stack([(idx % w).to(torch.float32), (idx // w).to(torch.float32)], -1)

    near = (pts[:, None, :] - pts[None, :, :]).abs().amax(-1) <= min_distance
    clash = near & torch.ones(cand, cand, dtype=torch.bool, device=pts.device).tril(-1)
    valid = vals > 0.0
    keep = valid
    while True:
        new = valid & ~(clash & keep[None, :]).any(-1)
        if torch.equal(new, keep):
            break
        keep = new
    vals = torch.where(keep, vals, 0.0)
    # kept entries first (stable: preserves strongest-first order)
    order = torch.argsort((~keep).to(torch.uint8), stable=True)
    return pts[order][:n_points], vals[order][:n_points]
