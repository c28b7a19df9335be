"""Closed-form 2x2 Lucas-Kanade solve.

Counterpart of ``cuda_optical_flow_2_tpu.ops.solve``.  With
A = [[sumIx2, sumIxIy], [sumIxIy, sumIy2]] and b = [sumIxIt, sumIyIt] the flow
is d = -A^-1 b.
"""

from __future__ import annotations

import torch

__all__ = ["solve_2x2", "solve_2x2_unguarded", "solve_flow"]


def solve_2x2(sum_ix2, sum_iy2, sum_ixiy, sum_ixit, sum_iyit, eps: float = 1e-8):
    """Guarded LK solve -> flow (..., 2); (0, 0) where |det| < eps (or det is NaN)."""
    det = sum_ix2 * sum_iy2 - sum_ixiy * sum_ixiy
    safe = det.abs() >= eps
    inv_det = 1.0 / torch.where(safe, det, torch.ones_like(det))
    u = (-sum_iy2 * sum_ixit + sum_ixiy * sum_iyit) * inv_det
    v = (sum_ixiy * sum_ixit - sum_ix2 * sum_iyit) * inv_det
    zero = torch.zeros_like(u)
    return torch.stack([torch.where(safe, u, zero), torch.where(safe, v, zero)], dim=-1)


def solve_2x2_unguarded(sum_ix2, sum_iy2, sum_ixiy, sum_ixit, sum_iyit):
    """Raw 1/det solve: inf/nan pass through."""
    det = sum_ix2 * sum_iy2 - sum_ixiy * sum_ixiy
    inv_det = 1.0 / det
    u = (-sum_iy2 * inv_det) * sum_ixit + (sum_ixiy * inv_det) * sum_iyit
    v = (sum_ixiy * inv_det) * sum_ixit - (sum_ix2 * inv_det) * sum_iyit
    return torch.stack([u, v], dim=-1)


def solve_flow(sums, config):
    """2x2 solve from the five sums, guarded per ``config.det_eps``
    (0.0 divides by the raw determinant)."""
    if config.det_eps == 0.0:
        return solve_2x2_unguarded(*sums)
    return solve_2x2(*sums, eps=config.det_eps)
