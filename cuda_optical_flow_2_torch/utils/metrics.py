"""Flow-quality metrics (numpy).

A copy of ``cuda_optical_flow_2_tpu.utils.metrics``, which the port cannot
import without loading jax: endpoint and angular error, the KITTI Fl outlier
rate, the Sintel matched/unmatched EPE split and summary statistics.  Inputs
may be numpy arrays or torch tensors on any device; tensors are moved to host
numpy at entry and every result is computed there in float64.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "epe",
    "mean_epe",
    "angular_error",
    "outlier_rate",
    "evaluate_flow",
    "flow_stats",
    "to_numpy",
]

# Middlebury marks unknown ground-truth pixels with huge sentinel values
# (|value| > 1e9); everything above this is treated as invalid truth.
_UNKNOWN_FLOW_THRESH = 1e9


def to_numpy(x):
    """A tensor (any device) as a host numpy array; anything else unchanged."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x


def epe(flow: np.ndarray, truth: np.ndarray) -> np.ndarray:
    """Per-pixel endpoint error |flow - truth| (..., H, W)."""
    d = np.asarray(to_numpy(flow), np.float64) - np.asarray(to_numpy(truth), np.float64)
    return np.hypot(d[..., 0], d[..., 1])


def mean_epe(
    flow: np.ndarray, truth: np.ndarray, margin: int = 0
) -> float:
    """Mean EPE over the interior (``margin`` pixels cropped per side)."""
    e = epe(flow, truth)
    if margin:
        e = e[..., margin:-margin, margin:-margin]
    return float(np.mean(e))


def angular_error(flow: np.ndarray, truth: np.ndarray) -> np.ndarray:
    """Barron angular error (radians) between flow and truth, per pixel."""
    f = np.asarray(to_numpy(flow), np.float64)
    t = np.asarray(to_numpy(truth), np.float64)
    num = f[..., 0] * t[..., 0] + f[..., 1] * t[..., 1] + 1.0
    den = np.sqrt(f[..., 0] ** 2 + f[..., 1] ** 2 + 1.0) * np.sqrt(
        t[..., 0] ** 2 + t[..., 1] ** 2 + 1.0
    )
    return np.arccos(np.clip(num / den, -1.0, 1.0))


def _valid_truth_mask(truth: np.ndarray) -> np.ndarray:
    """Pixels whose ground truth is known (finite, below the sentinel)."""
    t = np.asarray(to_numpy(truth), np.float64)
    return (
        np.isfinite(t).all(axis=-1)
        & (np.abs(t) < _UNKNOWN_FLOW_THRESH).all(axis=-1)
    )


def outlier_rate(
    flow: np.ndarray,
    truth: np.ndarray,
    abs_thresh: float = 3.0,
    rel_thresh: float = 0.05,
) -> float:
    """KITTI Fl outlier fraction: EPE > ``abs_thresh`` px AND > ``rel_thresh``
    of the ground-truth magnitude, over pixels with known truth."""
    flow, truth = to_numpy(flow), to_numpy(truth)
    valid = _valid_truth_mask(truth)
    if not valid.any():
        return float("nan")
    e = epe(flow, truth)[valid]
    t = np.asarray(truth, np.float64)
    mag = np.hypot(t[..., 0], t[..., 1])[valid]
    bad = (e > abs_thresh) & (e > rel_thresh * mag)
    return float(bad.mean())


def evaluate_flow(
    flow: np.ndarray,
    truth: np.ndarray,
    margin: int = 0,
    occ: np.ndarray | None = None,
) -> dict:
    """Standard accuracy report of ``flow`` against ground truth.

    Returns mean/median EPE, Barron angular error (degrees), the KITTI Fl
    outlier fraction, and Sintel-style badness fractions (EPE over 1 and 3
    px).  Unknown-truth pixels (Middlebury sentinel / non-finite) are
    excluded; ``margin`` crops each border before scoring (dense flow is
    undefined where the window/warp leaves the frame).

    ``occ`` (optional, (H, W) bool/uint8, nonzero = occluded) splits the EPE
    the Sintel way: ``epe_matched`` over valid non-occluded pixels,
    ``epe_unmatched`` over valid occluded ones (NaN when a side is empty).
    """
    f = np.asarray(to_numpy(flow), np.float64)
    t = np.asarray(to_numpy(truth), np.float64)
    occ = to_numpy(occ)
    if margin:
        f = f[..., margin:-margin, margin:-margin, :]
        t = t[..., margin:-margin, margin:-margin, :]
        if occ is not None:
            occ = np.asarray(occ)[..., margin:-margin, margin:-margin]
    valid = _valid_truth_mask(t)
    if not valid.any():
        return {"valid_fraction": 0.0}
    e_all = epe(f, t)
    e = e_all[valid]
    ang = angular_error(f, t)[valid]
    tm = np.hypot(t[..., 0], t[..., 1])[valid]
    bad = (e > 3.0) & (e > 0.05 * tm)
    rec = {
        "epe_mean": float(e.mean()),
        "epe_median": float(np.median(e)),
        "epe_p95": float(np.percentile(e, 95)),
        "angular_deg_mean": float(np.degrees(ang.mean())),
        "fl_all": float(bad.mean()),
        "bad_1px": float((e > 1.0).mean()),
        "bad_3px": float((e > 3.0).mean()),
        "valid_fraction": float(valid.mean()),
    }
    if occ is not None:
        om = np.asarray(occ).astype(bool)
        if om.shape != valid.shape:
            raise ValueError(
                f"occlusion mask shape {om.shape} != flow plane {valid.shape}"
            )
        matched, unmatched = valid & ~om, valid & om
        rec["epe_matched"] = (
            float(e_all[matched].mean()) if matched.any() else float("nan")
        )
        rec["epe_unmatched"] = (
            float(e_all[unmatched].mean()) if unmatched.any() else float("nan")
        )
        rec["occluded_fraction"] = float(om[valid].mean())
    return rec


def flow_stats(flow: np.ndarray) -> dict:
    """Summary statistics of a flow field (finite fraction, magnitudes)."""
    f = np.asarray(to_numpy(flow), np.float64)
    mag = np.hypot(f[..., 0], f[..., 1])
    finite = np.isfinite(mag)
    return {
        "finite_fraction": float(finite.mean()),
        "mean_magnitude": float(mag[finite].mean()) if finite.any() else float("nan"),
        "p99_magnitude": float(np.percentile(mag[finite], 99)) if finite.any() else float("nan"),
    }
