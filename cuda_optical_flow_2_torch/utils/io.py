"""Synthetic test sequences (numpy only).

A copy of ``cuda_optical_flow_2_tpu.utils.io.synthetic_sequence``, which the
port cannot import without loading jax; ``tests/test_torch_pipeline.py``
holds the two equal.
"""

from __future__ import annotations

import numpy as np

__all__ = ["synthetic_sequence"]


def synthetic_sequence(
    n_frames: int,
    h: int = 480,
    w: int = 640,
    velocity: tuple[float, float] = (2.0, 1.0),
    period: int = 16,
    seed: int = 0,
    noise: float = 1.0,
) -> np.ndarray:
    """(N, H, W) uint8 frames of a textured field translating at ``velocity``
    pixels per frame (the ground truth).  Deterministic given the seed."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    frames = np.zeros((n_frames, h, w), np.uint8)
    vx, vy = velocity
    for t in range(n_frames):
        sx, sy = xs - vx * t, ys - vy * t
        img = (
            127.0
            + 55.0 * np.sin(2 * np.pi * sx / period) * np.sin(2 * np.pi * sy / period)
            + 35.0 * np.sin(2 * np.pi * (sx + sy) / (period * 2.7))
        )
        if noise:
            img = img + rng.normal(0, noise, img.shape)
        frames[t] = np.clip(img, 0, 255).astype(np.uint8)
    return frames
