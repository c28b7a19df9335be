"""Layered-motion scene generator with analytic flow and occlusion truth (numpy).

A copy of ``cuda_optical_flow_2_tpu.utils.layered``, which the port cannot
import without loading jax; held to the same seed, the two give
byte-identical arrays (``tests/test_torch_eval_utils.py``).  Two-frame scenes
of textured rigid layers translating over a translating background, where
the dense flow and the occlusion mask are known exactly by construction:

* textures are band-limited sums of random sinusoids, evaluable exactly at
  any real coordinate, so a subpixel move is an exact phase shift;
* layer supports are soft-edged signed-distance masks (disk or rectangle)
  that translate rigidly with their layer;
* a pixel belongs to the topmost layer whose coverage exceeds 1/2 (else the
  background) and moves with it; it is occluded iff its true flow lands on
  a pixel owned by another layer in frame 2, or outside the frame.

The JAX module's docstring gives the design's reasons and the studies that
use it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Sequence

import numpy as np

__all__ = ["Layer", "LayeredScene", "layered_scene", "boundary_band"]


@dataclasses.dataclass(frozen=True)
class Layer:
    """One rigidly-translating textured foreground layer.

    Attributes:
      kind: "disk" (``size`` = radius) or "rect" (``size`` = (half_h, half_w)).
      center: (cy, cx) position in frame 1, pixels (row, col).
      size: radius (disk) or half-extents (rect), pixels.
      flow: (u, v) translation in pixels between the frames — the
        framework's flow convention: u along x (columns), v along y (rows),
        ``prev(x) = next(x + d)``.
      seed: texture seed (distinct per layer by default via the scene).
      contrast: texture amplitude (std, grayscale units).
    """

    kind: str = "disk"
    center: tuple[float, float] = (0.0, 0.0)
    size: float | tuple[float, float] = 40.0
    flow: tuple[float, float] = (0.0, 0.0)
    seed: int | None = None
    contrast: float = 55.0

    def __post_init__(self) -> None:
        if self.kind not in ("disk", "rect"):
            raise ValueError(f"unknown layer kind {self.kind!r}")
        if self.kind == "rect" and np.isscalar(self.size):
            raise ValueError("rect layers need size=(half_h, half_w)")


class LayeredScene(NamedTuple):
    """Two frames plus exact truth.

    prev, nxt: (H, W) float32 grayscale in [0, 255].
    flow: (H, W, 2) float32 true forward flow (u, v), prev(x) = next(x + d).
    occ: (H, W) bool — True where the prev pixel is NOT visible in nxt
      (covered by another layer, or carried outside the frame).
    owner: (H, W) int8 ownership in prev — -1 background, k = layers[k].
    """

    prev: np.ndarray
    nxt: np.ndarray
    flow: np.ndarray
    occ: np.ndarray
    owner: np.ndarray


def _texture(
    seed: int, contrast: float, n_components: int = 48,
    fmin: float = 1.0 / 48.0, fmax: float = 0.25,
) -> Callable[[np.ndarray, np.ndarray], np.ndarray]:
    """Band-limited analytic texture: sum of random sinusoids, 1/sqrt(f)
    amplitudes (natural-ish spectrum), exactly evaluable at real coords.
    ``fmax`` stays below Nyquist/2 so pixel sampling is alias-free even
    after subpixel shifts."""
    rng = np.random.default_rng(seed)
    f = np.exp(rng.uniform(np.log(fmin), np.log(fmax), n_components))
    theta = rng.uniform(0, 2 * np.pi, n_components)
    phase = rng.uniform(0, 2 * np.pi, n_components)
    amp = 1.0 / np.sqrt(f)
    # RMS of a cosine sum with independent phases is sqrt(sum a^2 / 2).
    amp *= contrast / np.sqrt(np.sum(amp**2) / 2.0)
    fy = 2 * np.pi * f * np.sin(theta)
    fx = 2 * np.pi * f * np.cos(theta)

    def tex(y: np.ndarray, x: np.ndarray) -> np.ndarray:
        acc = np.zeros(np.broadcast(y, x).shape, np.float64)
        for k in range(n_components):
            acc += amp[k] * np.cos(fy[k] * y + fx[k] * x + phase[k])
        return 127.0 + acc

    return tex


def _coverage(
    layer: Layer, ys: np.ndarray, xs: np.ndarray,
    center: tuple[float, float], edge: float,
) -> np.ndarray:
    """Layer coverage in [0, 1] at (ys, xs): smoothstep of the signed
    distance to the layer boundary over ``edge`` pixels (anti-aliasing)."""
    cy, cx = center
    if layer.kind == "disk":
        sdist = float(layer.size) - np.hypot(ys - cy, xs - cx)
    else:
        hh, hw = layer.size  # type: ignore[misc]
        sdist = np.minimum(hh - np.abs(ys - cy), hw - np.abs(xs - cx))
    return np.clip(0.5 + sdist / max(edge, 1e-6), 0.0, 1.0)


def layered_scene(
    h: int,
    w: int,
    bg_flow: tuple[float, float] = (0.0, 0.0),
    layers: Sequence[Layer] = (),
    seed: int = 0,
    edge: float = 1.0,
    bg_contrast: float = 55.0,
    clip: bool = True,
) -> LayeredScene:
    """Render a two-frame layered scene with exact flow + occlusion truth.

    ``bg_flow``/``Layer.flow`` are (u, v) translations in pixels.  Layers
    composite in order (later on top).  ``edge`` is the anti-aliasing width
    of layer boundaries (pixels); truth ownership uses the 1/2-coverage
    contour, so mixed edge pixels are assigned to the majority layer (the
    convention truth datasets use for boundary pixels).
    """
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    bu, bv = bg_flow
    bg_tex = _texture(seed, bg_contrast)

    img0 = bg_tex(ys, xs)
    img1 = bg_tex(ys - bv, xs - bu)
    owner = np.full((h, w), -1, np.int8)
    flow = np.empty((h, w, 2), np.float64)
    flow[..., 0] = bu
    flow[..., 1] = bv

    centers1 = []
    for li, layer in enumerate(layers):
        u, v = layer.flow
        c0 = layer.center
        c1 = (c0[0] + v, c0[1] + u)
        centers1.append(c1)
        ftex = _texture(
            layer.seed if layer.seed is not None else seed + 101 + li,
            layer.contrast,
        )
        a0 = _coverage(layer, ys, xs, c0, edge)
        a1 = _coverage(layer, ys, xs, c1, edge)
        # The layer texture rides the layer: local coords relative to its
        # (moving) center, so frame 2 is the same pattern shifted by (u, v).
        img0 = a0 * ftex(ys - c0[0], xs - c0[1]) + (1 - a0) * img0
        img1 = a1 * ftex(ys - c1[0], xs - c1[1]) + (1 - a1) * img1
        own0 = a0 > 0.5
        owner[own0] = li
        flow[own0, 0] = u
        flow[own0, 1] = v

    # Occlusion: follow each pixel's true flow; visible iff the landing
    # pixel in frame 2 is owned by the same layer (rigid translation makes
    # same-owner == same material point) and inside the frame.
    ty = ys + flow[..., 1]
    tx = xs + flow[..., 0]
    owner_t = np.full((h, w), -1, np.int8)
    for li, layer in enumerate(layers):
        owner_t[_coverage(layer, ty, tx, centers1[li], edge) > 0.5] = li
    occ = (owner_t != owner) | (ty < 0) | (ty > h - 1) | (tx < 0) | (tx > w - 1)

    if clip:
        img0, img1 = np.clip(img0, 0, 255), np.clip(img1, 0, 255)
    return LayeredScene(
        img0.astype(np.float32),
        img1.astype(np.float32),
        flow.astype(np.float32),
        occ,
        owner,
    )


def boundary_band(owner: np.ndarray, k: int) -> np.ndarray:
    """Bool mask of pixels within ``k`` px (Manhattan) of an ownership
    change — the motion-discontinuity band for sharpness metrics."""
    edge = np.zeros(owner.shape, bool)
    edge[:-1, :] |= owner[:-1, :] != owner[1:, :]
    edge[1:, :] |= owner[1:, :] != owner[:-1, :]
    edge[:, :-1] |= owner[:, :-1] != owner[:, 1:]
    edge[:, 1:] |= owner[:, 1:] != owner[:, :-1]
    band = edge
    for _ in range(k):
        grown = band.copy()
        grown[1:, :] |= band[:-1, :]
        grown[:-1, :] |= band[1:, :]
        grown[:, 1:] |= band[:, :-1]
        grown[:, :-1] |= band[:, 1:]
        band = grown
    return band
