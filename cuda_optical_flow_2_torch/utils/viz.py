"""Flow visualization, headless: color wheel, arrows, tracks, PNG.

Counterpart of ``cuda_optical_flow_2_tpu.utils.viz``.  The numpy functions
are copies of the JAX package's (which the port cannot import without
loading jax); :func:`flow_to_color_device` renders on the flow's device in
torch:

* :func:`flow_to_color` — Middlebury color-wheel encoding (numpy);
* :func:`flow_to_color_device` — its device twin, within one intensity level;
* :func:`draw_flow_arrows` — arrow overlay with the reference's per-arrow
  clamping;
* :func:`draw_tracks` — trajectory overlay of tracked points;
* :func:`cleanup_outliers` — binarized debug gradient maps;
* :func:`write_png` — dependency-free PNG writer.

The drawing functions take numpy arrays or tensors (any device).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from cuda_optical_flow_2_torch.utils.metrics import to_numpy

__all__ = [
    "flow_to_color",
    "flow_to_color_device",
    "draw_flow_arrows",
    "draw_tracks",
    "cleanup_outliers",
    "write_png",
]


def _make_color_wheel() -> np.ndarray:
    """Middlebury color wheel (55 colors, RY/YG/GC/CB/BM/MR segments)."""
    ry, yg, gc, cb, bm, mr = 15, 6, 4, 11, 13, 6
    wheel = np.zeros((ry + yg + gc + cb + bm + mr, 3))
    col = 0
    wheel[0:ry, 0] = 255
    wheel[0:ry, 1] = np.floor(255 * np.arange(ry) / ry)
    col += ry
    wheel[col : col + yg, 0] = 255 - np.floor(255 * np.arange(yg) / yg)
    wheel[col : col + yg, 1] = 255
    col += yg
    wheel[col : col + gc, 1] = 255
    wheel[col : col + gc, 2] = np.floor(255 * np.arange(gc) / gc)
    col += gc
    wheel[col : col + cb, 1] = 255 - np.floor(255 * np.arange(cb) / cb)
    wheel[col : col + cb, 2] = 255
    col += cb
    wheel[col : col + bm, 2] = 255
    wheel[col : col + bm, 0] = np.floor(255 * np.arange(bm) / bm)
    col += bm
    wheel[col : col + mr, 2] = 255 - np.floor(255 * np.arange(mr) / mr)
    wheel[col : col + mr, 0] = 255
    return wheel


_WHEEL = _make_color_wheel()


def flow_to_color(flow: np.ndarray, max_flow: float | None = None) -> np.ndarray:
    """(H, W, 2) flow -> (H, W, 3) uint8 color-wheel image.

    Hue encodes direction, saturation magnitude; non-finite flow renders
    black (useful with the unguarded compat solve).
    """
    flow = np.asarray(to_numpy(flow), dtype=np.float64)
    u, v = flow[..., 0].copy(), flow[..., 1].copy()
    bad = ~(np.isfinite(u) & np.isfinite(v))
    u[bad] = 0.0
    v[bad] = 0.0
    mag = np.hypot(u, v)
    if max_flow is None:
        max_flow = max(float(mag.max()), 1e-6)
    elif not np.isfinite(max_flow) or max_flow <= 0:
        raise ValueError(
            f"max_flow must be a positive finite scale, got {max_flow}"
        )
    u, v = u / max_flow, v / max_flow
    mag = np.minimum(mag / max_flow, 1.0)
    ncols = _WHEEL.shape[0]
    angle = np.arctan2(-v, -u) / np.pi  # [-1, 1]
    fk = (angle + 1.0) / 2.0 * (ncols - 1)
    k0 = np.floor(fk).astype(int) % ncols
    k1 = (k0 + 1) % ncols
    f = fk - np.floor(fk)
    out = np.zeros(flow.shape[:-1] + (3,), dtype=np.uint8)
    for c in range(3):
        col0 = _WHEEL[k0, c] / 255.0
        col1 = _WHEEL[k1, c] / 255.0
        col = (1 - f) * col0 + f * col1
        col = 1 - mag * (1 - col)  # desaturate toward white at low magnitude
        col[bad] = 0.0
        out[..., c] = np.floor(255.0 * col).astype(np.uint8)
    return out


def flow_to_color_device(flow, max_flow: float | None = None, device=None) -> torch.Tensor:
    """Device twin of :func:`flow_to_color`: (H, W, 2) flow -> (H, W, 3) uint8
    RGB on the flow's device (an array goes to ``device``, by default the
    CUDA device: ``models.streaming.resolve_device``).

    The 55-entry wheel is computed arithmetically, not looked up: each RGB
    channel is the floor-quantized piecewise-linear ramp of
    ``_make_color_wheel``.  float32 against the numpy version's float64
    rounds some floor boundaries the other way: within one intensity level.
    """
    if not isinstance(flow, torch.Tensor):
        from cuda_optical_flow_2_torch.models.streaming import resolve_device

        flow = torch.as_tensor(flow, device=resolve_device(device))
    u, v = flow[..., 0], flow[..., 1]
    bad = ~(torch.isfinite(u) & torch.isfinite(v))
    u = torch.where(bad, 0.0, u).to(torch.float32)
    v = torch.where(bad, 0.0, v).to(torch.float32)
    mag = torch.hypot(u, v)
    if max_flow is None:
        mf = mag.max().clamp_min(1e-6)
    elif not np.isfinite(max_flow) or max_flow <= 0:
        raise ValueError(f"max_flow must be a positive finite scale, got {max_flow}")
    else:
        # a fill on the device, not a host-to-device copy: capturable
        mf = torch.full((), max_flow, dtype=torch.float32, device=flow.device)
    u, v = u / mf, v / mf
    mag = torch.clamp(mag / mf, max=1.0)
    ncols = _WHEEL.shape[0]
    angle = torch.atan2(-v, -u) / np.pi
    fk = (angle + 1.0) / 2.0 * (ncols - 1)
    k0 = torch.floor(fk)
    f = fk - k0
    k0 = torch.remainder(k0, ncols)
    k1 = torch.remainder(k0 + 1, ncols)

    def select(k, bounds, choices, default):
        # the first bound that k is below picks its choice, as jnp.select
        out = torch.full_like(k, default) if isinstance(default, float) else default
        for b, c in reversed(list(zip(bounds, choices))):
            out = torch.where(k < b, c, out)
        return out

    # _make_color_wheel arithmetically: segments RY/YG/GC/CB/BM/MR =
    # 15/6/4/11/13/6, channel = floor(255 * ramp) / 255 per segment.
    def wheel(k):
        def ramp_up(k0_, n):
            return torch.floor(255.0 * (k - k0_) / n)

        r = select(k, (15, 21, 25, 36, 49), (255.0, 255.0 - ramp_up(15, 6), 0.0, 0.0,
                                             ramp_up(36, 13)), 255.0)
        g = select(k, (15, 21, 25, 36), (ramp_up(0, 15), 255.0, 255.0, 255.0 - ramp_up(25, 11)),
                   0.0)
        b = select(k, (21, 25, 36, 49), (0.0, ramp_up(21, 4), 255.0, 255.0),
                   255.0 - ramp_up(49, 6))
        return torch.stack([r, g, b], -1) / 255.0

    col = (1.0 - f)[..., None] * wheel(k0) + f[..., None] * wheel(k1)
    col = 1.0 - mag[..., None] * (1.0 - col)
    col = torch.where(bad[..., None], 0.0, col)
    return torch.floor(255.0 * col).to(torch.uint8)


def cleanup_outliers(src: np.ndarray) -> np.ndarray:
    """Binarize a gradient map: [20, 240) -> 255, else 0.

    Twin of utils::cleanup_outliers (OptFlowUtils.cpp:5-19).
    """
    src = np.asarray(to_numpy(src))
    return np.where((src >= 20) & (src < 240), 255, 0).astype(np.uint8)


def _draw_line(img: np.ndarray, y0: int, x0: int, y1: int, x1: int, color) -> None:
    """Bresenham line, in place."""
    h, w = img.shape[:2]
    dy, dx = abs(y1 - y0), abs(x1 - x0)
    sy = 1 if y0 < y1 else -1
    sx = 1 if x0 < x1 else -1
    err = dx - dy
    y, x = y0, x0
    while True:
        if 0 <= y < h and 0 <= x < w:
            img[y, x] = color
        if y == y1 and x == x1:
            break
        e2 = 2 * err
        if e2 > -dy:
            err -= dy
            x += sx
        if e2 < dx:
            err += dx
            y += sy


def draw_flow_arrows(
    image: np.ndarray,
    flow: np.ndarray,
    arrow_res: int = 30,
    color=(255, 0, 0),
) -> np.ndarray:
    """Arrow overlay on a grayscale/RGB image at a sparse grid.

    Reference semantics (visualizeFlowField, main.cu:114-174): sample every
    ``w / arrow_res`` pixels, clamp each component to +-offset, skip arrows
    with a negative endpoint.  Arrowheads are drawn as two short back-strokes.
    """
    image, flow = np.asarray(to_numpy(image)), np.asarray(to_numpy(flow))
    h, w = flow.shape[:2]
    if image.ndim == 2:
        canvas = np.repeat(image[..., None], 3, axis=-1).astype(np.uint8).copy()
    else:
        canvas = image.astype(np.uint8).copy()
    offset = max(w // arrow_res, 1)
    for i in range(0, h, offset):
        for j in range(0, w, offset):
            u = float(np.clip(flow[i, j, 0], -offset, offset))
            v = float(np.clip(flow[i, j, 1], -offset, offset))
            if not (np.isfinite(u) and np.isfinite(v)):
                continue
            ni, nj = int(v + i), int(u + j)
            if ni < 0 or nj < 0:
                continue
            _draw_line(canvas, i, j, ni, nj, color)
            # arrowhead: two strokes back from the tip at ~+-150 degrees
            ang = np.arctan2(ni - i, nj - j)
            ln = max(1, int(0.4 * np.hypot(ni - i, nj - j)))
            for da in (2.5, -2.5):
                ai = int(round(ni + ln * np.sin(ang + da)))
                aj = int(round(nj + ln * np.cos(ang + da)))
                _draw_line(canvas, ni, nj, ai, aj, color)
    return canvas


def draw_tracks(
    image: np.ndarray,
    history,
    alive: np.ndarray | None = None,
    color=(0, 255, 0),
    dot=(255, 255, 0),
) -> np.ndarray:
    """Trajectory overlay: polylines through each point's position history.

    ``history`` is a sequence of (N, 2) ``(x, y)`` arrays, oldest first (the
    successive outputs of ``models.advect_points`` / ``track_sequence``);
    ``alive`` masks out dead points (the sparse tracker's status).  The
    newest position gets a 3x3 dot — the temporal counterpart of the
    reference's per-frame arrow overlay (visualizeFlowField, main.cu:114-174).
    """
    image = np.asarray(to_numpy(image))
    if image.ndim == 2:
        canvas = np.repeat(image[..., None], 3, axis=-1).astype(np.uint8).copy()
    else:
        canvas = image.astype(np.uint8).copy()
    hist = [np.asarray(to_numpy(p)) for p in history]
    if not hist:
        return canvas
    h, w = canvas.shape[:2]
    n = hist[-1].shape[0]
    live = (
        np.ones(n, bool) if alive is None else np.asarray(to_numpy(alive)).astype(bool)
    )
    for k in range(n):
        if not live[k]:
            continue
        for a, b in zip(hist[:-1], hist[1:]):
            x0, y0 = a[k]
            x1, y1 = b[k]
            if not np.all(np.isfinite([x0, y0, x1, y1])):
                continue
            _draw_line(
                canvas, int(round(y0)), int(round(x0)),
                int(round(y1)), int(round(x1)), color,
            )
        x, y = hist[-1][k]
        yi, xi = int(round(y)), int(round(x))
        canvas[max(yi - 1, 0) : yi + 2, max(xi - 1, 0) : xi + 2] = dot
    return canvas


def write_png(path: str, img: np.ndarray) -> None:
    """Write (H, W) gray or (H, W, 3) RGB uint8 to a PNG file (no deps)."""
    img = np.asarray(to_numpy(img))
    if img.dtype != np.uint8:
        raise ValueError("write_png expects uint8")
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    h, w = img.shape[:2]
    raw = b"".join(b"\x00" + img[i].tobytes() for i in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))
