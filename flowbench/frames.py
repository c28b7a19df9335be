"""Seeded uint8 grayscale clips, made on the device in a few large calls.

Two kinds, both a sum of random sinusoidal waves (a texture with structure
at many scales and in every direction) plus sensor noise, rounded to uint8:

* :func:`video_clip`: one scene under a smooth affine camera motion (pan,
  roll and zoom about the image centre), so the flow of each pair varies
  over the image;
* :func:`stream_clips`: one periodic texture per stream, translating a whole
  number of periods over the loop, so a stream's clip repeats without a cut.

The same seed on the same kind of device gives the same frames; every seed
gives the same sizes.
"""

from __future__ import annotations

import math

import torch

__all__ = ["generator", "stream_clips", "video_clip"]


def generator(seed: int, device: torch.device) -> torch.Generator:
    """A generator on ``device`` seeded from ``seed`` (any whole number up to
    2**63 - 1)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2**63 - 1))
    return gen


def _uniform(gen, shape, lo, hi, device) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)


def _to_uint8(img: torch.Tensor, gen, noise: float) -> torch.Tensor:
    if noise:
        img = img + noise * torch.randn(img.shape, generator=gen, device=img.device)
    return img.round().clamp(0, 255).to(torch.uint8)


def video_clip(seed: int, frames: int, h: int, w: int, device, *, waves: int = 24,
               wavelength_px=(6.0, 120.0), pan_px: float = 3.0, roll_deg: float = 0.15,
               zoom: float = 0.002, noise: float = 2.0) -> torch.Tensor:
    """(frames, h, w) uint8: frame t samples the texture at the image point
    that the camera motion M^t maps there, M a pan of ``pan_px`` px, a roll
    of ``roll_deg`` degrees and a zoom of ``zoom`` per frame.

    The wavelengths (geometric between ``wavelength_px``), the wave
    directions (golden-angle spaced), the amplitudes and the motion's sizes
    are the same for every seed; the seed draws the waves' phases, the
    pan's direction and the signs of the roll and the zoom.  So every seed
    asks the same work of a kernel whose time depends on its data (TV-L1's
    threshold step divides at some pixels only), in another arrangement."""
    device = torch.device(device)
    gen = generator(seed, device)
    j = torch.arange(waves, dtype=torch.float32, device=device)
    lo, hi = wavelength_px
    lam = lo * (hi / lo) ** (j / max(1, waves - 1))
    ang = torch.remainder(j * math.pi * (3 - math.sqrt(5)), math.pi)
    kx, ky = 2 * math.pi * torch.cos(ang) / lam, 2 * math.pi * torch.sin(ang) / lam
    amp = 60.0 * (lam / hi) ** 0.5 / math.sqrt(waves / 4)
    phase = _uniform(gen, (waves,), 0.0, 2 * math.pi, device)
    heading = _uniform(gen, (), 0.0, 2 * math.pi, device)
    pan = pan_px * torch.stack([torch.cos(heading), torch.sin(heading)])
    signs = 2 * torch.randint(0, 2, (2,), generator=gen, device=device).float() - 1
    roll = math.radians(roll_deg) * signs[0]
    scale = 1.0 + zoom * signs[1]
    ys = torch.arange(h, dtype=torch.float32, device=device)[:, None] - (h - 1) / 2
    xs = torch.arange(w, dtype=torch.float32, device=device)[None, :] - (w - 1) / 2
    out = torch.empty((frames, h, w), dtype=torch.uint8, device=device)
    for t in range(frames):
        # texture point shown at (x, y) in frame t: the inverse of M^t
        c, s = torch.cos(-roll * t), torch.sin(-roll * t)
        z = scale ** (-t)
        px = z * (c * xs - s * ys) - t * pan[0]
        py = z * (s * xs + c * ys) - t * pan[1]
        img = torch.full((h, w), 128.0, device=device)
        for i in range(waves):
            img = img + amp[i] * torch.sin(kx[i] * px + ky[i] * py + phase[i])
        out[t] = _to_uint8(img, gen, noise)
    return out


def stream_clips(seed: int, frames: int, streams: int, h: int, w: int, device, *,
                 waves: int = 16, period_px: int = 288, max_k: int = 4, max_periods: int = 1,
                 noise: float = 2.0) -> torch.Tensor:
    """(frames, streams, h, w) uint8: stream s shows its own texture of
    period ``period_px`` in x and y (waves of up to ``max_k`` cycles per
    period, amplitude falling as 1 / frequency, as in natural images),
    translating by (mx, my) * period_px / frames px per frame with whole
    mx, my in [-max_periods, max_periods] and not 0, so frame ``frames``
    would equal frame 0 and the clip loops without a cut.  Noise is drawn
    per frame and does not loop."""
    device = torch.device(device)
    gen = generator(seed, device)
    shape = (streams, waves)
    kx = torch.randint(-max_k, max_k + 1, shape, generator=gen, device=device).float()
    ky = torch.randint(1, max_k + 1, shape, generator=gen, device=device).float()
    amp = 70.0 * torch.rsqrt(kx * kx + ky * ky) / math.sqrt(waves / 4)
    phase = _uniform(gen, shape, 0.0, 2 * math.pi, device)
    m = torch.randint(-max_periods, max_periods, (streams, 2), generator=gen, device=device)
    m = m + (m >= 0).long()  # whole periods in [-max, max], not 0
    v = m.float() * period_px / frames  # px per frame, (streams, 2)
    k = 2 * math.pi / period_px
    ys = torch.arange(h, dtype=torch.float32, device=device)
    xs = torch.arange(w, dtype=torch.float32, device=device)
    out = torch.empty((frames, streams, h, w), dtype=torch.uint8, device=device)
    for t in range(frames):
        ax = k * (xs[None, :] - t * v[:, 0:1])  # (streams, w)
        ay = k * (ys[None, :] - t * v[:, 1:2])  # (streams, h)
        img = torch.full((streams, h, w), 128.0, device=device)
        for j in range(waves):
            bx = kx[:, j:j + 1] * ax + phase[:, j:j + 1]
            by = ky[:, j:j + 1] * ay
            # sin(bx + by) as a sum of two outer products
            img = img + amp[:, j, None, None] * (
                torch.sin(bx)[:, None, :] * torch.cos(by)[:, :, None]
                + torch.cos(bx)[:, None, :] * torch.sin(by)[:, :, None])
        out[t] = _to_uint8(img, gen, noise)
    return out
