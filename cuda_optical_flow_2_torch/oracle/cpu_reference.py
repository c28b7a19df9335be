"""Exact NumPy twin of the reference's sequential CPU implementation.

The port's copy of ``cuda_optical_flow_2_tpu.oracle.cpu_reference`` (numpy
only; ``tests/test_torch_compat.py`` holds the two equal).

Every function mirrors one function in the reference's ``OptFlowCPU.cpp``
(cited per function) with bit-exact semantics, including:

* per-tap truncation of the int accumulator in the uchar convolutions
  (``int tmp; tmp += float`` truncates toward zero on every accumulation step,
  OptFlowCPU.cpp:87-106),
* modulo-256 wraparound on every ``(unsigned char)`` cast,
* the coarse-to-fine warp's ``1 >> offset == 0`` indexing bug, which makes every
  pixel use the coarser flow sampled at pixel (0, 0) (OptFlowCPU.cpp:260-262),
* the solver bug where ``c`` is never scaled by ``1/det``
  (OptFlowCPU.cpp:374-376 scale a, b, d but not c).

One documented deviation: ``shift_back_pyramid`` in the reference memcpy's only
``w*h`` of the ``w*h*3`` destination bytes before the shift loop
(OptFlowCPU.cpp:247), leaving out-of-bounds pixels partially uninitialized.  The
oracle initializes the full destination from ``src`` (the evident intent); pixels
whose shifted source lands out of bounds therefore keep their original value.

Images are row-major ``(h, w, 3)`` uint8 arrays (interleaved channels, matching
the reference's ``unsigned char*`` layout); flow fields are ``(h, w, 2)`` float32
(interleaved u, v, matching ``float*`` pos*2 / pos*2+1 layout).
"""

from __future__ import annotations

import numpy as np

from cuda_optical_flow_2_torch.constants import (
    DX_3X3,
    DY_3X3,
    GAUS_KERNEL_3X3,
    generate_gaussian_kernel,
)

__all__ = [
    "sub_arr",
    "grayscale_avg",
    "conv_3ch",
    "conv_3ch_to_1ch",
    "downscale_gaussian",
    "gauss_pyramid",
    "srm_1ch",
    "srm_3ch",
    "inverse_matrix",
    "shift_back_pyramid",
    "calc_optical_flow",
    "calc_optical_flow_pyramid",
    "bilateral_filter_3ch",
]


def sub_arr(arr1: np.ndarray, arr2: np.ndarray) -> np.ndarray:
    """uint8 wraparound subtraction. Twin of cpu::sub_arr (OptFlowCPU.cpp:11-17)."""
    return (arr1.astype(np.int32) - arr2.astype(np.int32)).astype(np.uint8)


def grayscale_avg(src: np.ndarray) -> np.ndarray:
    """Average-RGB grayscale, replicated into all 3 channels.

    Twin of cpu::grayscale_avg_cpu (OptFlowCPU.cpp:19-31) and of the live GPU
    kernel g_grayscale_avg_2d (OptFlowGpu.cu:48-60): integer ``(r+g+b)/3`` with
    C truncating division.
    """
    s = src.astype(np.int32)
    avg = (s[..., 0] + s[..., 1] + s[..., 2]) // 3
    return np.repeat(avg.astype(np.uint8)[..., None], 3, axis=-1)


def _conv_accum_truncating(
    src_f: np.ndarray, mask: np.ndarray, h: int, w: int
) -> np.ndarray:
    """Zero-padded 2-D correlation with per-tap trunc-toward-zero accumulation.

    Mirrors the ``int tmp; tmp += src * mask[k]`` accumulation of
    cpu::conv_3ch_to_1ch (OptFlowCPU.cpp:87-106): after each in-bounds tap the
    float partial product is added and the running value is truncated toward
    zero (C float->int conversion).  Out-of-bounds taps are skipped, which
    leaves the accumulator unchanged.
    """
    mh, mw = mask.shape
    hmh, hmw = mh >> 1, mw >> 1
    acc = np.zeros((h, w) + src_f.shape[2:], dtype=np.float64)
    padded = np.zeros((h + mh - 1, w + mw - 1) + src_f.shape[2:], dtype=np.float64)
    padded[hmh : hmh + h, hmw : hmw + w] = src_f
    for i in range(mh):
        for j in range(mw):
            tap = padded[i : i + h, j : j + w] * float(mask[i, j])
            acc = np.trunc(acc + tap)
    return acc


def conv_3ch(src: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """3-channel uchar convolution. Twin of cpu::conv_3ch (OptFlowCPU.cpp:33-73)."""
    h, w = src.shape[:2]
    acc = _conv_accum_truncating(src.astype(np.float64), mask, h, w)
    return (acc.astype(np.int64) % 256).astype(np.uint8)


def conv_3ch_to_1ch(src: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """3ch->1ch uchar convolution reading channel 0 only.

    Twin of cpu::conv_3ch_to_1ch (OptFlowCPU.cpp:75-109): int accumulator with
    per-tap truncation, final ``(unsigned char)`` cast wraps modulo 256.
    """
    h, w = src.shape[:2]
    acc = _conv_accum_truncating(src[..., 0].astype(np.float64), mask, h, w)
    return (acc.astype(np.int64) % 256).astype(np.uint8)


def downscale_gaussian(src: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Fused Gaussian blur + 2x subsample of a 3-channel uchar image.

    Twin of cpu::downscale_gaussian (OptFlowCPU.cpp:112-148) and of the live GPU
    kernel g_gauss_pyramid (OptFlowGpu.cu:1198-1232, which hardcodes the 3x3
    binomial mask): output pixel (x, y) accumulates, in float, the masked source
    taps at (2x - hmw + q, 2y - hmh + p) with zero padding, then truncates to
    uchar.  The source is treated as exactly twice the destination size
    (``pw = w << 1``), matching the reference's even-size assumption.
    """
    sh, sw = src.shape[:2]
    h, w = sh >> 1, sw >> 1
    mh, mw = mask.shape
    hmh, hmw = mh >> 1, mw >> 1
    src_f = src[: 2 * h, : 2 * w].astype(np.float32)
    acc = np.zeros((h, w, 3), dtype=np.float32)
    ys = 2 * np.arange(h)[:, None]
    xs = 2 * np.arange(w)[None, :]
    for p in range(mh):
        for q in range(mw):
            cy = ys + (p - hmh)
            cx = xs + (q - hmw)
            valid = (cy >= 0) & (cy < 2 * h) & (cx >= 0) & (cx < 2 * w)
            cy_c = np.clip(cy, 0, 2 * h - 1)
            cx_c = np.clip(cx, 0, 2 * w - 1)
            tap = src_f[cy_c, cx_c] * np.float32(mask[p, q])
            acc = acc + np.where(valid[..., None], tap, np.float32(0))
    return np.trunc(acc).astype(np.int64).astype(np.uint8)


def gauss_pyramid(
    base: np.ndarray, levels: int, mask: np.ndarray = GAUS_KERNEL_3X3
) -> list[np.ndarray]:
    """Build an n-level Gaussian pyramid; level k has size (h >> k, w >> k).

    Twin of cpu::gauss_pyramid (OptFlowCPU.cpp:151-160) / gpu::gauss_pyramid
    (OptFlowGpu.cu:1262-1271): level k is the blurred 2x subsample of level k-1.
    """
    h, w = base.shape[:2]
    pyr = [base]
    for k in range(1, levels):
        th, tw = h >> k, w >> k
        prev = pyr[-1]
        level = downscale_gaussian(prev[: 2 * th, : 2 * tw], mask)
        pyr.append(level)
    return pyr


def srm_1ch(arr1: np.ndarray, arr2: np.ndarray, ww: int, wh: int) -> np.ndarray:
    """Windowed sum of elementwise products, int32 accumulation, zero padding.

    Twin of cpu::srm_1ch (OptFlowCPU.cpp:162-200): for each pixel, sum
    ``arr1 * arr2`` over the wh x wh window centered at it (window start is
    pixel - window//2), skipping out-of-bounds taps.  uchar inputs, int sums —
    exact in int64.
    """
    h, w = arr1.shape
    prod = arr1.astype(np.int64) * arr2.astype(np.int64)
    hww, hwh = ww >> 1, wh >> 1
    padded = np.zeros((h + wh - 1, w + ww - 1), dtype=np.int64)
    padded[hwh : hwh + h, hww : hww + w] = prod
    acc = np.zeros((h, w), dtype=np.int64)
    for p in range(wh):
        for q in range(ww):
            acc += padded[p : p + h, q : q + w]
    return acc.astype(np.int32)


def srm_3ch(arr1: np.ndarray, arr2: np.ndarray, ww: int, wh: int) -> np.ndarray:
    """Per-channel windowed sum of products — bug-exact off-by-one bounds.

    Twin of cpu::srm_3ch (OptFlowCPU.cpp:202-238, dead in the reference).  The
    reference's bounds check is ``cx > w || cy > h`` instead of ``>=``, so taps
    at cx == w are NOT skipped: the flat index ``cy * w + w`` wraps to pixel
    (cy + 1, 0) of the interleaved buffer, and that wrapped read is reproduced
    here exactly.  Taps whose flat index falls past the end of the buffer
    (cy == h, and the cx == w tap of row h - 1) are undefined behavior in C;
    the oracle reads them as zero (documented deviation).

    Args: (h, w, 3) uint8 arrays. Returns (h, w, 3) int32.
    """
    h, w, _ = arr1.shape
    flat1 = arr1.reshape(-1).astype(np.int64)
    flat2 = arr2.reshape(-1).astype(np.int64)
    # One extra zero pixel so flat reads at index h*w (first out-of-buffer
    # pixel) are representable; anything past that is also zero.
    prod = np.concatenate([flat1 * flat2, np.zeros(3, np.int64)]).reshape(
        h * w + 1, 3
    )
    hkw, hkh = ww >> 1, wh >> 1
    dest = np.zeros((h, w, 3), dtype=np.int64)
    jj = np.arange(w)[None, :]
    ii = np.arange(h)[:, None]
    for y in range(wh):
        for x in range(ww):
            cx = jj - hkw + x
            cy = ii - hkh + y
            # Reference keeps taps with 0 <= cx <= w and 0 <= cy <= h.
            keep = (cx >= 0) & (cy >= 0) & (cx <= w) & (cy <= h)
            pos = np.clip(cy * w + cx, 0, h * w)  # flat, wraps at cx == w
            dest += np.where(keep[..., None], prod[pos], 0)
    return dest.astype(np.int32)


def inverse_matrix(
    sum_ix2: np.ndarray,
    sum_iy2: np.ndarray,
    sum_ixiy: np.ndarray,
    sum_ixit: np.ndarray,
    sum_iyit: np.ndarray,
) -> np.ndarray:
    """Per-pixel 2x2 LK solve from int sums, no determinant guard.

    Twin of cpu::inverse_matrix (OptFlowCPU.cpp:285-309; header comment at
    OptFlowCpu.hpp:284 flags it as "did not work properly" — the int-sum path
    is dead in the reference, superseded by the inline float solve in
    cpu::calc_optical_flow).  ``prefix = 1 / det`` with no |det| guard: det == 0
    produces inf/nan, which pass through exactly as in C.

    Args: (h, w) int32 sums. Returns (h, w, 2) float32 interleaved (u, v).
    """
    a = sum_ix2.astype(np.float32)
    b = sum_ixiy.astype(np.float32)
    c = sum_ixiy.astype(np.float32)
    d = sum_iy2.astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        prefix = np.float32(1.0) / (a * d - b * c)
        a, b, c, d = a * prefix, b * prefix, c * prefix, d * prefix
        u = -d * sum_ixit.astype(np.float32) + b * sum_iyit.astype(np.float32)
        v = c * sum_ixit.astype(np.float32) - a * sum_iyit.astype(np.float32)
    return np.stack([u, v], axis=-1).astype(np.float32)


def shift_back_pyramid(
    src: np.ndarray,
    level: int,
    max_level: int,
    flow_pyramid: list[np.ndarray],
) -> np.ndarray:
    """Warp ``src`` back by the cumulative coarser-level flow — bug-exact.

    Twin of cpu::shift_back_pyramid (OptFlowCPU.cpp:241-282).  Because of the
    reference's ``i * (1 >> offset)`` indexing bug (OptFlowCPU.cpp:260-261,
    ``1 >> offset == 0`` for offset >= 1), the cumulative flow is the SAME for
    every pixel: sum over k in (level, max_level) of 2^(k-level) * flow[k][0, 0].
    The shifted coordinate is truncated toward zero (C float->int conversion)
    and out-of-bounds pixels keep the source value (see module docstring for the
    uninitialized-memory deviation).
    """
    h, w = src.shape[:2]
    u = 0.0
    v = 0.0
    for k in range(max_level - 1, level, -1):
        offset = k - level
        multiplier = float(1 << offset)
        u += multiplier * float(flow_pyramid[k][0, 0, 0])
        v += multiplier * float(flow_pyramid[k][0, 0, 1])
    dest = src.copy()
    jj = np.arange(w)[None, :]
    ii = np.arange(h)[:, None]
    # C `int new_pos_x = j + u` truncates toward zero.
    new_x = np.trunc(jj + np.float64(u)).astype(np.int64) * np.ones_like(ii)
    new_y = np.trunc(ii + np.float64(v)).astype(np.int64) * np.ones_like(jj)
    valid = (new_x >= 0) & (new_x < w) & (new_y >= 0) & (new_y < h)
    src_gathered = src[np.clip(new_y, 0, h - 1), np.clip(new_x, 0, w - 1)]
    dest = np.where(valid[..., None], src_gathered, dest)
    return dest


def calc_optical_flow(
    prev: np.ndarray,
    nxt: np.ndarray,
    flow_pyramid: list[np.ndarray],
    level: int,
    max_level: int,
    window: int = 9,
) -> None:
    """One Lucas-Kanade level; writes flow_pyramid[level] in place.

    Twin of cpu::calc_optical_flow (OptFlowCPU.cpp:312-399):

    * STEP 0: coarse-to-fine warp via :func:`shift_back_pyramid` unless this is
      the coarsest level (OptFlowCPU.cpp:320-325).
    * STEP 1: Ix/Iy via Sobel through the truncating uchar convolution; It as
      the uint8-wraparound difference of 3x3-Gaussian-smoothed next and prev
      (OptFlowCPU.cpp:329-340).
    * STEP 2: five 9x9 windowed product sums in int (OptFlowCPU.cpp:343-358).
    * STEP 3: per-pixel double-precision 2x2 solve with the reference's
      unscaled-``c`` bug and no det==0 guard (OptFlowCPU.cpp:363-384); the
      float32 cast happens on the final u, v only.
    """
    if level != max_level - 1:
        nxt = shift_back_pyramid(nxt, level, max_level, flow_pyramid)

    ix = conv_3ch_to_1ch(prev, DX_3X3)
    iy = conv_3ch_to_1ch(prev, DY_3X3)
    it1 = conv_3ch_to_1ch(prev, GAUS_KERNEL_3X3)
    it2 = conv_3ch_to_1ch(nxt, GAUS_KERNEL_3X3)
    it = sub_arr(it2, it1)

    sum_ix2 = srm_1ch(ix, ix, window, window).astype(np.float64)
    sum_iy2 = srm_1ch(iy, iy, window, window).astype(np.float64)
    sum_ixiy = srm_1ch(ix, iy, window, window).astype(np.float64)
    sum_ixit = srm_1ch(ix, it, window, window).astype(np.float64)
    sum_iyit = srm_1ch(iy, it, window, window).astype(np.float64)

    a = sum_ix2
    b = sum_ixiy
    c = sum_ixiy
    d = sum_iy2
    with np.errstate(divide="ignore", invalid="ignore"):
        prefix = 1.0 / (a * d - b * c)
        a_s = a * prefix
        b_s = b * prefix
        d_s = d * prefix
        # Reference bug: c is never scaled by prefix (OptFlowCPU.cpp:374-376).
        u = (-d_s * sum_ixit + b_s * sum_iyit).astype(np.float32)
        v = (c * sum_ixit - a_s * sum_iyit).astype(np.float32)
    flow_pyramid[level] = np.stack([u, v], axis=-1)


def calc_optical_flow_pyramid(
    prev_pyramid: list[np.ndarray],
    next_pyramid: list[np.ndarray],
    window: int = 9,
) -> list[np.ndarray]:
    """Full coarse-to-fine pass over a pyramid pair (main.cu:256-262 loop).

    Returns the flow pyramid (one (h, w, 2) float32 field per level).
    """
    levels = len(prev_pyramid)
    flow_pyramid: list[np.ndarray] = [
        np.zeros(p.shape[:2] + (2,), dtype=np.float32) for p in prev_pyramid
    ]
    for k in range(levels - 1, -1, -1):
        calc_optical_flow(
            prev_pyramid[k], next_pyramid[k], flow_pyramid, k, levels, window
        )
    return flow_pyramid


def bilateral_filter_3ch(
    src: np.ndarray,
    gray: np.ndarray,
    ww: int,
    wh: int,
    sigma_s: float,
    sigma_b: float,
) -> np.ndarray:
    """Joint bilateral filter, double math, trunc-to-uchar output.

    Twin of cpu::bilinear_filter_3ch (OptFlowCPU.cpp:401-465) and of the live
    GPU kernel g_bilinear_filter (OptFlowGpu.cu:1984-2048) — both share the same
    math.  The spatial mask comes from generate_gaussian_kernel(sigma_s, ww)
    (square, ``ww`` is used for both dims, as in the reference); the range
    weight is an unnormalized Gaussian on channel-0 gray intensity.

    Rectangular windows are rejected: the reference generates only a ww x ww
    spatial kernel into a ww*wh buffer (OptFlowCPU.cpp:403-404), so wh > ww
    reads UNINITIALIZED memory (undefined behavior with no reproducible
    semantics) and wh < ww silently misweights taps; it is only ever called
    square (main.cu:240: ww = wh = 9).
    """
    if ww != wh:
        raise ValueError(
            f"rectangular bilateral windows ({ww}x{wh}) are undefined "
            f"behavior in the reference (uninitialized spatial-kernel rows, "
            f"OptFlowCPU.cpp:403-404); use ww == wh"
        )
    h, w = src.shape[:2]
    spatial = generate_gaussian_kernel(sigma_s, ww)
    hwh, hww = wh >> 1, ww >> 1
    f_ij = gray[..., 0].astype(np.float64)
    num = np.zeros((h, w, 3), dtype=np.float64)
    den = np.zeros((h, w), dtype=np.float64)
    sigma_b2 = float(sigma_b) * float(sigma_b)
    range_norm = 1.0 / (2.0 * np.pi * sigma_b2)
    src_f = src.astype(np.float64)
    for m in range(wh):
        for n in range(ww):
            dy, dx = m - hwh, n - hww
            cy = np.arange(h)[:, None] + dy
            cx = np.arange(w)[None, :] + dx
            valid = (cy >= 0) & (cy < h) & (cx >= 0) & (cx < w)
            cy_c = np.clip(cy, 0, h - 1)
            cx_c = np.clip(cx, 0, w - 1)
            f_mn = f_ij[cy_c, cx_c]
            k = f_mn - f_ij
            n_b = range_norm * np.exp(-0.5 * (k * k) / sigma_b2)
            wgt = np.where(valid, n_b * spatial[m, n], 0.0)
            den += wgt
            num += src_f[cy_c, cx_c] * wgt[..., None]
    out = num / den[..., None]
    return np.trunc(out).astype(np.int64).astype(np.uint8)
