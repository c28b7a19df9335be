"""Reference-exact pipelines (the compat profiles) in PyTorch.

Counterpart of ``cuda_optical_flow_2_tpu.models.compat``.  BASELINE config 1
asks for the reference CPU implementation reproduced *exactly* ("exact vs
OptFlowCPU semantics"); this module runs both reference paths bug for bug:

* ``cpu``: the OptFlowCPU.cpp path — uchar-truncating convolutions, uint8
  wraparound It, 9x9 integer window sums, double solve with the unscaled-``c``
  bug, (0,0)-sampled nearest warp.
* ``gpu``: the live OptFlowGpu.cu path — float gradients, unnormalized Dt_3x3
  temporal kernel, 19x19 float window sums, double solve (all four scaled),
  same buggy warp (the GPU path calls the CPU warp, OptFlowGpu.cu:1920).

Integer stages are exact on any device.  The solve runs in ``torch.float64``
on every device; the JAX module solves in float64 only with
``jax_enable_x64`` on (which its tests turn on), else in float32.
Production work should use ``models/lucas_kanade.py``, not this module.

All functions take interleaved (H, W, 3) uint8 tensors, like the
reference's buffers, and run on the device of their inputs (plain torch: the
JAX module is plain XLA and reaches no kernel).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from cuda_optical_flow_2_torch.constants import DT_3X3, DX_3X3, DY_3X3, GAUS_KERNEL_3X3
from cuda_optical_flow_2_torch.ops.window import window_sum

__all__ = [
    "conv_3ch_to_1ch_u8",
    "conv_3ch_1ch_f32",
    "sub_arr_u8",
    "downscale_gaussian_u8",
    "build_pyramid_u8",
    "srm_1ch_i32",
    "shift_back_exact",
    "lk_level_exact",
    "pyramidal_lk_exact",
]

_SOLVE_DTYPE = torch.float64


def _padded_plane(src: torch.Tensor, mh: int, mw: int) -> torch.Tensor:
    """Channel 0 as float32, zero-padded by the mask's half sizes."""
    plane = src[..., 0].to(torch.float32)
    return F.pad(plane, (mw // 2, mw - 1 - mw // 2, mh // 2, mh - 1 - mh // 2))


def conv_3ch_to_1ch_u8(src: torch.Tensor, mask: np.ndarray) -> torch.Tensor:
    """Per-tap-truncating uchar convolution of channel 0.

    Exact twin of cpu::conv_3ch_to_1ch (OptFlowCPU.cpp:75-109): the int
    accumulator truncates toward zero after every in-bounds tap; the final
    ``(unsigned char)`` cast wraps modulo 256.  Accumulator magnitudes stay
    below 2^12, so float32 ``trunc`` is exact.
    """
    mh, mw = mask.shape
    h, w = src.shape[:2]
    padded = _padded_plane(src, mh, mw)
    acc = torch.zeros((h, w), dtype=torch.float32, device=src.device)
    for i in range(mh):
        for j in range(mw):
            acc = torch.trunc(acc + padded[i : i + h, j : j + w] * float(mask[i, j]))
    return torch.remainder(acc.to(torch.int32), 256).to(torch.uint8)


def conv_3ch_1ch_f32(src: torch.Tensor, mask: np.ndarray) -> torch.Tensor:
    """Float gradient convolution of channel 0, zero-padded.

    Twin of g_conv_3ch_1ch_constant_uchar_float (OptFlowGpu.cu:1041-1089).
    """
    mh, mw = mask.shape
    h, w = src.shape[:2]
    padded = _padded_plane(src, mh, mw)
    acc = torch.zeros((h, w), dtype=torch.float32, device=src.device)
    for i in range(mh):
        for j in range(mw):
            if float(mask[i, j]) == 0.0:
                continue
            acc = acc + padded[i : i + h, j : j + w] * float(mask[i, j])
    return acc


def sub_arr_u8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """uint8 wraparound subtraction (cpu::sub_arr, OptFlowCPU.cpp:11-17)."""
    return torch.remainder(a.to(torch.int32) - b.to(torch.int32), 256).to(torch.uint8)


def downscale_gaussian_u8(src: torch.Tensor, mask: np.ndarray = GAUS_KERNEL_3X3) -> torch.Tensor:
    """Fused blur + 2x subsample with trunc-to-uchar output.

    Exact twin of cpu::downscale_gaussian / g_gauss_pyramid
    (OptFlowCPU.cpp:112-148, OptFlowGpu.cu:1198-1232): float32 accumulation in
    tap order, zero padding, truncating uchar cast.
    """
    sh, sw = src.shape[:2]
    h, w = sh >> 1, sw >> 1
    mh, mw = mask.shape
    hmh, hmw = mh >> 1, mw >> 1
    src_f = src[: 2 * h, : 2 * w].to(torch.float32).permute(2, 0, 1)
    padded = F.pad(src_f, (hmw, mw - 1 - hmw, hmh, mh - 1 - hmh))
    acc = torch.zeros((3, h, w), dtype=torch.float32, device=src.device)
    for p in range(mh):
        for q in range(mw):
            # output (y, x) taps source (2y - hmh + p, 2x - hmw + q).
            acc = acc + padded[:, p : p + 2 * h : 2, q : q + 2 * w : 2] * float(mask[p, q])
    return torch.trunc(acc).to(torch.int32).to(torch.uint8).permute(1, 2, 0).contiguous()


def build_pyramid_u8(base: torch.Tensor, levels: int) -> list[torch.Tensor]:
    """Exact uchar pyramid (gpu::gauss_pyramid, OptFlowGpu.cu:1262-1271)."""
    h, w = base.shape[:2]
    pyr = [base]
    for k in range(1, levels):
        th, tw = h >> k, w >> k
        pyr.append(downscale_gaussian_u8(pyr[-1][: 2 * th, : 2 * tw]))
    return pyr


def srm_1ch_i32(a: torch.Tensor, b: torch.Tensor, window: int) -> torch.Tensor:
    """Exact integer windowed product sums (cpu::srm_1ch, OptFlowCPU.cpp:162-200).

    An int64 integral image read at four clipped corners, exact at any image
    size (the JAX module sums in int64 with x64 on, int32 otherwise).
    """
    if window % 2 != 1:
        raise ValueError(f"window must be odd, got {window}")
    r = window // 2
    h, w = a.shape
    prod = a.to(torch.int64) * b.to(torch.int64)
    ii = F.pad(torch.cumsum(torch.cumsum(prod, dim=0), dim=1), (1, 0, 1, 0))
    rows = torch.arange(h, device=a.device)
    cols = torch.arange(w, device=a.device)
    y1, y0 = (rows + r + 1).clamp(0, h), (rows - r).clamp(0, h)
    x1, x0 = (cols + r + 1).clamp(0, w), (cols - r).clamp(0, w)

    def corner(ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
        return ii[ys][:, xs]

    out = corner(y1, x1) - corner(y0, x1) - corner(y1, x0) + corner(y0, x0)
    return out.to(torch.int32)


def shift_back_exact(
    src: torch.Tensor,
    level: int,
    max_level: int,
    flow_pyramid: list[torch.Tensor],
) -> torch.Tensor:
    """Bug-exact coarse-to-fine warp (cpu::shift_back_pyramid).

    Because of the reference's ``1 >> offset`` bug the cumulative flow is a
    single (u, v) from pixel (0, 0) of each coarser level
    (OptFlowCPU.cpp:260-265), so the warp is a uniform integer shift with C
    trunc-toward-zero and keep-original out-of-bounds handling.
    """
    h, w = src.shape[:2]
    dev = src.device
    u = torch.zeros((), dtype=_SOLVE_DTYPE, device=dev)
    v = torch.zeros((), dtype=_SOLVE_DTYPE, device=dev)
    for k in range(max_level - 1, level, -1):
        mult = float(1 << (k - level))
        u = u + mult * flow_pyramid[k][0, 0, 0].to(_SOLVE_DTYPE)
        v = v + mult * flow_pyramid[k][0, 0, 1].to(_SOLVE_DTYPE)
    jj = torch.arange(w, dtype=_SOLVE_DTYPE, device=dev).expand(h, w)
    ii = torch.arange(h, dtype=_SOLVE_DTYPE, device=dev)[:, None].expand(h, w)
    new_x = torch.trunc(jj + u).to(torch.int32)
    new_y = torch.trunc(ii + v).to(torch.int32)
    valid = (new_x >= 0) & (new_x < w) & (new_y >= 0) & (new_y < h)
    idx = new_y.clamp(0, h - 1).to(torch.int64) * w + new_x.clamp(0, w - 1).to(torch.int64)
    gathered = src.reshape(h * w, 3)[idx.reshape(-1)].reshape(h, w, 3)
    return torch.where(valid[..., None], gathered, src)


def lk_level_exact(
    prev: torch.Tensor,
    nxt: torch.Tensor,
    flow_pyramid: list[torch.Tensor],
    level: int,
    max_level: int,
    window: int,
    profile: str,
) -> torch.Tensor:
    """One LK level with reference-exact semantics; returns the level's flow.

    ``profile``: "cpu" (OptFlowCPU.cpp:312-399) or "gpu"
    (OptFlowGpu.cu:1909-1979).
    """
    if level != max_level - 1:
        nxt = shift_back_exact(nxt, level, max_level, flow_pyramid)

    dtype = _SOLVE_DTYPE
    if profile == "cpu":
        ix = conv_3ch_to_1ch_u8(prev, DX_3X3)
        iy = conv_3ch_to_1ch_u8(prev, DY_3X3)
        it1 = conv_3ch_to_1ch_u8(prev, GAUS_KERNEL_3X3)
        it2 = conv_3ch_to_1ch_u8(nxt, GAUS_KERNEL_3X3)
        it = sub_arr_u8(it2, it1)
        sum_ix2 = srm_1ch_i32(ix, ix, window).to(dtype)
        sum_iy2 = srm_1ch_i32(iy, iy, window).to(dtype)
        sum_ixiy = srm_1ch_i32(ix, iy, window).to(dtype)
        sum_ixit = srm_1ch_i32(ix, it, window).to(dtype)
        sum_iyit = srm_1ch_i32(iy, it, window).to(dtype)
    elif profile == "gpu":
        ix = conv_3ch_1ch_f32(prev, DX_3X3)
        iy = conv_3ch_1ch_f32(prev, DY_3X3)
        it = conv_3ch_1ch_f32(nxt, DT_3X3) - conv_3ch_1ch_f32(prev, DT_3X3)
        sums = window_sum(torch.stack([ix * ix, iy * iy, ix * iy, ix * it, iy * it]), window)
        sum_ix2, sum_iy2, sum_ixiy, sum_ixit, sum_iyit = sums.to(dtype).unbind(0)
    else:
        raise ValueError(f"unknown profile {profile!r}")

    a, b, c, d = sum_ix2, sum_ixiy, sum_ixiy, sum_iy2
    prefix = 1.0 / (a * d - b * c)
    u = (-(d * prefix) * sum_ixit + (b * prefix) * sum_iyit).to(torch.float32)
    if profile == "cpu":
        # Reference bug: c is never scaled by prefix (OptFlowCPU.cpp:374-376).
        v = (c * sum_ixit - (a * prefix) * sum_iyit).to(torch.float32)
    else:
        v = ((c * prefix) * sum_ixit - (a * prefix) * sum_iyit).to(torch.float32)
    return torch.stack([u, v], dim=-1)


def pyramidal_lk_exact(
    prev: torch.Tensor,
    nxt: torch.Tensor,
    levels: int,
    window: int | None = None,
    profile: str = "cpu",
) -> list[torch.Tensor]:
    """Full reference-exact coarse-to-fine pass on (H, W, 3) uint8 frames.

    Builds exact uchar pyramids and runs the per-level solve coarsest-first
    (main.cu:256-262).  Default windows follow the reference: 9 for the CPU
    profile, 19 for the GPU profile.  Returns the flow pyramid, finest first.
    """
    if window is None:
        window = 9 if profile == "cpu" else 19
    prev_pyr = build_pyramid_u8(prev, levels)
    next_pyr = build_pyramid_u8(nxt, levels)
    flow_pyramid = [
        torch.zeros(p.shape[:2] + (2,), dtype=torch.float32, device=p.device) for p in prev_pyr
    ]
    for k in range(levels - 1, -1, -1):
        flow_pyramid[k] = lk_level_exact(
            prev_pyr[k], next_pyr[k], flow_pyramid, k, levels, window, profile
        )
    return flow_pyramid
