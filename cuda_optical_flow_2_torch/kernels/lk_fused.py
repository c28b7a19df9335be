"""Fused LK residual kernel: gradients + window sums + 2x2 solve in one pass.

Replaces ``cuda_optical_flow_2_tpu/kernels/lk_fused.py::lk_residual``, both
forms: the LK sums and, with ``centered=True``, the mean-normalized sums of
the DIS data term (four more window sums, Ix, Iy, It and the in-image
count, and ``S_ab - S_a S_b / n`` before the solve).  The CUDA source is
``csrc/lk_fused.cu`` with the tile body in ``csrc/of2_lk_tile.cuh``.

What bounds it on an H100: bytes.  Per pixel it reads two f32 planes and
writes one (u, v) pair, against a few hundred flops of stencil and window
arithmetic, far below the card's flop/byte ratio.  The design keeps every
intermediate (Ix, Iy, It, the five or eight row-pass sums) in shared memory
and runs the window as a row pass then a column pass with the taps of
``ops.window.window_weight_taps`` (box, tri and gauss alike).

The five-sum kernel is a walker: a block of 256 threads owns a strip of 64
output columns (:func:`kernels.tile_geometry.lk_strip`, at r = 4, 7 and 9)
and walks down a segment of rows (:func:`kernels.tile_geometry.lk_segment`:
162 rows at 8 x 1080 x 1920) 16 rows a step, keeping a ring of the last
2r + 16 rows' row-pass sums, so the window's vertical halo is staged once
per segment, not once per tile.  A step's ``prev`` rows are copied with
``cp.async``, and the flow and the four bilinear taps of the step after
next are loaded into registers, while the steps before compute.  The
centered (DIS) kernel keeps one 32 x 32 output tile per block of 256
threads (:func:`kernels.tile_geometry.lk_tile`; 24 rows where the grid
would not fill the card once), three blocks an SM: its nine sums'
registers leave the walker two blocks, and there the walker was slower.

Every pass is register-blocked: a thread owns a run of 4 cells, loads each
input of the run's span once into a ring of registers, and forms the
products once per gradient cell; the radii of the main paths (r = 4, 7, 9)
run a kernel compiled for their tap count.  Each window sum keeps one order
per pixel (taps 0..2r, rows then columns), whatever the block, so a band
and the whole image give the same bits.  What the TPU kernel did about its
own limits (rolls on 128-lane padded rows, the O(log r) run-doubling box
sum) has no counterpart here.

:func:`lk_residual` launches the kernel for CUDA tensors and takes
:func:`lk_residual_plain` for CPU tensors; ``lk_residual.launches`` counts
kernel launches and ``lk_residual.launches_centered`` those with
``centered=True``.
"""

from __future__ import annotations

import numpy as np
import torch

from cuda_optical_flow_2_torch.config import LKConfig
from cuda_optical_flow_2_torch.constants import MASKS
from cuda_optical_flow_2_torch.kernels import _build
from cuda_optical_flow_2_torch.kernels import tile_geometry
from cuda_optical_flow_2_torch.ops.band import rows_in_image, zero_outside_global
from cuda_optical_flow_2_torch.ops.gradients import (
    sobel_scale,
    spatial_gradients,
    temporal_gradient,
    temporal_mask,
)
from cuda_optical_flow_2_torch.ops.solve import solve_flow
from cuda_optical_flow_2_torch.ops.window import (
    centered_structure_tensor_sums,
    structure_tensor_sums,
    window_weight_taps,
)

__all__ = ["lk_residual", "lk_residual_plain", "supported", "MAX_WINDOW"]

MAX_WINDOW = 65  # csrc/of2_common.cuh OF2_MAX_R = 32


def supported(config: LKConfig) -> bool:
    """Whether the CUDA LK kernels (``lk_residual``, ``lk_level_step`` and
    its band entry) take this config: a window of at most ``MAX_WINDOW``.
    The config-only counterpart of the JAX ``supported``; past the limit
    the callers take the plain composition, as the JAX package takes its
    XLA twin, and the wrappers raise when called directly."""
    return config.window <= MAX_WINDOW


def lk_residual_plain(
    prev: torch.Tensor,
    nxt: torch.Tensor,
    config: LKConfig,
    centered: bool = False,
    row0: int = 0,
    h_global: int | None = None,
) -> torch.Tensor:
    """The plain PyTorch version: the ops composition of the JAX package's
    ``models/lucas_kanade._lk_residual_xla`` (``centered``:
    ``models/dis._dis_residual_xla``).

    With ``h_global``, the frames are a band holding global rows
    [row0, row0 + H) of an ``h_global``-row image, and the gradients (and
    the centered count) are zero outside the global image before the window
    sums, as the JAX package's ``parallel/spatial._banded_residual``: a
    convolution over the zero rows beyond the image edge still gives
    nonzero "phantom" gradients next to it, which the whole-image sums never
    see."""
    ix, iy = spatial_gradients(prev, config.normalize_gradients)
    it = temporal_gradient(prev, nxt, config.temporal_kernel, config.normalize_gradients)
    valid = None
    if h_global is not None:
        ix, iy, it = (zero_outside_global(g, row0, h_global) for g in (ix, iy, it))
        valid = rows_in_image(ix.shape[-2], row0, h_global, ix.device).expand(ix.shape)
    method, weights = config.window_method, config.window_weights
    if centered:
        sums = centered_structure_tensor_sums(
            ix, iy, it, config.window, method, valid=valid, weights=weights
        )
    else:
        sums = structure_tensor_sums(ix, iy, it, config.window, method, weights=weights)
    return solve_flow(sums, config)


def kernel_constants(config: LKConfig) -> tuple[int, np.ndarray, np.ndarray]:
    """(r, window taps, the three 3x3 masks flattened) for the C entry points."""
    if config.window > MAX_WINDOW:
        raise ValueError(f"the CUDA LK kernels take window <= {MAX_WINDOW}, got {config.window}")
    taps = np.ascontiguousarray(window_weight_taps(config.window, config.window_weights))
    scale = sobel_scale(config.normalize_gradients)
    masks = np.concatenate(
        [
            (MASKS["sobel_x"] * scale).ravel(),
            (MASKS["sobel_y"] * scale).ravel(),
            temporal_mask(config.temporal_kernel, config.normalize_gradients).ravel(),
        ]
    ).astype(np.float32)
    return config.window // 2, taps, masks


def planes(*tensors: torch.Tensor) -> list[torch.Tensor]:
    """Contiguous float32 (B, H, W[, 2]) views of equally-shaped inputs."""
    return [t.to(torch.float32).contiguous() for t in tensors]


def lk_residual(
    prev: torch.Tensor, nxt: torch.Tensor, config: LKConfig, centered: bool = False
) -> torch.Tensor:
    """Residual flow (..., H, W, 2) between prev and (already warped) next;
    ``centered=True`` mean-normalizes the window sums (the DIS data term)."""
    if prev.device.type == "cpu" and nxt.device.type == "cpu":
        return lk_residual_plain(prev, nxt, config, centered)
    dev = _build.require_cuda(prev, nxt)
    if prev.shape != nxt.shape:
        raise ValueError(f"frame shapes differ: {tuple(prev.shape)} vs {tuple(nxt.shape)}")
    lead, (h, w) = prev.shape[:-2], prev.shape[-2:]
    p, n = planes(prev.reshape(-1, h, w), nxt.reshape(-1, h, w))
    out = torch.empty(p.shape + (2,), dtype=torch.float32, device=dev)
    r, taps, masks = kernel_constants(config)
    _build.launch(
        dev, "of2_lk_residual", p.data_ptr(), n.data_ptr(), out.data_ptr(), p.shape[0], h, w, r,
        *tile_geometry.lk_launch(p.shape[0], h, w, r, centered), taps.ctypes.data,
        masks.ctypes.data, float(config.det_eps), int(centered),
    )
    lk_residual.launches += 1
    lk_residual.launches_centered += int(centered)
    return out.reshape(lead + (h, w, 2))


lk_residual.launches = 0
lk_residual.launches_centered = 0
