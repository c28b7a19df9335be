"""Fused windowed sums + guarded 2x2 solve: the normal-equation tail.

Replaces ``cuda_optical_flow_2_tpu/kernels/win_solve.py::window_solve``.
CUDA source: ``csrc/win_solve.cu`` with the window pass and the solve in
``csrc/of2_win_tile.cuh``, which the fused FB step (``fb_step_fused``)
shares.  Given five per-pixel planes (g11, g12, g22, h1, h2) it box-sums each
over ``window x window`` (zero outside the image, ``ops.window.window_sum``)
and solves [[g11, g12], [g12, g22]] d = (h1, h2):
``det = g11 g22 - g12^2``; pixels with ``|det| < det_eps`` get zero flow;
``det_eps <= 0`` divides unguarded, as ``models.farneback.solve_normal_eqs``.
It is the Farnebäck ``warp_planes="coeff"`` iteration's last stage.

What bounds it on an H100: bytes.  Per pixel it reads five floats and
writes two (28 bytes) against 2 x window adds for each of the five planes
(150 at a 15x15 window) and about 10 operations of solve, under the card's
20 operations per byte up to a 33x33 window.  A block stages an output tile
(``tile_geometry.win_tile``, picked for the radius) plus its window halo of
all five planes in shared memory with ``cp.async``, runs the register-blocked
column pass then row pass there (a thread sums four cells from registers,
each in the plain version's order, so the flow is bit-equal to the plain
version), and writes only (u, v); the plain version makes a device-memory
pass per tap and plane.  The radius of ``FBConfig()`` (winsize 15) runs a
kernel compiled for its taps.

:func:`window_solve` launches the kernel for CUDA tensors and takes
:func:`window_solve_plain` for CPU tensors; ``window_solve.launches`` counts
kernel launches.  Over ``MAX_WINDOW`` the wrapper raises.
"""

from __future__ import annotations

import torch

from cuda_optical_flow_2_torch.kernels import _build
from cuda_optical_flow_2_torch.kernels.tile_geometry import win_tile
from cuda_optical_flow_2_torch.kernels.lk_fused import planes
from cuda_optical_flow_2_torch.ops.window import window_sum

__all__ = ["window_solve", "window_solve_plain", "MAX_WINDOW"]

MAX_WINDOW = 33  # csrc/of2_win_tile.cuh OF2_WT_MAX_R = 16


def window_solve_plain(
    p11: torch.Tensor,
    p12: torch.Tensor,
    p22: torch.Tensor,
    h1: torch.Tensor,
    h2: torch.Tensor,
    window: int,
    det_eps: float = 1e-6,
) -> torch.Tensor:
    """The plain PyTorch version: ``window_sum`` of the stacked planes, then
    ``models.farneback.solve_normal_eqs``."""
    from cuda_optical_flow_2_torch.models.farneback import solve_normal_eqs

    sums = window_sum(torch.stack([p11, p12, p22, h1, h2]).to(torch.float32), window)
    return solve_normal_eqs(sums, det_eps)


def check_window(window: int) -> int:
    """The window radius, raising over ``MAX_WINDOW`` or for an even window."""
    if window % 2 != 1:
        raise ValueError(f"window must be odd, got {window}")
    if window > MAX_WINDOW:
        raise ValueError(f"the CUDA window-solve kernels take window <= {MAX_WINDOW}, got {window}")
    return window // 2


def window_solve(
    p11: torch.Tensor,
    p12: torch.Tensor,
    p22: torch.Tensor,
    h1: torch.Tensor,
    h2: torch.Tensor,
    window: int,
    det_eps: float = 1e-6,
) -> torch.Tensor:
    """Box-window the five (..., H, W) planes and solve -> flow (..., H, W, 2)."""
    tensors = (p11, p12, p22, h1, h2)
    if all(t.device.type == "cpu" for t in tensors):
        return window_solve_plain(*tensors, window, det_eps)
    rw = check_window(window)
    dev = _build.require_cuda(*tensors)
    lead, (h, w) = p11.shape[:-2], p11.shape[-2:]
    if any(t.shape != p11.shape for t in tensors):
        raise ValueError(f"plane shapes differ: {[tuple(t.shape) for t in tensors]}")
    xs = planes(*(t.reshape(-1, h, w) for t in tensors))
    out = torch.empty(xs[0].shape + (2,), dtype=torch.float32, device=dev)
    tile = win_tile(rw)
    _build.launch(
        dev, "of2_window_solve", *(x.data_ptr() for x in xs), out.data_ptr(), xs[0].shape[0],
        h, w, rw, tile.tile_h, tile.tile_w, float(det_eps),
    )
    window_solve.launches += 1
    return out.reshape(lead + (h, w, 2))


window_solve.launches = 0
