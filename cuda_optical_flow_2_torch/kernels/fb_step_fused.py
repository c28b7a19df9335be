"""Fused Farnebäck iteration: warp + re-expansion + products + window solve.

Replaces ``cuda_optical_flow_2_tpu/kernels/fb_step_fused.py``: the
whole-image ``fb_level_step`` and the spatial-TP band entry
``fb_band_step``.  CUDA source: ``csrc/fb_step.cu``, with the expansion of
``csrc/of2_poly.cuh`` and
the window and solve of ``csrc/of2_win_tile.cuh``.  One launch per
displacement refinement of the ``warp_planes="image"`` formulation computes
one iteration of ``models.farneback.fb_level_image``'s plain path:

    fc      = clip(flow, +-max_displacement)          (0 when ``first``)
    warped  = warp_bilinear(next, fc)                  (next when ``first``;
                                                        out-of-image samples
                                                        keep the source pixel)
    exp_w   = poly_expansion(warped)                   (zero-padded)
    prods   = fb_normal_eq_products(exp1, exp_w, fc)   (zero outside the image)
    flow'   = solve_normal_eqs(box window of prods)    (TOTAL flow)

What bounds it on an H100: bytes, at the function's count: next, the five
prev-expansion planes and the flow in, the flow out (40 bytes per pixel),
against about 190 operations of expansion, 40 of products, 150 of window
and 30 of warp and solve per pixel at the defaults.  The TPU kernel warped
with select-loops over a bounded displacement range; here each pixel
gathers its four taps directly (``of2_warp_pixel_band``).  The design keeps every
intermediate in shared memory: a block warps its output tile plus an
(r_win + r_poly) halo once, expands it and forms the products over the tile
plus an r_win halo, then windows and solves, so only the flow goes back to
device memory.  Every pass is register-blocked (a thread owns a run of 4
cells and loads each input of the run's span once), the warp takes eight
cells a thread at once with every load unconditional, and ``FBConfig()``'s
radii run a kernel compiled for them.  The tile is picked per radius
(:func:`kernels.tile_geometry.fb_tile`): 16 x 32 at the defaults, 54,768
bytes of shared memory, so four blocks share an SM; the halos cost
recomputation (the products over 30 x 46 pixels for 16 x 32 outputs).

The band entry passes the band's global row ``row0`` and the image height
``h_global``: the warp floors and clamps the sample row in global rows, and
the warped band and the products are zero outside the global image, so the
expansion and the window see the whole image's zero padding.  With a caller
halo of :func:`band_margin` plus the warp budget and 2 rows the kept rows
match the whole image.  The TPU kernel's recentering mask (``real``) served
its select-loop warp and has no counterpart.  The whole-image entry is the
band ``(0, H)``.

:func:`fb_level_step` and :func:`fb_band_step` launch the kernel for CUDA
tensors and take their plain versions for CPU tensors; ``.launches`` on
each counts its kernel launches.  A config the kernel does not take
(:func:`supported`) makes the wrappers raise on CUDA tensors.
"""

from __future__ import annotations

import torch

from cuda_optical_flow_2_torch.kernels import _build
from cuda_optical_flow_2_torch.kernels.lk_fused import planes
from cuda_optical_flow_2_torch.kernels.tile_geometry import fb_tile
from cuda_optical_flow_2_torch.kernels.poly_exp_fused import MAX_POLY_N, checked_taps
from cuda_optical_flow_2_torch.kernels.win_solve import MAX_WINDOW, check_window
from cuda_optical_flow_2_torch.ops.band import zero_outside_global
from cuda_optical_flow_2_torch.ops.poly_exp import poly_expansion
from cuda_optical_flow_2_torch.ops.warp import warp_bilinear, warp_bilinear_band

__all__ = [
    "band_margin",
    "fb_band_step",
    "fb_band_step_plain",
    "fb_level_step",
    "fb_level_step_plain",
    "supported",
]


def supported(config) -> bool:
    """Whether the kernel computes this FBConfig's iteration: a box window of
    at most ``MAX_WINDOW`` and ``poly_n`` of at most ``MAX_POLY_N`` (the
    config-only part of the JAX ``supported``; its tile and displacement
    limits belong to the TPU's memory and select-loops)."""
    return (
        not config.gaussian_window
        and config.winsize <= MAX_WINDOW
        and config.poly_n <= MAX_POLY_N
    )


def band_margin(config) -> int:
    """Rows at each band edge that the band step leaves as margin (garbage
    on output): the window and expansion radii plus one, rounded up to 4,
    the JAX kernel's formula, so spatial TP's halos and validator limits
    match the JAX package's."""
    return -(-(config.winsize // 2 + config.poly_n // 2 + 1) // 4) * 4


def fb_level_step_plain(
    nxt: torch.Tensor,
    exp1: tuple[torch.Tensor, ...],
    flow: torch.Tensor | None,
    config,
    first: bool = False,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """The plain PyTorch version: one iteration of the plain image path of
    ``models.farneback.fb_level_image``, in ``dtype`` (float64 with float64
    ``exp1`` and ``flow``: the reference that shows float32's conditioning,
    ``chip_smoke.py`` phase 3)."""
    from cuda_optical_flow_2_torch.models.farneback import (
        _window,
        fb_normal_eq_products,
        solve_normal_eqs,
    )

    nxt = nxt.to(dtype)
    if first:
        warped = poly_expansion(nxt, config.poly_n, config.poly_sigma)
        u = v = torch.zeros_like(exp1[0])
    else:
        d = float(config.max_displacement)
        flow = flow.clamp(-d, d)
        warped = poly_expansion(warp_bilinear(nxt, flow), config.poly_n, config.poly_sigma)
        u, v = flow[..., 0], flow[..., 1]
    prods = fb_normal_eq_products(exp1, warped, u, v)
    return solve_normal_eqs(_window(torch.stack(prods), config), config.det_eps)


def fb_band_step_plain(
    nxt: torch.Tensor,
    exp1: tuple[torch.Tensor, ...],
    flow: torch.Tensor | None,
    row0: int,
    config,
    h_global: int,
    first: bool = False,
) -> torch.Tensor:
    """The plain PyTorch version of the band entry: one iteration of the
    JAX package's non-fused band step on the whole band (the band warp in
    global rows, the warped band and the products zero outside the global
    image, zero padding past the band edge)."""
    from cuda_optical_flow_2_torch.models.farneback import (
        _window,
        fb_normal_eq_products,
        solve_normal_eqs,
    )

    nxt = nxt.to(torch.float32)
    if first:
        warped = nxt
        u = v = torch.zeros_like(exp1[0])
    else:
        d = float(config.max_displacement)
        flow = flow.clamp(-d, d)
        warped = warp_bilinear_band(nxt, flow, row0, row0, h_global)
        u, v = flow[..., 0], flow[..., 1]
    w_exp = poly_expansion(zero_outside_global(warped, row0, h_global), config.poly_n,
                           config.poly_sigma)
    prods = zero_outside_global(torch.stack(fb_normal_eq_products(exp1, w_exp, u, v)), row0,
                                h_global)
    return solve_normal_eqs(_window(prods, config), config.det_eps)


def fb_level_step(
    nxt: torch.Tensor,
    exp1: tuple[torch.Tensor, ...],
    flow: torch.Tensor | None,
    config,
    first: bool = False,
) -> torch.Tensor:
    """One fused Farnebäck refinement (image formulation).

    Args:
      nxt: (..., H, W) next frame at this pyramid level.
      exp1: (bx, by, axx, ayy, axy) expansion planes of the previous frame.
      flow: (..., H, W, 2) prior total flow; not read (and may be None)
        when ``first``.
      config: an FBConfig.
      first: no prior flow: expand next directly, zero flow in the products.
    Returns the refined total flow (..., H, W, 2) float32.
    """
    tensors = (nxt, *exp1) + (() if first else (flow,))
    if all(t.device.type == "cpu" for t in tensors):
        return fb_level_step_plain(nxt, exp1, flow, config, first)
    out = _launch(nxt, exp1, flow, config, first, 0, nxt.shape[-2])
    fb_level_step.launches += 1
    return out


def fb_band_step(
    nxt: torch.Tensor,
    exp1: tuple[torch.Tensor, ...],
    flow: torch.Tensor | None,
    row0: int,
    config,
    h_global: int,
    first: bool = False,
) -> torch.Tensor:
    """One fused Farnebäck refinement on a row band holding global rows
    [row0, row0 + HB) of an ``h_global``-row image (the spatial-TP entry,
    ``parallel/spatial_models.py``); arguments as :func:`fb_level_step`, on
    the band.  Rows at least ``band_margin(config) + ceil(max_displacement)
    + 2`` from the band edges match :func:`fb_level_step` on the whole
    image; band-edge rows are for the caller to crop."""
    tensors = (nxt, *exp1) + (() if first else (flow,))
    if all(t.device.type == "cpu" for t in tensors):
        return fb_band_step_plain(nxt, exp1, flow, row0, config, h_global, first)
    out = _launch(nxt, exp1, flow, config, first, row0, h_global)
    fb_band_step.launches += 1
    return out


def _launch(nxt, exp1, flow, config, first, row0, h_global) -> torch.Tensor:
    tensors = (nxt, *exp1) + (() if first else (flow,))
    if config.gaussian_window:
        raise ValueError("the CUDA FB step takes a box window; gaussian_window=True has none")
    rw = check_window(config.winsize)
    taps, mix = checked_taps(config.poly_n, config.poly_sigma)
    dev = _build.require_cuda(*tensors)
    lead, (h, w) = nxt.shape[:-2], nxt.shape[-2:]
    if len(exp1) != 5 or any(e.shape != nxt.shape for e in exp1):
        raise ValueError(f"exp1 must be five planes of shape {tuple(nxt.shape)}")
    if not first and flow.shape != nxt.shape + (2,):
        raise ValueError(f"flow {tuple(flow.shape)} does not match next {tuple(nxt.shape)}")
    n, *e = planes(nxt.reshape(-1, h, w), *(x.reshape(-1, h, w) for x in exp1))
    f = None if first else planes(flow.reshape(-1, h, w, 2))[0]
    out = torch.empty(n.shape + (2,), dtype=torch.float32, device=dev)
    rp = config.poly_n // 2
    tile = fb_tile(rw, rp)
    _build.launch(
        dev, "of2_fb_step", n.data_ptr(), *(x.data_ptr() for x in e),
        None if f is None else f.data_ptr(), out.data_ptr(), n.shape[0], h, w, int(row0),
        int(h_global), rw, rp, tile.tile_h, tile.tile_w, taps.ctypes.data, mix.ctypes.data,
        float(config.det_eps), float(config.max_displacement), int(first),
    )
    return out.reshape(lead + (h, w, 2))


fb_level_step.launches = 0
fb_band_step.launches = 0
