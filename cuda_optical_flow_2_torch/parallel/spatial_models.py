"""Spatial (tensor-parallel) sharding for Horn-Schunck, Farnebäck, TV-L1 and
DIS, and the model-generic spatial entry points.

Counterpart of ``cuda_optical_flow_2_tpu.parallel.spatial_models``:

* **Horn-Schunck**: the gradients of each row block are built on an
  exchanged band, then the Jacobi relaxation runs time-tiled, each halo
  exchange shipping ``sweep_tile`` rows and buying ``sweep_tile`` local
  sweeps (band-edge error travels one row per sweep, so rows deeper than
  the tile stay exact and are all that is kept).  With ``use_pallas`` each
  chunk is one call of ``kernels.hs_sweep.hs_relax_band``.
* **Farnebäck** (image-warp formulation): the prev expansion on an
  exchanged band, then per iteration the band warp, re-expansion, windowed
  normal equations and solve.  With ``use_pallas`` and a config the fused
  kernel takes, each iteration is one call of
  ``kernels.fb_step_fused.fb_band_step``.
* **TV-L1**: per warp a banded linearization, then ``iter_tile``
  primal-dual iterations per exchange with the six state planes carried
  between chunks, and the shard-local median with an edge-replicated halo.
  With ``use_pallas`` each chunk is one call of
  ``kernels.tvl1_sweep.tvl1_relax_band``.
* **DIS**: the centered inverse search as LK's shard-local level (with
  ``use_pallas`` the centered mode of ``kernels.lk_step_fused.lk_band_step``),
  then the refinement: the linearization offset built once on a band wide
  enough for its window mean, and ``sweep_tile`` relaxation sweeps per
  exchange (with ``use_pallas`` one ``hs_relax_band`` call with
  ``it_offset`` per chunk).  Levels below ``finest_level`` are 2x upsamples.

Each family's TP entry is a captured entry, as ``spatial_pyramidal_lk`` is
(``parallel/spatial.py``'s docstring: one graph per key, across cards where
the space axis lists several, the eager body over cards without peer
access; the eager body stays as ``.eager``).

With ``use_pallas`` every coarse-to-fine warp outside the fused FB step is
one call of ``kernels.warp_select.warp_bilinear_select_band``; without it
the plain composition (the JAX package's XLA twin) runs.

Under the Charbonnier penalty the HS and DIS sweep chunk is the IRLS
cadence: sharded equals unsharded while ``iterations <= sweep_tile`` (DIS:
``refine_iterations``; with the kernels also ``<= MAX_SWEEPS``).  DIS's
refinement window means start their prefix sums at the band's first row, so
DIS under TP matches the unsharded path to float order, not bit for bit; at
``finest_level >= 2`` TP upsamples in 2x steps where the unsharded path
resizes once.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from cuda_optical_flow_2_torch.config import LKConfig
from cuda_optical_flow_2_torch.constants import MASKS
from cuda_optical_flow_2_torch.kernels import fb_step_fused, hs_sweep, tvl1_sweep, warp_select
from cuda_optical_flow_2_torch.models import farneback as fb
from cuda_optical_flow_2_torch.models import horn_schunck as hs
from cuda_optical_flow_2_torch.models.dis import DISConfig
from cuda_optical_flow_2_torch.models.dis import _lk_like as dis_lk_like
from cuda_optical_flow_2_torch.models.farneback import FBConfig
from cuda_optical_flow_2_torch.models.horn_schunck import HSConfig
from cuda_optical_flow_2_torch.models.streaming import not_ported
from cuda_optical_flow_2_torch.models.tvl1 import TVL1Config, tvl1_median
from cuda_optical_flow_2_torch.ops.band import rows_in_image, zero_outside_global
from cuda_optical_flow_2_torch.ops.clip import clip
from cuda_optical_flow_2_torch.ops.conv import stencil2d
from cuda_optical_flow_2_torch.ops.gradients import SOBEL_GAIN, spatial_gradients, temporal_gradient
from cuda_optical_flow_2_torch.ops.warp import warp_bilinear_band
from cuda_optical_flow_2_torch.ops.window import window_sum
from cuda_optical_flow_2_torch.parallel.batching import Mesh
from cuda_optical_flow_2_torch.parallel.spatial import (
    Blocks,
    _captured_tp,
    _crop_rows,
    _frame_hw,
    _grid,
    _local_family_pipeline,
    _local_lk_level,
    _row0s,
    _run_sharded,
    halo_exchange,
    spatial_pyramidal_lk,
    validate_prefilter_shards,
    validate_spatial,
)

__all__ = [
    "grid_pyramidal_flow",
    "spatial_pyramidal_flow",
    "validate_spatial_flow",
    "spatial_pyramidal_hs",
    "spatial_pyramidal_fb",
    "spatial_pyramidal_tvl1",
    "spatial_pyramidal_dis",
    "validate_spatial_hs",
    "validate_spatial_fb",
    "validate_spatial_tvl1",
    "validate_spatial_dis",
]


def _band_warp(
    nxt: Blocks, flow_c: Blocks, config, h_global: int, r_out: int, *,
    nxt_p: Blocks | None = None, flow_p: Blocks | None = None,
) -> Blocks:
    """Warp each block by its clamped flow, returning ``r_out``-extended
    warped bands: the band kernel with ``use_pallas``, the plain band warp
    else.

    ``nxt_p`` takes the frame already exchanged with ``r_out + d + 2`` rows,
    so a loop over a constant frame (TV-L1's warps) exchanges it once;
    ``flow_p`` the flow already exchanged with that halo (kernel) or
    ``r_out`` rows (plain).
    """
    d = int(math.ceil(config.max_displacement))
    r_img = r_out + d + 2
    if nxt_p is None:
        nxt_p = halo_exchange(nxt, r_img, r_img)
    row0s = _row0s(nxt)
    if config.use_pallas:
        if flow_p is None:
            flow_p = halo_exchange(flow_c, r_img, r_img, row_axis=-3)
        return [
            _crop_rows(
                warp_select.warp_bilinear_select_band(
                    np_, fp, r0 - r_img, h_global, config.max_displacement
                ),
                d + 2,
            )
            for np_, fp, r0 in zip(nxt_p, flow_p, row0s)
        ]
    if flow_p is None:
        flow_p = halo_exchange(flow_c, r_out, r_out, row_axis=-3)
    return [
        warp_bilinear_band(np_, fp, r0 - r_img, r0 - r_out, h_global)
        for np_, fp, r0 in zip(nxt_p, flow_p, row0s)
    ]


# ---------------------------------------------------------------------------
# Horn-Schunck
# ---------------------------------------------------------------------------


def _local_hs_relax(
    prev: Blocks, nxt: Blocks, config: HSConfig, h_global: int, sweep_tile: int
) -> Blocks:
    """Jacobi relaxation on row blocks, ``sweep_tile`` sweeps per exchange.

    With ``config.use_pallas`` each chunk is ONE call of the band kernel
    (``kernels.hs_sweep.hs_relax_band``, global-row zero padding) on the
    exchanged band, with ``sweeps + 2`` halo rows: the kernel recomputes the
    gradients per chunk from the frame bands.  Without it the gradient band
    is built once and the flow exchanged with ``sweep_tile`` halo rows per
    chunk (the JAX package's XLA twin).
    """
    robust = hs._robust_eps(config)
    row0s = _row0s(prev)
    zeros = [p.new_zeros(p.shape + (2,)) for p in prev]
    if config.use_pallas:
        k = min(sweep_tile, config.iterations, hs_sweep.MAX_SWEEPS)
        rg = k + 2
        prev_p = halo_exchange(prev, rg, rg)
        nxt_p = halo_exchange(nxt, rg, rg)
        uv = zeros
        sweeps_left = config.iterations
        for _ in range(-(-config.iterations // k)):
            s = min(k, sweeps_left)
            sweeps_left -= s
            uv = [
                _crop_rows(
                    hs_sweep.hs_relax_band(
                        pp, np_, fp, r0 - rg, h_global, sweeps=s, alpha=config.alpha,
                        temporal_kernel=config.temporal_kernel, robust=robust,
                    ),
                    rg, -3,
                )
                for pp, np_, fp, r0 in zip(
                    prev_p, nxt_p, halo_exchange(uv, rg, rg, row_axis=-3), row0s
                )
            ]
        return uv

    # Plain twin.  Under the Charbonnier penalty the flow band carries one
    # extra halo row (the lagged weights' central-difference ring) and the
    # weights are recomputed per exchange chunk: sweep_tile is the IRLS
    # cadence.
    k = min(sweep_tile, config.iterations)
    kh = k + (1 if robust is not None else 0)
    rg = kh + 2
    grads = []
    for pp, np_, r0 in zip(halo_exchange(prev, rg, rg), halo_exchange(nxt, rg, rg), row0s):
        ix, iy = spatial_gradients(pp, normalize=True)
        it = temporal_gradient(pp, np_, config.temporal_kernel, normalize=True)
        # the gradient band with exactly kh halo rows (the sweeps' margin)
        grads.append([_crop_rows(zero_outside_global(g, r0 - rg, h_global), 2)
                      for g in (ix, iy, it)])
    uv = zeros
    sweeps_left = config.iterations
    for _ in range(-(-config.iterations // k)):
        s = min(k, sweeps_left)
        sweeps_left -= s
        out = []
        for uv_p, (ix, iy, it), r0 in zip(halo_exchange(uv, kh, kh, row_axis=-3), grads, row0s):
            keep = rows_in_image(uv_p.shape[-3], r0 - kh, h_global, uv_p.device)
            if robust is not None:
                uv_p = hs._robust_chunk(uv_p, ix, iy, it, s, config.alpha, robust, keep)
            else:
                uv_p = hs._quadratic_relax(uv_p, ix, iy, it, s, config.alpha, keep)
            out.append(_crop_rows(uv_p, kh, -3))
        uv = out
    return uv


def _hs_warp_band(
    nxt: Blocks, flow: Blocks, config: HSConfig, h_global: int, r_out: int
) -> tuple[Blocks, Blocks]:
    d = float(config.max_displacement)
    flow_c = [clip(f, -d, d) for f in flow]
    warped = _band_warp(nxt, flow_c, config, h_global, r_out)
    return flow_c, [_crop_rows(w, r_out) for w in warped]


def validate_spatial_hs(h: int, w: int, config: HSConfig, n: int, sweep_tile: int = 8) -> None:
    validate_prefilter_shards(h, n, config)
    top = config.levels - 1
    if h % (n << top) or (top and w % (1 << top)):
        raise ValueError(
            f"spatial HS needs H divisible by n_shards * 2^(levels-1) "
            f"= {n << top} and W by {1 << top}; got {h}x{w}"
        )
    k = min(sweep_tile, config.iterations)
    d = int(math.ceil(config.max_displacement))
    for lvl in range(config.levels):
        hk = (h >> lvl) // n
        need = max(k + 2, 2 + d + 2 if lvl < top else 0, 2)
        if hk < need:
            raise ValueError(
                f"HS level {lvl} holds {hk} rows/shard but its halos need "
                f"{need}; reduce levels, sweep_tile, max_displacement or shards"
            )


def _local_hs_level(
    prev: Blocks, nxt: Blocks, flow: Blocks | None, config: HSConfig, h_global: int,
    sweep_tile: int,
) -> Blocks:
    """One HS pyramid level on row blocks: warp (below the coarsest) then
    the banded time-tiled relaxation."""
    if flow is None:
        return _local_hs_relax(prev, nxt, config, h_global, sweep_tile)
    flow, warped = _hs_warp_band(nxt, flow, config, h_global, 2)
    relaxed = _local_hs_relax(prev, warped, config, h_global, sweep_tile)
    return [f + r for f, r in zip(flow, relaxed)]


@_captured_tp
def spatial_pyramidal_hs(
    prev: torch.Tensor,
    nxt: torch.Tensor,
    config: HSConfig,
    mesh: Mesh,
    axis_name: str = "space",
    sweep_tile: int = 8,
) -> torch.Tensor:
    """Pyramidal Horn-Schunck for ONE pair, rows sharded over ``mesh``.

    ``sweep_tile`` Jacobi sweeps run per halo exchange (larger = fewer
    exchanges, wider halos).  Returns (H, W, 2) flow on the mesh's first
    device.
    """
    h, w = _frame_hw(prev)
    n = mesh.shape[axis_name]
    validate_spatial_hs(h, w, config, n, sweep_tile)
    return _run_sharded(prev, nxt, mesh.axis_devices(axis_name),
                        _family_local(config, h, sweep_tile, 8))


# ---------------------------------------------------------------------------
# Farnebäck (image-warp formulation)
# ---------------------------------------------------------------------------


def _fb_radii(config: FBConfig) -> tuple[int, int, int]:
    r_win = config.winsize // 2
    r_poly = config.poly_n // 2
    return r_win, r_poly, r_win + r_poly  # product band + expansion margin


def _banded_expansion(frame_p: torch.Tensor, config: FBConfig, row0_pad: int,
                      h_global: int) -> tuple[torch.Tensor, ...]:
    """Expansion of a padded band, zero outside the global image (the
    expansion's zero padding of the whole frame): kernel #9 where the
    unsharded path takes it (``models.farneback._expand``)."""
    return fb._expand(zero_outside_global(frame_p, row0_pad, h_global), config)


def _fb_fused_enabled(config: FBConfig) -> bool:
    """Whether the shard-local FB level runs the fused band kernel
    (``kernels.fb_step_fused.fb_band_step``), from the config alone, as the
    unsharded image path decides: ``use_pallas``, the image formulation and
    a config the kernel takes (box window <= 33, ``poly_n`` <= 31)."""
    return (config.use_pallas and config.warp_planes == "image"
            and fb_step_fused.supported(config))


def _fb_fused_halo(config: FBConfig) -> int:
    """Caller-side halo of the fused band step: the kernel's band margin
    plus the warp budget and the bilinear neighbour."""
    return fb_step_fused.band_margin(config) + int(math.ceil(config.max_displacement)) + 2


def _local_fb_level_fused(
    prev: Blocks, nxt: Blocks, flow: Blocks | None, config: FBConfig, h_global: int
) -> Blocks:
    """Kernel-path shard-local FB level: ONE band step per block and
    iteration on the halo-extended band (warp, re-expansion, window sums
    and solve in one launch).  The prev expansion and the next band are
    exchanged once per level; each iteration re-exchanges only the flow.
    Band-edge rows are garbage by construction and cropped."""
    _, r_poly, _ = _fb_radii(config)
    halo = _fb_fused_halo(config)
    row0s = _row0s(prev)
    exp1 = [
        tuple(_crop_rows(x, r_poly)
              for x in _banded_expansion(pp, config, r0 - halo - r_poly, h_global))
        for pp, r0 in zip(halo_exchange(prev, halo + r_poly, halo + r_poly), row0s)
    ]
    nxt_p = halo_exchange(nxt, halo, halo)
    for it in range(config.iterations):
        first = flow is None
        # the first step of a coarsest level reads no flow
        flow_p = [None] * len(prev) if first else halo_exchange(flow, halo, halo, row_axis=-3)
        flow = [
            _crop_rows(
                fb_step_fused.fb_band_step(np_, e1, fp, r0 - halo, config, h_global, first),
                halo, -3,
            )
            for np_, e1, fp, r0 in zip(nxt_p, exp1, flow_p, row0s)
        ]
    return flow


def _local_fb_level(
    prev: Blocks, nxt: Blocks, flow: Blocks | None, config: FBConfig, h_global: int
) -> Blocks:
    """One Farnebäck level on row blocks (image-warp formulation).

    Mirrors ``models.farneback.fb_level_image``: the prev expansion is
    computed once on an ``r_e``-padded band; each iteration warps the next
    band by the clipped flow (kernel #3b with ``use_pallas``), re-expands
    it, and solves the windowed normal equations (box or Gaussian window),
    cropping back to the block's rows.  With the fused kernel enabled
    (:func:`_fb_fused_enabled`) the level is :func:`_local_fb_level_fused`.
    """
    if _fb_fused_enabled(config):
        return _local_fb_level_fused(prev, nxt, flow, config, h_global)
    r_win, r_poly, r_e = _fb_radii(config)
    d = int(math.ceil(config.max_displacement))
    md = float(config.max_displacement)
    r_img = r_e + d + 2
    row0s = _row0s(prev)
    exp1 = [_banded_expansion(pp, config, r0 - r_e, h_global)
            for pp, r0 in zip(halo_exchange(prev, r_e, r_e), row0s)]
    # Only warping iterations need the displacement-wide frame halo; a
    # coarsest level running a single iteration never warps.
    r_nxt = r_img if flow is not None or config.iterations > 1 else r_e
    nxt_p = halo_exchange(nxt, r_nxt, r_nxt)
    for _ in range(config.iterations):
        if flow is None:
            w_exp = [_banded_expansion(_crop_rows(np_, r_nxt - r_e), config, r0 - r_e, h_global)
                     for np_, r0 in zip(nxt_p, row0s)]
            uv = [(torch.zeros_like(e[0]),) * 2 for e in exp1]
        else:
            flow = [clip(f, -md, md) for f in flow]
            if config.use_pallas:
                # one exchange serves the warp (r_img) and the products (r_e)
                flow_pw = halo_exchange(flow, r_img, r_img, row_axis=-3)
                flow_p = [_crop_rows(f, d + 2, -3) for f in flow_pw]
            else:
                flow_pw = flow_p = halo_exchange(flow, r_e, r_e, row_axis=-3)
            warped = _band_warp(nxt, flow, config, h_global, r_e, nxt_p=nxt_p, flow_p=flow_pw)
            w_exp = [_banded_expansion(wp, config, r0 - r_e, h_global)
                     for wp, r0 in zip(warped, row0s)]
            uv = [(f[..., 0], f[..., 1]) for f in flow_p]
        flow = []
        for e1, we, (u, v), r0 in zip(exp1, w_exp, uv, row0s):
            prods = torch.stack(fb.fb_normal_eq_products(e1, we, u, v))
            # The expansion band's outer r_poly rows see its own zero
            # padding: crop them, and zero the rows beyond the global image
            # as the whole image's window padding does.
            prods = zero_outside_global(_crop_rows(prods, r_poly), r0 - r_win, h_global)
            flow.append(_crop_rows(fb.solve_normal_eqs(fb._window(prods, config), config.det_eps),
                                   r_win, -3))
    return flow


def validate_spatial_fb(h: int, w: int, config: FBConfig, n: int) -> None:
    validate_prefilter_shards(h, n, config)
    if config.warp_planes != "image":
        raise NotImplementedError(
            "spatial FB implements the image-warp formulation "
            "(warp_planes='image'); the coefficient-warp form would "
            "silently diverge from pyramidal_farneback"
        )
    top = config.levels - 1
    if h % (n << top) or (top and w % (1 << top)):
        raise ValueError(
            f"spatial FB needs H divisible by n_shards * 2^(levels-1) "
            f"= {n << top} and W by {1 << top}; got {h}x{w}"
        )
    _, r_poly, r_e = _fb_radii(config)
    r_img = r_e + int(math.ceil(config.max_displacement)) + 2
    fused = _fb_fused_enabled(config)
    # the fused level exchanges halo + r_poly rows of prev on every level
    need_fused = _fb_fused_halo(config) + r_poly
    for lvl in range(config.levels):
        hk = (h >> lvl) // n
        # every level past the coarsest warps (needs r_img); the coarsest
        # only expands and windows (r_e), unless iterations > 1 warp there
        warps = lvl < top or config.iterations > 1
        need = max(need_fused if fused else (r_img if warps else r_e), 2)
        if hk < need:
            raise ValueError(
                f"FB level {lvl} holds {hk} rows/shard but its halos need "
                f"{need}; reduce levels, winsize, max_displacement or shards"
            )


@_captured_tp
def spatial_pyramidal_fb(
    prev: torch.Tensor,
    nxt: torch.Tensor,
    config: FBConfig,
    mesh: Mesh,
    axis_name: str = "space",
) -> torch.Tensor:
    """Pyramidal Farnebäck for ONE pair, rows sharded over ``mesh``.
    Returns (H, W, 2) flow on the mesh's first device."""
    h, w = _frame_hw(prev)
    validate_spatial_fb(h, w, config, mesh.shape[axis_name])
    return _run_sharded(prev, nxt, mesh.axis_devices(axis_name), _family_local(config, h, 8, 8))


# ---------------------------------------------------------------------------
# TV-L1 (image-warp, primal-dual): time-tiled exchanges with carried duals
# ---------------------------------------------------------------------------


def _local_tvl1_level(
    prev: Blocks, nxt: Blocks, flow: Blocks | None, config: TVL1Config, h_global: int,
    iter_tile: int,
) -> Blocks:
    """One TV-L1 level on row blocks: per warp a banded linearization, then
    ``iter_tile`` primal-dual iterations per exchange.

    Per warp the duals start at zero, as unsharded.  With ``use_pallas``
    each chunk is ONE call of ``kernels.tvl1_sweep.tvl1_relax_band`` on the
    exchanged band (``iterations + 2`` halo rows: the Sobel ring and one row
    of band-edge staleness per iteration), which recomputes the constants
    from the frame and flow bands; the six state planes are exchanged
    between chunks.  Without it the constants are built once per warp on
    the widest band and cropped, and the state is exchanged with
    ``iter_tile`` rows (the JAX package's XLA twin).  After each warp the
    shard-local median (``models.tvl1.tvl1_median``) takes an
    edge-replicated halo: OpenCV's BORDER_REPLICATE at the global top and
    bottom, true neighbour rows elsewhere.
    """
    kernel = config.use_pallas
    k = min(iter_tile, config.iterations)
    if kernel:
        k = min(k, tvl1_sweep.MAX_ITERS)
    rg = k + 2
    d = int(math.ceil(config.max_displacement))
    md = float(config.max_displacement)
    r_img = rg + d + 2
    row0s = _row0s(prev)
    coef = dict(lambda_=config.lambda_, theta=config.theta)
    prev_p = halo_exchange(prev, rg, rg)
    # the next frame is constant across warps: exchange its warp band once
    nxt_pw = halo_exchange(nxt, r_img, r_img)
    if flow is None:
        flow = [p.new_zeros(p.shape + (2,)) for p in prev]
    for _ in range(config.warps):
        flow = [clip(f, -md, md) for f in flow]
        if kernel:
            # one wide exchange serves the warp (r_img) and the band (rg)
            flow_pw = halo_exchange(flow, r_img, r_img, row_axis=-3)
            flow_p = [_crop_rows(f, d + 2, -3) for f in flow_pw]
        else:
            flow_pw = flow_p = halo_exchange(flow, rg, rg, row_axis=-3)
        warped_p = _band_warp(nxt, flow, config, h_global, rg, nxt_p=nxt_pw, flow_p=flow_pw)
        if not kernel:
            # the constants on the rg band, cropped to the k band: the Sobel
            # ring's margin rows go
            consts = [
                tuple(_crop_rows(x, rg - k) for x in tvl1_sweep.band_constants(
                    pp, wp, fp, r0 - rg, h_global, eps=config.epsilon, **coef))
                for pp, wp, fp, r0 in zip(prev_p, warped_p, flow_p, row0s)
            ]
        state = [torch.stack([f[..., 0], f[..., 1]] + [torch.zeros_like(f[..., 0])] * 4)
                 for f in flow]
        left = config.iterations
        for _ in range(-(-config.iterations // k)):
            s = min(k, left)
            left -= s
            if kernel:
                state = [
                    torch.stack([_crop_rows(x, rg) for x in tvl1_sweep.tvl1_relax_band(
                        pp, wp, fp, tuple(sb.unbind(0)), r0 - rg, h_global, iterations=s,
                        tau=config.tau, eps=config.epsilon, **coef)])
                    for pp, wp, fp, sb, r0 in zip(prev_p, warped_p, flow_p,
                                                  halo_exchange(state, rg, rg), row0s)
                ]
            else:
                state = [
                    torch.stack([_crop_rows(x, k) for x in tvl1_sweep.primal_dual_band(
                        c, tuple(sb.unbind(0)), r0 - k, h_global, iterations=s,
                        tau=config.tau, **coef)])
                    for c, sb, r0 in zip(consts, halo_exchange(state, k, k), row0s)
                ]
        planes = [st[:2] for st in state]
        if config.median_filtering > 1:
            rm = config.median_filtering // 2
            planes = [_crop_rows(tvl1_median(pl, config), rm)
                      for pl in halo_exchange(planes, rm, rm, boundary="edge")]
        flow = [pl.movedim(0, -1) for pl in planes]
    return flow


def validate_spatial_tvl1(h: int, w: int, config: TVL1Config, n: int,
                          iter_tile: int = 8) -> None:
    validate_prefilter_shards(h, n, config)
    top = config.levels - 1
    if h % (n << top) or (top and w % (1 << top)):
        raise ValueError(
            f"spatial TV-L1 needs H divisible by n_shards * 2^(levels-1) "
            f"= {n << top} and W by {1 << top}; got {h}x{w}"
        )
    k = min(iter_tile, config.iterations)
    d = int(math.ceil(config.max_displacement))
    # the per-warp median filter exchanges window//2 edge-replicated rows
    need = max(k + 2 + d + 2, config.median_filtering // 2)
    for lvl in range(config.levels):
        hk = (h >> lvl) // n
        if hk < need:
            raise ValueError(
                f"TV-L1 level {lvl} holds {hk} rows/shard but its halos "
                f"need {need}; reduce levels, iter_tile, max_displacement, "
                f"median_filtering or shards"
            )


@_captured_tp
def spatial_pyramidal_tvl1(
    prev: torch.Tensor,
    nxt: torch.Tensor,
    config: TVL1Config,
    mesh: Mesh,
    axis_name: str = "space",
    iter_tile: int = 8,
) -> torch.Tensor:
    """Pyramidal TV-L1 for ONE pair, rows sharded over ``mesh``;
    ``iter_tile`` primal-dual iterations run per halo exchange.  Returns
    (H, W, 2) flow on the mesh's first device."""
    h, w = _frame_hw(prev)
    validate_spatial_tvl1(h, w, config, mesh.shape[axis_name], iter_tile)
    return _run_sharded(prev, nxt, mesh.axis_devices(axis_name),
                        _family_local(config, h, 8, iter_tile))


# ---------------------------------------------------------------------------
# DIS (mean-normalized inverse search + variational refinement)
# ---------------------------------------------------------------------------


def _dis_lk_like(config: DISConfig) -> LKConfig:
    """LKConfig view of a DISConfig with the search iteration count folded
    in, so ``spatial._local_lk_level`` runs the whole per-level search."""
    return dataclasses.replace(dis_lk_like(config), iterations=config.iterations)


def _local_dis_refine(
    prev: Blocks, nxt: Blocks, flow: Blocks, config: DISConfig, h_global: int, sweep_tile: int
) -> Blocks:
    """Variational refinement on row blocks (``models.dis._refine``'s TP twin).

    The linearization offset ``-(ix u0 + iy v0) - win_mean(it_warped)`` is
    built once per block on an ``rp``-extended band (``rp = rg + window//2
    + 1``: the relaxation halo ``rg = k + 2`` plus the window mean's and the
    temporal stencil's margins), with the gradients, the count plane and the
    offset zero outside the GLOBAL image, as the unsharded centering sees
    them.  Then ``k``-sweep chunks relax the total flow per exchange: with
    ``use_pallas`` one ``kernels.hs_sweep.hs_relax_band`` call with
    ``it_offset`` per chunk and block, on bands cropped to ``rg`` rows;
    without it the plain sweeps with ``off`` folded into ``it``.
    """
    if config.refine_iterations <= 0:
        return flow
    kernel = config.use_pallas
    k = min(sweep_tile, config.refine_iterations)
    if kernel:
        k = min(k, hs_sweep.MAX_SWEEPS)
    rg = k + 2
    m = (config.window // 2 + 1) if config.mean_normalize else 1
    rp = rg + m
    d = float(config.max_displacement)
    flow_c = [clip(f, -d, d) for f in flow]
    warped_p = _band_warp(nxt, flow_c, _dis_lk_like(config), h_global, rp)
    prev_p = halo_exchange(prev, rp, rp)
    flow_p = halo_exchange(flow_c, rp, rp, row_axis=-3)
    row0s = _row0s(prev)
    sscale = 1.0 / SOBEL_GAIN
    tmask = MASKS[config.temporal_kernel]
    bands = []  # per block: (ix, iy, it_w, off) on the rp band
    for pp, wp, fp, r0 in zip(prev_p, warped_p, flow_p, row0s):
        ix = zero_outside_global(stencil2d(pp, MASKS["sobel_x"] * sscale), r0 - rp, h_global)
        iy = zero_outside_global(stencil2d(pp, MASKS["sobel_y"] * sscale), r0 - rp, h_global)
        off = -(ix * fp[..., 0] + iy * fp[..., 1])
        it_w = zero_outside_global(stencil2d(wp - pp, tmask / tmask.sum()), r0 - rp, h_global)
        if config.mean_normalize:
            valid = zero_outside_global(torch.ones_like(it_w), r0 - rp, h_global)
            counts = window_sum(valid, config.window, "cumsum")
            off = off - window_sum(it_w, config.window, "cumsum") / clip(counts, 1.0)
        bands.append((ix, iy, it_w, zero_outside_global(off, r0 - rp, h_global)))

    robust = (
        (config.refine_eps_data, config.refine_eps_smooth)
        if config.refine_penalty == "charbonnier" else None
    )
    uv = flow_c
    sweeps_left = config.refine_iterations
    if kernel:
        c = rp - rg
        for _ in range(-(-config.refine_iterations // k)):
            s = min(k, sweeps_left)
            sweeps_left -= s
            uv = [
                _crop_rows(
                    hs_sweep.hs_relax_band(
                        _crop_rows(pp, c), _crop_rows(wp, c), uv_p, r0 - rg, h_global,
                        sweeps=s, alpha=config.refine_alpha,
                        temporal_kernel=config.temporal_kernel,
                        it_offset=_crop_rows(off, c), robust=robust,
                    ),
                    rg, -3,
                )
                for pp, wp, (_, _, _, off), uv_p, r0 in zip(
                    prev_p, warped_p, bands, halo_exchange(uv, rg, rg, row_axis=-3), row0s
                )
            ]
        return uv

    # Plain twin: kh-halo gradient bands (k + 1 under the Charbonnier
    # penalty: the lagged weights' central-difference ring), the data term
    # constant across sweeps, the weights recomputed per chunk.
    kh = k + (1 if robust is not None else 0)
    ck = rp - kh
    grads = [
        (_crop_rows(ix, ck), _crop_rows(iy, ck), _crop_rows(it_w, ck) + _crop_rows(off, ck))
        for ix, iy, it_w, off in bands
    ]
    for _ in range(-(-config.refine_iterations // k)):
        s = min(k, sweeps_left)
        sweeps_left -= s
        out = []
        for uv_p, (ix, iy, it), r0 in zip(halo_exchange(uv, kh, kh, row_axis=-3), grads, row0s):
            keep = rows_in_image(uv_p.shape[-3], r0 - kh, h_global, uv_p.device)
            if robust is not None:
                uv_p = hs._robust_chunk(uv_p, ix, iy, it, s, config.refine_alpha, robust, keep)
            else:
                uv_p = hs._quadratic_relax(uv_p, ix, iy, it, s, config.refine_alpha, keep)
            out.append(_crop_rows(uv_p, kh, -3))
        uv = out
    return uv


def _local_dis_level(
    prev: Blocks, nxt: Blocks, flow: Blocks | None, config: DISConfig, h_global: int,
    sweep_tile: int,
) -> Blocks:
    """One DIS pyramid level on row blocks: the centered inverse-search
    steps (``spatial._local_lk_level`` with ``centered=mean_normalize``: the
    band kernel's centered mode, or the centered banded residual), then the
    banded refinement."""
    flow = _local_lk_level(prev, nxt, flow, _dis_lk_like(config), h_global,
                           centered=config.mean_normalize)
    return _local_dis_refine(prev, nxt, flow, config, h_global, sweep_tile)


def validate_spatial_dis(h: int, w: int, config: DISConfig, n: int, sweep_tile: int = 8) -> None:
    validate_prefilter_shards(h, n, config)
    top = config.levels - 1
    if h % (n << top) or (top and w % (1 << top)):
        raise ValueError(
            f"spatial DIS needs H divisible by n_shards * 2^(levels-1) "
            f"= {n << top} and W by {1 << top}; got {h}x{w}"
        )
    r_grad = config.window // 2 + 2
    d = int(math.ceil(config.max_displacement))
    r_img = r_grad + d + 2
    r_refine = 0
    if config.refine_iterations > 0:
        k = min(sweep_tile, config.refine_iterations)
        m = (config.window // 2 + 1) if config.mean_normalize else 1
        # the refine warp exchanges rp + d + 2 rows in one hop
        r_refine = (k + 2 + m) + d + 2
    for lvl in range(config.finest_level, config.levels):
        warps = lvl < top or config.iterations > 1
        hk = (h >> lvl) // n
        need = max(r_img if warps else r_grad, r_refine, 2)
        if hk < need:
            raise ValueError(
                f"DIS level {lvl} holds {hk} rows/shard but its halos need "
                f"{need}; reduce levels, window, refine sweeps, "
                f"max_displacement or shards"
            )


@_captured_tp
def spatial_pyramidal_dis(
    prev: torch.Tensor,
    nxt: torch.Tensor,
    config: DISConfig,
    mesh: Mesh,
    axis_name: str = "space",
    sweep_tile: int = 8,
) -> torch.Tensor:
    """Pyramidal DIS for ONE pair, rows sharded over ``mesh``;
    ``sweep_tile`` refinement sweeps run per halo exchange.  Levels below
    ``config.finest_level`` are never solved; the flow upsamples the rest
    of the way shard-locally, in 2x steps.  Under the Charbonnier penalty
    ``sweep_tile`` is also the IRLS cadence (see the module docstring).
    Returns (H, W, 2) flow on the mesh's first device."""
    h, w = _frame_hw(prev)
    validate_spatial_dis(h, w, config, mesh.shape[axis_name], sweep_tile)
    return _run_sharded(prev, nxt, mesh.axis_devices(axis_name),
                        _family_local(config, h, sweep_tile, 8))


# ---------------------------------------------------------------------------
# Model-generic spatial entry points
# ---------------------------------------------------------------------------


def _family_local(config, h: int, sweep_tile: int, iter_tile: int):
    """The shard-local pipeline function of an HS, FB, TV-L1 or DIS config
    (LK's is ``spatial._local_pipeline``)."""
    if isinstance(config, HSConfig):
        def level_fn(p: Blocks, q: Blocks, flow: Blocks | None, h_level: int) -> Blocks:
            return _local_hs_level(p, q, flow, config, h_level, sweep_tile)
    elif isinstance(config, FBConfig):
        def level_fn(p: Blocks, q: Blocks, flow: Blocks | None, h_level: int) -> Blocks:
            return _local_fb_level(p, q, flow, config, h_level)
    elif isinstance(config, TVL1Config):
        def level_fn(p: Blocks, q: Blocks, flow: Blocks | None, h_level: int) -> Blocks:
            return _local_tvl1_level(p, q, flow, config, h_level, iter_tile)
    elif isinstance(config, DISConfig):
        def level_fn(p: Blocks, q: Blocks, flow: Blocks | None, h_level: int) -> Blocks:
            return _local_dis_level(p, q, flow, config, h_level, sweep_tile)
    else:
        raise not_ported(config)
    finest = getattr(config, "finest_level", 0)
    return lambda p, q: _local_family_pipeline(p, q, config, h, level_fn, finest)


def validate_spatial_flow(h: int, w: int, config, n: int, sweep_tile: int = 8,
                          iter_tile: int = 8) -> None:
    """Model-generic spatial validation (dispatches on the config type)."""
    if isinstance(config, HSConfig):
        validate_spatial_hs(h, w, config, n, sweep_tile)
    elif isinstance(config, FBConfig):
        validate_spatial_fb(h, w, config, n)
    elif isinstance(config, TVL1Config):
        validate_spatial_tvl1(h, w, config, n, iter_tile)
    elif isinstance(config, DISConfig):
        validate_spatial_dis(h, w, config, n, sweep_tile)
    elif isinstance(config, LKConfig):
        validate_spatial(h, w, config, n)
    else:
        raise not_ported(config)


def _tp_entry(config, sweep_tile: int, iter_tile: int):
    """(the config family's captured TP entry, its tile keywords)."""
    if isinstance(config, HSConfig):
        return spatial_pyramidal_hs, {"sweep_tile": sweep_tile}
    if isinstance(config, FBConfig):
        return spatial_pyramidal_fb, {}
    if isinstance(config, TVL1Config):
        return spatial_pyramidal_tvl1, {"iter_tile": iter_tile}
    if isinstance(config, DISConfig):
        return spatial_pyramidal_dis, {"sweep_tile": sweep_tile}
    if isinstance(config, LKConfig):
        return spatial_pyramidal_lk, {}
    raise not_ported(config)


def spatial_pyramidal_flow(
    prev: torch.Tensor,
    nxt: torch.Tensor,
    config,
    mesh: Mesh,
    axis_name: str = "space",
    sweep_tile: int = 8,
    iter_tile: int = 8,
) -> torch.Tensor:
    """Model-generic spatial TP: dispatch on the config type to the family's
    (captured) TP entry (the TP counterpart of ``models.pyramidal_flow``)."""
    entry, tiles = _tp_entry(config, sweep_tile, iter_tile)
    return entry(prev, nxt, config, mesh, axis_name, **tiles)


def grid_pyramidal_flow(
    prev_batch: torch.Tensor,
    nxt_batch: torch.Tensor,
    config,
    mesh: Mesh,
    batch_axis: str = "batch",
    space_axis: str = "space",
    sweep_tile: int = 8,
    iter_tile: int = 8,
) -> torch.Tensor:
    """Combined DP x TP for the ported families: a frame-pair batch over a
    2-D mesh, batch-data-parallel x row-sharded with halo exchange (the
    model-generic form of ``spatial.grid_pyramidal_lk``): each batch group
    is one call of the family's TP entry, a replay on the group's space
    devices (``.eager`` runs every group eagerly).

    Args:
      prev_batch / nxt_batch: (B, H, W), B divisible by the batch axis size,
        H by space-size * 2^(levels-1).
    Returns: (B, H, W, 2) flow on the mesh's first device.
    """
    return _grid_flow(False, prev_batch, nxt_batch, config, mesh, batch_axis, space_axis,
                      sweep_tile, iter_tile)


def _grid_flow(eager: bool, prev_batch, nxt_batch, config, mesh, batch_axis, space_axis,
               sweep_tile, iter_tile):
    h, w = prev_batch.shape[-2:]
    entry, tiles = _tp_entry(config, sweep_tile, iter_tile)
    validate_spatial_flow(h, w, config, mesh.shape[space_axis], sweep_tile, iter_tile)
    tp = entry.eager if eager else entry
    return _grid(prev_batch, nxt_batch, mesh, batch_axis, space_axis,
                 lambda p, q, space: tp(p, q, config, space, "space", **tiles))


def _grid_pyramidal_flow_eager(
    prev_batch: torch.Tensor,
    nxt_batch: torch.Tensor,
    config,
    mesh: Mesh,
    batch_axis: str = "batch",
    space_axis: str = "space",
    sweep_tile: int = 8,
    iter_tile: int = 8,
) -> torch.Tensor:
    """:func:`grid_pyramidal_flow` with every group's TP call eager."""
    return _grid_flow(True, prev_batch, nxt_batch, config, mesh, batch_axis, space_axis,
                      sweep_tile, iter_tile)


grid_pyramidal_flow.eager = _grid_pyramidal_flow_eager
