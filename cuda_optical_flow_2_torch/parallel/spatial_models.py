"""Spatial (tensor-parallel) sharding for Horn-Schunck, and the model-generic
spatial entry points.

Counterpart of ``cuda_optical_flow_2_tpu.parallel.spatial_models`` for
Horn-Schunck (its HS part and the shared skeleton): the gradients of each
row block are built on an exchanged band, then the Jacobi relaxation runs
time-tiled, each halo exchange shipping ``sweep_tile`` rows and buying
``sweep_tile`` local sweeps (band-edge error travels one row per sweep, so
rows deeper than the tile stay exact and are all that is kept).  With
``use_pallas`` each exchange chunk is one call of the band kernel
``kernels.hs_sweep.hs_relax_band`` and each coarse-to-fine warp one call of
``kernels.warp_select.warp_bilinear_select_band``; without it the plain
composition (the JAX package's XLA twin) runs.

Under the Charbonnier penalty the sweep chunk is the IRLS cadence: sharded
equals unsharded while ``iterations <= sweep_tile`` (and, with the kernels,
``<= MAX_SWEEPS``).  Farnebäck, TV-L1 and DIS under spatial TP are not
ported yet: their configs raise ``NotImplementedError`` (ROADMAP queue 1
item 16).
"""

from __future__ import annotations

import math

import torch

from cuda_optical_flow_2_torch.config import LKConfig
from cuda_optical_flow_2_torch.kernels import hs_sweep, warp_select
from cuda_optical_flow_2_torch.models import horn_schunck as hs
from cuda_optical_flow_2_torch.models.dis import DISConfig
from cuda_optical_flow_2_torch.models.farneback import FBConfig
from cuda_optical_flow_2_torch.models.horn_schunck import HSConfig
from cuda_optical_flow_2_torch.models.streaming import not_ported
from cuda_optical_flow_2_torch.models.tvl1 import TVL1Config
from cuda_optical_flow_2_torch.ops.band import rows_in_image, zero_outside_global
from cuda_optical_flow_2_torch.ops.gradients import spatial_gradients, temporal_gradient
from cuda_optical_flow_2_torch.ops.warp import warp_bilinear_band
from cuda_optical_flow_2_torch.parallel.batching import Mesh
from cuda_optical_flow_2_torch.parallel.spatial import (
    Blocks,
    _crop_rows,
    _grid,
    _local_family_pipeline,
    _local_pipeline,
    _row0s,
    _run_sharded,
    halo_exchange,
    validate_prefilter_shards,
    validate_spatial,
)

__all__ = [
    "grid_pyramidal_flow",
    "spatial_pyramidal_flow",
    "validate_spatial_flow",
    "spatial_pyramidal_hs",
    "validate_spatial_hs",
]


def _band_warp(nxt: Blocks, flow_c: Blocks, config, h_global: int, r_out: int) -> Blocks:
    """Warp each block by its clamped flow, returning ``r_out``-extended
    warped bands: the band kernel with ``use_pallas``, the plain band warp
    else."""
    d = int(math.ceil(config.max_displacement))
    r_img = r_out + d + 2
    nxt_p = halo_exchange(nxt, r_img, r_img)
    row0s = _row0s(nxt)
    if config.use_pallas:
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
    flow_c = [f.clamp(-d, d) for f in flow]
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
    h, w = prev.shape[-2:]
    n = mesh.shape[axis_name]
    validate_spatial_hs(h, w, config, n, sweep_tile)
    return _run_sharded(prev, nxt, mesh.axis_devices(axis_name),
                        _family_local(config, h, sweep_tile))


# ---------------------------------------------------------------------------
# Model-generic spatial entry points
# ---------------------------------------------------------------------------


def _family_local(config, h: int, sweep_tile: int):
    """The shard-local pipeline function for a config's model family: the
    single dispatch point behind every spatial entry."""
    if isinstance(config, HSConfig):
        def level_fn(p: Blocks, q: Blocks, flow: Blocks | None, h_level: int) -> Blocks:
            return _local_hs_level(p, q, flow, config, h_level, sweep_tile)

        return lambda p, q: _local_family_pipeline(p, q, config, h, level_fn)
    if isinstance(config, (FBConfig, TVL1Config, DISConfig)):
        raise NotImplementedError(
            f"spatial TP for {type(config).__name__} is not ported yet (ROADMAP queue 1 "
            "item 16); run it unsharded (models.pyramidal_flow) or batch-sharded "
            "(parallel.sharded_flow)"
        )
    if isinstance(config, LKConfig):
        return lambda p, q: _local_pipeline(p, q, config, h)
    raise not_ported(config)


def validate_spatial_flow(h: int, w: int, config, n: int, sweep_tile: int = 8) -> None:
    """Model-generic spatial validation (dispatches on the config type)."""
    if isinstance(config, HSConfig):
        validate_spatial_hs(h, w, config, n, sweep_tile)
    elif isinstance(config, LKConfig):
        validate_spatial(h, w, config, n)
    else:
        _family_local(config, h, sweep_tile)  # raises for the rest


def spatial_pyramidal_flow(
    prev: torch.Tensor,
    nxt: torch.Tensor,
    config,
    mesh: Mesh,
    axis_name: str = "space",
    sweep_tile: int = 8,
) -> torch.Tensor:
    """Model-generic spatial TP: dispatch on the config type (the TP
    counterpart of ``models.pyramidal_flow``)."""
    h, w = prev.shape[-2:]
    local = _family_local(config, h, sweep_tile)
    validate_spatial_flow(h, w, config, mesh.shape[axis_name], sweep_tile)
    return _run_sharded(prev, nxt, mesh.axis_devices(axis_name), local)


def grid_pyramidal_flow(
    prev_batch: torch.Tensor,
    nxt_batch: torch.Tensor,
    config,
    mesh: Mesh,
    batch_axis: str = "batch",
    space_axis: str = "space",
    sweep_tile: int = 8,
) -> torch.Tensor:
    """Combined DP x TP for the ported families: a frame-pair batch over a
    2-D mesh, batch-data-parallel x row-sharded with halo exchange (the
    model-generic form of ``spatial.grid_pyramidal_lk``).

    Args:
      prev_batch / nxt_batch: (B, H, W), B divisible by the batch axis size,
        H by space-size * 2^(levels-1).
    Returns: (B, H, W, 2) flow on the mesh's first device.
    """
    h, w = prev_batch.shape[-2:]
    local = _family_local(config, h, sweep_tile)
    validate_spatial_flow(h, w, config, mesh.shape[space_axis], sweep_tile)
    return _grid(prev_batch, nxt_batch, mesh, batch_axis, space_axis, local)
